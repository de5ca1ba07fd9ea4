"""K1 — the clustering fused-scatter kernel and its plain version.

Port of ``repro.kernels.cluster_scatter``: one block of B edges of the
streaming-clustering scan (paper Alg. 2), run edge by edge over a fused
int32 table ``buf`` of 10·B entries ([0, 2B) vertex slot → local cluster
slot, [2B, 4B) streamed degree, [4B, 10B) cluster volumes).

- ``cluster_scatter`` is the wrapper: CPU tensors run the plain version,
  CUDA tensors launch ``csrc/cluster_scatter.cu`` (no fallback).
- ``cluster_scatter_plain`` walks the block in Python scalars over a
  host copy of the table, with ``edge_decisions`` — a line-by-line copy of
  the reference's decision math.  f32 semantics are kept exactly:
  ``_f32`` rounds a Python float to float32, and an f32 product or
  quotient of two f32 values computed in double and rounded once is the
  correctly rounded f32 result.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build


def _f32(x) -> float:
    return float(np.float32(x))


def edge_decisions(cu0, cv0, d0, d1, vg0, vg1, live, nid, nid0, seen_v,
                   seen_deg, *, vmax, allow_split, sdf, B):
    """One streamed edge's allocation–splitting–migration decisions (the
    reference's ``edge_decisions``, in Python ints).  ``vmax`` and ``sdf``
    are already f32-rounded.  Returns (nid, seen_v, seen_deg, newu, newv,
    vol_ids, vol_deltas, packed)."""
    scrap = 6 * B - 1
    du, dv = d0 + 1, d1 + 1
    duf, dvf = _f32(du), _f32(dv)
    preu, prev = cu0 >= 0, cv0 >= 0
    id0 = cu0 if preu else 2 * B + (nid - nid0)
    nid += int(live and not preu)
    id1 = cv0 if prev else 2 * B + (nid - nid0)
    nid += int(live and not prev)
    same = id0 == id1
    seen_v += int(live and not preu) + int(live and not prev)
    seen_deg += 2 * int(live)
    dthr = (_f32(_f32(sdf * _f32(seen_deg)) / _f32(max(seen_v, 1)))
            if sdf > 0.0 else 0.0)

    v = [vg0 if preu else 0, vg1 if (prev and not same) else 0, 0, 0]
    i0, i1 = v[0], v[1]
    lvflag = int(live)
    pu, pv = 0, (0 if same else 1)
    v[pu] += lvflag
    v[pv] += lvflag

    fire1 = fire2 = t1_is_u = False
    id2 = id3 = scrap
    if allow_split:
        t1_is_u = (du >= dv) if same else True
        pt1 = pu if t1_is_u else pv
        dt1 = du if t1_is_u else dv
        fire1 = live and _f32(v[pt1]) >= vmax \
            and (duf if t1_is_u else dvf) >= dthr
        f1 = int(fire1)
        v[pt1] -= dt1 * f1
        v[2] += dt1 * f1
        if fire1 and t1_is_u:
            pu = 2
        if fire1 and not t1_is_u:
            pv = 2
        id2 = 2 * B + (nid - nid0)
        nid += f1
        fire2 = live and not same and _f32(v[pv]) >= vmax and dvf >= dthr
        f2 = int(fire2)
        v[pv] -= dv * f2
        v[3] += dv * f2
        id3 = 2 * B + (nid - nid0)
        nid += f2
        if fire2:
            pv = 3

    vu_cur, vv_cur = v[pu], v[pv]
    both_room = live and pu != pv and _f32(vu_cur) < vmax \
        and _f32(vv_cur) < vmax
    u_moves = both_room and vu_cur <= vv_cur and _f32(vv_cur + du) < vmax
    v_moves = both_room and vu_cur > vv_cur and _f32(vu_cur + dv) < vmax
    mu, mv = int(u_moves), int(v_moves)
    v[pu] += -du * mu + dv * mv
    v[pv] += du * mu - dv * mv
    pu, pv = (pv if u_moves else pu), (pu if v_moves else pv)

    ids = (id0, id1, id2, id3)
    newu = ids[pu] if live else cu0
    newv = ids[pv] if live else cv0

    def clip(x):
        return min(max(x, 0), scrap)

    vol_ids = (clip(id0 if live else scrap), clip(scrap if same else id1),
               clip(id2 if fire1 else scrap), clip(id3 if fire2 else scrap))
    vol_deltas = (v[0] - i0, v[1] - i1, v[2], v[3])
    fire_u = fire1 and t1_is_u
    fire_v = (fire1 and not t1_is_u) or fire2
    packed = int(fire_u) + 2 * int(fire_v)
    return nid, seen_v, seen_deg, newu, newv, vol_ids, vol_deltas, packed


def cluster_scatter_plain(ints, buf, scal, vmax, *, allow_split=True,
                          split_degree_factor=0.0):
    """Plain version of K1 on any device: the block walks in Python over
    a host copy and the results return to the inputs' device."""
    B = ints.shape[0]
    device = buf.device
    rows = ints.cpu().tolist()
    b = buf.cpu().tolist()
    nid, nid0, seen_v, seen_deg = scal.cpu().tolist()
    vmax, sdf = _f32(vmax), _f32(split_degree_factor)
    scrap = 6 * B - 1
    packed = []
    for lu, lv, lv_live in rows:
        live = lv_live != 0
        cu0, cv0 = b[lu], b[lv]
        d0, d1 = b[2 * B + lu], b[2 * B + lv]
        vg0 = b[4 * B + min(max(cu0, 0), scrap)]
        vg1 = b[4 * B + min(max(cv0, 0), scrap)]
        (nid, seen_v, seen_deg, newu, newv, vol_ids, vol_deltas,
         pk) = edge_decisions(cu0, cv0, d0, d1, vg0, vg1, live, nid, nid0,
                              seen_v, seen_deg, vmax=vmax,
                              allow_split=allow_split, sdf=sdf, B=B)
        b[lu] += (newu - cu0) if lu != lv else 0
        b[lv] += newv - cv0
        b[2 * B + lu] += int(live)
        b[2 * B + lv] += int(live)
        for a, d in zip(vol_ids, vol_deltas):
            b[4 * B + a] += d
        packed.append(pk)
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.tensor(b, **i32),
            torch.tensor([nid, nid0, seen_v, seen_deg], **i32),
            torch.tensor(packed, **i32))


def cluster_scatter(ints, buf, scal, vmax: float, *, allow_split=True,
                    split_degree_factor=0.0):
    """One block of the clustering scan: ``ints`` (B, 3) int32 rows of
    (local u slot, local v slot, live); ``buf`` (10B,) int32; ``scal``
    (4,) int32 = (nid, nid0, seen_v, seen_deg); ``vmax`` a Python float.
    Returns (buf', scal', packed (B,)) with ``packed`` = fire_u + 2·fire_v
    per edge — the reference kernel's outputs, bit for bit."""
    if buf.device.type == "cpu":
        return cluster_scatter_plain(ints, buf, scal, vmax,
                                     allow_split=allow_split,
                                     split_degree_factor=split_degree_factor)
    B = ints.shape[0]
    if (ints.shape != (B, 3) or buf.shape != (10 * B,) or scal.shape != (4,)
            or not 0 < B <= 512):
        raise ValueError(f"cluster_scatter: bad shapes {tuple(ints.shape)}, "
                         f"{tuple(buf.shape)}, {tuple(scal.shape)}")
    if {ints.dtype, buf.dtype, scal.dtype} != {torch.int32}:
        raise ValueError("cluster_scatter: inputs must be int32")
    _build.require_cuda(ints, buf, scal)
    buf_out = torch.empty_like(buf)
    scal_out = torch.empty_like(scal)
    packed = torch.empty(B, dtype=torch.int32, device=buf.device)
    _build.launch("cluster_scatter", "k1_cluster_scatter", ints, buf, scal,
                  buf_out, scal_out, packed, int(B), float(vmax),
                  bool(allow_split), float(split_degree_factor))
    return buf_out, scal_out, packed
