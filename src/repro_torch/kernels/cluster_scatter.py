"""K1 — the streaming-clustering scan and its plain versions.

Port of ``repro.kernels.cluster_scatter``: one block of B edges of the
streaming-clustering scan (paper Alg. 2), run edge by edge over a fused
int32 table ``buf`` of 10·B entries ([0, 2B) vertex slot → local cluster
slot, [2B, 4B) streamed degree, [4B, 10B) cluster volumes); and the whole
pass over the stream, each block localized, walked and written back as
``repro.core.clustering._block_step`` does.

- ``cluster_pass`` is the pass the clustering runs: CPU tensors run
  ``cluster_pass_plain``, CUDA tensors launch ``k1_cluster_pass`` of
  ``csrc/cluster_scatter.cu`` once for the whole stream (no fallback).
- ``cluster_scatter`` is the one-block entry: CPU tensors run
  ``cluster_scatter_plain``, CUDA tensors launch ``k1_cluster_scatter``.
- ``cluster_scatter_plain`` walks the block in Python scalars over a
  host copy of the table, with ``edge_decisions`` — a line-by-line copy of
  the reference's decision math.  f32 semantics are kept exactly:
  ``_f32`` rounds a Python float to float32, and an f32 product or
  quotient of two f32 values computed in double and rounded once is the
  correctly rounded f32 result.  ``cluster_pass_plain`` runs it block by
  block between PyTorch gathers and scatters.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

BIG_ID = 2 ** 31 - 1     # the reference's _BIG_ID: an empty cluster slot
PASS_BLOCK = 128         # edges per block of the pass kernel


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


def _check_pass(ints, uvg, clu, deg, vol, scal):
    nb, B = uvg.shape[0], ints.shape[1]
    if (ints.shape != (nb, B, 3) or uvg.shape != (nb, 2 * B) or scal.shape
            != (4,) or clu.dim() != 1 or deg.shape != clu.shape
            or vol.dim() != 1 or clu.shape[0] < 2 or vol.shape[0] < 1):
        raise ValueError(f"cluster_pass: bad shapes ints {tuple(ints.shape)}"
                         f", uvg {tuple(uvg.shape)}, clu {tuple(clu.shape)}, "
                         f"deg {tuple(deg.shape)}, vol {tuple(vol.shape)}, "
                         f"scal {tuple(scal.shape)}")
    if {t.dtype for t in (ints, uvg, clu, deg, vol, scal)} != {torch.int32}:
        raise ValueError("cluster_pass: inputs must be int32")


def cluster_pass_plain(ints, uvg, clu, deg, vol, scal, vmax: float, *,
                       allow_split=True, split_degree_factor=0.0):
    """Plain version of the pass: per block, PyTorch gathers build the
    fused table, ``cluster_scatter_plain`` walks it, and PyTorch scatters
    write it back.  Updates ``clu``, ``deg``, ``vol`` and ``scal`` in
    place, like ``cluster_pass``; returns ``packed`` (nb·B,)."""
    _check_pass(ints, uvg, clu, deg, vol, scal)
    nb, B = ints.shape[0], ints.shape[1]
    V, cap = clu.shape[0] - 1, vol.shape[0]
    scrap = cap - 1
    i32 = dict(dtype=torch.int32, device=clu.device)
    uv_read = uvg.clamp(0, V - 1)             # gathers of real vertices
    uv_real = uvg < V
    uv_write = uvg.long()                     # pad slot V absorbs writes
    zeros4 = torch.zeros(4 * B, **i32)
    fresh = torch.arange(4 * B, **i32)
    start_of_block = torch.tensor([0, 0, 2, 3], device=clu.device)
    fires = []
    # index_select / index_copy_ keep each step off PyTorch's slower
    # advanced-indexing path
    for b in range(nb):
        rd = uv_read[b]
        cids = clu.index_select(0, rd)
        validc = uv_real[b] & (cids >= 0)
        keyc = torch.where(validc, cids, BIG_ID)
        ucl = torch.sort(keyc).values
        lc = torch.where(validc, torch.searchsorted(ucl, keyc,
                                                    out_int32=True), -1)
        lvol0 = torch.where(ucl < BIG_ID,
                            vol.index_select(0, ucl.clamp(0, scrap)), 0)
        buf = torch.cat([lc, deg.index_select(0, rd), lvol0, zeros4])
        scal0 = scal.index_select(0, start_of_block)     # nid0 := nid
        out, scal1, packed = cluster_scatter_plain(
            ints[b], buf, scal0, vmax, allow_split=allow_split,
            split_degree_factor=split_degree_factor)
        scal.copy_(scal1)
        fires.append(packed)
        lclu, ldeg, lvol = out[:2 * B], out[2 * B:4 * B], out[4 * B:]
        glob_of = torch.cat([ucl, scal[1] + fresh])
        newclu = torch.where(
            lclu >= 0, glob_of.index_select(0, lclu.clamp(0, 6 * B - 1)), -1)
        wr = uv_write[b]
        clu.index_copy_(0, wr, newclu)
        deg.index_copy_(0, wr, ldeg)
        dvol = lvol - torch.cat([lvol0, zeros4])
        keep = torch.cat([ucl < BIG_ID, dvol[2 * B:] != 0])
        ids = torch.where(keep, glob_of.clamp(0, scrap), scrap)
        vol.index_add_(0, ids, dvol)
    return torch.cat(fires)


def cluster_pass(ints, uvg, clu, deg, vol, scal, vmax: float, *,
                 allow_split=True, split_degree_factor=0.0):
    """The whole clustering pass over nb blocks of B edges, **in place**.

    ``ints`` (nb, B, 3) int32 rows of (local u slot, local v slot, live)
    and ``uvg`` (nb, 2B) int32, the global vertex of each local slot (pad
    = V), come from the batched localization; ``clu`` and ``deg`` (V + 1,)
    carry the extra slot V that absorbs the pad slots' writes, ``vol``
    (cap,) the cluster volumes (scrap id cap − 1), ``scal`` (4,) = (nid,
    nid0, seen_v, seen_deg).  ``clu``, ``deg``, ``vol`` and ``scal`` are
    updated in place; returns ``packed`` (nb·B,) = fire_u + 2·fire_v per
    edge.  CUDA tensors launch ``k1_cluster_pass`` once (B = 128)."""
    if clu.device.type == "cpu":
        return cluster_pass_plain(ints, uvg, clu, deg, vol, scal, vmax,
                                  allow_split=allow_split,
                                  split_degree_factor=split_degree_factor)
    _check_pass(ints, uvg, clu, deg, vol, scal)
    nb, B = ints.shape[0], ints.shape[1]
    if B != PASS_BLOCK:
        raise ValueError(f"cluster_pass: the kernel walks blocks of "
                         f"{PASS_BLOCK} edges, not {B}")
    if max(clu.shape[0], vol.shape[0]) > 2 ** 31 - 1:
        raise ValueError("cluster_pass: tables exceed int32 indexing")
    _build.require_cuda(ints, uvg, clu, deg, vol, scal)
    packed = torch.empty(nb * B, dtype=torch.int32, device=clu.device)
    _build.launch("cluster_scatter", "k1_cluster_pass", ints, uvg, clu, deg,
                  vol, scal, packed, int(nb), int(clu.shape[0] - 1),
                  int(vol.shape[0]), float(vmax), bool(allow_split),
                  float(split_degree_factor))
    return packed
