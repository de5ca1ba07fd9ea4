"""T — the transform scan (paper Alg. 1) and its plain versions.

The reference runs ``repro.core.transform._transform_step`` under a
``lax.scan`` over every edge and has no Pallas kernel for it.  The port
splits the step in two: ``transform_inputs`` computes, vectorized, what
does not depend on the running loads (each edge's endpoint partitions and
its Alg. 1 lines 15-22 choice), and ``transform_scan`` walks the stream
against the load table — ``csrc/transform_scan.cu`` on CUDA tensors, the
plain Python loop ``transform_scan_plain`` on CPU tensors.

The kernel decides the stream in chunks of ``CHUNK`` edges, each in the
cheapest exact tier (parallel, frozen-F warp walk, exact warp walk; see
the source's header).  ``transform_scan_tiered_plain`` emulates those
tiers on the host, chunk size and decisions included, and counts them as
the kernel does: it is what the tests hold against the reference, since
the kernel cannot run on the CPU.

Every walk takes an optional ``loads0``, the (k,) loads already carried
(the reference's ``transform_np(..., loads=)``): a window of new edges is
then assigned against a resident partition's loads.  Without it the walk
starts from zero loads, as ``transform_jax`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

MAX_K = 1024         # the warp walk keeps the loads in registers, ⌈k/32⌉ a lane
CHUNK = 4096         # csrc/transform_scan.cu kChunk
# the kernel's stats slots, in order: chunks decided in parallel, by a
# frozen-F walk, by an exact walk; frozen walks redone exactly; edges in
# frozen walks (redone ones included) and in exact walks; both-full edges
TIER_KEYS = ("parallel", "frozen", "exact", "redone", "frozen_edges",
             "exact_edges", "both_edges")


def transform_inputs(src, dst, vertex_part, deg, divided, live=None):
    """Per-edge (pu, pv, normal) int32: the endpoints' prior partitions
    and the choice Alg. 1 makes when neither partition is full — same
    partition → keep, a divided endpoint → its mirror side, else cut the
    higher-degree endpoint.  ``normal`` is -1 on padding lanes."""
    pu = vertex_part[src]
    pv = vertex_part[dst]
    du, dv = deg[src], deg[dst]
    divu, divv = divided[src], divided[dst]
    mirror = torch.where(divu, pv, pu)
    degree = torch.where(dv > du, pu, pv)
    normal = torch.where(pu == pv, pu,
                         torch.where(divu | divv, mirror, degree))
    if live is not None:
        normal = torch.where(live, normal, torch.full_like(normal, -1))
    return (pu.to(torch.int32).contiguous(), pv.to(torch.int32).contiguous(),
            normal.to(torch.int32).contiguous())


def _start_loads(loads0, k: int) -> list:
    return [0] * k if loads0 is None else \
        [int(x) for x in torch.as_tensor(loads0).cpu().tolist()]


def transform_scan_plain(pu, pv, normal, k: int, lmax: float, loads0=None):
    """The walk in Python over host copies, from the loads ``loads0``
    (zero when None); returns on the inputs' device.  The cap test is an
    f32 compare, as in the reference's jit path: loads below 2**24 are
    exact in f32."""
    out = _walk(pu.cpu().tolist(), pv.cpu().tolist(), normal.cpu().tolist(),
                _start_loads(loads0, k), float(np.float32(lmax)))
    return torch.tensor(out, dtype=torch.int32, device=pu.device)


def _full(load, lmax):
    """(float)load >= lmax in f32: loads below 2**24 are exact in f32."""
    return (load if load < 16777216 else float(np.float32(load))) >= lmax


def _walk(a, b, nm, loads, lmax, frozen=None):
    """The walk over lists from ``loads`` (updated in place); ``frozen``
    replaces the running full test by a fixed full set."""
    out = []
    for x, y, n in zip(a, b, nm):
        if n < 0:
            out.append(0)
            continue
        if frozen is None:
            fu, fv = _full(loads[x], lmax), _full(loads[y], lmax)
        else:
            fu, fv = frozen[x], frozen[y]
        p = n
        if fu or fv:
            p = y if fu and not fv else x if not fu else \
                loads.index(min(loads))
        out.append(p)
        loads[p] += 1
    return out


def transform_scan_tiered_plain(pu, pv, normal, k: int, lmax: float,
                                loads0=None):
    """The kernel's tiered walk on the host from the loads ``loads0``
    (zero when None), chunk by chunk: speculate
    every choice from the chunk's starting full set F; keep them when no
    edge is both-full and no partition outside F fills (parallel); else
    walk with F frozen and keep that when no partition filled (frozen);
    else walk exactly.  Returns ((E,) int32 on the inputs' device, the
    tier counts keyed by ``TIER_KEYS``)."""
    lmax = float(np.float32(lmax))
    a_all, b_all, n_all = (t.cpu().numpy() for t in (pu, pv, normal))
    loads = np.array(_start_loads(loads0, k), np.int64)
    out = np.zeros(a_all.shape[0], np.int32)
    tiers = dict.fromkeys(TIER_KEYS, 0)

    def full(x):
        return x.astype(np.float32) >= lmax
    for base in range(0, a_all.shape[0], CHUNK):
        sl = slice(base, base + CHUNK)
        a, b, nm = a_all[sl], b_all[sl], n_all[sl]
        f = full(loads)
        live = nm >= 0
        fu, fv = f[np.where(live, a, 0)], f[np.where(live, b, 0)]
        spec = np.where(~fu, np.where(fv, a, nm), b)
        both = live & fu & fv
        hist = np.bincount(spec[live & ~both], minlength=k)
        fill = bool((~f & full(loads + hist)).any())
        n_both = int(both.sum())
        tiers["both_edges"] += n_both
        if not fill and n_both == 0:
            tiers["parallel"] += 1
            out[sl] = np.where(live, spec, 0)
            loads += hist
            continue
        args = (a.tolist(), b.tolist(), nm.tolist())
        if not fill:
            walked = loads.tolist()
            got = _walk(*args, walked, lmax, frozen=f.tolist())
            tiers["frozen_edges"] += len(got)
            if not (~f & full(np.array(walked))).any():
                tiers["frozen"] += 1
                out[sl] = got
                loads = np.array(walked, np.int64)
                continue
            tiers["redone"] += 1
        walked = loads.tolist()
        out[sl] = _walk(*args, walked, lmax)
        loads = np.array(walked, np.int64)
        tiers["exact"] += 1
        tiers["exact_edges"] += len(nm)
    return torch.from_numpy(out).to(pu.device), tiers


def _check(pu, pv, normal, k, loads0):
    E = pu.shape[0]
    if pv.shape != (E,) or normal.shape != (E,):
        raise ValueError("transform_scan: inconsistent shapes")
    if not 0 < k <= MAX_K:
        raise ValueError(f"transform_scan: k={k} is outside 1..{MAX_K} (the "
                         "walk keeps the loads in a warp's registers)")
    if loads0 is not None:
        loads0 = torch.as_tensor(loads0)
        if loads0.shape != (k,):
            raise ValueError(f"transform_scan: loads0 must have shape ({k},)")
        if int(loads0.min()) < 0 or int(loads0.max()) + E >= 2 ** 31:
            raise ValueError("transform_scan: seeded loads must be "
                             "non-negative and, with the stream's edges, "
                             "fit int32")


def _launch(pu, pv, normal, k, lmax, loads0):
    E = pu.shape[0]
    if {pu.dtype, pv.dtype, normal.dtype} != {torch.int32}:
        raise ValueError("transform_scan: inputs must be int32")
    _build.require_cuda(pu, pv, normal)
    if any(t.data_ptr() % 16 for t in (pu, pv, normal)):
        raise ValueError("transform_scan: inputs must be 16-byte aligned "
                         "(the kernel stages them with 16-byte copies)")
    if loads0 is not None:
        loads0 = torch.as_tensor(loads0).to(device=pu.device,
                                            dtype=torch.int32).contiguous()
    out = torch.empty(E, dtype=torch.int32, device=pu.device)
    stats = torch.zeros(len(TIER_KEYS), dtype=torch.int64, device=pu.device)
    _build.launch("transform_scan", "t_transform_scan", pu, pv, normal,
                  loads0, out, stats, int(E), int(k), float(lmax))
    return out, stats


def transform_scan(pu, pv, normal, k: int, lmax: float, loads0=None):
    """Edge → partition under the balance cap ``lmax`` (rounded to f32),
    for 1 ≤ k ≤ ``MAX_K``, from the loads ``loads0`` (a (k,) count; zero
    when None).  Returns (E,) int32."""
    _check(pu, pv, normal, k, loads0)
    if pu.device.type == "cpu":
        return transform_scan_plain(pu, pv, normal, k, lmax, loads0)
    return _launch(pu, pv, normal, k, lmax, loads0)[0]


def transform_scan_tiers(pu, pv, normal, k: int, lmax: float, loads0=None):
    """``transform_scan`` on CUDA tensors that also returns the kernel's
    tier counts (keyed by ``TIER_KEYS``): where a run's walk went."""
    _check(pu, pv, normal, k, loads0)
    out, stats = _launch(pu, pv, normal, k, lmax, loads0)
    return out, dict(zip(TIER_KEYS, stats.tolist()))
