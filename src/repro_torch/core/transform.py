"""Pass 3 — partition transformation (paper Alg. 1) and the restream prior.

Port of ``repro.core.transform``: ``transform`` (``transform_jax``) turns
the vertex → partition prior into an edge → partition assignment under
the balance cap L_max = τ·|E|/k, walking the stream on the T kernel
(``kernels.transform_scan``); ``majority_vertex_map``
(``majority_vertex_map_jax``) is the prioritized-restream prior, its count
table summed over the ranks of a sharded run.  Both
are bit-identical to the reference.

``transform(..., loads=, lmax=)`` is the counterpart of the host oracle
``transform_np``'s keywords: the walk starts from loads already carried
and takes an explicit cap, compared as ``transform_np`` compares it.

``transform_np`` and ``majority_vertex_map_np`` are numpy copies of the
reference's host oracle (the ``np`` backend's transform and prior).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..dist import collectives as coll
from ..kernels.transform_scan import (transform_inputs, transform_scan,
                                      transform_scan_plain)


def transform_np(src: np.ndarray, dst: np.ndarray,
                 vertex_part: np.ndarray, deg: np.ndarray,
                 divided: np.ndarray, k: int, tau: float = 1.0, *,
                 loads: np.ndarray | None = None,
                 lmax: float | None = None) -> np.ndarray:
    """Alg. 1 on the host, edge by edge, with an f64 cap (the reference's
    oracle).  ``loads``/``lmax`` seed the pass with per-partition edge
    counts already carried and an external cap; the defaults are the
    batch pass."""
    E = src.shape[0]
    if lmax is None:
        lmax = tau * E / float(k)
    loads = (np.zeros(k, dtype=np.int64) if loads is None
             else np.asarray(loads, dtype=np.int64).copy())
    assign = np.zeros(E, dtype=np.int32)
    vp = vertex_part
    for i in range(E):
        u = int(src[i]); v = int(dst[i])
        pu = int(vp[u]); pv = int(vp[v])
        if loads[pu] >= lmax or loads[pv] >= lmax:      # lines 6-14
            if loads[pu] < lmax:
                p = pu
            elif loads[pv] < lmax:
                p = pv
            else:
                p = int(np.argmin(loads))
        elif pu == pv:                                   # lines 15-16
            p = pu
        elif divided[u]:                                 # lines 17-19
            p = pv
        elif divided[v]:
            p = pu
        elif deg[v] > deg[u]:                            # lines 20-22
            p = pu
        else:
            p = pv
        assign[i] = p
        loads[p] += 1
    return assign


def majority_vertex_map_np(src, dst, assign, num_vertices: int,
                           k: int) -> np.ndarray:
    """Per vertex, the partition holding most of its edges in the previous
    pass (ties → the lowest partition id)."""
    key = (np.concatenate([src, dst]).astype(np.int64) * k
           + np.tile(assign, 2))
    cnt = np.bincount(key, minlength=num_vertices * k)
    return cnt.reshape(num_vertices, k).argmax(axis=1).astype(np.int32)


# loads are exact in f32 below 2**24, so an integral cap up to it is too
_F32_EXACT = 1 << 24


def host_exact_cap(lmax: float) -> float:
    """The cap T compares in f32 that decides as the host oracle's f64
    ``load >= lmax`` does: for an integer load that holds exactly when
    ``load >= ceil(lmax)``, and the ceiling is exact in f32 up to 2**24."""
    cap = math.ceil(lmax)
    if cap > _F32_EXACT:
        raise ValueError(f"cap {lmax} is above 2**24, where f32 loads are "
                         "no longer exact")
    return float(cap)


def transform(src, dst, vertex_part, deg, divided, k: int, tau: float = 1.0,
              mask=None, kernel: str = "cuda", *, loads=None, lmax=None):
    """Alg. 1 over int32 ``src``/``dst`` tensors.  ``mask`` marks live
    edges (padding lanes get partition 0 and add no load).
    ``kernel="torch"`` walks with the plain version.  Returns (E,) int32.

    Without ``lmax`` the cap is τ·E/k compared in f32, as
    ``transform_jax`` compares it.  With ``lmax`` (``transform_np``'s
    keyword) the cap is compared as the host oracle compares it, in f64:
    T gets ``host_exact_cap(lmax)``.  ``loads`` (a (k,) count) seeds the
    walk with the loads already carried; None starts from zero.  A
    k-sweep step's f32 cap (τ·E in f32 over k in f32, as the reference
    computes it) comes as ``lmax`` too: for integer loads ``load >= cap``
    and ``load >= ceil(cap)`` decide alike."""
    cap = tau * src.shape[0] / float(k) if lmax is None \
        else host_exact_cap(lmax)
    pu, pv, normal = transform_inputs(src.long(), dst.long(),
                                      vertex_part.to(torch.int32),
                                      deg, divided.to(torch.bool),
                                      None if mask is None
                                      else mask.to(torch.bool))
    walk = transform_scan if kernel == "cuda" else transform_scan_plain
    return walk(pu, pv, normal, k, cap, loads)


def partition_counts(src, dst, assign, num_vertices: int, k: int,
                     mask=None):
    """(V, k) int32: per vertex, its edge endpoints in each partition.
    Masked lanes drop into one extra row that is sliced off."""
    src, dst = src.long(), dst.long()
    if mask is not None:
        src = torch.where(mask, src, num_vertices)
        dst = torch.where(mask, dst, num_vertices)
    a = assign.long()
    cnt = torch.zeros((num_vertices + 1) * k, dtype=torch.int32,
                      device=src.device)
    one = torch.ones(src.shape[0], dtype=torch.int32, device=src.device)
    cnt.index_add_(0, src * k + a, one)
    cnt.index_add_(0, dst * k + a, one)
    return cnt.view(num_vertices + 1, k)[:num_vertices]


def majority_vertex_map(src, dst, assign, num_vertices: int, k: int,
                        mask=None, axis=None):
    """Per vertex, the partition holding most of its edges (ties → the
    lowest partition id, as ``jnp.argmax``).  Under a mesh ``axis`` each
    rank counts its slice and the (V, k) tables are summed over the ranks
    (``majority_vertex_map_jax``'s psum), so the prior is global while
    the streams stay local."""
    cnt = coll.psum(partition_counts(src, dst, assign, num_vertices, k,
                                     mask), axis, site="restream.counts")
    return torch.argmax(cnt, dim=1).to(torch.int32)
