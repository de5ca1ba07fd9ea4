"""Pass 1 — streaming clustering (paper Alg. 2), blocked, on the device.

Port of ``repro.core.clustering.streaming_clustering_jax``.  The stream
is cut into blocks of B edges; per block the ≤ 2B touched vertices and
their ≤ 2B current clusters are localized into one fused 10·B-entry table
(``[0, 2B)`` vertex → local cluster slot, ``[2B, 4B)`` streamed degree,
``[4B, 10B)`` cluster volumes), the exact per-edge transition runs on it,
and the block's deltas scatter back to the global ``clu``/``deg``/``vol``
tables.

The vertex half of the localization (sort, first occurrence, local
slots) depends on the stream only, so it runs for all blocks in one
batched pass (``localize_stream``); the cluster half reads the carried
``clu``, so it runs per block inside the K1 pass
(``kernels.cluster_scatter.cluster_pass``): one launch walks the whole
stream on the card.  Results are bit-identical to the reference:
``clu``, ``deg``, ``divided``, ``replicas`` and ``next_id``, overflowed
``id_cap`` runs included.

Dropped indices: the reference scatters with ``mode="drop"`` onto the
sentinel ``num_vertices``; here ``clu``/``deg`` carry one extra slot at
``num_vertices`` that absorbs those writes and is sliced off.

``streaming_clustering_np`` is the reference's host oracle, a numpy copy
of it (the ``np`` backend's cluster stage).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.cluster_scatter import (PASS_BLOCK, cluster_pass,
                                       cluster_pass_plain)


@dataclass
class ClusteringResult:
    clu: np.ndarray            # vertex -> compact cluster id, int32[V]
    deg: np.ndarray            # streamed degree, int32[V]
    divided: np.ndarray        # bool[V], vertex was split at least once
    replicas: np.ndarray       # int32[V], #mirrors created during clustering
    num_clusters: int

    def cluster_rf(self, num_vertices: int) -> float:
        """Replication factor at cluster granularity (Fig. 2 accounting)."""
        active = self.deg > 0
        return float((active.sum() + self.replicas[active].sum())
                     / max(1, active.sum()))


def default_vmax(num_edges: int, k: int) -> float:
    """Paper §VI-A: V_max = |E| / k."""
    return max(2.0, num_edges / float(k))


def _compact_labels(raw: np.ndarray) -> tuple[np.ndarray, int]:
    used, inv = np.unique(raw[raw >= 0], return_inverse=True)
    out = np.full(raw.shape[0], -1, dtype=np.int32)
    out[raw >= 0] = inv.astype(np.int32)
    return out, int(used.shape[0])


def streaming_clustering_np(src: np.ndarray, dst: np.ndarray,
                            num_vertices: int, vmax: float,
                            allow_split: bool = True,
                            split_degree_factor: float = 0.0
                            ) -> ClusteringResult:
    """Alg. 2 on the host, edge by edge (the reference's oracle, bit for
    bit).  ``split_degree_factor`` (beyond the paper): a split of vertex x
    fires only if deg(x) ≥ factor × the mean streamed degree; 0 is Alg. 2
    verbatim.  The id space holds the worst case V + 2E + 2."""
    V = num_vertices
    clu = np.full(V, -1, dtype=np.int64)
    deg = np.zeros(V, dtype=np.int64)
    divided = np.zeros(V, dtype=bool)
    replicas = np.zeros(V, dtype=np.int64)
    vol = np.zeros(V + 2 * src.shape[0] + 2, dtype=np.int64)
    next_id = 0
    seen_deg = 0
    seen_v = 0

    cl = clu  # local aliases (python-loop hot path)
    dg = deg
    vl = vol
    for i in range(src.shape[0]):
        u = int(src[i]); v = int(dst[i])
        if u == v:
            continue
        cu = cl[u]
        if cu < 0:                       # allocation (lines 3-5)
            cu = next_id; next_id += 1
            cl[u] = cu
            seen_v += 1
        cv = cl[v]
        if cv < 0:
            cv = next_id; next_id += 1
            cl[v] = cv
            seen_v += 1
        dg[u] += 1; dg[v] += 1           # line 6
        vl[cu] += 1; vl[cv] += 1         # line 7
        seen_deg += 2
        if allow_split:
            dthresh = split_degree_factor * seen_deg / seen_v
            if cu == cv:
                # same-cluster overflow: split only the higher-degree
                # endpoint (paper §IV-A divided-vertex tie rule)
                if vl[cu] >= vmax:
                    x = u if dg[u] >= dg[v] else v
                    if dg[x] >= dthresh:
                        nc = next_id; next_id += 1
                        cl[x] = nc
                        divided[x] = True
                        replicas[x] += 1
                        vl[cu] -= dg[x]
                        vl[nc] += dg[x]
            else:
                if vl[cu] >= vmax and dg[u] >= dthresh:   # split u (8-13)
                    nc = next_id; next_id += 1
                    cl[u] = nc
                    divided[u] = True
                    replicas[u] += 1
                    vl[cu] -= dg[u]
                    vl[nc] += dg[u]
                cv = cl[v]
                if vl[cv] >= vmax and dg[v] >= dthresh:   # split v (14-18)
                    nc = next_id; next_id += 1
                    cl[v] = nc
                    divided[v] = True
                    replicas[v] += 1
                    vl[cv] -= dg[v]
                    vl[nc] += dg[v]
        cu = cl[u]; cv = cl[v]           # line 19
        if cu != cv and vl[cu] < vmax and vl[cv] < vmax:   # migration 20-26
            # post-guard: a migration must not overflow the target
            if vl[cu] <= vl[cv]:
                if vl[cv] + dg[u] < vmax:
                    cl[u] = cv
                    vl[cu] -= dg[u]; vl[cv] += dg[u]
            else:
                if vl[cu] + dg[v] < vmax:
                    cl[v] = cu
                    vl[cv] -= dg[v]; vl[cu] += dg[v]

    compact, m = _compact_labels(clu)
    return ClusteringResult(compact, deg.astype(np.int32), divided,
                            replicas.astype(np.int32), m)


def localize_stream(src, dst, num_vertices: int):
    """Vertex half of every block's localization at once.  The stream is
    cut into blocks of ``PASS_BLOCK`` edges, the last one padded with dead
    (0, 0) edges; per block the local slot of each endpoint (``ints``
    (nb, B, 3) int32 = local u, local v, live) and the global vertex of
    each local slot (``uvg`` (nb, 2B) int32, pad = num_vertices)."""
    E, B = src.shape[0], PASS_BLOCK
    nb = max(1, -(-E // B))
    pad = torch.zeros(nb * B - E, dtype=torch.int32, device=src.device)
    bu = torch.cat([src.to(torch.int32), pad]).reshape(nb, B)
    bv = torch.cat([dst.to(torch.int32), pad]).reshape(nb, B)
    verts = torch.cat([bu, bv], dim=1)
    perm = torch.argsort(verts, dim=1, stable=True)
    svert = torch.gather(verts, 1, perm)
    firstv = torch.ones_like(svert, dtype=torch.bool)
    firstv[:, 1:] = svert[:, 1:] != svert[:, :-1]
    lidx = torch.cumsum(firstv.to(torch.int32), dim=1, dtype=torch.int32) - 1
    lv_of_pos = torch.zeros_like(verts).scatter_(1, perm, lidx)
    uvg = torch.full_like(verts, num_vertices).scatter_(1, lidx.long(),
                                                        svert)
    live = (bu != bv).to(torch.int32)
    ints = torch.stack([lv_of_pos[:, :B], lv_of_pos[:, B:], live], dim=2)
    return ints.contiguous(), uvg


def streaming_clustering(src, dst, num_vertices: int, vmax: float,
                         allow_split: bool = True,
                         split_degree_factor: float = 0.0,
                         id_cap: int | None = None, kernel: str = "cuda"):
    """Blocked clustering over int32 ``src``/``dst`` tensors on one
    device; returns raw (non-compacted) labels and state tensors (clu,
    deg, divided, replicas, next_id) like ``streaming_clustering_jax``.

    ``id_cap`` bounds the cluster-id space (default the worst case
    V + 2E + 2); an overflowed run clips fresh ids into the scrap slot
    and shows it through ``next_id``.  ``kernel``: ``"cuda"`` = the K1
    pass wrapper (one launch for the whole stream on a CUDA device),
    ``"torch"`` = its plain version."""
    E = src.shape[0]
    V = int(num_vertices)
    cap = int(id_cap) if id_cap is not None else V + 2 * E + 2
    i32 = dict(dtype=torch.int32, device=src.device)
    ints, uvg = localize_stream(src, dst, V)
    clu = torch.full((V + 1,), -1, **i32)
    deg = torch.zeros(V + 1, **i32)
    vol = torch.zeros(cap, **i32)
    scal = torch.zeros(4, **i32)              # nid, nid0, seen_v, seen_deg
    run = cluster_pass if kernel == "cuda" else cluster_pass_plain
    fires = run(ints, uvg, clu, deg, vol, scal, vmax,
                allow_split=allow_split,
                split_degree_factor=split_degree_factor)[:E]
    fire_u = (fires & 1).to(torch.int32)
    fire_v = ((fires & 2) >> 1).to(torch.int32)
    replicas = torch.zeros(V, **i32)
    replicas.index_add_(0, src.long(), fire_u)
    replicas.index_add_(0, dst.long(), fire_v)
    return clu[:V], deg[:V], replicas > 0, replicas, scal[0]


def compact_labels(clu, cap: int):
    """Raw cluster ids (< cap) → dense 0..m-1 ids in ascending raw-id
    order (``np.unique`` order, as ``compact_labels_jax``).  Returns
    (compact int32 with -1 preserved, m as a 0-dim tensor); ids ≥ cap of
    an overflowed run are dropped from ``used`` like ``mode="drop"``."""
    valid = clu >= 0
    idx = torch.where(valid & (clu < cap), clu, cap).long()
    used = torch.zeros(cap + 1, dtype=torch.bool, device=clu.device)
    used[idx] = True
    used = used[:cap]
    ranks = torch.cumsum(used.to(torch.int32), 0, dtype=torch.int32) - 1
    compact = torch.where(valid, ranks[clu.clamp(0, cap - 1).long()], -1)
    return compact.to(torch.int32), used.sum()
