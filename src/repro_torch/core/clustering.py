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


def default_vmax(num_edges: int, k: int) -> float:
    """Paper §VI-A: V_max = |E| / k."""
    return max(2.0, num_edges / float(k))


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
