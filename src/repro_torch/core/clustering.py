"""Pass 1 — streaming clustering (paper Alg. 2), blocked, on the device.

Port of ``repro.core.clustering.streaming_clustering_jax``.  The stream
is cut into blocks of B edges; per block the ≤ 2B touched vertices and
their ≤ 2B current clusters are localized into one fused 10·B-entry table
(``[0, 2B)`` vertex → local cluster slot, ``[2B, 4B)`` streamed degree,
``[4B, 10B)`` cluster volumes), K1 (``kernels.cluster_scatter``) runs the
exact per-edge transition on it, and the block's deltas scatter back to
the global ``clu``/``deg``/``vol`` tables.

The vertex half of the localization (sort, first occurrence, local
slots) depends on the stream only, so it runs for all blocks in one
batched pass; the cluster half reads the carried ``clu`` and runs per
block.  Results are bit-identical to the reference: ``clu``, ``deg``,
``divided``, ``replicas`` and ``next_id``, overflowed ``id_cap`` runs
included.

Dropped indices: the reference scatters with ``mode="drop"`` onto the
sentinel ``num_vertices``; here ``clu``/``deg`` carry one extra slot at
``num_vertices`` that absorbs those writes and is sliced off.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.cluster_scatter import cluster_scatter, cluster_scatter_plain

_BIG_ID = 2 ** 31 - 1
BLOCK = 128          # edges per K1 launch


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


def _localize(bu, bv, num_vertices: int):
    """Vertex half of every block's localization at once: per block the
    local slot of each endpoint (``ints`` (nb, B, 3) = local u, local v,
    live) and the global vertex of each local slot (``uvg`` (nb, 2B), pad
    = num_vertices)."""
    nb, B = bu.shape
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
                         id_cap: int | None = None, kernel: str = "cuda",
                         on_block=None):
    """Blocked clustering over int32 ``src``/``dst`` tensors on one
    device; returns raw (non-compacted) labels and state tensors (clu,
    deg, divided, replicas, next_id) like ``streaming_clustering_jax``.

    ``id_cap`` bounds the cluster-id space (default the worst case
    V + 2E + 2); an overflowed run clips fresh ids into the scrap slot
    and shows it through ``next_id``.  ``kernel``: ``"cuda"`` = the K1
    wrapper, ``"torch"`` = its plain version.  ``on_block(b, ints, buf,
    scal)``, if given, sees each block's K1 inputs before the launch."""
    device = src.device
    E = src.shape[0]
    V = int(num_vertices)
    cap = int(id_cap) if id_cap is not None else V + 2 * E + 2
    B = BLOCK
    scrap = cap - 1
    nb = max(1, -(-E // B))
    pad = nb * B - E
    i32 = dict(dtype=torch.int32, device=device)

    def blocks(a):
        return torch.cat([a.to(torch.int32), torch.zeros(pad, **i32)]
                         ).reshape(nb, B)

    ints, uvg = _localize(blocks(src), blocks(dst), V)
    uv_read = uvg.clamp(0, V - 1)             # gathers of real vertices
    uv_real = uvg < V
    uv_write = uvg.long()                     # pad slot V absorbs writes

    clu = torch.full((V + 1,), -1, **i32)
    deg = torch.zeros(V + 1, **i32)
    vol = torch.zeros(cap, **i32)
    scal = torch.zeros(4, **i32)              # nid, nid0, seen_v, seen_deg
    zeros4 = torch.zeros(4 * B, **i32)
    fresh = torch.arange(4 * B, **i32)
    start_of_block = torch.tensor([0, 0, 2, 3], device=device)
    step = cluster_scatter if kernel == "cuda" else cluster_scatter_plain
    fires = []
    # the per-block work is ~30 small operations issued from the host;
    # index_select / index_copy_ keep each one off PyTorch's slower
    # advanced-indexing path
    for b in range(nb):
        rd = uv_read[b]
        cids = clu.index_select(0, rd)
        validc = uv_real[b] & (cids >= 0)
        keyc = torch.where(validc, cids, _BIG_ID)
        ucl = torch.sort(keyc).values
        lc = torch.where(validc, torch.searchsorted(ucl, keyc,
                                                    out_int32=True), -1)
        lvol0 = torch.where(ucl < _BIG_ID,
                            vol.index_select(0, ucl.clamp(0, scrap)), 0)
        buf = torch.cat([lc, deg.index_select(0, rd), lvol0, zeros4])
        scal0 = scal.index_select(0, start_of_block)     # nid0 := nid
        if on_block is not None:
            on_block(b, ints[b], buf, scal0)
        out, scal, packed = step(ints[b], buf, scal0, vmax,
                                 allow_split=allow_split,
                                 split_degree_factor=split_degree_factor)
        fires.append(packed)
        lclu, ldeg, lvol = out[:2 * B], out[2 * B:4 * B], out[4 * B:]
        glob_of = torch.cat([ucl, scal[1] + fresh])
        newclu = torch.where(
            lclu >= 0, glob_of.index_select(0, lclu.clamp(0, 6 * B - 1)), -1)
        wr = uv_write[b]
        clu.index_copy_(0, wr, newclu)
        deg.index_copy_(0, wr, ldeg)
        dvol = lvol - torch.cat([lvol0, zeros4])
        keep = torch.cat([ucl < _BIG_ID, dvol[2 * B:] != 0])
        ids = torch.where(keep, glob_of.clamp(0, scrap), scrap)
        vol.index_add_(0, ids, dvol)
    fires = torch.cat(fires)[:E]
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
