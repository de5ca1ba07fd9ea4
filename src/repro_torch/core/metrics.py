"""Partition-quality metrics (paper §II-B) — a numpy copy of
``repro.core.metrics`` (the port imports nothing of the JAX package).

- replication factor  RF = (1/|V|) Σ_v |P(v)|   (Eq. 1 objective)
- relative load balance  k · max|p_i| / |E|     (Eq. 1 constraint)
"""
from __future__ import annotations

import numpy as np


def replication_factor(src: np.ndarray, dst: np.ndarray,
                       assign: np.ndarray, num_vertices: int,
                       k: int) -> float:
    """Σ_p |distinct vertices in p| / |V| — memory-light (no V×k table)."""
    total = 0
    order = np.argsort(assign, kind="stable")
    s, d, a = src[order], dst[order], assign[order]
    bounds = np.searchsorted(a, np.arange(k + 1))
    for p in range(k):
        lo, hi = bounds[p], bounds[p + 1]
        if hi > lo:
            total += np.unique(np.concatenate([s[lo:hi], d[lo:hi]])).shape[0]
    return total / float(num_vertices)


def vertex_partition_counts(src: np.ndarray, dst: np.ndarray,
                            assign: np.ndarray, num_vertices: int,
                            k: int) -> np.ndarray:
    """|P(v)| per vertex (used by the graph engine's mirror tables)."""
    counts = np.zeros(num_vertices, dtype=np.int32)
    order = np.argsort(assign, kind="stable")
    s, d, a = src[order], dst[order], assign[order]
    bounds = np.searchsorted(a, np.arange(k + 1))
    for p in range(k):
        lo, hi = bounds[p], bounds[p + 1]
        if hi > lo:
            verts = np.unique(np.concatenate([s[lo:hi], d[lo:hi]]))
            counts[verts] += 1
    return counts


def load_balance(assign: np.ndarray, k: int) -> float:
    sizes = np.bincount(assign, minlength=k)
    return float(k * sizes.max() / max(1, assign.shape[0]))


def partition_sizes(assign: np.ndarray, k: int) -> np.ndarray:
    return np.bincount(assign, minlength=k).astype(np.int64)


def cut_edges(src_part: np.ndarray, dst_part: np.ndarray) -> int:
    """Edges whose endpoint *vertices* live in different partitions
    (cluster/partition-level cut used by the game objective)."""
    return int(np.sum(src_part != dst_part))


def summarize(src: np.ndarray, dst: np.ndarray, assign: np.ndarray,
              num_vertices: int, k: int) -> dict:
    return {
        "rf": replication_factor(src, dst, assign, num_vertices, k),
        "balance": load_balance(assign, k),
        "sizes": partition_sizes(assign, k).tolist(),
    }
