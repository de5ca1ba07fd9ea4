"""Streaming vertex-cut baselines (paper Table I + §VI competitors).

- ``hashing``  : PowerGraph random edge hashing               (low / low)
- ``dbh``      : degree-based hashing, cut the high-deg end   (low / low)
- ``greedy``   : PowerGraph greedy heuristic                  (high / high)
- ``hdrf``     : High-Degree Replicated First                 (high / high)
- ``mint_like``: quasi-streaming batched game (Mint is closed-source; this
  reimplements its published recipe — edge windows assigned jointly by a
  local game on the window's contracted graph)                (med / med)

All use the *partial degree* seen so far (the streaming setting of HDRF) and
maintain per-vertex partition sets A(v) as packed uint64 bitmasks.

A numpy copy of ``repro.core.baselines`` (the port imports nothing of the
JAX package): host streaming heuristics there too, with no card version.
"""
from __future__ import annotations

import numpy as np


def _hash2(u: np.ndarray | int, v: np.ndarray | int, k: int):
    return ((np.uint64(u) * np.uint64(0x9E3779B97F4A7C15)
             ^ np.uint64(v) * np.uint64(0xC2B2AE3D27D4EB4F))
            % np.uint64(k))


def hashing(src, dst, num_vertices, k, seed=0):
    """Random edge placement (PowerGraph's default)."""
    u = src.astype(np.uint64)
    v = dst.astype(np.uint64)
    return (((u * np.uint64(0x9E3779B97F4A7C15))
             ^ (v * np.uint64(0xC2B2AE3D27D4EB4F))
             ^ np.uint64(seed)) % np.uint64(k)).astype(np.int32)


class _PartSets:
    """A(v) as packed bitmasks: (V, ceil(k/64)) uint64."""

    def __init__(self, num_vertices: int, k: int):
        self.words = (k + 63) // 64
        self.bits = np.zeros((num_vertices, self.words), dtype=np.uint64)

    def has(self, v: int, p: int) -> bool:
        return bool((self.bits[v, p >> 6] >> np.uint64(p & 63)) & np.uint64(1))

    def add(self, v: int, p: int) -> None:
        self.bits[v, p >> 6] |= np.uint64(1) << np.uint64(p & 63)

    def mask_list(self, v: int, k: int) -> np.ndarray:
        out = np.zeros(k, dtype=bool)
        w = self.bits[v]
        for i in range(self.words):
            word = int(w[i])
            while word:
                b = word & -word
                out[i * 64 + b.bit_length() - 1] = True
                word ^= b
        return out

    def common(self, u: int, v: int) -> np.ndarray:
        return self.bits[u] & self.bits[v]

    def any(self, v: int) -> bool:
        return bool(self.bits[v].any())


def dbh(src, dst, num_vertices, k, seed=0):
    """Degree-Based Hashing (Xie et al. NeurIPS'14): hash on the lower
    partial-degree endpoint so the high-degree vertex is the one cut."""
    E = src.shape[0]
    deg = np.zeros(num_vertices, dtype=np.int64)
    assign = np.zeros(E, dtype=np.int32)
    MASK = (1 << 64) - 1
    for i in range(E):
        u = int(src[i]); v = int(dst[i])
        deg[u] += 1; deg[v] += 1
        key = u if deg[u] <= deg[v] else v
        assign[i] = ((key * 0x9E3779B97F4A7C15 ^ seed) & MASK) % k
    return assign


def greedy(src, dst, num_vertices, k, seed=0):
    """PowerGraph greedy (Gonzalez et al. OSDI'12) with partial degrees."""
    E = src.shape[0]
    sets = _PartSets(num_vertices, k)
    deg = np.zeros(num_vertices, dtype=np.int64)
    loads = np.zeros(k, dtype=np.int64)
    assign = np.zeros(E, dtype=np.int32)
    for i in range(E):
        u = int(src[i]); v = int(dst[i])
        deg[u] += 1; deg[v] += 1
        common = sets.common(u, v)
        if common.any():
            cand = _mask_to_idx(common, k)
        elif sets.any(u) and sets.any(v):
            # both replicated, disjoint: partitions of the higher-remaining-
            # degree endpoint (streaming proxy: higher partial degree)
            cand = _mask_to_idx(sets.bits[u if deg[u] >= deg[v] else v], k)
        elif sets.any(u):
            cand = _mask_to_idx(sets.bits[u], k)
        elif sets.any(v):
            cand = _mask_to_idx(sets.bits[v], k)
        else:
            cand = np.arange(k)
        p = int(cand[np.argmin(loads[cand])])
        assign[i] = p
        loads[p] += 1
        sets.add(u, p)
        sets.add(v, p)
    return assign


def _mask_to_idx(mask_words: np.ndarray, k: int) -> np.ndarray:
    out = []
    for i, w in enumerate(mask_words):
        word = int(w)
        while word:
            b = word & -word
            out.append(i * 64 + b.bit_length() - 1)
            word ^= b
    return np.asarray(out if out else range(k), dtype=np.int64)


def hdrf(src, dst, num_vertices, k, lam: float = 1.0, eps: float = 1.0,
         seed=0):
    """HDRF (Petroni et al. CIKM'15): replicate high-degree vertices first."""
    E = src.shape[0]
    sets = _PartSets(num_vertices, k)
    deg = np.zeros(num_vertices, dtype=np.int64)
    loads = np.zeros(k, dtype=np.float64)
    assign = np.zeros(E, dtype=np.int32)
    ks = np.arange(k)
    for i in range(E):
        u = int(src[i]); v = int(dst[i])
        deg[u] += 1; deg[v] += 1
        du, dv = deg[u], deg[v]
        theta_u = du / (du + dv)
        theta_v = 1.0 - theta_u
        in_u = _mask_to_bool(sets.bits[u], k)
        in_v = _mask_to_bool(sets.bits[v], k)
        g_u = np.where(in_u, 1.0 + (1.0 - theta_u), 0.0)
        g_v = np.where(in_v, 1.0 + (1.0 - theta_v), 0.0)
        maxl, minl = loads.max(), loads.min()
        c_bal = lam * (maxl - loads) / (eps + maxl - minl)
        score = g_u + g_v + c_bal
        p = int(np.argmax(score))
        assign[i] = p
        loads[p] += 1.0
        sets.add(u, p)
        sets.add(v, p)
    return assign


def _mask_to_bool(mask_words: np.ndarray, k: int) -> np.ndarray:
    out = np.zeros(k, dtype=bool)
    for i, w in enumerate(mask_words):
        word = int(w)
        while word:
            b = word & -word
            out[i * 64 + b.bit_length() - 1] = True
            word ^= b
    return out


def mint_like(src, dst, num_vertices, k, window: int = 4096, seed=0):
    """Quasi-streaming batched game in the spirit of Mint (Hua et al.
    TPDS'19): buffer a window of edges, contract it by shared endpoints into
    micro-clusters, assign each micro-cluster by one best-response round
    against the *global* loads plus a stickiness/affinity term from vertices
    already placed in earlier windows, emit, repeat."""
    E = src.shape[0]
    assign = np.zeros(E, dtype=np.int32)
    loads = np.zeros(k, dtype=np.float64)
    vertex_last = np.full(num_vertices, -1, dtype=np.int64)
    norm = k / max(1.0, float(E))       # load term in units of "edges cut"
    for lo in range(0, E, window):
        hi = min(E, lo + window)
        s, d = src[lo:hi], dst[lo:hi]
        labels = _window_components(s, d, num_vertices)
        nlab = int(labels[np.concatenate([s, d])].max()) + 1
        csize = np.bincount(labels[s], minlength=nlab).astype(np.float64)
        # affinity[c, p] = #window vertices of c already resident in p
        aff = np.zeros((nlab, k), dtype=np.float64)
        verts = np.unique(np.concatenate([s, d]))
        placed = verts[vertex_last[verts] >= 0]
        if placed.size:
            np.add.at(aff, (labels[placed], vertex_last[placed]), 1.0)
        order = np.argsort(-csize[:nlab])
        ca = np.zeros(nlab, dtype=np.int64)
        for c in order:
            cost = norm * csize[c] * loads - aff[c]
            p = int(np.argmin(cost))
            ca[c] = p
            loads[p] += csize[c]
        w_assign = ca[labels[s]].astype(np.int32)
        assign[lo:hi] = w_assign
        vertex_last[s] = w_assign
        vertex_last[d] = w_assign
    return assign


def _window_components(s: np.ndarray, d: np.ndarray,
                       num_vertices: int) -> np.ndarray:
    """Union-find over the window's vertices; labels indexed by vertex."""
    parent: dict[int, int] = {}

    def find(x: int) -> int:
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, b in zip(s.tolist(), d.tolist()):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb
    roots = {}
    labels = np.zeros(num_vertices, dtype=np.int64)
    for x in parent:
        r = find(x)
        labels[x] = roots.setdefault(r, len(roots))
    return labels


ALL_BASELINES = {
    "hashing": hashing,
    "dbh": dbh,
    "greedy": greedy,
    "hdrf": hdrf,
    "mint": mint_like,
}
