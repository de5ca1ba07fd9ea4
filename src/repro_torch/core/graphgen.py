"""Synthetic power-law graph generators + BFS stream ordering.

A numpy copy of ``repro.core.graphgen``: the port imports nothing of the
JAX package, and the same seed must give the same edges bit for bit
(``tests/test_torch_core.py`` holds the two against each other).

The paper evaluates on real web crawls (uk-2002, arabic-2005, webbase-2001,
it-2004) streamed in BFS order, and one social graph (Twitter).  Offline we
generate graphs in the same degree-law regime:

- ``rmat``       : Kronecker/R-MAT recursive generator — web-graph-like,
                   heavy-tailed in/out degrees (Chakrabarti et al., SDM'04).
- ``barabasi``   : preferential attachment — social-graph-like.
- ``bfs_order``  : relabels vertices by BFS discovery and orders the edge
                   stream the way a crawler would emit it (paper §II fn. 1).
"""
from __future__ import annotations

import numpy as np
from collections import deque
from dataclasses import dataclass


@dataclass(frozen=True)
class Graph:
    """An edge-streamed directed graph.  src/dst are int32 arrays."""
    src: np.ndarray
    dst: np.ndarray
    num_vertices: int

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def degrees(self) -> np.ndarray:
        deg = np.zeros(self.num_vertices, dtype=np.int64)
        np.add.at(deg, self.src, 1)
        np.add.at(deg, self.dst, 1)
        return deg


def _dedupe(src: np.ndarray, dst: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    keep = src != dst                      # drop self loops
    src, dst = src[keep], dst[keep]
    key = src.astype(np.int64) * (int(max(dst.max(), src.max())) + 1) + dst
    _, idx = np.unique(key, return_index=True)
    idx.sort()                             # preserve stream order of first occurrence
    return src[idx], dst[idx]


def _compact(src: np.ndarray, dst: np.ndarray) -> Graph:
    """Relabel vertices to a dense 0..V-1 range (drop isolated ids)."""
    verts, inv = np.unique(np.concatenate([src, dst]), return_inverse=True)
    n = verts.shape[0]
    return Graph(inv[: src.shape[0]].astype(np.int32),
                 inv[src.shape[0]:].astype(np.int32), int(n))


def rmat(scale: int, edge_factor: int = 8, seed: int = 0,
         a: float = 0.57, b: float = 0.19, c: float = 0.19) -> Graph:
    """R-MAT generator; scale = log2(#vertices)."""
    rng = np.random.default_rng(seed)
    n_edges = edge_factor * (1 << scale)
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    for level in range(scale):
        r = rng.random(n_edges)
        src_bit = (r >= a + b).astype(np.int64)
        # conditional distribution of dst bit given src bit
        p_dst1_given_src0 = b / (a + b)
        p_dst1_given_src1 = (1.0 - a - b - c) / max(1.0 - a - b, 1e-12)
        r2 = rng.random(n_edges)
        dst_bit = np.where(src_bit == 0, (r2 < p_dst1_given_src0),
                           (r2 < p_dst1_given_src1)).astype(np.int64)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    src, dst = _dedupe(src, dst)
    return _compact(src, dst)


def barabasi(n: int, m: int = 4, seed: int = 0) -> Graph:
    """Barabási–Albert preferential attachment (directed new→old)."""
    rng = np.random.default_rng(seed)
    targets = list(range(m))
    repeated: list[int] = list(range(m))
    src_l: list[int] = []
    dst_l: list[int] = []
    for v in range(m, n):
        chosen = set()
        while len(chosen) < m:
            chosen.add(int(repeated[rng.integers(len(repeated))])
                       if repeated else int(rng.integers(v)))
        for t in chosen:
            src_l.append(v)
            dst_l.append(t)
            repeated.extend([v, t])
    src, dst = _dedupe(np.asarray(src_l, dtype=np.int64),
                       np.asarray(dst_l, dtype=np.int64))
    return _compact(src, dst)


def bfs_order(g: Graph) -> Graph:
    """Relabel by BFS discovery order and emit the edge stream crawler-style:
    all out-edges of a vertex appear when the vertex is dequeued (Fig. 2)."""
    n, e = g.num_vertices, g.num_edges
    # undirected adjacency in CSR form
    u = np.concatenate([g.src, g.dst])
    v = np.concatenate([g.dst, g.src])
    order = np.argsort(u, kind="stable")
    u, v = u[order], v[order]
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, u + 1, 1)
    np.cumsum(indptr, out=indptr)

    deg = g.degrees()
    seen = np.zeros(n, dtype=bool)
    rank = np.full(n, -1, dtype=np.int64)
    nxt = 0
    # start from the highest-degree vertex of each component (crawl seeds)
    seeds = np.argsort(-deg)
    q: deque[int] = deque()
    for s in seeds:
        s = int(s)
        if seen[s]:
            continue
        seen[s] = True
        q.append(s)
        while q:
            x = q.popleft()
            rank[x] = nxt
            nxt += 1
            for y in v[indptr[x]:indptr[x + 1]]:
                y = int(y)
                if not seen[y]:
                    seen[y] = True
                    q.append(y)
    src = rank[g.src]
    dst = rank[g.dst]
    # stream order: lexicographic by (bfs rank of src, bfs rank of dst)
    order = np.lexsort((dst, src))
    return Graph(src[order].astype(np.int32), dst[order].astype(np.int32), n)


def community_web(n: int, avg_deg: int = 10, avg_site: int = 40,
                  beta: float = 0.08, alpha: float = 2.1,
                  seed: int = 0) -> Graph:
    """Web-crawl-like generator: power-law degrees *and* strong host-level
    locality.  Pages on the same site link densely; a fraction ``beta`` of
    links cross sites, preferentially toward hub pages.  This is the regime
    the paper's premise targets ("the property of web graph clustering"):
    real crawls (uk-2002 etc.) have >90% intra-host links.

    - site sizes ~ power law, capped
    - per-page out-degree ~ zipf(alpha)
    - cross-site targets ~ degree-preferential (power-law in-degree hubs)
    """
    rng = np.random.default_rng(seed)
    # carve [0,n) into sites with power-law sizes
    sizes = []
    total = 0
    while total < n:
        s = min(int(rng.pareto(1.6) * avg_site / 2.0) + 4, n - total, 40 * avg_site)
        sizes.append(s)
        total += s
    starts = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    site_of = np.repeat(np.arange(len(sizes)), sizes)[:n]
    site_start = starts[site_of]
    site_size = np.asarray(sizes)[site_of]

    out_deg = np.minimum(rng.zipf(alpha, size=n) + avg_deg // 2, 10 * avg_deg)
    m_total = int(out_deg.sum())
    src = np.repeat(np.arange(n, dtype=np.int64), out_deg)
    cross = rng.random(m_total) < beta
    # intra-site target: uniform within the source's site
    tgt_local = (site_start[src]
                 + rng.integers(0, np.maximum(site_size[src], 1)))
    # cross-site target: preferential to global hubs (power-law ranks)
    dst = tgt_local.astype(np.int64)
    dst[cross] = rng.zipf(1.5, size=int(cross.sum())) % n
    src, dst = _dedupe(src, dst)
    # vertex ids are already crawl-ordered (site-contiguous); keep the
    # stream in crawl order: all out-links of a page when it is fetched.
    order = np.lexsort((dst, src))
    return _compact(src[order], dst[order])


def web_graph(scale: int = 14, edge_factor: int = 8, seed: int = 0) -> Graph:
    """Web-crawl-like benchmark graph: community structure + power law,
    streamed in crawl (per-host BFS burst) order — the order UbiCrawler-
    style crawlers emit and the paper's §II fn. 1 setting."""
    n = 1 << scale
    return community_web(n, avg_deg=edge_factor, seed=seed)


def rmat_graph(scale: int = 14, edge_factor: int = 8, seed: int = 0) -> Graph:
    """R-MAT + BFS order — a *hard* case with weak community structure."""
    return bfs_order(rmat(scale, edge_factor, seed))


def social_graph(n: int = 8192, m: int = 8, seed: int = 0) -> Graph:
    """Social-network-like benchmark graph (paper's Twitter analogue)."""
    return bfs_order(barabasi(n, m, seed))


def random_stream(g: Graph, seed: int = 0) -> Graph:
    """Random edge order (best order for HDRF/Greedy/Hash/DBH per §VI-A)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(g.num_edges)
    return Graph(g.src[perm], g.dst[perm], g.num_vertices)
