"""The CLUGP pipeline as a stage protocol — one body, device stages.

Port of ``repro.core.stages``: ``run_clugp_body`` is the only place the
cluster → contract → game → transform (→ restream) sequence exists.
``TORCH_STAGES`` is the counterpart of the reference's ``JAX_STAGES``
(every stage works on tensors on ``ctx.device``) and ``HOST_STAGES``
the numpy copy of its host oracle, which the ``np`` backend runs.
``StageCtx`` carries what distinguishes a run: the device, the resolved
kernels, the static id/m caps of the partitioner's retry loop and a
k-sweep step's transform cap; the sharded partitioner adds its stream
slice's live-edge ``mask`` (pad lanes are masked self-loops), the slice's
cap ``lmax`` and the mesh ``axis`` its reductions go over: the game's
loads, moves and cut, the cap check and the restream prior's count table
(``dist.collectives``; each the identity when ``axis`` is None).

The body records each stage's wall time (``PipelineOut.seconds``),
synchronizing the card between stages so every time covers its own
stage's device work.

The serving entry points (``stream_state``, ``incremental_assign``,
``restream_assign``) assign new edges against a resident partition and
repair it by restreaming; they match the reference's host oracle
(``HOST_STAGES``) bit for bit, with T's cap compared as the host
compares it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..dist import collectives as coll
from . import metrics
from .clustering import (compact_labels, streaming_clustering,
                         streaming_clustering_np)
from .game import (PAIR_KEY_LIMIT, ClusterGraph, best_response_rounds,
                   cluster_pairs, contract, game_rounds, game_rounds_gs,
                   greedy_assign, greedy_assign_np, lambda_from_weight,
                   lambda_max)
from .transform import (majority_vertex_map, majority_vertex_map_np,
                        partition_counts, transform, transform_np)


def resolve_device(device=None) -> torch.device:
    """The port runs on the card unless the caller names another device;
    with no card and no explicit device it raises instead of quietly
    running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' to "
                           "run the plain versions on the CPU")
    return torch.device("cuda")


@dataclass(frozen=True)
class StageCtx:
    """Per-run stage context."""
    num_vertices: int
    vmax: float
    device: torch.device
    game_mode: str = "cuda"      # resolved: "cuda" (K2) | "torch" | "scan" (G)
    cluster_mode: str = "cuda"   # resolved: "cuda" (K1) | "torch"
    id_cap: int = 0              # cluster-id space of the clustering scan
    m_cap: int = 0               # compacted-cluster cap of the game tables
    assign0: Any = None          # injected game start assignment (tests)
    draw: Callable | None = None  # injected damping draw (tests)
    lmax: float | None = None    # a k-sweep step's / a slice's f32 cap
    mask: Any = None             # live-edge mask; None = every lane real
    axis: Any = None             # bound mesh of the sharded run; None = local


@dataclass(frozen=True)
class StageSet:
    """One implementation of every stage; ``vertex_part`` joins passes 1
    and 2, ``prior`` is the restream majority map; ``trace`` (host only)
    samples RF before each restream pass."""
    cluster: Callable
    contract: Callable
    game: Callable
    vertex_part: Callable
    transform: Callable
    prior: Callable
    trace: Callable | None = None


class TorchCluster(NamedTuple):
    compact: Any               # int32[V] dense labels, -1 = never streamed
    deg: Any                   # int32[V] streamed degree
    divided: Any               # bool[V] split at least once
    replicas: Any              # int32[V] mirrors created while clustering
    m: int                     # cluster count (≤ m_cap)


class TorchGraph(NamedTuple):
    sizes: Any                 # (m_cap,) f32 game sizes (intra [+ boundary])
    row_tot: Any               # (m_cap,) f32 boundary row totals
    xs: Any                    # cross-edge cluster endpoints (pad: m_cap)
    xd: Any
    n_cross: Any               # 0-dim f32 cross-edge count (λ_max)


class HostGraph(NamedTuple):
    cg: ClusterGraph           # the contraction (result object)
    game_cg: ClusterGraph      # what the game balances (effective sizes)


class PipelineOut(NamedTuple):
    assign: Any
    cluster: Any               # TorchCluster / host ClusteringResult
    cluster_assign: Any
    rounds: int
    seconds: dict              # wall time per stage
    graph: Any = None          # TorchGraph / HostGraph
    trace: tuple = ()          # pre-pass RF per restream (host runs only)


class CapOverflow(Exception):
    """The clustering pass overflowed ``id_cap`` or ``m_cap``: the
    partitioner grows the caps and runs again (the reference detects the
    same after the whole body; stopping here skips a wasted game).  On a
    mesh the check reduces (next_id, m) by a max over the ranks first, so
    every rank raises at the same point with the same values and they
    retry together."""

    def __init__(self, next_id: int, m: int):
        super().__init__(f"cap overflow: next_id={next_id}, m={m}")
        self.next_id = next_id
        self.m = m


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_clugp_body(src, dst, ctx: StageCtx, cfg, stages: StageSet
                   ) -> PipelineOut:
    """The pipeline body; ``src``/``dst`` are int32 tensors on
    ``ctx.device``."""
    seconds = {}
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        _sync(ctx.device)
        now = time.perf_counter()
        seconds[name] = now - t
        t = now

    cstate = stages.cluster(src, dst, ctx, cfg)
    lap("cluster")
    gstate = stages.contract(src, dst, cstate, ctx, cfg)
    lap("contract")
    cluster_assign, rounds = stages.game(gstate, ctx, cfg)
    lap("game")
    vp = stages.vertex_part(cluster_assign, cstate, ctx)
    assign = stages.transform(src, dst, vp, cstate, ctx, cfg)
    lap("transform")
    assign, trace = restream_loop(src, dst, assign, [(None, cstate, ctx)],
                                  ctx, cfg, stages)
    lap("restream")
    return PipelineOut(assign, cstate, cluster_assign, rounds, seconds,
                       gstate, trace)


def restream_loop(src, dst, assign, parts, ctx: StageCtx, cfg,
                  stages: StageSet) -> tuple:
    """``cfg.restream`` prioritized passes: the previous pass's realized
    majority becomes the prior and the transform re-runs.  ``parts`` is
    ``[(sl, cstate, ctx_slice), …]``: one entry over the whole stream
    (``sl=None``) or one per contiguous slice of the host combine (``sl``
    a ``slice``: the prior spans every slice, each transform sees its
    own).  Returns (assign, the RF before each pass when
    ``stages.trace`` samples it)."""
    trace = []
    for _ in range(int(cfg.restream)):
        if stages.trace is not None:
            trace.append(stages.trace(src, dst, assign, ctx, cfg))
        vp = stages.prior(src, dst, assign, ctx, cfg)
        if len(parts) == 1 and parts[0][0] is None:
            _, cstate, pctx = parts[0]
            assign = stages.transform(src, dst, vp, cstate, pctx, cfg)
        else:
            assign = np.concatenate([
                stages.transform(src[sl], dst[sl], vp, cstate, pctx, cfg)
                for sl, cstate, pctx in parts])
    return assign, tuple(trace)


def resolve_mode(kernel: str) -> str:
    """The clustering and transform kernels: ``auto`` → ``cuda``, the
    kernels on every device (on CPU tensors their wrappers run the plain
    versions)."""
    return "cuda" if kernel == "auto" else kernel


def resolve_game_mode(kernel: str, m_cap: int) -> str:
    """The game: ``auto`` → ``cuda``, the Jacobi game on the CSR K2 — the
    port's card is the counterpart of the reference's TPU, where ``auto``
    means the batched game.  ``scan`` is the Gauss–Seidel game on G, which
    falls back to the Jacobi CSR game where ``m_cap·(m_cap+1)`` overflows
    the reference's int32 pair keys (m_cap > 46,340), as
    ``repro.core.stages.resolve_game_mode`` falls back to ``xla``.
    ``CLUGPConfig`` has already rejected any other value."""
    mode = resolve_mode(kernel)
    if mode == "scan" and m_cap * (m_cap + 1) >= PAIR_KEY_LIMIT:
        return "cuda"
    return mode


def cluster_graph_arrays(src, dst, compact, m_cap: int, effective: bool,
                         mask=None):
    """Contract the streamed graph against compacted labels: per-cluster
    intra sizes, boundary row totals and the cross-edge cluster endpoints
    (padded with the drop sentinel ``m_cap``).  Self-loop edges of
    clustered vertices count toward their cluster's intra size; ``mask``
    drops a sharded slice's pad lanes (fake self-loops)."""
    cs, cd = compact[src.long()], compact[dst.long()]
    ok = (cs >= 0) & (cd >= 0)
    if mask is not None:
        ok = ok & mask
    intra = ok & (cs == cd)
    cross = ok & (cs != cd)
    sent = m_cap

    def counts(*idx):
        out = torch.zeros(m_cap + 1, dtype=torch.float32, device=cs.device)
        for i in idx:
            i = torch.where(i < m_cap, i, sent).long()
            out.index_add_(0, i, torch.ones(i.shape[0], dtype=torch.float32,
                                            device=cs.device))
        return out[:m_cap]

    sizes = counts(torch.where(intra, cs, sent))
    xs = torch.where(cross, cs, sent)
    xd = torch.where(cross, cd, sent)
    row_tot = counts(xs, xd)
    game_sizes = sizes + row_tot if effective else sizes
    n_cross = cross.sum().to(torch.float32)
    return TorchGraph(game_sizes, row_tot, xs, xd, n_cross)


def lambda_from_totals(total, n_cross, k: int, relative_weight):
    """λ_max (Thm 5) / relative-weight λ from the cluster-graph totals
    (Σ game sizes, #cross edges), in f32 like ``lambda_jax``."""
    kf = torch.full_like(total, float(k))
    lam_max = torch.where(total > 0,
                          (kf * kf) * n_cross
                          / torch.clamp(total * total, min=1.0),
                          torch.ones_like(total))
    if relative_weight is None:
        return lam_max
    w = min(max(relative_weight, 1e-3), 1 - 1e-3)
    lam = lam_max * (w / (1 - w))
    return torch.where((total > 0) & (n_cross > 0), lam,
                       torch.ones_like(total))


def _cluster(src, dst, ctx, cfg):
    clu_raw, deg, divided, replicas, next_id = streaming_clustering(
        src, dst, ctx.num_vertices, ctx.vmax, allow_split=cfg.split,
        split_degree_factor=cfg.split_degree_factor, id_cap=ctx.id_cap,
        kernel=ctx.cluster_mode)
    compact, m = compact_labels(clu_raw, ctx.id_cap)
    seen = torch.stack([next_id.long(), m.long()])
    # the caps are every rank's: each decides on the largest slice
    grown = coll.pmax(seen, ctx.axis, site="partition.caps")
    (next_id, m), (top_id, top_m) = torch.stack([seen, grown]).tolist()
    if top_id > ctx.id_cap - 2 or top_m > ctx.m_cap:
        raise CapOverflow(top_id, top_m)
    return TorchCluster(compact, deg, divided, replicas, m)


def _contract(src, dst, cstate, ctx, cfg):
    return cluster_graph_arrays(src, dst, cstate.compact, ctx.m_cap,
                                cfg.effective_sizes, mask=ctx.mask)


def _game(gstate, ctx, cfg):
    if not cfg.game:
        return greedy_assign(gstate.sizes, cfg.k), 0
    # λ from the local cluster graph on a mesh too (Thm 5's range is a
    # per-id-space quantity); the loads the game plays against are global
    lam = lambda_from_totals(gstate.sizes.sum(), gstate.n_cross, cfg.k,
                             cfg.relative_weight)
    if ctx.game_mode == "scan":
        row, col, w = cluster_pairs(gstate.xs, gstate.xd, ctx.m_cap)
        return game_rounds_gs(row, col, w, gstate.sizes, gstate.row_tot,
                              cfg.k, lam, max_rounds=cfg.max_rounds,
                              seed=cfg.seed, assign0=ctx.assign0,
                              axis=ctx.axis)
    return game_rounds(gstate.xs, gstate.xd, gstate.sizes, gstate.row_tot,
                       cfg.k, lam, batch_size=cfg.batch_size,
                       max_rounds=cfg.max_rounds, seed=cfg.seed,
                       mode=ctx.game_mode, assign0=ctx.assign0,
                       draw=ctx.draw, axis=ctx.axis)


def _vertex_part(cluster_assign, cstate, ctx):
    return cluster_assign[cstate.compact.clamp(0, ctx.m_cap - 1).long()]


def _transform(src, dst, vp, cstate, ctx, cfg):
    # the transform walk is the other stream scan: it follows the
    # clustering's kernel choice
    return transform(src, dst, vp, cstate.deg, cstate.divided, cfg.k,
                     cfg.tau, mask=ctx.mask, kernel=ctx.cluster_mode,
                     lmax=ctx.lmax)


def _prior(src, dst, assign, ctx, cfg):
    # on a mesh the (V, k) count table is summed over the ranks: the
    # prior spans every slice (the host combine's ``restream_loop`` twin)
    return majority_vertex_map(src, dst, assign, ctx.num_vertices, cfg.k,
                               mask=ctx.mask, axis=ctx.axis)


TORCH_STAGES = StageSet(cluster=_cluster, contract=_contract, game=_game,
                        vertex_part=_vertex_part, transform=_transform,
                        prior=_prior)


# ------------------------------------------------------------ host stages
# numpy copies of the reference's HOST_STAGES: the np backend's oracle.

def _host_cluster(src, dst, ctx, cfg):
    return streaming_clustering_np(
        src, dst, ctx.num_vertices, ctx.vmax, allow_split=cfg.split,
        split_degree_factor=cfg.split_degree_factor)


def _host_contract(src, dst, cstate, ctx, cfg):
    cg = contract(src, dst, cstate.clu)
    game_cg = cg
    if cfg.effective_sizes:
        boundary = np.asarray(cg.adj.sum(axis=1)).ravel()
        game_cg = ClusterGraph(cg.sizes + boundary, cg.adj,
                               cg.vertex_cluster, cg.m)
    return HostGraph(cg, game_cg)


def _host_game(gstate, ctx, cfg):
    if not cfg.game:
        return greedy_assign_np(gstate.game_cg, cfg.k), 0
    lam = (lambda_max(gstate.game_cg, cfg.k)
           if cfg.relative_weight is None
           else lambda_from_weight(gstate.game_cg, cfg.k,
                                   cfg.relative_weight))
    game = best_response_rounds(gstate.game_cg, cfg.k, lam=lam,
                                batch_size=cfg.batch_size,
                                max_rounds=cfg.max_rounds, seed=cfg.seed)
    return game.assign, game.rounds


def _host_vertex_part(cluster_assign, cstate, ctx):
    return cluster_assign[np.maximum(cstate.clu, 0)].astype(np.int32)


def _host_transform(src, dst, vp, cstate, ctx, cfg):
    return transform_np(src, dst, vp, cstate.deg, cstate.divided,
                        cfg.k, cfg.tau)


def _host_prior(src, dst, assign, ctx, cfg):
    return majority_vertex_map_np(src, dst, assign, ctx.num_vertices, cfg.k)


def _host_trace(src, dst, assign, ctx, cfg):
    return metrics.replication_factor(src, dst, assign, ctx.num_vertices,
                                      cfg.k)


HOST_STAGES = StageSet(cluster=_host_cluster, contract=_host_contract,
                       game=_host_game, vertex_part=_host_vertex_part,
                       transform=_host_transform, prior=_host_prior,
                       trace=_host_trace)


# ---------------------------------------------------------------- serving
# A resident partition takes live edges in windows (``incremental_assign``:
# one Alg. 1 pass over the window against the loads it already carries)
# and is repaired by restreaming when its RF drifts (``restream_assign``).
# Both read one (V, k) count table of the resident assignment on the
# device: the prior is its row argmax, the transform state its row sums
# and row supports, the RF its support over V.

class StreamState(NamedTuple):
    """The transform's per-vertex state, derived from a resident
    assignment instead of a clustering pass."""
    deg: Any                   # (V,) int32 streamed endpoint degree
    divided: Any               # (V,) bool: on two partitions or more


def _on(x, device, dtype=torch.int32):
    """A host array or a tensor as ``dtype`` on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x).astype(
            np.bool_ if dtype == torch.bool else np.int32))
    return x.to(device=device, dtype=dtype)


def _state(cnt) -> StreamState:
    return StreamState(cnt.sum(dim=1).to(torch.int32),
                       (cnt > 0).sum(dim=1) > 1)


def _rf(cnt) -> float:
    """Σ_p |vertices in p| / V: the metric's exact integer count, divided
    as ``metrics.replication_factor`` divides it."""
    return int((cnt > 0).sum()) / float(cnt.shape[0])


def stream_state(src, dst, assign, num_vertices: int, k: int, *,
                 device=None) -> StreamState:
    """``deg`` and ``divided`` of every vertex under an existing edge →
    partition assignment, as tensors on ``device``."""
    dev = resolve_device(device)
    return _state(partition_counts(_on(src, dev), _on(dst, dev),
                                   _on(assign, dev), num_vertices, k))


def incremental_assign(src, dst, new_src, new_dst, assign,
                       num_vertices: int, cfg, *,
                       device=None) -> np.ndarray:
    """Assign a new edge window against the resident partition: one Alg. 1
    pass over the window on T, primed with the majority vertex map of the
    current assignment (ties → the lowest partition) and seeded with the
    current per-partition loads, under the cap τ·(E_old + E_new)/k of the
    grown stream.  Returns the window's (E_new,) int32 assignment; the
    resident one is untouched.  Vertices the resident stream never saw
    have degree 0, are not divided and take prior 0."""
    dev = resolve_device(device)
    s, d, a = _on(src, dev), _on(dst, dev), _on(assign, dev)
    cnt = partition_counts(s, d, a, num_vertices, cfg.k)
    prior, state = torch.argmax(cnt, dim=1), _state(cnt)
    del cnt
    ws, wd = _on(new_src, dev), _on(new_dst, dev)
    loads = torch.bincount(a.long(), minlength=cfg.k)
    lmax = cfg.tau * (s.shape[0] + ws.shape[0]) / float(cfg.k)
    out = transform(ws, wd, prior, state.deg, state.divided, cfg.k,
                    cfg.tau, loads=loads, lmax=lmax)
    return out.cpu().numpy()


def restream_assign(src, dst, assign, num_vertices: int, cfg, *,
                    passes: int = 1, device=None) -> tuple:
    """Prioritized restream of the whole stream seeded by the current
    assignment: ``passes`` Alg. 1 passes on T, each primed with the
    previous pass's majority and using the degrees and divided flags of
    the input assignment, under the cap τ·E/k compared as the host
    oracle compares it.  Monotone: returns ``(best_assign, rf_trace)``,
    the best-RF assignment seen (the input included) and the RF before
    each pass (entry 0 is the input's)."""
    dev = resolve_device(device)
    s, d, cur = _on(src, dev), _on(dst, dev), _on(assign, dev)
    cnt = partition_counts(s, d, cur, num_vertices, cfg.k)
    st = _state(cnt)
    lmax = cfg.tau * s.shape[0] / float(cfg.k)
    best, best_rf = cur, _rf(cnt)
    r, trace = best_rf, []
    for _ in range(int(passes)):
        trace.append(r)
        cur = transform(s, d, torch.argmax(cnt, dim=1), st.deg, st.divided,
                        cfg.k, cfg.tau, lmax=lmax)
        cnt = partition_counts(s, d, cur, num_vertices, cfg.k)
        r = _rf(cnt)
        if r < best_rf:
            best, best_rf = cur, r
    return best.cpu().numpy(), tuple(trace)
