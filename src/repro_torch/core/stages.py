"""The CLUGP pipeline as a stage protocol — one body, device stages.

Port of ``repro.core.stages``: ``run_clugp_body`` is the only place the
cluster → contract → game → transform (→ restream) sequence exists, and
``TORCH_STAGES`` is the counterpart of the reference's ``JAX_STAGES``
(every stage works on tensors on ``ctx.device``).  ``StageCtx`` carries
what distinguishes a run: the device, the resolved kernels and the
static id/m caps of the partitioner's retry loop.

The body records each stage's wall time (``PipelineOut.seconds``),
synchronizing the card between stages so every time covers its own
stage's device work.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from .clustering import compact_labels, streaming_clustering
from .game import game_rounds, greedy_assign
from .transform import majority_vertex_map, transform


@dataclass(frozen=True)
class StageCtx:
    """Per-run stage context."""
    num_vertices: int
    vmax: float
    device: torch.device
    game_mode: str = "cuda"      # resolved: "cuda" (K2) | "torch"
    cluster_mode: str = "cuda"   # resolved: "cuda" (K1) | "torch"
    id_cap: int = 0              # cluster-id space of the clustering scan
    m_cap: int = 0               # compacted-cluster cap of the game tables
    assign0: Any = None          # injected game start assignment (tests)
    draw: Callable | None = None  # injected damping draw (tests)


@dataclass(frozen=True)
class StageSet:
    """One implementation of every stage; ``vertex_part`` joins passes 1
    and 2, ``prior`` is the restream majority map."""
    cluster: Callable
    contract: Callable
    game: Callable
    vertex_part: Callable
    transform: Callable
    prior: Callable


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


class PipelineOut(NamedTuple):
    assign: Any
    cluster: TorchCluster
    cluster_assign: Any
    rounds: int
    seconds: dict              # wall time per stage


class CapOverflow(Exception):
    """The clustering pass overflowed ``id_cap`` or ``m_cap``: the
    partitioner grows the caps and runs again (the reference detects the
    same after the whole body; stopping here skips a wasted game)."""

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
    assign = restream_loop(src, dst, assign, cstate, ctx, cfg, stages)
    lap("restream")
    return PipelineOut(assign, cstate, cluster_assign, rounds, seconds)


def restream_loop(src, dst, assign, cstate, ctx: StageCtx, cfg,
                  stages: StageSet):
    """``cfg.restream`` prioritized passes: the previous pass's realized
    majority becomes the prior and the transform re-runs."""
    for _ in range(int(cfg.restream)):
        vp = stages.prior(src, dst, assign, ctx, cfg)
        assign = stages.transform(src, dst, vp, cstate, ctx, cfg)
    return assign


def resolve_mode(kernel: str) -> str:
    """``auto`` → ``cuda``: the kernels on every device (on CPU tensors
    their wrappers run the plain versions).  ``CLUGPConfig`` has already
    rejected any value other than ``auto``/``cuda``/``torch``."""
    return "cuda" if kernel == "auto" else kernel


def cluster_graph_arrays(src, dst, compact, m_cap: int, effective: bool):
    """Contract the streamed graph against compacted labels: per-cluster
    intra sizes, boundary row totals and the cross-edge cluster endpoints
    (padded with the drop sentinel ``m_cap``).  Self-loop edges of
    clustered vertices count toward their cluster's intra size."""
    cs, cd = compact[src.long()], compact[dst.long()]
    ok = (cs >= 0) & (cd >= 0)
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
    next_id, m = (int(x) for x in torch.stack([next_id.long(),
                                               m.long()]).tolist())
    if next_id > ctx.id_cap - 2 or m > ctx.m_cap:
        raise CapOverflow(next_id, m)
    return TorchCluster(compact, deg, divided, replicas, m)


def _contract(src, dst, cstate, ctx, cfg):
    return cluster_graph_arrays(src, dst, cstate.compact, ctx.m_cap,
                                cfg.effective_sizes)


def _game(gstate, ctx, cfg):
    if not cfg.game:
        return greedy_assign(gstate.sizes, cfg.k), 0
    lam = lambda_from_totals(gstate.sizes.sum(), gstate.n_cross, cfg.k,
                             cfg.relative_weight)
    return game_rounds(gstate.xs, gstate.xd, gstate.sizes, gstate.row_tot,
                       cfg.k, lam, batch_size=cfg.batch_size,
                       max_rounds=cfg.max_rounds, seed=cfg.seed,
                       mode=ctx.game_mode, assign0=ctx.assign0,
                       draw=ctx.draw)


def _vertex_part(cluster_assign, cstate, ctx):
    return cluster_assign[cstate.compact.clamp(0, ctx.m_cap - 1).long()]


def _transform(src, dst, vp, cstate, ctx, cfg):
    # the transform walk is the other stream scan: it follows the
    # clustering's kernel choice
    return transform(src, dst, vp, cstate.deg, cstate.divided, cfg.k,
                     cfg.tau, kernel=ctx.cluster_mode)


def _prior(src, dst, assign, ctx, cfg):
    return majority_vertex_map(src, dst, assign, ctx.num_vertices, cfg.k)


TORCH_STAGES = StageSet(cluster=_cluster, contract=_contract, game=_game,
                        vertex_part=_vertex_part, transform=_transform,
                        prior=_prior)
