"""CLUGP partitioner entry points (port of ``repro.core.partitioner``).

    partition(src, dst, num_vertices, cfg, backend="torch", nodes=1,
              device=None, mesh=None)
    partition_sweep(src, dst, num_vertices, cfg, ks, device=None)

Three backends share one ``CLUGPConfig`` and one ``CLUGPResult``:

- ``"np"`` — the host oracle: the stage body with ``HOST_STAGES`` (numpy
  copies of the reference's), bit for bit with the reference's ``np``
  backend.  With ``nodes > 1`` it is the §III-C host combine: contiguous
  ⌈E/n⌉ slices, each in a private cluster-id space, their assignments
  concatenated, then global restream passes.  It runs on the host
  whatever the device; it is chosen by name, never as a fallback.
- ``"torch"`` — the counterpart of the reference's single-device
  ``"jit"`` backend: the stage body with ``TORCH_STAGES`` on one device,
  and the adaptive id/m caps retry with a doubled cap when a run
  overflows.
- ``"sharded"`` — the reference's sharded backend (paper §III-C's
  parallel mechanism): ``nodes`` ranks, one contiguous ⌈E/n⌉ slice of
  the stream each (pad lanes are masked self-loops), every rank running
  the same stage body with its slice's V_max and balance cap τ·e_real/k
  and a mesh ``axis`` bound, over which the game's loads, moves and cut
  and the restream prior's count table are summed
  (``dist.collectives``).  The caps are every rank's: the cap check
  reduces (next_id, m) by a max over the ranks, so all ranks grow them
  and retry together.  The assignment and each rank's summary
  (``stats["per_node"]``) are gathered on rank 0.  From a single process
  the call spawns the ranks (``dist.mesh.run_on_ranks``) and returns
  rank 0's result; inside an initialized process group of ``nodes``
  ranks (``torchrun``) it runs SPMD, rank 0 returns the result and the
  other ranks None.  The ranks run on the card (over NCCL when each has
  a card of its own, over gloo when they share one) unless ``device``
  names the CPU.

``partition_sweep`` partitions one stream at several k (the reference's
compile-once stacked sweep).  The reference pads every step to k_max
lanes and masks them with a traced k, because it compiles once; the
port compiles nothing, so each k runs the same body at its own lane
count, with the caps shared across the sweep and retried as the
reference retries them.  The reference's ``sweep_trace_count`` counts
JAX traces and has no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import metrics
from .clustering import ClusteringResult, default_vmax
from .pipeline import CLUGPConfig, CLUGPResult
from .stages import (HOST_STAGES, TORCH_STAGES, CapOverflow,  # noqa: F401
                     StageCtx, resolve_device, resolve_game_mode,
                     resolve_mode, restream_loop, run_clugp_body)
from ..dist import collectives as coll
from ..kernels import _build
from ..dist.mesh import as_axis, make_stream_mesh, run_on_ranks

BACKENDS = ("np", "torch", "sharded")
_BLOCK = 256          # game tables: m_cap pads to a multiple of this
_HOST = torch.device("cpu")


def _check_stream(src: np.ndarray) -> None:
    if src.shape[0] == 0:
        raise ValueError("partition: the edge stream is empty (0 edges); "
                         "there is nothing to partition")


def _pad_to(n: int, mult: int) -> int:
    return -(-max(n, 1) // mult) * mult


def _resolve_vmax(cfg: CLUGPConfig, num_edges: int) -> float:
    """The §VI-A default cap over the edges the strategy streams (a
    slice's count for the host combine's nodes)."""
    return cfg.vmax if cfg.vmax is not None else default_vmax(num_edges,
                                                              cfg.k)


class Caps(NamedTuple):
    id_cap: int
    m_cap: int


def _init_caps(num_vertices: int, num_edges: int) -> Caps:
    """Tight first guesses (the reference's ``_id_cap_guess`` /
    ``_m_cap_guess``): ids ≈ allocations + splits, clusters ≪ V."""
    id_cap = _pad_to(min(2 * num_vertices + 2048,
                         num_vertices + 2 * num_edges + 2), 1024)
    m_cap = _pad_to(min(num_vertices, max(_BLOCK, num_vertices // 4)),
                    _BLOCK)
    return Caps(id_cap, m_cap)


def _grow_caps(caps: Caps, *, next_id: int, m: int, num_vertices: int,
               num_edges: int) -> Caps:
    id_cap, m_cap = caps
    if next_id > id_cap - 2:
        id_cap = min(2 * id_cap, num_vertices + 2 * num_edges + 2)
    if m > m_cap:
        m_cap = min(2 * m_cap, _pad_to(num_vertices, _BLOCK))
    return Caps(id_cap, m_cap)


def partition(src, dst, num_vertices: int, cfg: CLUGPConfig, *,
              backend: str = "torch", nodes: int = 1, device=None,
              mesh=None, assign0=None, draw=None) -> CLUGPResult:
    """Run the CLUGP pipeline.  ``nodes`` is the §III-C stream split of
    the ``np`` and ``sharded`` backends; ``mesh`` (a ``make_stream_mesh``
    mesh of ``nodes`` ranks) overrides the sharded backend's.
    ``assign0``/``draw`` inject the device game's random start and
    damping draws (see ``game_rounds``); on the sharded backend one per
    rank (a sequence indexed by rank)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if nodes < 1:
        raise ValueError(f"nodes must be >= 1, got {nodes}")
    src = np.asarray(src)
    dst = np.asarray(dst)
    _check_stream(src)
    if backend == "np":
        if nodes == 1:
            return _run_np(src, dst, num_vertices, cfg)
        return _run_np_nodes(src, dst, num_vertices, cfg, nodes)
    if backend == "sharded":
        return _run_sharded(src, dst, num_vertices, cfg, nodes, device,
                            mesh, assign0, draw)
    if nodes > 1:
        raise ValueError("backend='torch' runs on one device; nodes > 1 is "
                         "backend='sharded' (or 'np', the host combine)")
    dev = resolve_device(device)
    s, d = _to_device(src, dst, dev)
    caps, retries = _init_caps(num_vertices, src.shape[0]), 0
    vmax = _resolve_vmax(cfg, src.shape[0])
    while True:
        try:
            out = run_clugp_body(s, d, _ctx(num_vertices, vmax, dev, cfg,
                                            caps, assign0, draw),
                                 cfg, TORCH_STAGES)
            break
        except CapOverflow as e:
            caps = _grow_caps(caps, next_id=e.next_id, m=e.m,
                              num_vertices=num_vertices,
                              num_edges=src.shape[0])
            retries += 1
    c = out.cluster
    clus = ClusteringResult(c.compact.cpu().numpy(), c.deg.cpu().numpy(),
                            c.divided.cpu().numpy(),
                            c.replicas.cpu().numpy(), c.m)
    res = _result(out, src, dst, num_vertices, cfg.k, clus,
                  out.cluster_assign[:c.m].cpu().numpy(), c.m)
    res.stats.update(device=str(dev), id_cap=caps.id_cap, m_cap=caps.m_cap,
                     cap_retries=retries)
    return res


def _to_device(src, dst, dev):
    return (torch.from_numpy(src.astype(np.int32)).to(dev),
            torch.from_numpy(dst.astype(np.int32)).to(dev))


def _ctx(num_vertices, vmax, dev, cfg, caps, assign0=None, draw=None,
         lmax=None, mask=None, axis=None) -> StageCtx:
    return StageCtx(num_vertices=num_vertices, vmax=float(vmax), device=dev,
                    game_mode=resolve_game_mode(cfg.kernel, caps.m_cap),
                    cluster_mode=resolve_mode(cfg.cluster_kernel),
                    id_cap=caps.id_cap, m_cap=caps.m_cap, assign0=assign0,
                    draw=draw, lmax=lmax, mask=mask, axis=axis)


def _result(out, src, dst, num_vertices, k, clustering, cluster_assign,
            num_clusters, backend="torch") -> CLUGPResult:
    assign = np.asarray(out.assign.cpu() if backend == "torch"
                        else out.assign)
    res = CLUGPResult(assign, clustering, cluster_assign, out.rounds)
    res.stats = metrics.summarize(src, dst, assign, num_vertices, k)
    res.stats.update(num_clusters=num_clusters, game_rounds=out.rounds,
                     backend=backend, stage_seconds=out.seconds)
    return res


# ------------------------------------------------------------ np backend

def _host_ctx(num_vertices: int, num_edges: int, cfg: CLUGPConfig
              ) -> StageCtx:
    return StageCtx(num_vertices=num_vertices,
                    vmax=_resolve_vmax(cfg, num_edges), device=_HOST)


def _rf_trace(trace, rf) -> list:
    return [round(r, 4) for r in list(trace) + [rf]]


def _run_np(src, dst, num_vertices: int, cfg: CLUGPConfig) -> CLUGPResult:
    out = run_clugp_body(src, dst, _host_ctx(num_vertices, src.shape[0], cfg),
                         cfg, HOST_STAGES)
    res = _result(out, src, dst, num_vertices, cfg.k, out.cluster,
                  out.cluster_assign, out.cluster.num_clusters, backend="np")
    res.cluster_graph = out.graph.cg
    if cfg.restream:
        res.stats["restream_rf_trace"] = _rf_trace(out.trace,
                                                   res.stats["rf"])
    return res


def _run_np_nodes(src, dst, num_vertices: int, cfg: CLUGPConfig,
                  nodes: int) -> CLUGPResult:
    """The §III-C host combine (``_run_np_nodes`` of the reference):
    contiguous ⌈E/n⌉ slices, each in a private id space, their edge
    assignments concatenated, then global restream passes whose majority
    prior spans every slice.  ``clustering``, ``cluster_graph`` and
    ``cluster_assign`` are None; ``stats["per_node"]`` holds each node's
    own summary."""
    E = src.shape[0]
    e_per = -(-E // nodes)
    sub_cfg = dataclasses.replace(cfg, restream=0)
    parts, per_node, pieces = [], [], []
    rounds = clusters = 0
    for i in range(nodes):
        lo, hi = i * e_per, min(E, (i + 1) * e_per)
        if hi <= lo:
            continue
        ctx = _host_ctx(num_vertices, hi - lo, sub_cfg)
        out = run_clugp_body(src[lo:hi], dst[lo:hi], ctx, sub_cfg,
                             HOST_STAGES)
        pieces.append(out.assign)
        rounds = max(rounds, out.rounds)
        clusters += out.cluster.num_clusters
        per_node.append({"node": i, "edges": int(hi - lo),
                         "clusters": out.cluster.num_clusters,
                         "game_rounds": out.rounds})
        parts.append((slice(lo, hi), out.cluster, ctx))
    gctx = StageCtx(num_vertices=num_vertices, vmax=None, device=_HOST)
    assign, trace = restream_loop(src, dst, np.concatenate(pieces), parts,
                                  gctx, cfg, HOST_STAGES)
    res = CLUGPResult(assign, None, None, rounds)
    res.stats = metrics.summarize(src, dst, assign, num_vertices, cfg.k)
    res.stats.update(num_clusters=clusters, game_rounds=rounds,
                     backend="np", nodes=nodes, per_node=per_node)
    if cfg.restream:
        res.stats["restream_rf_trace"] = _rf_trace(trace, res.stats["rf"])
    return res


# ------------------------------------------------------- sharded backend

def _slices(src, dst, n: int):
    """Per rank the contiguous ⌈E/n⌉ slice, padded to that length: (src,
    dst, live) with the pad lanes 0 → 0 and not live."""
    E = src.shape[0]
    e_per = -(-E // n)
    out = []
    for r in range(n):
        lo, hi = min(E, r * e_per), min(E, (r + 1) * e_per)
        s = np.zeros(e_per, np.int32)
        d = np.zeros(e_per, np.int32)
        live = np.zeros(e_per, bool)
        s[:hi - lo], d[:hi - lo], live[:hi - lo] = src[lo:hi], dst[lo:hi], True
        out.append((s, d, live))
    return out


def _slice_caps(cfg: CLUGPConfig, e_real: int) -> tuple:
    """A slice's V_max and balance cap from its real edge count, in f32
    as the reference's ``node_fn`` computes them: max(2, e_real/k) and
    τ·e_real/k."""
    e = np.float32(e_real)
    kf = np.float32(cfg.k)
    vmax = cfg.vmax if cfg.vmax is not None else \
        float(np.maximum(np.float32(2.0), e / kf))
    lmax = float(np.float32(np.float32(cfg.tau) * e) / kf)
    return vmax, lmax


def _per_rank(x, rank: int):
    """An injected draw: one per rank (a sequence) or None; a start
    assignment may come as a numpy array."""
    if x is None:
        return None
    x = x[rank]
    return torch.from_numpy(np.asarray(x)) if isinstance(x, np.ndarray) \
        else x


def _sharded_rank(mesh, num_vertices: int, cfg: CLUGPConfig, e_per: int,
                  assign0, draw, src_b, dst_b, live):
    """One rank of the sharded backend: the stage body on this rank's
    slice (``src_b``, ``dst_b``, ``live``).  Returns, on rank 0, the
    assignment of every slice (n, e_per), every rank's summary and the
    caps; None on the others."""
    axis, rank, dev = mesh, mesh.rank, mesh.device
    coll.reset_counts()
    _build.reset_launch_counts()
    s = torch.from_numpy(src_b.astype(np.int32)).to(dev)
    d = torch.from_numpy(dst_b.astype(np.int32)).to(dev)
    mask = torch.from_numpy(live).to(dev)
    e_real = int(live.sum())
    vmax, lmax = _slice_caps(cfg, e_real)
    caps, retries = _init_caps(num_vertices, e_per), 0
    while True:
        ctx = _ctx(num_vertices, vmax, dev, cfg, caps,
                   _per_rank(assign0, rank), _per_rank(draw, rank),
                   lmax=lmax, mask=mask, axis=axis)
        try:
            out = run_clugp_body(s, d, ctx, cfg, TORCH_STAGES)
            break
        except CapOverflow as e:
            caps = _grow_caps(caps, next_id=e.next_id, m=e.m,
                              num_vertices=num_vertices, num_edges=e_per)
            retries += 1
    assign = coll.gather_to_root(out.assign.to(torch.int32), axis,
                                 site="partition.assign")
    wire = coll.counts()
    node = {"node": rank, "edges": e_real, "clusters": out.cluster.m,
            "game_rounds": out.rounds, "game_form": ctx.game_mode,
            "device": str(dev), "stage_seconds": out.seconds,
            "prior_allreduce_seconds": wire.get(
                "restream.counts", {}).get("seconds", 0.0),
            "collectives": wire, "launches": _build.launch_counts(),
            "cap_retries": retries}
    nodes = coll.gather_objects(node, axis)
    if rank != 0:
        return None
    return assign.cpu().numpy(), nodes, caps, retries


def _sharded_result(src, dst, num_vertices, cfg, mesh, pieces
                    ) -> CLUGPResult:
    assign_p, nodes, caps, retries = pieces
    assign = assign_p.reshape(-1)[:src.shape[0]]
    rounds = max(n["game_rounds"] for n in nodes)
    res = CLUGPResult(assign, None, None, rounds)
    res.stats = metrics.summarize(src, dst, assign, num_vertices, cfg.k)
    res.stats.update(num_clusters=sum(n["clusters"] for n in nodes),
                     game_rounds=rounds, backend="sharded", nodes=mesh.size,
                     per_node=nodes, mesh=mesh.describe(),
                     id_cap=caps.id_cap, m_cap=caps.m_cap,
                     cap_retries=retries)
    return res


def _run_sharded(src, dst, num_vertices, cfg, nodes, device, mesh,
                 assign0, draw):
    if mesh is None:
        mesh = make_stream_mesh(nodes, device=device)
    elif mesh.size != nodes:
        raise ValueError(f"mesh has {mesh.size} ranks, nodes={nodes}")
    mesh = as_axis(mesh, "stream")
    for x in (assign0, draw):
        if x is not None and len(x) != nodes:
            raise ValueError(f"the sharded backend takes one injected draw "
                             f"a rank ({nodes}), got {len(x)}")
    parts = _slices(src, dst, nodes)
    e_per = parts[0][0].shape[0]
    args = (num_vertices, cfg, e_per, assign0, draw)
    if mesh.bound:
        pieces = _sharded_rank(mesh, *args, *parts[mesh.rank])
        return None if pieces is None else _sharded_result(
            src, dst, num_vertices, cfg, mesh, pieces)
    pieces = run_on_ranks(_sharded_rank, mesh, *args, rank_args=parts)
    return _sharded_result(src, dst, num_vertices, cfg, mesh, pieces)


# --------------------------------------------------------------- k-sweep

def partition_sweep(src, dst, num_vertices: int, cfg: CLUGPConfig, ks, *,
                    device=None) -> list:
    """Partition the stream at every k in ``ks`` on the torch backend and
    return one ``CLUGPResult`` per k, in input order (stats ``sweep=True``,
    ``k_max``).  Every k runs the stage body at its own lane count with
    what the reference's padded step gives it: V_max from that k, the
    transform cap τ·E in f32 over k in f32, the game mode resolved on the
    shared m_cap.  The caps are the sweep's: a round runs every k, and a
    k that overflows grows them for a rerun of the whole sweep, as the
    reference's retry does."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    _check_stream(src)
    ks = tuple(int(k) for k in ks)
    if not ks or min(ks) < 1:
        raise ValueError(f"partition_sweep: need at least one k >= 1, "
                         f"got {ks!r}")
    E, k_max = src.shape[0], max(ks)
    dev = resolve_device(device)
    s, d = _to_device(src, dst, dev)
    caps, retries = _init_caps(num_vertices, E), 0
    while True:
        outs, over = [], []
        for k in ks:
            kcfg = dataclasses.replace(cfg, k=k)
            lmax = float(np.float32(kcfg.tau * E) / np.float32(k))
            ctx = _ctx(num_vertices, _resolve_vmax(kcfg, E), dev, kcfg, caps,
                       lmax=lmax)
            try:
                outs.append(run_clugp_body(s, d, ctx, kcfg, TORCH_STAGES))
            except CapOverflow as e:
                over.append(e)
        if not over:
            break
        caps = _grow_caps(caps, next_id=max(e.next_id for e in over),
                          m=max(e.m for e in over),
                          num_vertices=num_vertices, num_edges=E)
        retries += 1
    results = []
    for k, out in zip(ks, outs):
        res = _result(out, src, dst, num_vertices, k, None, None,
                      out.cluster.m)
        res.stats.update(sweep=True, k_max=k_max, device=str(dev),
                         id_cap=caps.id_cap, m_cap=caps.m_cap,
                         cap_retries=retries)
        results.append(res)
    return results
