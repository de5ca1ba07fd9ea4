"""CLUGP partitioner entry points (port of ``repro.core.partitioner``).

    partition(src, dst, num_vertices, cfg, backend="torch", nodes=1,
              device=None)
    partition_sweep(src, dst, num_vertices, cfg, ks, device=None)

Two backends share one ``CLUGPConfig`` and one ``CLUGPResult``:

- ``"np"`` — the host oracle: the stage body with ``HOST_STAGES`` (numpy
  copies of the reference's), bit for bit with the reference's ``np``
  backend.  With ``nodes > 1`` it is the §III-C host combine: contiguous
  ⌈E/n⌉ slices, each in a private cluster-id space, their assignments
  concatenated, then global restream passes.  It runs on the host
  whatever the device; it is chosen by name, never as a fallback.
- ``"torch"`` — the counterpart of the reference's single-device
  ``"jit"`` backend: the stage body with ``TORCH_STAGES`` on one device,
  and the adaptive id/m caps retry with a doubled cap when a run
  overflows.  ``nodes > 1`` there would be the reference's sharded
  backend, which is not ported (ROADMAP Queue 1 item 7).

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

BACKENDS = ("np", "torch")
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
              assign0=None, draw=None) -> CLUGPResult:
    """Run the CLUGP pipeline.  ``nodes`` is the §III-C stream split of
    the ``np`` backend.  ``assign0``/``draw`` inject the device game's
    random start and damping draws (see ``game_rounds``)."""
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
    if nodes > 1:
        raise ValueError("backend='torch' with nodes > 1 is the sharded "
                         "partitioner, not ported yet (ROADMAP, Queue 1 "
                         "item 7); use backend='np' for the host combine")
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
         lmax=None) -> StageCtx:
    return StageCtx(num_vertices=num_vertices, vmax=float(vmax), device=dev,
                    game_mode=resolve_game_mode(cfg.kernel, caps.m_cap),
                    cluster_mode=resolve_mode(cfg.cluster_kernel),
                    id_cap=caps.id_cap, m_cap=caps.m_cap, assign0=assign0,
                    draw=draw, lmax=lmax)


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
