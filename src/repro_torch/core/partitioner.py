"""CLUGP partitioner entry point (port of ``repro.core.partitioner``).

    partition(src, dst, num_vertices, cfg, backend="torch", device=None)

``"torch"`` is the counterpart of the reference's single-device ``"jit"``
backend: the stage body runs with ``TORCH_STAGES`` on one device, and the
adaptive id/m caps retry with a doubled cap when a run overflows.  The
host ``"np"`` oracle and the sharded backend are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import metrics
from .clustering import ClusteringResult, default_vmax
from .pipeline import CLUGPConfig, CLUGPResult
from .stages import (TORCH_STAGES, CapOverflow, StageCtx,  # noqa: F401
                     resolve_device, resolve_mode, run_clugp_body)

BACKENDS = ("torch",)
_BLOCK = 256          # game tables: m_cap pads to a multiple of this


def _pad_to(n: int, mult: int) -> int:
    return -(-max(n, 1) // mult) * mult


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
              backend: str = "torch", device=None, assign0=None,
              draw=None) -> CLUGPResult:
    """Run the CLUGP pipeline on one device.  ``assign0``/``draw`` inject
    the game's random start and damping draws (see ``game_rounds``)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    src = np.asarray(src)
    dst = np.asarray(dst)
    E = src.shape[0]
    if E == 0:
        raise ValueError("partition: the edge stream is empty (0 edges); "
                         "there is nothing to partition")
    dev = resolve_device(device)
    vmax = cfg.vmax if cfg.vmax is not None else default_vmax(E, cfg.k)
    s = torch.from_numpy(src.astype(np.int32)).to(dev)
    d = torch.from_numpy(dst.astype(np.int32)).to(dev)
    caps = _init_caps(num_vertices, E)
    retries = 0
    while True:
        ctx = StageCtx(num_vertices=num_vertices, vmax=float(vmax),
                       device=dev, game_mode=resolve_mode(cfg.kernel),
                       cluster_mode=resolve_mode(cfg.cluster_kernel),
                       id_cap=caps.id_cap, m_cap=caps.m_cap,
                       assign0=assign0, draw=draw)
        try:
            out = run_clugp_body(s, d, ctx, cfg, TORCH_STAGES)
            break
        except CapOverflow as e:
            caps = _grow_caps(caps, next_id=e.next_id, m=e.m,
                              num_vertices=num_vertices, num_edges=E)
            retries += 1
    c = out.cluster
    assign = out.assign.cpu().numpy()
    clus = ClusteringResult(c.compact.cpu().numpy(), c.deg.cpu().numpy(),
                            c.divided.cpu().numpy(),
                            c.replicas.cpu().numpy(), c.m)
    res = CLUGPResult(assign, clus, out.cluster_assign[:c.m].cpu().numpy(),
                      out.rounds)
    res.stats = metrics.summarize(src, dst, assign, num_vertices, cfg.k)
    res.stats.update(num_clusters=c.m, game_rounds=out.rounds,
                     backend="torch", device=str(dev),
                     id_cap=caps.id_cap, m_cap=caps.m_cap,
                     cap_retries=retries, stage_seconds=out.seconds)
    return res
