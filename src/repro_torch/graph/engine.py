"""Vertex-cut GAS engine (PowerGraph semantics), stacked on one device.

Port of ``repro.graph.engine``'s stacked driver: the k partitions are a
leading axis of every table (the reference's ``vmap`` written out), and
each iteration is local gather → mirror partials reduced to masters →
apply → master values broadcast to mirrors, the two sync phases going
through the halo exchange (``repro_torch.dist.halo``).

PageRank's local gather runs on K3: the layout's edges become a
row-split ELL over the flattened (k·(L_max+1)) contribution vector
(column ``p·(L_max+1) + edge_src``, destination ``p·(L_max+1) +
edge_dst``), built once per layout and device and cached on the layout.
Its sums run in another order than the reference's ``segment_sum``, and
float atomics on the card vary the order from run to run, so PageRank is
held to a tolerance, not bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..dist.halo import get_exchange, halo_routes
from ..kernels.ell_spmv import row_split_ell
from .partition import PartitionLayout

DAMPING = 0.85


@dataclass(frozen=True)
class GASProgram:
    """One GAS computation as callables over the stacked device tables
    (every value is (k, L_max)):

      init(dev)               -> initial per-slot values
      local(value, dev)       -> gather partials over each partition's edges
      apply(total, aux, dev)  -> new master-slot values
      aux(value, dev)         -> optional global scalar (pagerank's
                                 dangling mass) reduced before ``apply``

    Partials combine by sum across partitions: the reference's min-combine
    programs are not ported yet."""
    name: str
    init: Callable
    local: Callable
    apply: Callable
    aux: Callable | None = None


def _local_rank_partial(rank, dev):
    """Σ_{(u,w)∈E_p, w=v} rank[u]/outdeg[u] per local slot, on K3."""
    k, L = rank.shape
    safe_deg = torch.clamp(dev["out_deg"], min=1).to(torch.float32)
    contrib = torch.where(dev["vert_mask"] & (dev["out_deg"] > 0),
                          rank / safe_deg, 0.0)
    x = torch.cat([contrib, torch.zeros(k, 1, dtype=contrib.dtype,
                                        device=contrib.device)], dim=1)
    out = dev["ell"].spmv(x.reshape(-1))
    return out.view(k, L + 1)[:, :L]


def _local_dangle(rank, dev):
    """Rank mass sitting on dangling masters (out_deg == 0)."""
    m = dev["vert_mask"] & dev["is_master"] & (dev["out_deg"] == 0)
    return torch.sum(torch.where(m, rank, 0.0))


def _pagerank_apply(total_in, dangle, dev, num_vertices):
    base = (1.0 - DAMPING) / num_vertices
    new = base + DAMPING * (total_in + dangle / num_vertices)
    return torch.where(dev["vert_mask"] & dev["is_master"], new, 0.0)


def pagerank_program(num_vertices: int) -> GASProgram:
    """Damped pagerank with dangling-mass redistribution (f32, sum)."""
    def init(dev):
        return torch.where(dev["vert_mask"], 1.0 / num_vertices,
                           0.0).to(torch.float32)

    def apply(total, dangle, dev):
        return _pagerank_apply(total, dangle, dev, num_vertices)

    return GASProgram(name="pagerank", init=init, local=_local_rank_partial,
                      apply=apply, aux=_local_dangle)


PROGRAM_NAMES = ("pagerank",)


def get_program(name: str, num_vertices: int) -> GASProgram:
    if name == "pagerank":
        return pagerank_program(num_vertices)
    raise ValueError(f"program {name!r} is not ported yet (ROADMAP, Queue "
                     f"1: the other GAS programs); the port has "
                     f"{PROGRAM_NAMES}")


def stack_dev(layout: PartitionLayout, exchange: str, device) -> dict:
    """The layout's tables on ``device`` plus the halo routes and the
    K3 gather table — built once per (device, exchange), then cached."""
    key = (str(torch.device(device)), exchange)
    dev = layout.cache.get(key)
    if dev is not None:
        return dev
    dev = {name: torch.from_numpy(np.ascontiguousarray(a)).to(device)
           for name, a in layout.device_arrays(exchange).items()}
    dev.update(halo_routes(dev["halo_send"], dev["halo_recv"],
                           layout.l_max))
    stride = layout.l_max + 1
    row = np.arange(layout.k, dtype=np.int64)[:, None] * stride
    em = layout.edge_mask
    dev["ell"] = row_split_ell(
        (layout.edge_dst + row)[em], (layout.edge_src + row)[em],
        np.ones(int(em.sum()), np.float32), layout.k * stride,
        pad_col=layout.l_max, device=device)
    layout.cache[key] = dev
    return dev


def _gas_body(program: GASProgram, ex, dev):
    """One stacked GAS iteration."""
    def body(value):
        aux = program.aux(value, dev) if program.aux is not None else None
        total = ex.reduce_stacked(program.local(value, dev), dev)
        return ex.broadcast_stacked(program.apply(total, aux, dev), dev)
    return body


def _sim_gas(program: GASProgram, dev, iters: int, ex):
    value = program.init(dev)
    body = _gas_body(program, ex, dev)
    for _ in range(iters):
        value = body(value)
    return value


def collect_master_values(layout: PartitionLayout, stacked) -> np.ndarray:
    """(k, L_max) per-partition values → dense (V,) from master slots."""
    vals = stacked.cpu().numpy()
    out = np.zeros(layout.num_vertices, dtype=vals.dtype)
    sel = layout.is_master & layout.vert_mask
    out[layout.vert_gid[sel]] = vals[sel]
    return out


def simulate_gas(program: GASProgram, layout: PartitionLayout,
                 iters: int = 30, exchange: str = "halo", *,
                 device) -> np.ndarray:
    """Stacked one-device driver; returns dense (V,) master values."""
    ex = get_exchange(exchange)
    dev = stack_dev(layout, exchange, device)
    return collect_master_values(layout, _sim_gas(program, dev, iters, ex))


def reference_pagerank(src, dst, num_vertices, iters: int = 30
                       ) -> np.ndarray:
    """Dense float64 oracle with identical dangling handling (the
    reference's ``reference_pagerank``; ``bincount`` sums in edge order
    like its ``np.add.at``)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    outdeg = np.bincount(src, minlength=num_vertices)
    rank = np.full(num_vertices, 1.0 / num_vertices)
    base = (1.0 - DAMPING) / num_vertices
    for _ in range(iters):
        contrib = np.where(outdeg > 0, rank / np.maximum(outdeg, 1), 0.0)
        s = np.bincount(dst, weights=contrib[src], minlength=num_vertices)
        dangle = rank[outdeg == 0].sum()
        rank = base + DAMPING * (s + dangle / num_vertices)
    return rank
