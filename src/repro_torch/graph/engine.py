"""Vertex-cut GAS engine (PowerGraph semantics): stacked on one device,
or one partition per rank.

Port of ``repro.graph.engine``'s drivers and its program library.  In the
stacked drivers (``simulate_*``) the k partitions are a leading axis of
every table (the reference's ``vmap`` written out); in the per-rank
drivers (``shard_map_*``, the reference's shard_map path) each rank of a
``dist.mesh`` graph mesh holds one partition's row of every table and
runs the same program callables on it.  Each iteration is local gather →
mirror partials reduced to masters → apply → master values broadcast to
mirrors, the two sync phases going through the exchange
(``repro_torch.dist.halo``: any of its five wire formats, its stacked or
its per-rank halves).

The library spans the exchange's wire cells: (sum, f32) pagerank, ppr and
centrality; (min, i32) cc, labelprop, sssp and bfs; (sum, i32) degree.
``simulate_gas`` runs one program, ``simulate_gas_many`` a ``FusedGAS``
bundle of programs that share one (combine, dtype) cell, with one
exchange per phase for the whole bundle; both take ``tol`` (early exit),
``init_values`` (warm start) and ``return_iters``.

The local gathers run over flat indices of the real edges into the
(k·(L_max+1)) value table (``e_src``, ``e_dst``: column ``p·(L_max+1) +
edge_src``), built once per layout and device and cached on the layout;
the reference's masked pad edges only ever reach the pad bucket it slices
off.  The f32 sums Aᵀx (pagerank and ppr over ``rank/outdeg``, centrality
over ``value``) run on K3 over a row-split ELL of the same edges.  Its
sums run in another order than the reference's ``segment_sum``, and float
atomics on the card vary the order from run to run, so the f32 programs
are held to a tolerance; the min and integer-sum gathers (``scatter_reduce_``
"amin" from the int32 sentinel, ``index_add_``) are exact in any order,
so those programs match the reference bit for bit.

The programs' global scalars (pagerank's dangling mass, centrality's L1
norm) are one reduction over the (k,) vector of per-partition sums: the
stacked run reduces its own, a rank reduces the vector gathered from the
ranks.  So on the CPU a per-rank run equals the stacked run bit for bit:
the local gathers
keep their order (a rank's K3 table takes the layout's row width) and
the exchanges combine received lanes in rank order.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..core.partitioner import resolve_device
from ..dist import collectives as coll
from ..dist.halo import RAGGED_EXCHANGES, _segment_combine, get_exchange
from ..kernels import _build
from ..kernels.ell_spmv import choose_width, row_split_ell
from ..dist.mesh import Mesh, as_axis, run_on_ranks
from .partition import PartitionLayout

DAMPING = 0.85
# labels and distances are int32; the min identity marks pad and
# non-master slots and never wins a minimum against a real value
CC_SENTINEL = int(np.iinfo(np.int32).max)
DEFAULT_SOURCE = 0


@dataclass(frozen=True)
class GASProgram:
    """One GAS computation as callables over the stacked device tables
    (every value is (k, L_max)):

      init(dev)               -> initial per-slot values
      local(value, dev)       -> gather partials over each partition's edges
      apply(total, aux, dev)  -> new master-slot values (others get the
                                 combine's identity / the sentinel)
      aux(value, dev)         -> optional per-partition (k,) sums of a
                                 global scalar (pagerank's dangling
                                 mass), added in partition order before
                                 ``apply``

    ``combine`` ("sum" | "min") and ``dtype`` (a torch dtype) fix how
    partials combine across partitions.  ``spec`` names a library
    program's factory and its arguments: such a program pickles as its
    spec (the per-rank drivers send programs to spawned ranks)."""
    name: str
    combine: str
    dtype: torch.dtype
    init: Callable
    local: Callable
    apply: Callable
    aux: Callable | None = None
    spec: tuple = dataclasses.field(default=(), compare=False)

    def __reduce__(self):
        if self.spec:
            return _program_from_spec, self.spec
        return GASProgram, tuple(getattr(self, f.name)
                                 for f in dataclasses.fields(self))


# ------------------------------------------------------- per-slot helpers

def _masters(dev):
    return dev["vert_mask"] & dev["is_master"]


def _masked_ext(values, mask, fill):
    """(k, L) values → flat (k·(L+1)) with invalid slots and the pad
    column set to ``fill`` (what the edge gathers read)."""
    k = values.shape[0]
    safe = torch.where(mask, values, fill)
    pad = torch.full((k, 1), fill, dtype=values.dtype, device=values.device)
    return torch.cat([safe, pad], dim=1).reshape(-1)


def _segment_slots(vals, seg, dev, combine: str):
    """Combine per-edge ``vals`` into the slots ``seg`` names (flat
    (k·(L+1)) indices: ``dev["e_src"]`` or ``dev["e_dst"]``) → (k, L);
    slots with no edge hold the combine's identity."""
    k, L = dev["vert_gid"].shape
    return _segment_combine(vals, seg, k * (L + 1), combine) \
        .view(k, L + 1)[:, :L]


def _ell_gather(x, dev):
    """Σ over each slot's in-edges of x[edge source], on K3: x (k, L) with
    0 wherever it must not contribute."""
    k, L = x.shape
    ext = torch.cat([x, torch.zeros(k, 1, dtype=x.dtype, device=x.device)],
                    dim=1)
    return dev["ell"].spmv(ext.reshape(-1)).view(k, L + 1)[:, :L]


# ---------------------------------------------------------- pagerank, ppr

def _local_rank_partial(rank, dev):
    """Σ_{(u,w)∈E_p, w=v} rank[u]/outdeg[u] per local slot, on K3."""
    safe_deg = torch.clamp(dev["out_deg"], min=1).to(torch.float32)
    contrib = torch.where(dev["vert_mask"] & (dev["out_deg"] > 0),
                          rank / safe_deg, 0.0)
    return _ell_gather(contrib, dev)


def _local_dangle(rank, dev):
    """Rank mass sitting on dangling masters (out_deg == 0), per
    partition."""
    m = _masters(dev) & (dev["out_deg"] == 0)
    return torch.sum(torch.where(m, rank, 0.0), dim=-1)


def _pagerank_apply(total_in, dangle, dev, num_vertices):
    base = (1.0 - DAMPING) / num_vertices
    new = base + DAMPING * (total_in + dangle / num_vertices)
    return torch.where(_masters(dev), new, 0.0)


def pagerank_program(num_vertices: int) -> GASProgram:
    """Damped pagerank with dangling-mass redistribution (f32, sum)."""
    def init(dev):
        return torch.where(dev["vert_mask"], 1.0 / num_vertices,
                           0.0).to(torch.float32)

    def apply(total, dangle, dev):
        return _pagerank_apply(total, dangle, dev, num_vertices)

    return GASProgram(name="pagerank", combine="sum", dtype=torch.float32,
                      init=init, local=_local_rank_partial, apply=apply,
                      aux=_local_dangle, spec=("pagerank", num_vertices))


def default_num_seeds(num_vertices: int) -> int:
    """Seed-set size for labelprop/ppr: ~V/256, at least 2."""
    return max(2, num_vertices // 256)


def ppr_program(num_vertices: int, num_seeds: int | None = None
                ) -> GASProgram:
    """Personalized pagerank: teleport (and dangling) mass lands on the
    seed set {gid < num_seeds} — pagerank's gather on K3 and its aux, a
    different apply (f32, sum)."""
    ns = default_num_seeds(num_vertices) if num_seeds is None else num_seeds

    def init(dev):
        seeded = dev["vert_mask"] & (dev["vert_gid"] < ns)
        return torch.where(seeded, 1.0 / ns, 0.0).to(torch.float32)

    def apply(total, dangle, dev):
        seeded = dev["vert_gid"] < ns
        teleport = torch.where(
            seeded, (1.0 - DAMPING) / ns + DAMPING * dangle / ns, 0.0)
        return torch.where(_masters(dev), DAMPING * total + teleport, 0.0)

    return GASProgram(name="ppr", combine="sum", dtype=torch.float32,
                      init=init, local=_local_rank_partial, apply=apply,
                      aux=_local_dangle, spec=("ppr", num_vertices, ns))


# ------------------------------------------------------------- centrality

def _cent_local(value, dev):
    """In-neighbour sum without degree normalization (Aᵀx), on K3."""
    return _ell_gather(torch.where(dev["vert_mask"], value, 0.0), dev)


def _cent_aux(value, dev):
    """L1 mass of the current iterate (masters only), per partition."""
    return torch.sum(torch.where(_masters(dev), value, 0.0), dim=-1)


def centrality_program(num_vertices: int) -> GASProgram:
    """Damped power iteration x ← (1−d)/V + d·(Aᵀx)/‖x‖₁, the
    normalization riding the global aux (f32, sum)."""
    base = (1.0 - DAMPING) / num_vertices

    def init(dev):
        return torch.where(dev["vert_mask"], 1.0 / num_vertices,
                           0.0).to(torch.float32)

    def apply(total, norm, dev):
        new = base + DAMPING * total / torch.clamp(norm, min=1e-30)
        return torch.where(_masters(dev), new, 0.0)

    return GASProgram(name="centrality", combine="sum", dtype=torch.float32,
                      init=init, local=_cent_local, apply=apply,
                      aux=_cent_aux, spec=("centrality", num_vertices))


# --------------------------------------------------------- cc, labelprop

def _cc_init(dev):
    return torch.where(dev["vert_mask"], dev["vert_gid"], CC_SENTINEL)


def _cc_local_min(label, dev):
    """Edge-wise min exchange in both directions (undirected semantics)."""
    lab = _masked_ext(label, dev["vert_mask"], CC_SENTINEL)
    s, d = dev["e_src"], dev["e_dst"]
    out = _segment_slots(lab[s], d, dev, "min")
    out2 = _segment_slots(lab[d], s, dev, "min")
    cur = torch.where(dev["vert_mask"], label, CC_SENTINEL)
    return torch.minimum(cur, torch.minimum(out, out2))


def _cc_apply(total, aux, dev):
    return torch.where(_masters(dev), total, CC_SENTINEL)


# connected components by min-label contagion (min, i32)
CC_PROGRAM = GASProgram(name="cc", combine="min", dtype=torch.int32,
                        init=_cc_init, local=_cc_local_min, apply=_cc_apply,
                        spec=("cc",))


def labelprop_program(num_vertices: int, num_seeds: int | None = None
                      ) -> GASProgram:
    """Seeded directed label propagation: vertices with gid < num_seeds
    hold their own gid; everything else takes the min label over its
    in-neighbours each round (min, i32)."""
    ns = default_num_seeds(num_vertices) if num_seeds is None else num_seeds

    def init(dev):
        seeded = dev["vert_mask"] & (dev["vert_gid"] < ns)
        return torch.where(seeded, dev["vert_gid"], CC_SENTINEL)

    def local(label, dev):
        lab = _masked_ext(label, dev["vert_mask"], CC_SENTINEL)
        out = _segment_slots(lab[dev["e_src"]], dev["e_dst"], dev, "min")
        cur = torch.where(dev["vert_mask"], label, CC_SENTINEL)
        return torch.minimum(cur, out)

    def apply(total, aux, dev):
        seeded = dev["vert_gid"] < ns
        clamped = torch.where(seeded, dev["vert_gid"], total)
        return torch.where(_masters(dev), clamped, CC_SENTINEL)

    return GASProgram(name="labelprop", combine="min", dtype=torch.int32,
                      init=init, local=local, apply=apply,
                      spec=("labelprop", num_vertices, ns))


# -------------------------------------------------------------- sssp, bfs

def _sssp_weight(gu, gv):
    """Deterministic positive edge weight from the endpoint gids (1..11):
    SSSP gets a weighted metric with no edge-weight table."""
    return 1 + (3 * gu + 7 * gv) % 11


def _edge_gids(dev):
    """Global ids of each real edge's endpoints (int32, cached with the
    edge indices)."""
    return dev["e_gsrc"], dev["e_gdst"]


def _relax_local(dist, dev, weight_fn):
    """One Bellman-Ford relaxation over the local directed edges: min over
    incoming (u → v) of dist[u] + w(u, v), min'd with the current value.
    int32 throughout; clamping before the add keeps sentinel + w from
    wrapping."""
    du = _masked_ext(dist, dev["vert_mask"], CC_SENTINEL)[dev["e_src"]]
    w = weight_fn(*_edge_gids(dev))
    cand = torch.where(du < CC_SENTINEL,
                       torch.clamp(du, max=CC_SENTINEL - 64) + w,
                       CC_SENTINEL)
    relaxed = _segment_slots(cand, dev["e_dst"], dev, "min")
    cur = torch.where(dev["vert_mask"], dist, CC_SENTINEL)
    return torch.minimum(cur, relaxed)


def _distance_program(name: str, source: int, weight_fn) -> GASProgram:
    """sssp / bfs from ``source`` under ``weight_fn``."""
    def init(dev):
        at_src = dev["vert_mask"] & (dev["vert_gid"] == source)
        return torch.where(at_src, 0, CC_SENTINEL).to(torch.int32)

    def local(dist, dev):
        return _relax_local(dist, dev, weight_fn)

    def apply(total, aux, dev):
        clamped = torch.where(dev["vert_gid"] == source, 0, total)
        return torch.where(_masters(dev), clamped, CC_SENTINEL)

    return GASProgram(name=name, combine="min", dtype=torch.int32,
                      init=init, local=local, apply=apply,
                      spec=(name, source))


def sssp_program(source: int = DEFAULT_SOURCE) -> GASProgram:
    """Single-source shortest paths (Bellman-Ford relaxations) under the
    gid-hash weights (min, i32)."""
    return _distance_program("sssp", source, _sssp_weight)


def bfs_program(source: int = DEFAULT_SOURCE) -> GASProgram:
    """BFS levels from ``source`` (unit-weight min-plus; min, i32)."""
    return _distance_program("bfs", source, lambda gu, gv: 1)


# ----------------------------------------------------------------- degree

def _degree_local(value, dev):
    """Per-slot incident-edge count (out at src + in at dst); ignores the
    carried value, so any iteration count ≥ 1 gives the same answer."""
    ones = torch.ones(dev["e_src"].shape[0], dtype=torch.int32,
                      device=value.device)
    return (_segment_slots(ones, dev["e_src"], dev, "sum")
            + _segment_slots(ones, dev["e_dst"], dev, "sum"))


# total degree, the (sum, i32) cell: an exact integer count
DEGREE_PROGRAM = GASProgram(
    name="degree", combine="sum", dtype=torch.int32,
    init=lambda dev: torch.zeros_like(dev["vert_gid"]),
    local=_degree_local,
    apply=lambda total, aux, dev: torch.where(_masters(dev), total, 0),
    spec=("degree",))


PROGRAM_NAMES = ("pagerank", "cc", "labelprop", "sssp", "bfs", "degree",
                 "centrality", "ppr")


def get_program(name: str, num_vertices: int) -> GASProgram:
    """Program registry: name → GASProgram with the library defaults
    (source vertex 0, ~V/256 seeds)."""
    factories = {"pagerank": lambda: pagerank_program(num_vertices),
                 "cc": lambda: CC_PROGRAM,
                 "labelprop": lambda: labelprop_program(num_vertices),
                 "sssp": sssp_program,
                 "bfs": bfs_program,
                 "degree": lambda: DEGREE_PROGRAM,
                 "centrality": lambda: centrality_program(num_vertices),
                 "ppr": lambda: ppr_program(num_vertices)}
    if name not in factories:
        raise ValueError(f"unknown program {name!r}; expected one of "
                         f"{PROGRAM_NAMES}")
    return factories[name]()


def _program_from_spec(name: str, *args) -> GASProgram:
    """A library program from its ``spec`` (what it pickles as)."""
    return {"pagerank": pagerank_program, "ppr": ppr_program,
            "centrality": centrality_program,
            "labelprop": labelprop_program, "sssp": sssp_program,
            "bfs": bfs_program, "cc": lambda: CC_PROGRAM,
            "degree": lambda: DEGREE_PROGRAM}[name](*args)


# ------------------------------------------------------------ device tables

def _tensor(a, device):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _edge_tables(layout: PartitionLayout, device) -> dict:
    """What every exchange shares: the common tables, the real edges'
    flat (k·(L_max+1)) endpoint indices and global ids, and K3's gather
    table."""
    dev = {name: _tensor(getattr(layout, name), device)
           for name in PartitionLayout.COMMON_TABLES}
    stride = layout.l_max + 1
    row = np.arange(layout.k, dtype=np.int64)[:, None] * stride
    em = layout.edge_mask
    e_src, e_dst = (layout.edge_src + row)[em], (layout.edge_dst + row)[em]
    gid = np.concatenate([layout.vert_gid,
                          np.full((layout.k, 1), -1, np.int32)], axis=1)
    gid = gid.reshape(-1)
    for name, idx in (("src", e_src), ("dst", e_dst)):
        dev[f"e_{name}"] = _tensor(idx, device)
        dev[f"e_g{name}"] = _tensor(gid[idx], device)
    dev["ell"] = row_split_ell(e_dst, e_src, np.ones(e_src.shape[0],
                                                     np.float32),
                               layout.k * stride, pad_col=layout.l_max,
                               device=device, width=ell_width(layout))
    return dev


def ell_width(layout: PartitionLayout) -> int:
    """K3's row width for the layout: chosen once from every partition's
    in-degrees, shared by the stacked table and each rank's share."""
    w = layout.cache.get("ell_width")
    if w is None:
        stride = layout.l_max + 1
        row = np.arange(layout.k, dtype=np.int64)[:, None] * stride
        dst = (layout.edge_dst + row)[layout.edge_mask]
        w = layout.cache["ell_width"] = choose_width(
            np.bincount(dst, minlength=layout.k * stride))
    return w


def stack_dev(layout: PartitionLayout, exchange: str, device) -> dict:
    """The layout's tables on ``device`` with the edge indices, K3's
    gather table and the exchange's routes — the shared part built once
    per device, the routes once per (device, exchange), then cached."""
    dkey = str(torch.device(device))
    key = (dkey, exchange)
    dev = layout.cache.get(key)
    if dev is not None:
        return dev
    ex = get_exchange(exchange, layout)
    common = layout.cache.get((dkey, None))
    if common is None:
        common = layout.cache[(dkey, None)] = _edge_tables(layout, device)
    dev = dict(common)
    arrays = layout.device_arrays(exchange)
    for name in PartitionLayout.EXCHANGE_TABLES[exchange]:
        dev[name] = _tensor(arrays[name], device)
    dev.update(ex.routes(dev, layout.l_max))
    dev["routes"] = {}
    layout.cache[key] = dev
    return dev


# ---------------------------------------------------------------- drivers

def _check_overlap(exchange: str, overlap: bool) -> None:
    """The overlapped body needs the ring's hopwise reduce and the
    frontier split, which only the ragged exchanges have."""
    if overlap and exchange not in RAGGED_EXCHANGES:
        raise ValueError(
            f"overlap=True needs a ragged ring exchange "
            f"{RAGGED_EXCHANGES}; got {exchange!r}")


def _gas_body(program: GASProgram, ex, dev, overlap: bool = False):
    """One stacked GAS iteration over (value, state).

    ``overlap=True`` (ragged exchanges) is the reference's overlapped
    body: the reduce folds the ring into the master accumulator
    (``hopwise``), and interior slots (``~dev["frontier"]``, one replica)
    apply from their local partial, which has no data dependence on the
    ring; frontier slots apply from the exchanged total.  An interior
    slot's total is its partial (the accumulator holds the identity
    there), so the values equal the phase-ordered body's."""
    def body(value, state):
        aux = _stacked_aux(program, value, dev)
        partial = program.local(value, dev)
        if overlap:
            total, state = ex.reduce_stacked(partial, dev, program.combine,
                                             state, hopwise=True)
            new_master = torch.where(dev["frontier"],
                                     program.apply(total, aux, dev),
                                     program.apply(partial, aux, dev))
        else:
            total, state = ex.reduce_stacked(partial, dev, program.combine,
                                             state)
            new_master = program.apply(total, aux, dev)
        return ex.broadcast_stacked(new_master, dev, program.combine, state)
    return body


def _stacked_aux(program: GASProgram, value, dev):
    """The program's global scalar: one sum over its (k,) per-partition
    sums (None without an aux)."""
    if program.aux is None:
        return None
    return program.aux(value, dev).sum()


def _residual(new, old, mask):
    """Masked max-norm residual between iterates, as f32.  Integer
    programs difference as max − min, exact in the native dtype (values
    live in [0, iinfo.max]; a plain new − old overflows on the sentinel);
    any real change is ≥ 1 and survives the f32 cast."""
    if new.dtype.is_floating_point:
        d = torch.abs(new - old)
    else:
        d = torch.maximum(new, old) - torch.minimum(new, old)
    return torch.max(torch.where(mask, d, 0)).to(torch.float32)


def _converge_loop(body, value, state, iters: int, tol: float, mask,
                   axis=None):
    """The GAS loop with early exit: ``iters`` is a cap and the loop ends
    once the masked master residual drops to ``tol``.  Returns (value,
    iters_run).  The residual is read back to the host once an iteration
    (one device-to-host copy that waits for the iteration) — the
    reference's ``while_loop`` tests it on the device.  Under a mesh
    ``axis`` it is max-reduced over the ranks first, so every rank leaves
    on the same iteration."""
    tol32 = float(np.float32(tol))      # the reference compares in f32
    i, res = 0, float("inf")
    while i < iters and res > tol32:
        new, state = body(value, state)
        res = float(coll.pmax(_residual(new, value, mask), axis,
                              site="gas.residual"))
        value, i = new, i + 1
    return value, i


def _np_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def _warm_tables(dev, dtype, init_values):
    """Host dense (V_old,) warm vector → per-slot (k, L_max) values and
    validity, gathered on the device through the cached slot gids (the
    host casts and uploads only the (V_old,) vector).  Vertices the old
    vector knew (gid < len) seed from it; the rest keep ``program.init``;
    an empty vector is the cold run."""
    dense = (np.zeros(0) if init_values is None
             else np.asarray(init_values))
    n = dense.shape[0]
    gid = dev["vert_gid"]
    known = dev["vert_mask"] & (gid < n)
    if not n:
        return torch.zeros(gid.shape, dtype=dtype, device=gid.device), known
    vals = torch.from_numpy(dense.astype(_np_dtype(dtype))).to(gid.device)
    return torch.where(known, vals[gid.long().clamp(0, n - 1)], 0), known


def _run_loop(body, value, state, iters: int, tol, mask, axis=None):
    if tol is None:
        for _ in range(iters):
            value, state = body(value, state)
        return value, iters
    return _converge_loop(body, value, state, iters, tol, mask, axis)


def _sim_gas(program: GASProgram, dev, iters: int, ex, tol=None,
             warm=None, overlap: bool = False):
    value = program.init(dev)
    if warm is not None:
        value = torch.where(warm[1], warm[0], value)
    if not iters:
        return value, 0
    state = ex.init_state(dev, program.dtype, program.combine)
    return _run_loop(_gas_body(program, ex, dev, overlap), value, state,
                     iters, tol, _masters(dev))


def collect_master_values(layout: PartitionLayout, stacked) -> np.ndarray:
    """(k, L_max) per-partition values (a tensor or numpy) → dense (V,)
    from master slots."""
    vals = stacked.cpu().numpy() if isinstance(stacked, torch.Tensor) \
        else np.asarray(stacked)
    out = np.zeros(layout.num_vertices, dtype=vals.dtype)
    sel = layout.is_master & layout.vert_mask
    out[layout.vert_gid[sel]] = vals[sel]
    return out


def simulate_gas(program: GASProgram, layout: PartitionLayout,
                 iters: int = 30, exchange: str = "dense", *,
                 tol: float | None = None, overlap: bool = False,
                 init_values=None, return_iters: bool = False,
                 device=None):
    """Stacked one-device driver; returns dense (V,) master values.

    ``tol`` makes ``iters`` a cap: the run stops once the master-slot
    residual max-norm drops to ``tol`` (``return_iters=True`` also
    returns the iterations run).  ``init_values`` warm-starts from a
    dense (V_old,) vector, e.g. an earlier fixed point.  ``overlap`` runs
    the overlapped body (ragged exchanges; ``_gas_body``).  Runs on the
    card unless ``device`` names another device."""
    _check_overlap(exchange, overlap)
    device = resolve_device(device)
    ex = get_exchange(exchange, layout)
    dev = stack_dev(layout, exchange, device)
    warm = (None if init_values is None
            else _warm_tables(dev, program.dtype, init_values))
    value, iters_run = _sim_gas(program, dev, iters, ex, tol, warm, overlap)
    dense = collect_master_values(layout, value)
    return (dense, iters_run) if return_iters else dense


def simulate_pagerank(layout: PartitionLayout, iters: int = 30,
                      exchange: str = "dense", **kw):
    return simulate_gas(pagerank_program(layout.num_vertices), layout,
                        iters, exchange, **kw)


def simulate_cc(layout: PartitionLayout, iters: int = 30,
                exchange: str = "dense", **kw):
    out = simulate_gas(CC_PROGRAM, layout, iters, exchange, **kw)
    if kw.get("return_iters"):
        value, iters_run = out
        return value.astype(np.int64), iters_run
    return out.astype(np.int64)


# ------------------------------------------------- fused multi-program driver

@dataclass(frozen=True)
class FusedGAS:
    """N programs run as one fused iteration over one layout: each
    program's local/apply math runs on its slice of a (k, N, L_max)
    stack, and each sync phase is one exchange call for all N (one
    gather and one scatter).  The programs must share one (combine,
    dtype) wire cell."""
    programs: tuple[GASProgram, ...]

    def __post_init__(self):
        if not self.programs:
            raise ValueError("FusedGAS needs at least one program")
        combines = {p.combine for p in self.programs}
        dtypes = {_np_dtype(p.dtype).name for p in self.programs}
        if len(combines) > 1 or len(dtypes) > 1:
            raise ValueError(
                "fused programs must share one (combine, dtype) wire "
                f"cell; got combines {sorted(combines)} and dtypes "
                f"{sorted(dtypes)}")

    @property
    def combine(self) -> str:
        return self.programs[0].combine

    @property
    def dtype(self):
        return self.programs[0].dtype

    @property
    def name(self) -> str:
        return "+".join(p.name for p in self.programs)


def fuse_programs(programs) -> FusedGAS:
    """Coerce a GASProgram sequence (or an existing FusedGAS) to FusedGAS."""
    if isinstance(programs, FusedGAS):
        return programs
    return FusedGAS(tuple(programs))


def _gas_body_multi(fused: FusedGAS, ex, dev, overlap: bool = False):
    """One fused GAS iteration over (values (k, N, L_max), state): each
    program's math on its own slice, one ``*_multi`` exchange call per
    phase for all N; ``overlap`` as in ``_gas_body``."""
    programs = fused.programs

    def apply_all(total, auxes):
        return torch.stack([p.apply(total[:, i], auxes[i], dev)
                            for i, p in enumerate(programs)], dim=1)

    def body(value, state):
        auxes = [_stacked_aux(p, value[:, i], dev)
                 for i, p in enumerate(programs)]
        partials = torch.stack([p.local(value[:, i], dev)
                                for i, p in enumerate(programs)], dim=1)
        if overlap:
            total, state = ex.reduce_stacked_multi(
                partials, dev, fused.combine, state, hopwise=True)
            new_master = torch.where(dev["frontier"][:, None, :],
                                     apply_all(total, auxes),
                                     apply_all(partials, auxes))
        else:
            total, state = ex.reduce_stacked_multi(
                partials, dev, fused.combine, state)
            new_master = apply_all(total, auxes)
        return ex.broadcast_stacked_multi(new_master, dev, fused.combine,
                                          state)
    return body


def _sim_gas_many(fused: FusedGAS, dev, iters: int, ex, tol=None,
                  warm=None, overlap: bool = False):
    value = torch.stack([p.init(dev) for p in fused.programs], dim=1)
    if warm is not None:
        value = torch.where(warm[1], warm[0], value)
    if not iters:
        return value, 0
    state = ex.init_state_multi(dev, fused.dtype, fused.combine,
                                len(fused.programs))
    return _run_loop(_gas_body_multi(fused, ex, dev, overlap), value, state,
                     iters, tol, _masters(dev)[:, None, :])


def _warm_tables_many(dev, fused: FusedGAS, init_values):
    """Per-program warm tables stacked on the program axis: one dense
    (V_old,) vector or None (a cold start) per program."""
    pairs = [_warm_tables(dev, fused.dtype, iv)
             for iv in init_values]
    return (torch.stack([v for v, _ in pairs], dim=1),
            torch.stack([m for _, m in pairs], dim=1))


def simulate_gas_many(programs, layout: PartitionLayout, iters: int = 30,
                      exchange: str = "dense", *, tol: float | None = None,
                      overlap: bool = False, init_values=None,
                      return_iters: bool = False, device=None):
    """Stacked one-device driver for a fused bundle; returns one dense
    (V,) array per program, in bundle order.  ``tol`` (the residual is
    the max over all programs), per-program ``init_values`` and
    ``return_iters`` and ``overlap`` as in ``simulate_gas``."""
    _check_overlap(exchange, overlap)
    fused = fuse_programs(programs)
    device = resolve_device(device)
    ex = get_exchange(exchange, layout)
    dev = stack_dev(layout, exchange, device)
    warm = (None if init_values is None
            else _warm_tables_many(dev, fused, init_values))
    value, iters_run = _sim_gas_many(fused, dev, iters, ex, tol, warm,
                                     overlap)
    dense = [collect_master_values(layout, value[:, i])
             for i in range(len(fused.programs))]
    return (dense, iters_run) if return_iters else dense


# ------------------------------------------------------- per-rank drivers
# One partition a rank of a graph mesh (the reference's shard_map path):
# each rank holds its row of every table as a (1, …) stack, so the
# program callables run unchanged, and its exchange halves go over the
# mesh (``dist.halo``'s per-rank halves, ``dist.collectives``).

def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank_tables(layout: PartitionLayout, exchange: str, r: int) -> dict:
    """Partition r's share of the layout (numpy): its rows of the common
    tables and of the exchange's, its real edges as slot indices and
    global ids, and the layout-wide K3 width."""
    L = layout.l_max
    t = {name: getattr(layout, name)[r:r + 1]
         for name in PartitionLayout.COMMON_TABLES}
    for name in PartitionLayout.EXCHANGE_TABLES[exchange]:
        a = getattr(layout, name)
        t[name] = a[r:r + 1] if name == "frontier" else a[r]
    em = layout.edge_mask[r]
    gid = np.concatenate([layout.vert_gid[r], [-1]]).astype(np.int32)
    for end in ("src", "dst"):
        idx = getattr(layout, f"edge_{end}")[r][em].astype(np.int64)
        t[f"e_{end}"], t[f"e_g{end}"] = idx, gid[idx]
    t["meta"] = {"k": layout.k, "l_max": L, "ell_width": ell_width(layout)}
    return t


def _rank_dev(tables: dict, ex, device) -> dict:
    """A rank's device tables from ``_rank_tables``: the (1, …) rows, the
    edge indices, K3's table over its edges and the exchange's routes."""
    meta = tables["meta"]
    L = meta["l_max"]
    dev = {name: _tensor(a, device) for name, a in tables.items()
           if name != "meta"}
    dev["ell"] = row_split_ell(tables["e_dst"], tables["e_src"],
                               np.ones(tables["e_src"].shape[0], np.float32),
                               L + 1, pad_col=L, device=device,
                               width=meta["ell_width"])
    dev.update(ex.rank_routes(dev, L))
    return dev


def _rank_aux(program: GASProgram, value, dev, axis):
    """The global scalar over the ranks: one sum over the (k,) vector of
    the ranks' partition sums (the stacked ``_stacked_aux`` bit for
    bit)."""
    if program.aux is None:
        return None
    return coll.all_gather(program.aux(value, dev).reshape(()), axis,
                           site="gas.aux").sum()


def _rank_body(program: GASProgram, ex, dev, overlap: bool):
    """One GAS iteration of a rank over (value (1, L_max), state):
    ``_gas_body`` with the exchange's per-rank halves."""
    def body(value, state):
        aux = _rank_aux(program, value, dev, ex.axis)
        partial = program.local(value, dev)
        if overlap:
            total, state = ex.reduce_to_masters(
                partial[0], dev, program.combine, state, hopwise=True)
            new_master = torch.where(dev["frontier"],
                                     program.apply(total[None], aux, dev),
                                     program.apply(partial, aux, dev))
        else:
            total, state = ex.reduce_to_masters(partial[0], dev,
                                                program.combine, state)
            new_master = program.apply(total[None], aux, dev)
        value, state = ex.broadcast_from_masters(new_master[0], dev,
                                                 program.combine, state)
        return value[None], state
    return body


def _rank_body_multi(fused: FusedGAS, ex, dev, overlap: bool):
    """One fused GAS iteration of a rank over (values (1, N, L_max),
    state): ``_gas_body_multi`` with the per-rank ``*_multi`` halves."""
    programs = fused.programs

    def apply_all(total, auxes):
        return torch.stack([p.apply(total[:, i], auxes[i], dev)
                            for i, p in enumerate(programs)], dim=1)

    def body(value, state):
        auxes = [_rank_aux(p, value[:, i], dev, ex.axis)
                 for i, p in enumerate(programs)]
        partials = torch.stack([p.local(value[:, i], dev)
                                for i, p in enumerate(programs)], dim=1)
        if overlap:
            total, state = ex.reduce_to_masters_multi(
                partials[0], dev, fused.combine, state, hopwise=True)
            new_master = torch.where(dev["frontier"][:, None, :],
                                     apply_all(total[None], auxes),
                                     apply_all(partials, auxes))
        else:
            total, state = ex.reduce_to_masters_multi(
                partials[0], dev, fused.combine, state)
            new_master = apply_all(total[None], auxes)
        value, state = ex.broadcast_from_masters_multi(
            new_master[0], dev, fused.combine, state)
        return value[None], state
    return body


def _gas_rank(mesh, programs, ex, iters, tol, overlap, init_values,
              tables):
    """A spawned rank's run: its share of the tables on its device, then
    ``_gas_loop``."""
    ex = dataclasses.replace(ex, axis=mesh)
    return _gas_loop(mesh, programs, ex, iters, tol, overlap, init_values,
                     _rank_dev(tables, ex, mesh.device))


def _cached_rank_dev(layout: PartitionLayout, exchange: str, ex, mesh):
    """A bound rank's device tables for ``exchange``, built once per
    layout, device and rank and kept in ``layout.cache`` (as
    ``stack_dev`` keeps the stacked ones)."""
    key = ("rank", str(mesh.device), exchange, mesh.rank)
    dev = layout.cache.get(key)
    if dev is None:
        dev = layout.cache[key] = _rank_dev(
            _rank_tables(layout, exchange, mesh.rank), ex, mesh.device)
    return dev


def _gas_loop(mesh, programs, ex, iters, tol, overlap, init_values, dev):
    """One rank's loop on its device tables, the values gathered on rank
    0.  ``programs`` is a GASProgram or a FusedGAS.  Returns, on rank 0,
    (every rank's values (k, [N,] L_max) as numpy, iterations run, every
    rank's report); None on the others.  A report holds the loop's
    collective counts (``dist.collectives.counts``), its kernel launches
    and its wall seconds (the device synchronized)."""
    coll.reset_counts()
    _build.reset_launch_counts()
    _sync(mesh.device)
    t = time.perf_counter()
    fused = isinstance(programs, FusedGAS)
    mask = _masters(dev)
    if fused:
        value = torch.stack([p.init(dev) for p in programs.programs], dim=1)
        warm = None if init_values is None \
            else _warm_tables_many(dev, programs, init_values)
        mask = mask[:, None, :]
    else:
        value = programs.init(dev)
        warm = None if init_values is None \
            else _warm_tables(dev, programs.dtype, init_values)
    if warm is not None:
        value = torch.where(warm[1], warm[0], value)
    iters_run = 0
    if iters:
        if fused:
            state = ex.init_state_rank_multi(dev, programs.dtype,
                                             programs.combine,
                                             len(programs.programs))
            body = _rank_body_multi(programs, ex, dev, overlap)
        else:
            state = ex.init_state_rank(dev, programs.dtype,
                                       programs.combine)
            body = _rank_body(programs, ex, dev, overlap)
        value, iters_run = _run_loop(body, value, state, iters, tol, mask,
                                     mesh)
    _sync(mesh.device)
    wire = coll.gather_objects({"collectives": coll.counts(),
                                "launches": _build.launch_counts(),
                                "loop_seconds": time.perf_counter() - t},
                               mesh)
    rows = coll.gather_to_root(value[0], mesh, site="gas.collect")
    if rows is None:
        return None
    return rows.cpu().numpy(), iters_run, wire


def check_graph_mesh(mesh, k: int) -> None:
    """A per-rank driver's mesh: a ``dist.mesh.Mesh`` of k ranks, one
    partition a rank."""
    if not isinstance(mesh, Mesh) or mesh.size != k:
        raise ValueError(f"mesh= takes a graph mesh of k = {k} "
                         f"ranks (one partition a rank), got {mesh!r}")


def _on_ranks(layout: PartitionLayout, mesh, axis: str, exchange: str,
              programs, iters, tol, overlap, init_values):
    """Run ``_gas_rank`` one partition a rank: SPMD on a bound mesh
    (every rank holds the layout), else on ranks spawned here (each
    gets its own share of the tables).  Returns rank 0's result, None on
    the other ranks of a bound mesh."""
    _check_overlap(exchange, overlap)
    check_graph_mesh(mesh, layout.k)
    mesh = as_axis(mesh, axis)
    ex = get_exchange(exchange, layout)
    args = (programs, ex, iters, tol, overlap, init_values)
    if mesh.bound:
        ex = dataclasses.replace(ex, axis=mesh)
        return _gas_loop(mesh, programs, ex, iters, tol, overlap,
                         init_values,
                         _cached_rank_dev(layout, exchange, ex, mesh))
    return run_on_ranks(_gas_rank, mesh, *args, rank_args=[
        (_rank_tables(layout, exchange, r),) for r in range(layout.k)])


def shard_map_gas(program: GASProgram, layout: PartitionLayout, mesh,
                  iters: int = 30, axis: str = "parts",
                  exchange: str = "dense", *, tol: float | None = None,
                  overlap: bool = False, init_values=None,
                  return_iters: bool = False, return_wire: bool = False):
    """Production path: one partition per rank of ``mesh`` (a
    ``make_graph_mesh`` mesh of k = ``layout.k`` ranks) over
    ``torch.distributed``, the exchange's per-rank halves carrying the
    mirror sync.  Returns the dense (V,) master values, gathered on rank
    0 (None on the other ranks of a bound mesh).  From a single process
    the ranks are spawned here; inside an initialized process group of k
    ranks (``torchrun``) every rank calls it with the same arguments.
    ``tol`` (the residual max-reduced over the ranks, so every rank
    leaves on the same iteration), ``overlap``, ``init_values`` and
    ``return_iters`` as in ``simulate_gas``; ``return_wire`` also
    returns every rank's report of the loop (its collective counts,
    kernel launches and wall seconds; see ``_gas_rank``)."""
    out = _on_ranks(layout, mesh, axis, exchange, program, iters, tol,
                    overlap, init_values)
    if out is None:
        return None
    rows, iters_run, wire = out
    dense = collect_master_values(layout, rows)
    return _with(dense, iters_run if return_iters else None,
                 wire if return_wire else None)


def _with(value, iters_run, wire):
    extra = tuple(x for x in (iters_run, wire) if x is not None)
    return (value, *extra) if extra else value


def shard_map_pagerank(layout: PartitionLayout, mesh, iters: int = 30,
                       axis: str = "parts", exchange: str = "dense"):
    return shard_map_gas(pagerank_program(layout.num_vertices), layout,
                         mesh, iters=iters, axis=axis, exchange=exchange)


def shard_map_cc(layout: PartitionLayout, mesh, iters: int = 30,
                 axis: str = "parts", exchange: str = "dense"):
    out = shard_map_gas(CC_PROGRAM, layout, mesh, iters=iters, axis=axis,
                        exchange=exchange)
    return None if out is None else out.astype(np.int64)


def shard_map_gas_many(programs, layout: PartitionLayout, mesh,
                       iters: int = 30, axis: str = "parts",
                       exchange: str = "dense", *, tol: float | None = None,
                       overlap: bool = False, init_values=None,
                       return_iters: bool = False,
                       return_wire: bool = False):
    """``shard_map_gas`` for a fused bundle: one dense (V,) array per
    program, in bundle order (rank 0), with one ``*_multi`` exchange call
    a phase for all N programs."""
    fused = fuse_programs(programs)
    out = _on_ranks(layout, mesh, axis, exchange, fused, iters, tol,
                    overlap, init_values)
    if out is None:
        return None
    rows, iters_run, wire = out
    dense = [collect_master_values(layout, rows[:, i])
             for i in range(len(fused.programs))]
    return _with(dense, iters_run if return_iters else None,
                 wire if return_wire else None)


def gas_step_for_dryrun(program, layout: PartitionLayout, mesh,
                        axis: str = "parts", iters: int = 1,
                        exchange: str = "dense", overlap: bool = False):
    """The graph dry-run's cell (``launch/dryrun.py --graph``): ``iters``
    iterations of ``program`` on a k-rank ``mesh``, one partition a rank,
    and every rank's report of the loop.  The port lowers nothing, so
    where the reference returns a step to compile and parses its HLO,
    this runs the step and returns what each rank handed to the wire.

    ``program`` is a ``GASProgram``, or a program sequence / ``FusedGAS``
    run as the fused multi-program iteration (one exchange a phase for
    the bundle).  ``overlap`` runs the interleaved interior/frontier body
    (ragged exchanges only).  Returns, on rank 0, (the values: one dense
    (V,) array, or one a program; every rank's report: its
    ``dist.collectives.counts()`` of the loop, reset just before it, its
    kernel launches and its wall seconds); None on the other ranks of a
    bound mesh."""
    kw = dict(iters=iters, axis=axis, exchange=exchange, overlap=overlap,
              return_wire=True)
    if isinstance(program, GASProgram):
        return shard_map_gas(program, layout, mesh, **kw)
    return shard_map_gas_many(program, layout, mesh, **kw)


def pagerank_step_for_dryrun(layout: PartitionLayout, mesh,
                             axis: str = "parts", iters: int = 1,
                             exchange: str = "dense"):
    return gas_step_for_dryrun(pagerank_program(layout.num_vertices),
                               layout, mesh, axis=axis, iters=iters,
                               exchange=exchange)


# ---------------------------------------------------------------- oracles
#
# Dense single-machine numpy oracles computing what the reference's
# ``reference_*`` compute.  Sums accumulate in float64 in edge order
# (``bincount`` like the reference's ``np.add.at``); minima group the
# edges by destination once and take ``minimum.reduceat`` per round,
# which gives the reference's integers in any order.

def reference_pagerank(src, dst, num_vertices, iters: int = 30
                       ) -> np.ndarray:
    """Dense float64 oracle with identical dangling handling."""
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


class _MinByDst:
    """Per-destination minimum of per-edge values: the edges sorted by
    destination once, then one ``minimum.reduceat`` per call."""

    def __init__(self, dst):
        self.order = np.argsort(dst, kind="stable")
        d = dst[self.order]
        self.starts = np.flatnonzero(np.r_[True, d[1:] != d[:-1]]) \
            if d.size else np.zeros(0, np.int64)
        self.heads = d[self.starts]

    def into(self, out, vals):
        """out[v] = min(out[v], min over edges into v of vals[e])."""
        if self.starts.size:
            m = np.minimum.reduceat(vals[self.order], self.starts)
            out[self.heads] = np.minimum(out[self.heads], m)
        return out


def reference_cc(src, dst, num_vertices) -> np.ndarray:
    """Connected components (undirected), labelled by the least vertex id
    of each component (what min-label propagation finds)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import connected_components
    A = sp.coo_matrix((np.ones(len(src)), (src, dst)),
                      shape=(num_vertices, num_vertices))
    _, comp = connected_components(A, directed=False)
    mins = np.full(comp.max() + 1, num_vertices, dtype=np.int64)
    np.minimum.at(mins, comp, np.arange(num_vertices))
    return mins[comp]


def _reference_relax(src, dst, num_vertices, iters, source, weights):
    """Bellman-Ford oracle giving the engine's exact per-round relaxation,
    so it matches at any iteration count; unreachable vertices keep
    CC_SENTINEL.  A round relaxes only the out-edges of the vertices the
    last round lowered: every other edge's candidate is the one it gave
    the round before, which its head already holds."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.int64)
    order = np.argsort(src, kind="stable")
    starts = np.r_[0, np.cumsum(np.bincount(src, minlength=num_vertices))]
    dist = np.full(num_vertices, CC_SENTINEL, dtype=np.int64)
    dist[source] = 0
    front = np.array([source], dtype=np.int64)
    for _ in range(iters):
        if not front.size:
            break
        n = starts[front + 1] - starts[front]
        at = np.repeat(starts[front] - np.cumsum(n) + n, n) \
            + np.arange(n.sum())
        e = order[at]
        cand = np.minimum(dist[src[e]], CC_SENTINEL - 64) + weights[e]
        new = _MinByDst(dst[e]).into(dist.copy(), cand)
        new[source] = 0
        front = np.flatnonzero(new != dist)
        dist = new
    return dist


def reference_sssp(src, dst, num_vertices, iters: int = 40,
                   source: int = DEFAULT_SOURCE) -> np.ndarray:
    """SSSP under the gid-hash weights w(u,v) = 1 + (3u + 7v) % 11."""
    s = np.asarray(src, dtype=np.int64)
    d = np.asarray(dst, dtype=np.int64)
    return _reference_relax(s, d, num_vertices, iters, source,
                            _sssp_weight(s, d))


def reference_bfs(src, dst, num_vertices, iters: int = 40,
                  source: int = DEFAULT_SOURCE) -> np.ndarray:
    """BFS levels from ``source`` over directed edges."""
    s = np.asarray(src, dtype=np.int64)
    return _reference_relax(s, dst, num_vertices, iters, source,
                            np.ones(len(s), dtype=np.int64))


def reference_labelprop(src, dst, num_vertices, iters: int = 40,
                        num_seeds: int | None = None) -> np.ndarray:
    """Seeded directed min-label propagation; non-seeds that no seed
    reaches keep CC_SENTINEL."""
    ns = default_num_seeds(num_vertices) if num_seeds is None else num_seeds
    src = np.asarray(src, dtype=np.int64)
    by_dst = _MinByDst(np.asarray(dst, dtype=np.int64))
    lab = np.full(num_vertices, CC_SENTINEL, dtype=np.int64)
    lab[:ns] = np.arange(ns)
    for _ in range(iters):
        lab = by_dst.into(lab.copy(), lab[src])
        lab[:ns] = np.arange(ns)
    return lab


def reference_degree(src, dst, num_vertices) -> np.ndarray:
    """Total (in + out) degree, counting duplicate edges like the engine."""
    return (np.bincount(np.asarray(src, dtype=np.int64),
                        minlength=num_vertices)
            + np.bincount(np.asarray(dst, dtype=np.int64),
                          minlength=num_vertices))


def reference_centrality(src, dst, num_vertices,
                         iters: int = 30) -> np.ndarray:
    """L1-normalized damped power iteration x ← (1−d)/V + d·(Aᵀx)/‖x‖₁."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    x = np.full(num_vertices, 1.0 / num_vertices)
    base = (1.0 - DAMPING) / num_vertices
    for _ in range(iters):
        s = np.bincount(dst, weights=x[src], minlength=num_vertices)
        x = base + DAMPING * s / max(x.sum(), 1e-30)
    return x


def reference_ppr(src, dst, num_vertices, iters: int = 30,
                  num_seeds: int | None = None) -> np.ndarray:
    """Personalized pagerank with teleport + dangling mass on the seeds."""
    ns = default_num_seeds(num_vertices) if num_seeds is None else num_seeds
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    outdeg = np.bincount(src, minlength=num_vertices)
    e = np.zeros(num_vertices)
    e[:ns] = 1.0 / ns
    rank = e.copy()
    for _ in range(iters):
        contrib = np.where(outdeg > 0, rank / np.maximum(outdeg, 1), 0.0)
        s = np.bincount(dst, weights=contrib[src], minlength=num_vertices)
        dangle = rank[outdeg == 0].sum()
        rank = DAMPING * s + (1.0 - DAMPING) * e + DAMPING * dangle * e
    return rank
