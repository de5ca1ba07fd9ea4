"""GraphSession — edge stream → CLUGP partition → layout → GAS, on PyTorch.

Port of ``repro.session``'s core: a fluent session with a serializable
config.

    from repro_torch.core import CLUGPConfig, web_graph
    from repro_torch.session import GraphSession, SessionConfig
    g = web_graph(scale=20, edge_factor=8, seed=0)
    sess = GraphSession(SessionConfig(clugp=CLUGPConfig.optimized(64,
                                                                  restream=1),
                                      backend="torch", exchange="halo",
                                      iters=30))
    pr = sess.partition(g.src, g.dst, g.num_vertices).layout().run("pagerank")

    cc = sess.run("cc", tol=0, iters=100)           # int64 labels
    pr, ppr = sess.run_many(["pagerank", "ppr"])   # one fused loop

The session runs on the card unless ``device=`` names another device;
with no card and no ``device`` it raises.  ``backend="torch"`` is the
counterpart of the reference's ``"jit"`` backend, ``"np"`` its host
oracle (``nodes > 1``: the §III-C host combine) and ``"sharded"`` its
sharded backend (``nodes`` ranks, one stream slice each); ``run_sweep``
partitions at several k; ``with_partition``
adopts an external edge → partition assignment instead, and
``snapshot``/``from_snapshot`` carry graph and partition across a
restart (``repro_torch.serve``).  ``run`` takes any of ``PROGRAMS`` (the
``repro_torch.graph.engine`` library) or a ``GASProgram``, over any of
the five ``EXCHANGES``: stacked on the session's device, or with
``mesh=`` (a ``launch.mesh.make_graph_mesh(k)``) one partition a rank —
ranks spawned here from a single process, or SPMD inside a process
group of k ranks, where rank 0 gets the values and the others None;
``overlap=True`` runs the overlapped body on the ragged ones.
``comm_bytes`` is the modelled wire bytes of an iteration;
``dryrun_step`` runs a program's step on the mesh and returns what each
rank handed to the wire (``launch.dryrun --graph``).

    from repro_torch.launch.mesh import make_graph_mesh
    pr = sess.run("pagerank", mesh=make_graph_mesh(64))  # 64 ranks
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass

import numpy as np

from .core import metrics
from .core.partitioner import (BACKENDS, partition, partition_sweep,
                               resolve_device)
from .core.pipeline import CLUGPConfig, CLUGPResult
from .dist.halo import EXCHANGE_NAMES, lossy_payload
from .graph.engine import (GASProgram, PROGRAM_NAMES, fuse_programs,
                           gas_step_for_dryrun, get_program, shard_map_gas,
                           shard_map_gas_many, simulate_gas,
                           simulate_gas_many)
from .graph.partition import PartitionLayout, build_layout

EXCHANGES = EXCHANGE_NAMES
PROGRAMS = PROGRAM_NAMES


def resolve_program(program, num_vertices: int) -> GASProgram:
    """Name → library GASProgram (a GASProgram passes through)."""
    if isinstance(program, GASProgram):
        return program
    return get_program(program, num_vertices)


def _as_int64(out):
    return out.astype(np.int64) if np.issubdtype(out.dtype, np.integer) \
        else out


@dataclass(frozen=True)
class SessionConfig:
    """Everything a reproducible partition → layout → GAS run needs;
    round-trips through ``to_json``/``from_json``."""
    clugp: CLUGPConfig
    backend: str = "torch"     # partitioner strategy: torch | np | sharded
    nodes: int = 1             # §III-C stream split (np, sharded)
    exchange: str = "halo"     # mirror wire format for run()
    iters: int = 30            # default GAS iterations
    pad_multiple: int = 8      # layout table padding

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; expected "
                             f"one of {BACKENDS}")
        if self.exchange not in EXCHANGES:
            raise ValueError(f"unknown exchange {self.exchange!r}; "
                             f"expected one of {EXCHANGES}")
        if self.nodes < 1:
            raise ValueError(f"nodes must be >= 1, got {self.nodes}")
        if self.nodes > 1 and self.backend == "torch":
            raise ValueError("nodes > 1 is the np backend's host combine "
                             "or the sharded backend's ranks; the torch "
                             "backend runs on one device")
        if not isinstance(self.clugp, CLUGPConfig):
            raise TypeError("SessionConfig.clugp must be a CLUGPConfig")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=1)

    @classmethod
    def from_json(cls, text: str) -> "SessionConfig":
        d = json.loads(text)
        clugp = CLUGPConfig(**d.pop("clugp"))
        return cls(clugp=clugp, **d)


class GraphSession:
    """``GraphSession(cfg).partition(...).layout().run(...)``; the first
    two return ``self``, ``run`` the program's dense (V,) master values."""

    def __init__(self, cfg: SessionConfig | CLUGPConfig, *, device=None,
                 **overrides):
        if isinstance(cfg, CLUGPConfig):
            cfg = SessionConfig(clugp=cfg, **overrides)
        elif overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        if not isinstance(cfg, SessionConfig):
            raise TypeError("GraphSession takes a SessionConfig or a "
                            "CLUGPConfig (+ SessionConfig overrides)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.result: CLUGPResult | None = None
        self._layout: PartitionLayout | None = None
        self._src = self._dst = None
        self._num_vertices: int | None = None

    @property
    def k(self) -> int:
        return self.cfg.clugp.k

    def to_json(self) -> str:
        return self.cfg.to_json()

    @classmethod
    def from_json(cls, text: str, *, device=None) -> "GraphSession":
        return cls(SessionConfig.from_json(text), device=device)

    def partition(self, src, dst, num_vertices: int) -> "GraphSession":
        """Run CLUGP on the edge stream."""
        self._adopt_graph(src, dst, num_vertices)
        self.result = partition(self._src, self._dst, self._num_vertices,
                                self.cfg.clugp, backend=self.cfg.backend,
                                nodes=self.cfg.nodes, device=self.device)
        return self

    def run_sweep(self, src, dst, num_vertices: int, ks) -> dict:
        """Partition the stream at every k in ``ks``
        (``core.partition_sweep``: the torch backend whatever the
        session's, as the reference sweeps on jit; each k at its own lane
        count, the caps shared).  Returns ``{k: CLUGPResult}`` in input
        order and leaves the session on the last k's partition, ready for
        ``layout()``/``run()``."""
        self._adopt_graph(src, dst, num_vertices)
        results = partition_sweep(self._src, self._dst, self._num_vertices,
                                  self.cfg.clugp, ks, device=self.device)
        table = dict(zip((int(k) for k in ks), results))
        last_k = int(tuple(ks)[-1])
        self.cfg = dataclasses.replace(
            self.cfg, clugp=dataclasses.replace(self.cfg.clugp, k=last_k))
        self.result = table[last_k]
        return table

    def with_partition(self, src, dst, num_vertices: int,
                       assign) -> "GraphSession":
        """Adopt an externally computed edge → partition assignment, so
        the layout and the engine work on it."""
        self._adopt_graph(src, dst, num_vertices)
        assign = np.asarray(assign)
        if assign.shape[0] != self._src.shape[0]:
            raise ValueError(
                f"assignment covers {assign.shape[0]} edges but the "
                f"stream has {self._src.shape[0]}")
        res = CLUGPResult(assign, None, None, 0)
        res.stats = metrics.summarize(self._src, self._dst, assign,
                                      self._num_vertices, self.k)
        res.stats["backend"] = "external"
        self.result = res
        return self

    def _adopt_graph(self, src, dst, num_vertices: int) -> None:
        self._src = np.asarray(src)
        self._dst = np.asarray(dst)
        self._num_vertices = int(num_vertices)
        self._layout = None
        self.result = None

    def _require_partition(self) -> None:
        if self.result is None:
            raise RuntimeError("GraphSession: no partition yet — call "
                               "partition(src, dst, V) or "
                               "with_partition(...) first")

    @property
    def num_vertices(self) -> int:
        if self._num_vertices is None:
            raise RuntimeError("GraphSession: no graph yet — call "
                               "partition(...) or with_partition(...)")
        return self._num_vertices

    @property
    def edges(self) -> tuple:
        """(src, dst) of the adopted edge stream."""
        if self._src is None:
            raise RuntimeError("GraphSession: no graph yet — call "
                               "partition(...) or with_partition(...)")
        return self._src, self._dst

    def snapshot(self) -> dict:
        """Host copies of the session's graph and partition (``src``,
        ``dst``, ``assign``): with ``to_json()`` and ``num_vertices``,
        what ``from_snapshot`` rebuilds the session from."""
        self._require_partition()
        return {"src": np.asarray(self._src).copy(),
                "dst": np.asarray(self._dst).copy(),
                "assign": np.asarray(self.result.assign).copy()}

    @classmethod
    def from_snapshot(cls, config_json: str, tree: dict, num_vertices: int,
                      *, device=None) -> "GraphSession":
        """A session from ``to_json()`` and ``snapshot()``: the same config
        blob, edges and assignment, with no partitioning."""
        sess = cls.from_json(config_json, device=device)
        return sess.with_partition(tree["src"], tree["dst"], num_vertices,
                                   tree["assign"])

    @property
    def assign(self) -> np.ndarray:
        self._require_partition()
        return self.result.assign

    @property
    def stats(self) -> dict:
        self._require_partition()
        return self.result.stats

    def layout(self) -> "GraphSession":
        """Build the vertex-cut tables for the current partition."""
        self._require_partition()
        self._layout = build_layout(
            self._src, self._dst, self.result.assign, self._num_vertices,
            self.k, self.cfg.pad_multiple)
        return self

    @property
    def partition_layout(self) -> PartitionLayout:
        if self._layout is None:
            self.layout()
        return self._layout

    def comm_bytes(self, programs=None, exchange: str | None = None,
                   fused: bool = False):
        """Modelled mirror-sync wire bytes per GAS iteration:
        ``comm_bytes()`` the table of every model; ``comm_bytes(exchange=
        name)`` one model; ``comm_bytes(programs=[...])`` rows ``{program:
        {exchange: bytes}}`` with each program's lossiness (min and
        integer programs ship exact on the quantized wires), narrowed to
        ``{program: bytes}`` by ``exchange=``; ``fused=True`` one fused
        step of the bundle on ``exchange`` (default: the session's)."""
        lay = self.partition_layout
        if programs is None:
            if fused:
                raise ValueError(
                    "comm_bytes(fused=True) needs programs=[...]")
            return lay.comm_bytes(exchange)
        if fused:
            bundle = fuse_programs(
                [resolve_program(p, self._num_vertices) for p in programs])
            lossy = lossy_payload(bundle.combine, bundle.dtype)
            return lay.comm_bytes(exchange or self.cfg.exchange,
                                  programs=len(bundle.programs),
                                  fused=True, lossy=lossy)
        table = {}
        for p in programs:
            prog = resolve_program(p, self._num_vertices)
            lossy = lossy_payload(prog.combine, prog.dtype)
            if exchange is None:
                table[prog.name] = {ex: lay.comm_bytes(ex, lossy=lossy)
                                    for ex in EXCHANGE_NAMES}
            else:
                table[prog.name] = lay.comm_bytes(exchange, lossy=lossy)
        return table

    def comm_bytes_programs(self, programs=PROGRAMS) -> dict:
        """Deprecated — use ``comm_bytes(programs=[...])``."""
        warnings.warn(
            "GraphSession.comm_bytes_programs is deprecated; use "
            "GraphSession.comm_bytes(programs=[...])",
            DeprecationWarning, stacklevel=2)
        return self.comm_bytes(programs=programs)

    def comm_bytes_fused(self, programs, exchange: str | None = None) -> int:
        """Deprecated — use ``comm_bytes(programs=[...], fused=True)``."""
        warnings.warn(
            "GraphSession.comm_bytes_fused is deprecated; use "
            "GraphSession.comm_bytes(programs=[...], fused=True)",
            DeprecationWarning, stacklevel=2)
        return self.comm_bytes(programs=programs, exchange=exchange,
                               fused=True)

    def run(self, program="pagerank", *, iters: int | None = None,
            exchange: str | None = None, mesh=None, axis: str = "parts",
            tol: float | None = None, overlap: bool = False,
            init_values=None, return_iters: bool = False):
        """Run a GAS program (name or ``GASProgram``) on the layout and
        return its dense (V,) master values, int64 for the integer
        programs.  ``mesh=None`` runs the stacked engine on the session's
        device; a graph mesh of k ranks runs one partition a rank
        (``graph.engine.shard_map_gas``), with the same values (bit for
        bit on the CPU).  ``tol`` makes ``iters`` a cap: the loop ends
        once the master residual max-norm drops to ``tol``
        (``return_iters=True`` also returns the iterations run);
        ``init_values`` warm-starts from a dense (V_old,) vector;
        ``overlap`` runs the overlapped body (ragged exchanges only)."""
        lay = self.partition_layout
        prog = resolve_program(program, self._num_vertices)
        iters = self.cfg.iters if iters is None else iters
        kw = dict(iters=iters, exchange=exchange or self.cfg.exchange,
                  tol=tol, overlap=overlap, init_values=init_values,
                  return_iters=True)
        out = (simulate_gas(prog, lay, device=self.device, **kw)
               if mesh is None else shard_map_gas(prog, lay, mesh,
                                                  axis=axis, **kw))
        if out is None:          # a rank other than 0 of a bound mesh
            return None
        out, iters_run = _as_int64(out[0]), out[1]
        return (out, iters_run) if return_iters else out

    def run_many(self, programs, *, iters: int | None = None,
                 exchange: str | None = None, mesh=None,
                 axis: str = "parts", tol: float | None = None,
                 overlap: bool = False, init_values=None,
                 return_iters: bool = False):
        """Run N programs of one (combine, dtype) cell as one fused GAS
        loop: one exchange per phase carries every program's lanes
        (``repro_torch.graph.engine.FusedGAS``).  Returns one dense (V,)
        array per program, in input order; ``mesh``, ``tol``,
        ``init_values`` (one dense vector or None per program),
        ``overlap`` and ``return_iters`` as in ``run``."""
        lay = self.partition_layout
        progs = [resolve_program(p, self._num_vertices) for p in programs]
        iters = self.cfg.iters if iters is None else iters
        kw = dict(iters=iters, exchange=exchange or self.cfg.exchange,
                  tol=tol, overlap=overlap, init_values=init_values,
                  return_iters=True)
        out = (simulate_gas_many(progs, lay, device=self.device, **kw)
               if mesh is None else shard_map_gas_many(progs, lay, mesh,
                                                       axis=axis, **kw))
        if out is None:          # a rank other than 0 of a bound mesh
            return None
        outs, iters_run = out
        outs = [_as_int64(o) for o in outs]
        return (outs, iters_run) if return_iters else outs

    def dryrun_step(self, program="pagerank", *, mesh, iters: int = 1,
                    exchange: str | None = None, axis: str = "parts",
                    overlap: bool = False):
        """One dry-run cell (``launch.dryrun --graph``): ``iters``
        iterations of ``program`` (a name or ``GASProgram``; a sequence of
        them runs the fused multi-program step) one partition a rank of
        ``mesh``, with ``overlap`` the interleaved ragged body.  Returns,
        on rank 0, (the values, every rank's report of the loop: its
        collective counts by call site, launches and wall seconds;
        ``graph.engine.gas_step_for_dryrun``); None on the other ranks of
        a bound mesh.  The reference returns a step to compile; the port
        compiles nothing, so it runs the step and counts."""
        lay = self.partition_layout
        if isinstance(program, (list, tuple)):
            prog = [resolve_program(p, self._num_vertices)
                    for p in program]
        else:
            prog = resolve_program(program, self._num_vertices)
        return gas_step_for_dryrun(prog, lay, mesh, axis=axis, iters=iters,
                                   exchange=exchange or self.cfg.exchange,
                                   overlap=overlap)
