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
counterpart of the reference's ``"jit"`` backend; ``with_partition``
adopts an external edge → partition assignment instead, and
``snapshot``/``from_snapshot`` carry graph and partition across a
restart (``repro_torch.serve``).  ``run`` takes any of ``PROGRAMS`` (the
``repro_torch.graph.engine`` library) or a ``GASProgram``, over any of
the five ``EXCHANGES``, on one device (the reference's ``mesh`` is not
ported); ``overlap=True`` runs the overlapped body on the ragged ones.
``comm_bytes`` is the modelled wire bytes of an iteration.
"""
from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass

import numpy as np

from .core import metrics
from .core.partitioner import BACKENDS, partition, resolve_device
from .core.pipeline import CLUGPConfig, CLUGPResult
from .dist.halo import EXCHANGE_NAMES, lossy_payload
from .graph.engine import (GASProgram, PROGRAM_NAMES, fuse_programs,
                           get_program, simulate_gas, simulate_gas_many)
from .graph.partition import PartitionLayout, build_layout

EXCHANGES = EXCHANGE_NAMES
PROGRAMS = PROGRAM_NAMES


def resolve_program(program, num_vertices: int) -> GASProgram:
    """Name → library GASProgram (a GASProgram passes through)."""
    if isinstance(program, GASProgram):
        return program
    return get_program(program, num_vertices)


def _check_one_device(mesh) -> None:
    if mesh is not None:
        raise ValueError("mesh= is not ported yet (ROADMAP, Queue 1: the "
                         "sharded partitioner and the multi-GPU engine); "
                         "run on one device with mesh=None")


def _as_int64(out):
    return out.astype(np.int64) if np.issubdtype(out.dtype, np.integer) \
        else out


@dataclass(frozen=True)
class SessionConfig:
    """Everything a reproducible partition → layout → GAS run needs;
    round-trips through ``to_json``/``from_json``."""
    clugp: CLUGPConfig
    backend: str = "torch"     # partitioner strategy
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
                                device=self.device)
        return self

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
            exchange: str | None = None, mesh=None, tol: float | None = None,
            overlap: bool = False, init_values=None,
            return_iters: bool = False):
        """Run a GAS program (name or ``GASProgram``) on the layout and
        return its dense (V,) master values, int64 for the integer
        programs.  ``tol`` makes ``iters`` a cap: the loop ends once the
        master residual max-norm drops to ``tol`` (``return_iters=True``
        also returns the iterations run); ``init_values`` warm-starts from
        a dense (V_old,) vector; ``overlap`` runs the overlapped body
        (ragged exchanges only)."""
        _check_one_device(mesh)
        lay = self.partition_layout
        prog = resolve_program(program, self._num_vertices)
        iters = self.cfg.iters if iters is None else iters
        out = simulate_gas(prog, lay, iters=iters,
                           exchange=exchange or self.cfg.exchange, tol=tol,
                           overlap=overlap, init_values=init_values,
                           return_iters=True, device=self.device)
        out, iters_run = _as_int64(out[0]), out[1]
        return (out, iters_run) if return_iters else out

    def run_many(self, programs, *, iters: int | None = None,
                 exchange: str | None = None, mesh=None,
                 tol: float | None = None, overlap: bool = False,
                 init_values=None, return_iters: bool = False):
        """Run N programs of one (combine, dtype) cell as one fused GAS
        loop: one exchange per phase carries every program's lanes
        (``repro_torch.graph.engine.FusedGAS``).  Returns one dense (V,)
        array per program, in input order; ``tol``, ``init_values`` (one
        dense vector or None per program), ``overlap`` and
        ``return_iters`` as in ``run``."""
        _check_one_device(mesh)
        lay = self.partition_layout
        progs = [resolve_program(p, self._num_vertices) for p in programs]
        iters = self.cfg.iters if iters is None else iters
        outs, iters_run = simulate_gas_many(
            progs, lay, iters=iters, exchange=exchange or self.cfg.exchange,
            tol=tol, overlap=overlap, init_values=init_values,
            return_iters=True, device=self.device)
        outs = [_as_int64(o) for o in outs]
        return (outs, iters_run) if return_iters else outs
