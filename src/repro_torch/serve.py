"""Partitioning as a service: a long-lived graph server over GraphSession
(port of ``repro.serve``).

``GraphServer`` keeps a partitioned graph and its vertex-cut
``PartitionLayout`` resident and answers queries against them:

- **Queries** (``submit``/``step``/``result``): vertex scores of any GAS
  program of the library, component or propagation labels, 1-hop
  neighborhoods, and the partition that owns a vertex.  ``step`` drains
  one microbatch from an in-process queue, groups the score queries that
  share a (combine, dtype, exchange) cell, runs each group as one fused
  ``run_many`` and scatters the replies.  Computed (V,) vectors are
  cached per (program, exchange) until the graph changes.
- **Live ingestion** (``ingest``): arrivals buffer into a window; a full
  window is assigned against the resident partition
  (``core.stages.incremental_assign``: one Alg. 1 pass on T, seeded with
  the loads the partition already carries) and the layout is rebuilt and
  swapped between microbatches.  When the replication factor drifts past
  ``rf_watermark`` × its baseline, a prioritized restream
  (``core.stages.restream_assign``) repairs it and resets the baseline.
- **Preemption survival** (``checkpoint``/``resume``): the session's
  ``snapshot()`` and config blob go through ``dist.ft.ServiceFT``'s
  atomic, shape-blind checkpoints; a server killed and resumed from the
  same directory has the identical config and assignment.

The launcher (``repro_torch.launch.serve_graph``) calls ``step`` in a
loop.  The server runs where its session runs; with ``mesh`` (a graph
mesh of k ranks) each fused query step runs one partition a rank
(``GraphSession.run_many(mesh=)``; from a single process every step
spawns the ranks anew).  On
the card the float sums of pagerank use float atomics, so its replies
repeat within f32 rounding, not bit for bit (the integer programs are
exact).
"""
from __future__ import annotations

import dataclasses
import queue
import time
from typing import Any

import numpy as np

from .core.stages import incremental_assign, restream_assign
from .graph.engine import check_graph_mesh
from .session import GraphSession, resolve_program

QUERY_KINDS = ("score", "label", "neighbors", "owner")
# per-kind default program: "label" reads the min-combine label programs
# (cc components by default), "score" the float rank programs
DEFAULT_PROGRAM = {"score": "pagerank", "label": "cc"}


@dataclasses.dataclass
class Reply:
    ticket: int
    kind: str
    value: Any = None
    error: str | None = None


class GraphServer:
    """A resident ``GraphSession`` behind a microbatched request queue.

    ``session`` must already hold a partition (``partition(...)`` or
    ``with_partition(...)``).  ``mesh`` (axis size == k) makes every fused
    query step run one partition a rank; ``mesh=None`` runs the stacked
    engine on the session's device — the same replies (bit for bit on
    the CPU).  ``ft`` (a ``dist.ft.ServiceFT``) enables
    ``checkpoint``/``resume`` and the microbatch straggler watch.

    ``swap_log`` records every layout swap: its event (``window`` or
    ``restream``), the wall seconds of the assignment
    (``incremental_assign`` or ``restream_assign``), of adopting it
    (``with_partition``: RF and balance on the host) and of the layout
    rebuild, the grown stream's edges and largest partition load, and for
    a restream its RF trace (the RF before each pass).
    """

    def __init__(self, session: GraphSession, *, max_batch: int = 64,
                 window: int = 4096, rf_watermark: float = 1.05,
                 restream_passes: int = 2, iters: int | None = None,
                 tol: float | None = None, mesh=None, ft=None):
        session._require_partition()
        if mesh is not None:
            check_graph_mesh(mesh, session.k)
        self.sess = session
        self.max_batch = int(max_batch)
        self.window = int(window)
        self.rf_watermark = float(rf_watermark)
        self.restream_passes = int(restream_passes)
        self.iters = iters
        # tol switches queries to the early-exit loop (iters becomes a cap)
        # and turns the value caches into warm-start state: after a swap
        # the previous fixed point seeds the rerun
        self.tol = tol
        self.mesh = mesh
        self.ft = ft
        self._queue: queue.Queue = queue.Queue()
        self._replies: dict[int, Reply] = {}
        self._next_ticket = 0
        self._ckpt_step = -1
        self._values: dict = {}     # (program, exchange) -> dense (V,)
        self._warm: dict = {}       # pre-swap fixed points (same keys)
        self.last_iters_run: dict = {}   # wire cell -> executed iters
        self._csr = None            # (indptr, neighbors) over both dirs
        self._owner_of = None       # (V,) master partition per vertex
        self._buf_src: list = []
        self._buf_dst: list = []
        self._buffered = 0
        self.rf_base = self._rf_now()
        self.rf_trace: list = [("start", self.rf_base)]
        self.swap_log: list = []
        self.stats = {"queries": 0, "microbatches": 0, "ingested_edges": 0,
                      "windows": 0, "restreams": 0, "stragglers": 0}

    # ---------------------------------------------------------- queries

    def submit(self, kind: str, *, program=None, vertices=None,
               exchange: str | None = None) -> int:
        """Enqueue a request; returns a ticket for ``result``.

        ``score``/``label`` take a program (name or GASProgram) and
        optional vertex ids (None = the full dense vector);
        ``neighbors``/``owner`` require vertex ids."""
        if kind not in QUERY_KINDS:
            raise ValueError(f"unknown query kind {kind!r}; expected one "
                             f"of {QUERY_KINDS}")
        if kind in ("neighbors", "owner") and vertices is None:
            raise ValueError(f"{kind!r} queries need vertices=")
        if program is None:
            program = DEFAULT_PROGRAM.get(kind)
        ticket = self._next_ticket
        self._next_ticket += 1
        verts = None if vertices is None else np.atleast_1d(
            np.asarray(vertices))
        self._queue.put((ticket, kind, program, verts, exchange))
        return ticket

    def result(self, ticket: int) -> Reply | None:
        """Pop the reply for ``ticket`` (None while still queued)."""
        return self._replies.pop(ticket, None)

    def pending(self) -> int:
        return self._queue.qsize()

    def step(self) -> int:
        """Serve one microbatch: drain up to ``max_batch`` requests,
        compute every missing score vector (one fused ``run_many`` per
        (combine, dtype, exchange) cell) and scatter the replies.  Returns
        the number of requests served (0 = the queue was empty)."""
        batch = []
        while len(batch) < self.max_batch:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        if not batch:
            return 0
        t0 = time.perf_counter()
        self._ensure_host_tables()
        needed: dict = {}
        resolved = []
        for ticket, kind, program, verts, exchange in batch:
            key = None
            if kind in ("score", "label"):
                try:
                    prog = resolve_program(program, self.sess.num_vertices)
                except ValueError as e:
                    self._replies[ticket] = Reply(ticket, kind,
                                                  error=str(e))
                    continue
                ex = exchange or self.sess.cfg.exchange
                key = (prog.name, ex)
                if key not in self._values:
                    needed[key] = (prog, ex)
            resolved.append((ticket, kind, key, verts))
        cells: dict = {}
        for key, (prog, ex) in needed.items():
            cell = (prog.combine, str(prog.dtype).removeprefix("torch."), ex)
            cells.setdefault(cell, []).append(prog)
        for cell, progs in cells.items():
            ex = cell[2]
            if self.tol is None:
                outs = self.sess.run_many(progs, iters=self.iters,
                                          exchange=ex, mesh=self.mesh)
            else:
                # always explicit init_values: a program with no cached
                # fixed point ships an empty vector, which the engine maps
                # to the program's init (a cold start)
                seeds = [self._warm.get((p.name, ex), np.zeros(0))
                         for p in progs]
                outs, iters_run = self.sess.run_many(
                    progs, iters=self.iters, exchange=ex, mesh=self.mesh,
                    tol=self.tol, init_values=seeds, return_iters=True)
                self.last_iters_run[cell] = int(iters_run)
            for prog, out in zip(progs, outs):
                self._values[(prog.name, ex)] = out
        for ticket, kind, key, verts in resolved:
            try:
                self._replies[ticket] = Reply(
                    ticket, kind, value=self._answer(kind, key, verts))
            except Exception as e:  # noqa: BLE001 — the request's reply
                self._replies[ticket] = Reply(ticket, kind, error=str(e))
        dt = time.perf_counter() - t0
        if self.ft is not None and self.ft.watch.observe(dt):
            self.stats["stragglers"] += 1
        self.stats["microbatches"] += 1
        self.stats["queries"] += len(batch)
        return len(batch)

    def serve_pending(self) -> int:
        """Drain the whole queue, microbatch by microbatch."""
        total = 0
        while True:
            n = self.step()
            if n == 0:
                return total
            total += n

    def _answer(self, kind: str, key, verts):
        if kind in ("score", "label"):
            vals = self._values[key]
            return vals.copy() if verts is None else vals[verts]
        if kind == "owner":
            return self._owner_of[verts]
        indptr, nbrs = self._csr                    # neighbors
        return [np.unique(nbrs[indptr[int(v)]:indptr[int(v) + 1]])
                for v in verts]

    def _ensure_host_tables(self):
        if self._csr is None:
            src, dst = self.sess.edges
            n = self.sess.num_vertices
            ends = np.concatenate([src, dst]).astype(np.int64)
            nbrs = np.concatenate([dst, src]).astype(np.int64)
            order = np.argsort(ends, kind="stable")
            indptr = np.zeros(n + 1, np.int64)
            indptr[1:] = np.bincount(ends, minlength=n).cumsum()
            self._csr = (indptr, nbrs[order])
        if self._owner_of is None:
            lay = self.sess.partition_layout
            own = np.zeros(self.sess.num_vertices, np.int32)
            for p in range(lay.k):
                own[lay.vert_gid[p][lay.is_master[p]]] = p
            self._owner_of = own

    # ---------------------------------------------------------- ingest

    def ingest(self, src, dst) -> bool:
        """Buffer live edge arrivals; once a full ``window`` has
        accumulated, flush it.  Returns True when a flush happened."""
        src = np.atleast_1d(np.asarray(src))
        dst = np.atleast_1d(np.asarray(dst))
        if src.shape != dst.shape:
            raise ValueError("ingest: src/dst length mismatch")
        self._buf_src.append(src)
        self._buf_dst.append(dst)
        self._buffered += src.shape[0]
        self.stats["ingested_edges"] += src.shape[0]
        if self._buffered >= self.window:
            self.flush_window()
            return True
        return False

    def flush_window(self) -> bool:
        """Assign the buffered window against the resident partition and
        swap the grown graph in: one pass over the window only, the
        resident assignment untouched, the balance cap covering the grown
        stream.  Past the RF watermark this triggers a restream."""
        if self._buffered == 0:
            return False
        ws = np.concatenate(self._buf_src)
        wd = np.concatenate(self._buf_dst)
        self._buf_src, self._buf_dst, self._buffered = [], [], 0
        src, dst = self.sess.edges
        assign = self.sess.assign
        nv = int(max(self.sess.num_vertices,
                     ws.max(initial=-1) + 1, wd.max(initial=-1) + 1))
        t = time.perf_counter()
        wa = incremental_assign(src, dst, ws, wd, assign, nv,
                                self.sess.cfg.clugp, device=self.sess.device)
        self._swap("window", time.perf_counter() - t,
                   np.concatenate([src, ws]), np.concatenate([dst, wd]),
                   np.concatenate([assign, wa]), nv)
        self.stats["windows"] += 1
        rf_now = self._rf_now()
        self.rf_trace.append(("window", rf_now))
        if rf_now > self.rf_watermark * self.rf_base:
            self.restream()
        return True

    def restream(self, passes: int | None = None) -> tuple:
        """Repair drift: a prioritized restream of the whole resident
        stream seeded by the current assignment, then swap and reset the
        RF baseline.  Returns the RF trace before each pass."""
        src, dst = self.sess.edges
        t = time.perf_counter()
        new_assign, trace = restream_assign(
            src, dst, self.sess.assign, self.sess.num_vertices,
            self.sess.cfg.clugp,
            passes=self.restream_passes if passes is None else passes,
            device=self.sess.device)
        self._swap("restream", time.perf_counter() - t, src, dst,
                   new_assign, self.sess.num_vertices, trace=list(trace))
        self.stats["restreams"] += 1
        self.rf_base = self._rf_now()
        self.rf_trace.append(("restream", self.rf_base))
        return trace

    def _swap(self, event: str, assign_s: float, src, dst, assign,
              num_vertices: int, **extra):
        # serving is single-threaded, so a microbatch only ever sees
        # the layout fully rebuilt and the caches freshly invalidated
        t0 = time.perf_counter()
        self.sess.with_partition(src, dst, num_vertices, assign)
        t1 = time.perf_counter()
        self.sess.layout()
        t2 = time.perf_counter()
        self.swap_log.append({"event": event, "assign": assign_s,
                              "stats": t1 - t0, "layout": t2 - t1,
                              "edges": int(len(src)),
                              "max_load": max(self.sess.stats["sizes"]),
                              **extra})
        # the outgoing vectors become warm-start seeds for the grown graph
        # (dense (V,) by gid, so they survive the remap; new vertices fall
        # back to the program's init)
        self._warm.update(self._values)
        self._values.clear()
        self._csr = None
        self._owner_of = None

    def _rf_now(self) -> float:
        # the session's stats hold metrics.replication_factor of its
        # current assignment (computed when it was adopted)
        return float(self.sess.stats["rf"])

    # ------------------------------------------------------ preemption

    def checkpoint(self, step: int | None = None) -> int:
        """Snapshot graph, partition and config through ``ServiceFT``
        (atomic write; async if the ft was built so)."""
        if self.ft is None:
            raise RuntimeError("GraphServer: no ServiceFT attached; pass "
                               "ft= to enable checkpointing")
        if step is None:
            step = self._ckpt_step + 1
        self._ckpt_step = step
        extra = {"config": self.sess.to_json(),
                 "num_vertices": self.sess.num_vertices,
                 "rf_base": self.rf_base}
        self.ft.snapshot(step, self.sess.snapshot(), extra=extra)
        return step

    @classmethod
    def resume(cls, ft, *, device=None, **kw) -> "GraphServer":
        """A server from the newest intact ``ServiceFT`` snapshot: the
        identical config blob, edges and edge → partition assignment (no
        partitioning), on ``device`` (the card unless named)."""
        flat, extra, step = ft.restore_latest()
        if flat is None:
            raise FileNotFoundError(
                f"no snapshot under {ft.ckpt_dir!r} to resume from")
        sess = GraphSession.from_snapshot(extra["config"], flat,
                                          int(extra["num_vertices"]),
                                          device=device)
        srv = cls(sess, ft=ft, **kw)
        srv.rf_base = float(extra.get("rf_base", srv.rf_base))
        srv._ckpt_step = step
        return srv
