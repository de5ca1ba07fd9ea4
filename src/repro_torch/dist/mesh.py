"""Meshes of ranks (the graph half of ``repro.launch.mesh``, which
``launch.mesh`` re-exports).

    make_stream_mesh(n)   the sharded partitioner's n stream slices
                          (axis "stream", paper §III-C)
    make_graph_mesh(k)    the GAS engine's k partitions (axis "parts")
    run_on_ranks(fn, mesh, *args)
                          spawn the mesh's ranks in this machine and
                          return rank 0's ``fn(bound_mesh, *args)``

A ``Mesh`` names its axis, its size, the device kind of its ranks and
its transport.  Made inside an initialized process group whose size is
the mesh's (a ``torchrun`` job, or a rank ``run_on_ranks`` started), it
is bound: it holds the group, this rank and the rank's device
(``cuda:rank % device_count``, or the CPU when the caller names it), and
the drivers run SPMD on it.  Made in a single process, it is a spec the
drivers hand to ``run_on_ranks``.

The transport is chosen, never guessed silently: ``nccl`` when every rank
has a card of its own, ``gloo`` when ranks share a card (NCCL refuses
two ranks on one device) or run on the CPU; on gloo the collectives
stage CUDA tensors to the host (``dist.collectives``).  A mesh's
``describe()`` names it, and the drivers' stats carry it.

``make_production_mesh`` and ``make_test_mesh`` (the LM half) are not
ported yet.
"""
from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, replace
from typing import Any

import torch
import torch.multiprocessing as mp

from . import collectives as coll

# a collective that waits longer than this raises in every rank still
# waiting, so a rank that died takes its peers down with it
GROUP_TIMEOUT_S = 300.0


def _resolve_kind(device) -> str:
    """The ranks' device kind: the card unless the caller names another
    device; with no card and no explicit device it raises."""
    if device is not None:
        return torch.device(device).type
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                           "to run the ranks on the CPU")
    return "cuda"


def choose_transport(size: int, kind: str) -> str:
    """``nccl`` when each of ``size`` ranks has a card of its own, else
    ``gloo``."""
    if kind == "cuda" and coll.nccl_available() \
            and size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


@dataclass(frozen=True)
class Mesh:
    """One flat axis of ranks.  Bound (``group`` set) inside a process
    group of ``size`` ranks; else a spec for ``run_on_ranks``."""
    axis: str
    size: int
    kind: str = "cuda"           # the ranks' device kind: "cuda" | "cpu"
    transport: str = "gloo"      # "nccl" | "gloo"
    rank: int | None = None
    group: Any = None            # the ranks' process group; None = default
    device: torch.device | None = None

    @property
    def bound(self) -> bool:
        return self.rank is not None

    def describe(self) -> dict:
        return {"axis": self.axis, "ranks": self.size, "device": self.kind,
                "transport": self.transport}


def _bind(mesh: Mesh, rank: int) -> Mesh:
    dev = torch.device("cpu") if mesh.kind == "cpu" else \
        torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return replace(mesh, rank=rank, group=None, device=dev)


def _make(axis: str, n: int, device) -> Mesh:
    if n < 1:
        raise ValueError(f"a mesh needs at least one rank, got {n}")
    kind = _resolve_kind(device)
    w = coll.world()
    if w is not None:
        rank, size, backend = w
        if size != n:
            raise ValueError(f"the initialized process group has {size} "
                             f"ranks; a {axis!r} mesh of {n} needs {n}")
        return _bind(Mesh(axis, n, kind, backend), rank)
    return Mesh(axis, n, kind, choose_transport(n, kind))


def make_stream_mesh(n: int, *, device=None) -> Mesh:
    """The sharded partitioner's mesh: n stream slices on one flat axis
    (``core.partitioner`` ``backend="sharded"``, paper §III-C)."""
    return _make("stream", n, device)


def make_graph_mesh(k: int, *, device=None) -> Mesh:
    """The graph engine's mesh: k partitions on one flat axis."""
    return _make("parts", k, device)


def as_axis(mesh: Mesh, axis: str) -> Mesh:
    """``mesh`` under the driver's axis name."""
    return mesh if mesh.axis == axis else replace(mesh, axis=axis)


# ------------------------------------------------------------- spawning

def _rank_main(rank, mesh, store, job, results, threads):
    """One spawned rank: take its job (``fn`` and its arguments) from the
    parent, join the group, run ``fn``, report to the parent (rank 0's
    result, any rank's traceback)."""
    try:
        fn, args = job.recv()
        job.close()
        torch.set_num_threads(threads)
        bound = _bind(mesh, rank)       # NCCL wants the device set first
        coll.init_group(mesh.transport, store, rank, mesh.size,
                        GROUP_TIMEOUT_S)
        out = fn(bound, *args)
        # by value: the queue's own pickler would pass a tensor's storage
        # as a handle this process must still serve after it has exited
        results.put((rank, "ok", pickle.dumps(out) if rank == 0 else None))
    except BaseException:   # noqa: BLE001 — reported, then the rank exits
        results.put((rank, "error", traceback.format_exc()))
        raise
    finally:
        coll.destroy_group()


def run_on_ranks(fn, mesh: Mesh, *args, rank_args=None,
                 timeout: float = 900.0):
    """Spawn ``mesh.size`` ranks in this machine (``spawn`` start method,
    rendezvous through a ``FileStore`` in a fresh temporary directory, so
    concurrent runs never share an address) and return rank 0's
    ``fn(bound_mesh, *args, *rank_args[rank])``.  ``fn`` and its
    arguments are pickled.  A rank that raises, dies or outlasts
    ``timeout`` seconds stops every rank and raises here with its
    traceback."""
    if mesh.bound:
        raise ValueError("run_on_ranks takes a mesh spec, not a bound mesh")
    n = mesh.size
    rank_args = [()] * n if rank_args is None else list(rank_args)
    if len(rank_args) != n:
        raise ValueError(f"rank_args has {len(rank_args)} entries for "
                         f"{n} ranks")
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    results = ctx.Queue()
    threads = max(1, (os.cpu_count() or 1) // n)
    pipes = [ctx.Pipe(duplex=False) for _ in range(n)]
    procs = [ctx.Process(target=_rank_main,
                         args=(r, mesh, os.path.join(tmp, "store"),
                               pipes[r][0], results, threads), daemon=True)
             for r in range(n)]
    try:
        for p, (recv, _) in zip(procs, pipes):
            p.start()
            recv.close()         # the child's copy stays; a dead child
            #                      breaks the pipe instead of blocking us
        # the jobs go out once every rank is starting: a large argument
        # in the spawn itself would hold each start until that child had
        # booted, one after another
        for r, (_, send) in enumerate(pipes):
            try:
                send.send((fn, tuple(args) + tuple(rank_args[r])))
            except BrokenPipeError:
                raise RuntimeError(f"rank {r} died before taking its job "
                                   f"(exit code {procs[r].exitcode})") \
                    from None
            finally:
                send.close()
        out = _collect(procs, results, n, time.monotonic() + timeout)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _failures(results, rank, payload) -> str:
    """The first failure's traceback, then those of the peers it took
    down (reported within a grace period)."""
    lines = [f"rank {rank} failed:\n{payload}"]
    end = time.monotonic() + 2.0
    while time.monotonic() < end:
        try:
            r, status, more = results.get(timeout=0.2)
        except queue.Empty:
            continue
        if status == "error":
            lines.append(f"rank {r} failed too:\n{more}")
    return "\n".join(lines)


def _collect(procs, results, n, deadline):
    """Rank 0's result once every rank reported ``ok``; the first
    failure raises."""
    done, out = set(), None
    while len(done) < n:
        try:
            rank, status, payload = results.get(timeout=0.2)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs)
                    if r not in done and p.exitcode not in (None, 0)]
            if dead:
                try:   # its traceback may still be in flight
                    rank, status, payload = results.get(timeout=2.0)
                except queue.Empty:
                    raise RuntimeError(
                        f"rank {dead[0]} died with exit code "
                        f"{procs[dead[0]].exitcode} and no report") from None
            elif time.monotonic() > deadline:
                raise TimeoutError(f"ranks {sorted(set(range(n)) - done)} "
                                   "did not finish in time")
            else:
                continue
        if status == "error":
            raise RuntimeError(_failures(results, rank, payload))
        done.add(rank)
        if rank == 0:
            out = pickle.loads(payload)
    return out
