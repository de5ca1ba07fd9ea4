"""Meshes of ranks (``repro.launch.mesh``, which ``launch.mesh``
re-exports).

    make_stream_mesh(n)   the sharded partitioner's n stream slices
                          (axis "stream", paper §III-C)
    make_graph_mesh(k)    the GAS engine's k partitions (axis "parts")
    make_test_mesh(n_data, n_model)
                          the LM's ("data", "model") mesh of the tests and
                          of ``chip_smoke.py``'s ``[lm-mesh]``
    make_mesh({name: ranks, ...})
                          any named axes (a pipeline's {"stage": S})
    make_production_mesh(multi_pod=)
                          the LM's (16, 16) ("data", "model") mesh, or
                          (2, 16, 16) ("pod", "data", "model"): a spec of
                          256 or 512 ranks that nothing here spawns
    simulate(mesh, coords)
                          one rank of a spec with no process group: the
                          dry mode's mesh (``collectives.dry``)
    run_on_ranks(fn, mesh, *args)
                          spawn the mesh's ranks in this machine and
                          return rank 0's ``fn(bound_mesh, *args)``

A ``Mesh`` names its axes, their sizes, the device kind of its ranks and
its transport.  Its ranks are laid out row-major over the axes, the last
fastest, as ``jax.make_mesh`` lays out devices: on a (2, 4) ("data",
"model") mesh rank 6 is data 1, model 2.  Made inside an initialized
process group whose size is the mesh's (a ``torchrun`` job, or a rank
``run_on_ranks`` started), it is bound: it holds the group, this rank
and the rank's device (``cuda:rank % device_count``, or the CPU when the
caller names it), and the drivers run SPMD on it.  A bound mesh of more
than one axis also holds one process group per axis line this rank lies
on (every rank makes every line's group, in one order), and
``as_axis(mesh, "model")`` is the bound one-axis view of this rank's
line along "model": the ``Mesh`` that ``dist.collectives`` takes.  Made
in a single process, a mesh is a spec the drivers hand to
``run_on_ranks``; ``simulate`` binds a spec to one of its ranks without
a process group (transport ``"dry"``, device ``meta``), the mesh the
dry mode of ``dist.collectives`` runs that rank's program on.

The transport is chosen, never guessed silently: ``nccl`` when every rank
has a card of its own, ``gloo`` when ranks share a card (NCCL refuses
two ranks on one device) or run on the CPU; on gloo the collectives
stage CUDA tensors to the host (``dist.collectives``).  A mesh's
``describe()`` names it, and the drivers' stats carry it.
"""
from __future__ import annotations

import itertools
import math
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
    """Named axes of ranks.  Bound (``rank`` set) inside a process group
    of ``size`` ranks; else a spec for ``run_on_ranks``.

    A one-axis mesh names its axis in ``axis`` (a string); a mesh of
    several axes names them all (a tuple) and gives their sizes in
    ``dims``.  ``group`` is the process group the mesh's collectives run
    on (None: the default group) and ``ranks`` the global ranks of its
    members in axis order (None: 0..size−1); a bound multi-axis mesh
    keeps, per axis, the group and ranks of this rank's line in
    ``lines``."""
    axis: str | tuple
    size: int
    kind: str = "cuda"           # the ranks' device kind: "cuda" | "cpu"
    transport: str = "gloo"      # "nccl" | "gloo" | "dry" (``simulate``)
    rank: int | None = None      # this rank's index in the mesh
    group: Any = None
    device: torch.device | None = None
    dims: tuple = ()             # ranks along each axis (multi-axis)
    ranks: tuple | None = None
    lines: tuple = ()            # bound multi-axis: (group, ranks) per axis

    @property
    def bound(self) -> bool:
        return self.rank is not None

    @property
    def axes(self) -> tuple:
        return self.axis if isinstance(self.axis, tuple) else (self.axis,)

    @property
    def shape(self) -> dict:
        """{axis: ranks along it}, in axis order (jax's ``mesh.shape``)."""
        return dict(zip(self.axes, self.dims or (self.size,)))

    @property
    def coords(self) -> dict:
        """This rank's {axis: index along it} (row-major, last fastest)."""
        out, r = {}, self.rank
        for name, n in reversed(list(self.shape.items())):
            out[name] = r % n
            r //= n
        return dict(reversed(list(out.items())))

    def describe(self) -> dict:
        out = {"axis": self.axis, "ranks": self.size, "device": self.kind,
               "transport": self.transport}
        if len(self.axes) > 1:
            out["shape"] = self.shape
        return out


def _bind(mesh: Mesh, rank: int) -> Mesh:
    dev = torch.device("cpu") if mesh.kind == "cpu" else \
        torch.device("cuda", rank % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return replace(mesh, rank=rank, group=None, device=dev)


def axis_lines(shape: dict, axis: str) -> list[list[int]]:
    """The global ranks of every line of ``shape`` along ``axis`` (each in
    axis order), lines in row-major order of the other axes."""
    names, dims = list(shape), list(shape.values())
    i = names.index(axis)
    strides = [math.prod(dims[j + 1:]) for j in range(len(dims))]
    others = [j for j in range(len(dims)) if j != i]
    lines = []
    for rest in itertools.product(*(range(dims[j]) for j in others)):
        base = sum(c * strides[j] for c, j in zip(rest, others))
        lines.append([base + c * strides[i] for c in range(dims[i])])
    return lines


def _bind_lines(mesh: Mesh) -> Mesh:
    """A bound multi-axis mesh's per-axis groups: every rank makes every
    line's group, axis by axis, in one order (``new_group`` is collective
    over the whole group), and keeps the lines it lies on."""
    if len(mesh.axes) == 1:
        return mesh
    mine = []
    for name in mesh.axes:
        for members in axis_lines(mesh.shape, name):
            g = coll.new_group(members, GROUP_TIMEOUT_S)
            if mesh.rank in members:
                mine.append((g, tuple(members)))
    return replace(mesh, lines=tuple(mine))


def _make(axes: tuple, dims: tuple, device) -> Mesh:
    if any(n < 1 for n in dims):
        raise ValueError(f"a mesh needs at least one rank an axis, got "
                         f"{dict(zip(axes, dims))}")
    kind = _resolve_kind(device)
    n = math.prod(dims)
    axis = axes[0] if len(axes) == 1 else tuple(axes)
    spec_dims = () if len(axes) == 1 else tuple(dims)
    w = coll.world()
    if w is not None:
        rank, size, backend = w
        if size != n:
            raise ValueError(f"the initialized process group has {size} "
                             f"ranks; a {dict(zip(axes, dims))} mesh needs "
                             f"{n}")
        return _bind_lines(_bind(Mesh(axis, n, kind, backend,
                                      dims=spec_dims), rank))
    return Mesh(axis, n, kind, choose_transport(n, kind), dims=spec_dims)


def make_mesh(shape: dict, *, device=None) -> Mesh:
    """A mesh of named axes, ``{name: ranks}`` in axis order (the
    counterpart of ``jax.make_mesh``; ``{"stage": 4}`` is a pipeline's)."""
    return _make(tuple(shape), tuple(shape.values()), device)


def make_stream_mesh(n: int, *, device=None) -> Mesh:
    """The sharded partitioner's mesh: n stream slices on one flat axis
    (``core.partitioner`` ``backend="sharded"``, paper §III-C)."""
    return make_mesh({"stream": n}, device=device)


def make_graph_mesh(k: int, *, device=None) -> Mesh:
    """The graph engine's mesh: k partitions on one flat axis."""
    return make_mesh({"parts": k}, device=device)


def make_test_mesh(n_data: int = 2, n_model: int = 4, *,
                   device=None) -> Mesh:
    """The LM's small ("data", "model") mesh (the reference's is 8 host
    devices in its multidevice tests; here ``run_on_ranks`` spawns
    n_data · n_model ranks)."""
    return make_mesh({"data": n_data, "model": n_model}, device=device)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The LM's production mesh: (16, 16) over ("data", "model"), or
    (2, 16, 16) over ("pod", "data", "model") with ``multi_pod``.  From a
    single process a spec of 256 or 512 ranks (nothing here spawns it)."""
    if multi_pod:
        return make_mesh({"pod": 2, "data": 16, "model": 16}, device=device)
    return make_mesh({"data": 16, "model": 16}, device=device)


def simulate(mesh: Mesh, coords) -> Mesh:
    """The rank of ``mesh``'s axes at ``coords`` (``{axis: index}``, or
    its row-major rank number) bound with no process group: transport
    ``"dry"``, device ``meta``, and per axis this rank's line (its
    members, no group), so ``as_axis``, ``use_rules`` and the placements
    take it as they take a bound mesh.  ``mesh`` is a spec, or a bound
    mesh whose shape is taken (a rank checking itself).  Only
    ``collectives.dry`` runs collectives on it."""
    if isinstance(coords, int):
        rank = coords
    else:
        if set(coords) != set(mesh.shape):
            raise ValueError(f"coordinates {coords} do not name the axes "
                             f"of {mesh.shape}")
        rank = 0
        for name, n in mesh.shape.items():
            if not 0 <= coords[name] < n:
                raise ValueError(f"{name} {coords[name]} outside 0..{n - 1}")
            rank = rank * n + coords[name]
    if not 0 <= rank < mesh.size:
        raise ValueError(f"rank {rank} outside a mesh of {mesh.size}")
    dry = replace(mesh, transport=coll.DRY, rank=rank, group=None,
                  device=torch.device("meta"), ranks=None, lines=())
    if len(mesh.axes) == 1:
        return dry
    return replace(dry, lines=tuple(
        (None, tuple(next(m for m in axis_lines(mesh.shape, name)
                          if rank in m))) for name in mesh.axes))


def as_axis(mesh: Mesh, axis: str) -> Mesh:
    """The one-axis mesh a driver runs on.  A one-axis mesh is renamed
    ``axis``.  A multi-axis mesh gives its axis ``axis``: bound, the view
    of this rank's line along it (its group, its ranks, this rank's index
    on it); a spec, that axis alone."""
    if len(mesh.axes) == 1:
        return mesh if mesh.axis == axis else replace(mesh, axis=axis)
    if axis not in mesh.axes:
        raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
    n = mesh.shape[axis]
    if not mesh.bound:
        return Mesh(axis, n, mesh.kind, mesh.transport)
    i = mesh.axes.index(axis)
    group, members = mesh.lines[i]
    return Mesh(axis, n, mesh.kind, mesh.transport,
                rank=mesh.coords[axis], group=group, device=mesh.device,
                ranks=members)


def line_mesh(mesh: Mesh, axis: str, index: int = 0) -> Mesh | None:
    """The ``index``-th line of a bound multi-axis mesh along ``axis``
    (``axis_lines``' order) as a mesh of its own: ``axis`` at its size on
    the line's group, every other axis of size 1 on a one-rank group;
    its whole-mesh collectives run on the line's group.  None on a rank
    off the line.  Every rank of ``mesh`` calls it, in one order: it
    makes one group a rank of the line (``new_group`` is collective)."""
    members = axis_lines(mesh.shape, axis)[index]
    singles = [coll.new_group([r], GROUP_TIMEOUT_S) for r in members]
    if mesh.rank not in members:
        return None
    line = as_axis(mesh, axis)
    single = (singles[line.rank], (mesh.rank,))
    return replace(mesh, size=line.size, rank=line.rank, group=line.group,
                   ranks=line.ranks,
                   dims=tuple(line.size if a == axis else 1
                              for a in mesh.axes),
                   lines=tuple((line.group, line.ranks) if a == axis
                               else single for a in mesh.axes))


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
        bound = _bind_lines(bound)
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
