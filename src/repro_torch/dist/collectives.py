"""Named-axis collectives — the one door ``torch.distributed`` goes through.

Port of ``repro.dist.collectives``.  Every ``torch.distributed`` call of
the port is in this module: the process group's set-up and tear-down,
the axis-wide reductions the shared stage and engine bodies call
(``psum``, ``pmax``, ``pmin``, ``axis_index``; each the identity when
``axis`` is None, so one body serves one device and a mesh), the two
wire primitives of the mirror exchanges (``all_to_all`` over equal lanes
and ``ring_hop`` to rank ± d), the gathers to rank 0 and the broadcasts
from a root (a copy of blocks one rank holds, ``broadcast``).  The lint's
RAW-COLLECTIVE rule (``python -m repro_torch.analysis``) holds that no
other module of the port calls ``torch.distributed``.

``axis`` is a bound one-axis ``dist.mesh.Mesh`` (its process group, its
members' global ranks, this rank's index on it, size, device and
transport): a whole mesh of one axis, the whole of a multi-axis mesh
over the default group, or ``as_axis(mesh, name)``'s view of one line.  On the ``gloo`` transport a CUDA tensor is
staged to the host before the call and back after it; ``nccl`` takes
device tensors as they are.  Float sums are made deterministic: the
ranks' values are gathered and added in rank order (16-bit floats in
f32, rounded once), so every rank gets the same bits.  int32/int64 sums and extrema are exact in any order and
go through ``all_reduce``.

``reduce_scatter`` is the rank-order sum's 1/n slice: an ``all_to_all``
of 1/n slices, then each rank adds its slice's n parts in rank order
(the same adds, so the same bits, as that slice of ``psum``).  The
autograd forms (``psum_grad``, ``copy_grad``, ``all_gather_grad``,
``reduce_scatter_grad``, ``slice_grad``) carry a gradient through the
tensor-parallel and ZeRO points of ``models``: each backward is chosen
by what the ranks do with the output downstream.  Where every rank uses
it alike (the replicated residual stream, the loss), a sum's backward is
the identity and a gather's the rank's own slice; where the ranks use
different parts of it (their q heads, the KV heads they read, their
columns of a product fed by a replicated input, their batch rows), a
gather's backward is a reduce-scatter and an identity's a sum.  A
backward call counts at its forward's site with ``.grad`` appended.

Each call counts, by its call site, the bytes it hands to other ranks
(``all_to_all``: the lanes addressed to the other ranks — the self block
stays home; ``ring_hop``: the whole payload; ``all_gather`` and a
gathered sum: the payload once for each other rank; an ``all_reduce``:
its payload), its wall seconds and its calls, by primitive too (the
graph dry-run reads a ring's hops as ``ring_hop`` calls; each call
counts under the primitive the caller named, ``psum`` for a gathered
sum, ``reduce_scatter`` for its ``all_to_all``);
``counts()`` reads them, ``reset_counts()`` zeroes them.  The counts
live in the process, one set a rank.

The dry mode (``dry(mesh, coords)``) runs one rank of a mesh with no
process group and nothing on a wire: inside it the mesh is the rank's
``dist.mesh.simulate`` view (transport ``"dry"``, device ``meta``), and
every primitive given one of its axes moves nothing, returns a meta
tensor of the shape and dtype the real call returns on that rank, and
counts the bytes the real call would hand to the other ranks, by the
same byte rules (the transport call is the one thing skipped), into a
count set of its own, the calling thread's alone.  The picklable object
calls (``gather_objects``, ``broadcast_objects``) refuse it.
"""
from __future__ import annotations

import threading
import time
from collections import Counter
from contextlib import contextmanager
from datetime import timedelta

import torch
import torch.distributed as dist

DRY = "dry"         # the transport of a dry mesh: nothing moves


class _Counts:
    """One set of counts: bytes, seconds and calls by site; calls and
    bytes by (site, primitive)."""

    def __init__(self):
        self.bytes, self.seconds, self.calls = Counter(), Counter(), Counter()
        self.ops, self.op_bytes = Counter(), Counter()


_live = _Counts()          # the process's counts: every real call's
_dry = threading.local()   # a thread's dry mode: its own counts


# ------------------------------------------------------------ the group

def init_group(backend: str, store_path: str, rank: int, size: int,
               timeout_s: float) -> None:
    """Join the default process group through a ``FileStore`` at
    ``store_path``; every collective of the group raises after
    ``timeout_s`` seconds instead of waiting for a lost rank forever."""
    store = dist.FileStore(store_path, size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=size,
                            timeout=timedelta(seconds=timeout_s))


def new_group(ranks: list, timeout_s: float):
    """A process group of the global ``ranks`` (a mesh axis's line).
    Collective over the default group: every rank calls it for every
    group, in the same order, whether it is a member or not."""
    return dist.new_group(ranks, timeout=timedelta(seconds=timeout_s))


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def world() -> tuple | None:
    """(rank, size, backend) of the initialized default group, or None."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.get_rank(), dist.get_world_size(), dist.get_backend()


def nccl_available() -> bool:
    return dist.is_available() and dist.is_nccl_available()


# ------------------------------------------------------------ counting

def _current() -> _Counts:
    """The counts this thread's calls go to: its dry mode's, else the
    process's."""
    return getattr(_dry, "counts", None) or _live


def reset_counts() -> None:
    global _live
    if getattr(_dry, "counts", None) is not None:
        _dry.counts = _Counts()
    else:
        _live = _Counts()


def counts() -> dict:
    """``{site: {"bytes", "seconds", "calls", "ops", "op_bytes"}}`` since
    the last reset; ``ops`` splits the calls by primitive (``{"ring_hop":
    n}``) and ``op_bytes`` the bytes."""
    c = _current()
    return {s: {"bytes": int(c.bytes[s]), "seconds": float(c.seconds[s]),
                "calls": int(c.calls[s]),
                "ops": {op: int(n) for (site, op), n in c.ops.items()
                        if site == s},
                "op_bytes": {op: int(n) for (site, op), n in
                             c.op_bytes.items() if site == s}}
            for s in c.calls}


@contextmanager
def dry(mesh, coords):
    """Run as the rank at ``coords`` (``{axis: index}``, or a rank number)
    of ``mesh`` (a spec, or a bound mesh whose shape is taken) on the meta
    device (module docstring): yields that rank's dry mesh
    (``dist.mesh.simulate``), every call in this thread counted into a
    fresh set that ``counts()`` and ``reset_counts()`` act on inside the
    context.  Other threads keep counting into the process's counts, so a
    rank may run its dry twin beside its real work."""
    from .mesh import simulate
    saved = getattr(_dry, "counts", None)
    _dry.counts = _Counts()
    try:
        yield simulate(mesh, coords)
    finally:
        _dry.counts = saved


def _moves(axis) -> bool:
    """Whether a call on ``axis`` goes on the wire (False on a dry mesh,
    which only the dry mode may use)."""
    if axis.transport != DRY:
        return True
    if getattr(_dry, "counts", None) is None:
        raise RuntimeError("a dry mesh's collectives run only inside "
                           "collectives.dry(...)")
    return False


class _Timed:
    """Counts one call: its bytes and its wall seconds (the device is
    synchronized on both sides on an NCCL mesh, whose calls return
    before the device is done)."""

    def __init__(self, axis, site: str, nbytes: int, op: str):
        self.axis, self.site, self.nbytes, self.op = axis, site, nbytes, op

    def __enter__(self):
        self._sync()
        self.t = time.perf_counter()

    def __exit__(self, *exc):
        self._sync()
        c = _current()
        c.seconds[self.site] += time.perf_counter() - self.t
        c.bytes[self.site] += self.nbytes
        c.calls[self.site] += 1
        c.ops[self.site, self.op] += 1
        c.op_bytes[self.site, self.op] += self.nbytes

    def _sync(self):
        if self.axis.transport == "nccl":
            torch.cuda.synchronize(self.axis.device)


def _global(axis, i: int) -> int:
    """The global rank of member ``i`` of ``axis``'s group (point-to-point
    peers and roots are named by global rank)."""
    return i if axis.ranks is None else axis.ranks[i]


def _host(axis, x):
    """The tensor the transport takes: gloo stages CUDA tensors to the
    host."""
    x = x.contiguous()
    if axis.transport == "gloo" and x.is_cuda:
        return x.cpu()
    return x


# ----------------------------------------------------------- reductions

def psum(x, axis=None, *, site: str = "psum"):
    """Sum ``x`` across ``axis``; identity when ``axis`` is None.  int32
    and int64 tensors go through ``all_reduce`` (exact in any order);
    every other dtype (floats, and int16, which neither transport
    reduces) is gathered and added in rank order, deterministic on every
    rank; bf16 and f16 are added in f32 and rounded once."""
    if axis is None:
        return x
    if x.dtype in (torch.int32, torch.int64):
        return _all_reduce(x, axis, dist.ReduceOp.SUM, site, "psum")
    parts = _all_gather(x, axis, site, "psum")
    wide = x.dtype in (torch.bfloat16, torch.float16)
    out = parts[0].float() if wide else parts[0]
    for p in parts[1:]:      # in rank order: the same bits on every rank
        out = out + p
    return out.to(x.dtype) if wide else out


def _all_reduce(x, axis, op, site, name):
    """``all_reduce`` of ``x`` over ``axis`` (its payload counted once),
    counted as primitive ``name``."""
    with _Timed(axis, site, x.numel() * x.element_size(), name):
        out = _host(axis, x.reshape(-1)).clone()
        if _moves(axis):
            dist.all_reduce(out, op=op, group=axis.group)
    return out.to(x.device).reshape(x.shape)


def pmax(x, axis=None, *, site: str = "pmax"):
    """Max of ``x`` across ``axis``; identity when ``axis`` is None."""
    if axis is None:
        return x
    return _all_reduce(x, axis, dist.ReduceOp.MAX, site, "pmax")


def pmin(x, axis=None, *, site: str = "pmin"):
    """Min of ``x`` across ``axis``; identity when ``axis`` is None."""
    if axis is None:
        return x
    return _all_reduce(x, axis, dist.ReduceOp.MIN, site, "pmin")


def axis_index(axis) -> int:
    """This rank's position along ``axis`` (0 when unbound)."""
    return 0 if axis is None else axis.rank


def over_axes(values: list, axes: list, op, *, site: str) -> list:
    """``op`` (``psum`` or ``pmax``) of each of ``values`` over its bound
    axes (``axes[i]``, applied in order; none: the value as it is), in one
    call an axis for the values that share their axes: those travel
    flattened and joined, and come back in their own shapes."""
    groups: dict = {}
    for i, ax in enumerate(axes):
        if ax:
            groups.setdefault(tuple(a.axis for a in ax), (ax, []))[1] \
                .append(i)
    out = list(values)
    for ax, idx in groups.values():
        flat = torch.cat([values[i].reshape(-1) for i in idx])
        for a in ax:
            flat = op(flat, a, site=site)
        at = 0
        for i in idx:
            n = values[i].numel()
            out[i] = flat[at:at + n].reshape(values[i].shape)
            at += n
    return out


# --------------------------------------------------------------- wires

def _as_bytes(x):
    """(n, ...) → (n, bytes a lane) uint8 view: one transport path for
    every dtype (bool and fp16 included)."""
    flat = x.contiguous().reshape(x.shape[0], -1)
    return flat.view(torch.uint8) if flat.dtype != torch.uint8 else flat


def all_to_all(x, axis, *, site: str):
    """Equal lanes: ``x`` (n, ...) sends ``x[q]`` to rank q; returns
    (n, ...) with row p what rank p addressed to this rank."""
    n = axis.size
    if x.shape[0] != n:
        raise ValueError(f"all_to_all: leading dim {x.shape[0]} != axis "
                         f"size {n}")
    return _all_to_all(x, axis, site, "all_to_all")


def _all_to_all(x, axis, site, name):
    raw = _as_bytes(x)
    with _Timed(axis, site, raw.shape[1] * (axis.size - 1), name):
        h = _host(axis, raw)
        out = torch.empty_like(h)
        if _moves(axis):
            dist.all_to_all_single(out, h, group=axis.group)
    return out.to(x.device).view(x.dtype).reshape(x.shape)


def ring_hop(x, axis, d: int, *, site: str):
    """Send ``x`` to rank (r + d) mod n and return what rank (r − d) mod n
    sent here (the ring's hop at distance d; every rank calls it with
    the same d and shape)."""
    n, r = axis.size, axis.rank
    if d % n == 0:
        return x.clone()
    raw = _as_bytes(x[None])
    with _Timed(axis, site, raw.numel(), "ring_hop"):
        h = _host(axis, raw)
        out = torch.empty_like(h)
        if _moves(axis):
            ops = [dist.P2POp(dist.isend, h, _global(axis, (r + d) % n),
                              axis.group),
                   dist.P2POp(dist.irecv, out, _global(axis, (r - d) % n),
                              axis.group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return out.to(x.device).view(x.dtype).reshape(x.shape)


def all_gather(x, axis, *, site: str):
    """(n, *x.shape): every rank's ``x`` in rank order."""
    return _all_gather(x, axis, site, "all_gather")


def _all_gather(x, axis, site, name):
    raw = _as_bytes(x[None])
    with _Timed(axis, site, raw.numel() * (axis.size - 1), name):
        h = _host(axis, raw)
        parts = [torch.empty_like(h) for _ in range(axis.size)]
        if _moves(axis):
            dist.all_gather(parts, h, group=axis.group)
        out = torch.cat(parts)
    return out.to(x.device).view(x.dtype).reshape(axis.size, *x.shape)


def gather_to_root(x, axis, *, site: str):
    """(n, *x.shape) on rank 0 (every rank's ``x`` in rank order), None on
    the others."""
    raw = _as_bytes(x[None])
    root = axis.rank == 0
    with _Timed(axis, site, 0 if root else raw.numel(), "gather_to_root"):
        h = _host(axis, raw)
        parts = [torch.empty_like(h) for _ in range(axis.size)] \
            if root else None
        if _moves(axis):
            dist.gather(h, parts, dst=_global(axis, 0), group=axis.group)
    if not root:
        return None
    return torch.cat(parts).to(x.device).view(x.dtype) \
        .reshape(axis.size, *x.shape)


def _objects(axis):
    if axis.transport == DRY:
        raise RuntimeError("a dry mesh moves no Python objects: their "
                           "values are the other ranks'")


def gather_objects(obj, axis) -> list | None:
    """Every rank's picklable ``obj`` on rank 0, in rank order; None on
    the others."""
    _objects(axis)
    out = [None] * axis.size if axis.rank == 0 else None
    dist.gather_object(obj, out, dst=_global(axis, 0), group=axis.group)
    return out


def broadcast(x, axis, root: int = 0, *, site: str):
    """Rank ``root``'s ``x`` written into ``x`` on every other rank of
    ``axis`` (each passes a tensor of its shape and dtype, whose values
    are overwritten); returns ``x``.  Root's payload counts once for each
    other rank."""
    raw = _as_bytes(x[None])
    nbytes = raw.numel() * (axis.size - 1) if axis.rank == root else 0
    with _Timed(axis, site, nbytes, "broadcast"):
        h = _host(axis, raw)
        if _moves(axis):
            dist.broadcast(h, src=_global(axis, root), group=axis.group)
    if axis.rank != root:
        x.copy_(h.to(x.device).view(x.dtype).reshape(x.shape))
    return x


def broadcast_objects(obj, axis, root: int = 0):
    """Rank ``root``'s picklable ``obj`` on every rank of ``axis``."""
    _objects(axis)
    box = [obj]
    dist.broadcast_object_list(box, src=_global(axis, root),
                               group=axis.group)
    return box[0]


def reduce_scatter(x, axis, dim: int = 0, *, site: str):
    """This rank's 1/n slice along ``dim`` of the sum of every rank's
    ``x`` over ``axis``: an ``all_to_all`` of the n slices, then the n
    parts of this rank's slice added in rank order (16-bit floats in f32,
    rounded once) — the same adds, so the same bits on every rank, as
    that slice of ``psum``.  ``x`` itself when ``axis`` is None."""
    if axis is None:
        return x
    n = axis.size
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    m = x.shape[dim] // n
    lanes = x.movedim(dim, 0).reshape(n, m, *x.shape[:dim],
                                      *x.shape[dim + 1:])
    parts = _all_to_all(lanes, axis, site, "reduce_scatter")
    wide = x.dtype in (torch.bfloat16, torch.float16)
    out = parts[0].float() if wide else parts[0]
    for p in parts[1:]:      # in rank order: the same bits on every rank
        out = out + p
    out = out.to(x.dtype) if wide else out
    return out.movedim(0, dim)


def _cat_parts(parts, dim: int):
    """(n, ...) every rank's block → the blocks joined along ``dim`` in
    rank order."""
    return torch.cat(list(parts.unbind(0)), dim)


def _own_slice(x, axis, dim: int):
    n = x.shape[dim] // axis.size
    return x.narrow(dim, axis.rank * n, n)


class _PsumGrad(torch.autograd.Function):
    """Forward ``psum``; backward the identity: every rank uses the sum
    alike and takes the gradient of its own part."""

    @staticmethod
    def forward(ctx, x, axis, site):
        return psum(x, axis, site=site)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _CopyGrad(torch.autograd.Function):
    """Forward the identity; backward ``psum``: the ranks use different
    parts of a replicated value, each gradient is a partial one."""

    @staticmethod
    def forward(ctx, x, axis, site):
        ctx.axis, ctx.site = axis, site
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.axis, site=ctx.site + ".grad"), None, None


class _AllGatherGrad(torch.autograd.Function):
    """Forward every rank's block joined along ``dim``; backward a
    reduce-scatter along it (the ranks use different parts), or this
    rank's own slice (``alike``: every rank uses the whole the same
    way)."""

    @staticmethod
    def forward(ctx, x, axis, dim, site, alike):
        ctx.axis, ctx.dim, ctx.site, ctx.alike = axis, dim, site, alike
        return _cat_parts(all_gather(x, axis, site=site), dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.alike:
            g = _own_slice(g, ctx.axis, ctx.dim)
        else:
            g = reduce_scatter(g.contiguous(), ctx.axis, ctx.dim,
                               site=ctx.site + ".grad")
        return g, None, None, None, None


class _ReduceScatterGrad(torch.autograd.Function):
    """Forward ``reduce_scatter``; backward the blocks' gradients gathered
    (each rank's part of the sum feeds every rank's slice)."""

    @staticmethod
    def forward(ctx, x, axis, dim, site):
        ctx.axis, ctx.dim, ctx.site = axis, dim, site
        return reduce_scatter(x, axis, dim, site=site)

    @staticmethod
    def backward(ctx, g):
        parts = all_gather(g.contiguous(), ctx.axis, site=ctx.site + ".grad")
        return _cat_parts(parts, ctx.dim), None, None, None


class _SliceGrad(torch.autograd.Function):
    """Forward this rank's 1/n slice of a replicated tensor along ``dim``;
    backward every rank's slice gradient gathered, so the whole
    gradient is on every rank."""

    @staticmethod
    def forward(ctx, x, axis, dim, site):
        ctx.axis, ctx.dim, ctx.site = axis, dim, site
        return _own_slice(x, axis, dim).clone()

    @staticmethod
    def backward(ctx, g):
        parts = all_gather(g.contiguous(), ctx.axis, site=ctx.site + ".grad")
        return _cat_parts(parts, ctx.dim), None, None, None


def psum_grad(x, axis=None, *, site: str = "psum"):
    """``psum`` whose backward is the identity (every rank uses the sum
    alike); ``x`` when ``axis`` is None."""
    return x if axis is None else _PsumGrad.apply(x, axis, site)


def copy_grad(x, axis=None, *, site: str):
    """``x``, whose gradient is summed over ``axis`` (the ranks use
    different parts of it downstream); ``x`` when ``axis`` is None."""
    return x if axis is None else _CopyGrad.apply(x, axis, site)


def all_gather_grad(x, axis=None, dim: int = 0, *, site: str,
                    alike: bool = False):
    """Every rank's ``x`` joined along ``dim`` in rank order; the backward
    reduce-scatters, or keeps this rank's slice when every rank uses the
    whole ``alike``.  ``x`` when ``axis`` is None."""
    if axis is None:
        return x
    return _AllGatherGrad.apply(x, axis, dim % x.dim(), site, alike)


def reduce_scatter_grad(x, axis=None, dim: int = 0, *, site: str):
    """``reduce_scatter`` with its backward (an all-gather)."""
    if axis is None:
        return x
    return _ReduceScatterGrad.apply(x, axis, dim % x.dim(), site)


def slice_grad(x, axis=None, dim: int = 0, *, site: str):
    """This rank's 1/n slice of a tensor whole on every rank, its gradient
    gathered back whole; ``x`` when ``axis`` is None."""
    if axis is None:
        return x
    return _SliceGrad.apply(x, axis, dim % x.dim(), site)
