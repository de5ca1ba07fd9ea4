"""Named-axis sharding rules (logical tags → mesh axes): port of
``repro.dist.sharding``.

Model code never names mesh axes; it tags each dim of an array with a
logical name ("batch", "seq", "heads", "kv_heads", "kv_heads_sharded",
"vocab", "experts", "sp_seq", "stage", or None) and the rule table made
active by ``use_rules(rules, mesh)`` decides which mesh axis, if any,
each tag lands on.  ``resolve_spec`` is that decision, a pure function:
per dim it looks the tag up, drops axes the mesh lacks, axes an earlier
dim took and axes whose product does not divide the dim (replicated
instead), and returns a plain tuple, one entry a dim: None, an axis name
or a tuple of names — the reference's ``PartitionSpec`` as a tuple.

PyTorch has no GSPMD to turn a constraint into communication, so on a
bound mesh ``shard(x, *tags)`` is the one move that needs none: ``x``
whole on every rank → this rank's block of it under the resolved spec
(a replicated value constrained to a sharded layout).  The collectives a
compiler would insert at the reference's other ``shard`` points are
explicit calls through ``dist.collectives`` where the model code makes
them (``models.lm``'s docstring lists them); ``unshard`` is the
converse of ``shard``, an all-gather along each sharded dim.  Outside
any ``use_rules`` context ``shard`` is the identity, so single-device
code and the tests' oracles run unchanged.

Rule tables: ``SINGLE_POD_RULES`` (DP × TP on ("data", "model"): batch
on data; heads, experts and vocab on model; decode caches sharded by
sequence on model), ``MULTI_POD_RULES`` (the same with the batch over
("pod", "data")), ``PARTITIONER_RULES`` (the edge stream) and
``CP_SERVE_RULES`` (context-parallel serving: the sequence on model,
heads replicated).
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch

from . import collectives as coll
from .mesh import as_axis

SINGLE_POD_RULES: dict = {
    "batch": "data",
    "seq": None,                      # sequence replicated in TP train
    "heads": "model",
    "kv_heads": None,                 # GQA KV replicated (cheap all-gather)
    "kv_heads_sharded": "model",      # when kv_heads divide the mesh
    "vocab": "model",
    "experts": "model",
    "sp_seq": "model",                # decode caches: sequence-parallel
    "stage": None,
}

MULTI_POD_RULES: dict = {**SINGLE_POD_RULES, "batch": ("pod", "data")}

# the partitioner's edge stream: one contiguous stream slice per rank
# along a flat "stream" axis (core.partitioner, paper §III-C)
PARTITIONER_RULES: dict = {
    "stream": "stream",
    "vertex": None,                   # vertex state replicated per node
}

CP_SERVE_RULES: dict = {
    **SINGLE_POD_RULES,
    "seq": "model",                   # context parallelism
    "heads": None,
    "kv_heads_sharded": None,
    "sp_seq": "model",
}

_state = threading.local()


def _stack() -> list:
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


@contextmanager
def use_rules(rules: dict, mesh):
    """Activate ``rules`` over ``mesh`` (a ``dist.mesh.Mesh``) for every
    ``shard`` call and every model entry point in scope, in this thread
    (re-entrant; the innermost context wins)."""
    _stack().append((rules, mesh))
    try:
        yield
    finally:
        _stack().pop()


def active_rules():
    """(rules, mesh) of the innermost ``use_rules`` context, or None."""
    stack = _stack()
    return stack[-1] if stack else None


def resolve_spec(shape: tuple, tags: tuple, rules: dict,
                 axis_sizes: dict) -> tuple:
    """Pure tag → spec resolution: per dim look the tag up in ``rules``;
    drop axes absent from ``axis_sizes``, axes already used by an earlier
    dim, and axes whose product does not divide the dim (replicate
    instead)."""
    if len(tags) != len(shape):
        raise ValueError(f"{len(tags)} tags {tags} for shape {shape}")
    used: set = set()
    entries = []
    for dim, tag in zip(shape, tags):
        ax = rules.get(tag) if tag is not None else None
        if ax is None:
            entries.append(None)
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        axes = tuple(a for a in axes if a in axis_sizes and a not in used)
        size = math.prod(axis_sizes[a] for a in axes)
        if not axes or dim % size != 0:
            entries.append(None)
            continue
        used.update(axes)
        entries.append(axes if len(axes) > 1 else axes[0])
    return tuple(entries)


def active_spec(shape: tuple, *tags) -> tuple:
    """``resolve_spec`` of ``shape`` under the active rules and mesh; all
    None outside any context."""
    ctx = active_rules()
    if ctx is None:
        return (None,) * len(shape)
    rules, mesh = ctx
    return resolve_spec(tuple(shape), tags, rules, mesh.shape)


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    return () if entry is None else (
        entry if isinstance(entry, tuple) else (entry,))


def block(x: torch.Tensor, spec: tuple, mesh) -> torch.Tensor:
    """This rank's block of ``x`` (whole) on the bound ``mesh`` under
    ``spec``: along a dim sharded over axes (a, b, ...) the block at the
    row-major index of this rank's coordinates on them (a major), as a
    ``PartitionSpec`` lays it out.  A view, no copy."""
    shape, coords = mesh.shape, mesh.coords
    idx = []
    for dim, entry in zip(x.shape, spec):
        axes = entry_axes(entry)
        n, c = 1, 0
        for a in axes:
            n, c = n * shape[a], c * shape[a] + coords[a]
        if dim % n:
            raise ValueError(f"dim {dim} does not split over {axes}")
        size = dim // n
        idx.append(slice(c * size, (c + 1) * size))
    return x[tuple(idx)]


def unshard(x: torch.Tensor, spec: tuple, mesh, *,
            site: str = "unshard") -> torch.Tensor:
    """The whole array from every rank's block ``x`` under ``spec`` on the
    bound ``mesh``: an all-gather along each sharded dim (its axes from
    the innermost out, so a tuple of axes comes back in row-major
    order).  Every rank gets the same tensor."""
    for d, entry in enumerate(spec):
        for a in reversed(entry_axes(entry)):
            parts = coll.all_gather(x, as_axis(mesh, a), site=site)
            x = torch.cat(list(parts.unbind(0)), d)
    return x


def shard(x: torch.Tensor, *tags) -> torch.Tensor:
    """``x`` under the active rule table: the identity when no
    ``use_rules`` context is active; inside one, ``x`` is whole on every
    rank and this rank's block of it comes back.  One tag per dim."""
    ctx = active_rules()
    if ctx is None:
        return x
    rules, mesh = ctx
    spec = resolve_spec(tuple(x.shape), tags, rules, mesh.shape)
    if all(mesh.shape[a] == 1 for e in spec for a in entry_axes(e)):
        return x
    if not mesh.bound:
        raise ValueError("shard needs a bound mesh (inside a rank)")
    return block(x, spec, mesh)
