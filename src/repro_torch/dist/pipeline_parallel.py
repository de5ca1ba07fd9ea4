"""GPipe-style pipeline parallelism over a named "stage" axis of ranks
(port of ``repro.dist.pipeline_parallel``).

``pipeline_apply`` runs S stages, one a rank of the axis, and streams M
microbatches through the ring: at tick t stage s works on microbatch
t − s, so the pipeline fills in S − 1 ticks and drains in S − 1, M + S − 1
ticks in all against M · S in sequence.  Each tick is one hop of the ring
(``collectives.ring_hop(x, axis, 1)``): stage s receives stage s − 1's
output of the tick before, stage 0 takes the next microbatch instead, and
the last stage writes its output into microbatch t − (S − 1)'s slot.  The
outputs are made whole on every rank by the reference's sum of
zeros-plus-one-writer (exact).  A stage whose tick holds no microbatch
(the fill and the drain) computes nothing; the reference computes on a
clipped input and throws the result away, so the outputs are the same.
``reference_apply`` is the single-device oracle.

Parameters follow the port's per-layer idiom: a sequence of the S
stages' parameter trees instead of one tree stacked on a leading stage
dim; a rank reads only its own stage's entry (the others may be None, so
a rank never holds another stage's weights).
"""
from __future__ import annotations

import torch

from . import collectives as coll
from .mesh import as_axis


def reference_apply(stage_params, xs, fn):
    """Every microbatch through all stages in order: ``stage_params`` the
    S stages' trees, xs (M, mb, ...), ``fn(x, stage_tree)`` → x.  Returns
    (M, mb, ...)."""
    out = []
    for x in xs:
        for p in stage_params:
            x = fn(x, p)
        out.append(x)
    return torch.stack(out)


def pipeline_apply(mesh, axis: str, stage_params, xs, fn):
    """Run ``fn`` as an S-stage pipeline on ``mesh``'s ``axis`` (bound;
    S = the axis's size, stage = this rank's index on it).
    ``stage_params[stage]`` is this rank's tree; xs (M, mb, ...) are whole
    on every rank (stage 0 takes them in order).  Returns the last stage's
    (M, mb, ...) outputs, whole on every rank."""
    ax = as_axis(mesh, axis)
    S, stage = ax.size, ax.rank
    if len(stage_params) != S:
        raise ValueError(f"{len(stage_params)} stages for an axis of {S}")
    p_local = stage_params[stage]
    M = xs.shape[0]
    state = torch.zeros_like(xs[0])
    outputs = torch.zeros_like(xs)
    for t in range(M + S - 1):
        prev = coll.ring_hop(state, ax, 1, site="pipeline.hop")
        mb = t - stage                    # this stage's microbatch
        if 0 <= mb < M:
            state = fn(xs[t] if stage == 0 else prev, p_local)
            if stage == S - 1:
                outputs[mb] = state
    # only the last stage wrote: the sum of its buffer and zeros
    return coll.psum(outputs, ax, site="pipeline.out")
