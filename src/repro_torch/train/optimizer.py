"""Optimizers (port of ``repro.train.optimizer``): AdamW and factored
Adafactor, no ``torch.optim``.

``Optimizer.update(grads, state, params, step) → (params, state)`` is a
function, as the reference's is: it returns new parameter and state trees
and leaves its arguments as they were.  The state mirrors the port's
parameter tree (nested dicts, and lists of per-layer dicts for the layer
groups); Adafactor's holds a dict per leaf (``{"vr", "vc"}`` when the
leaf is factored, ``{"v"}`` when not).

The step, the schedule, the bias corrections and Adafactor's decay are f32
tensors on the parameters' device, so they round as the reference's f32
arrays do (a Python float divisor on CUDA is a multiply by its
reciprocal).

Where the two differ: the reference stacks a layer group's leaves on a
leading layer axis, so Adafactor's update clip takes the RMS of the
update over the whole group; here each layer's leaf is its own (the
clip of the Adafactor paper, per matrix).  With one layer a group, and
for AdamW (elementwise) always, the two are the same function.

On a mesh each leaf is a rank's block.  ``init`` and ``update`` then take
``axes`` (``train.shardings.leaf_axes``: per leaf, per dim, the bound
axes that cut it): AdamW is elementwise and ignores them; Adafactor
decides whether a leaf is factored by its whole shape, and sums every
term of its means (g²'s row and column means, the row factor's mean,
the update's RMS) over the axes that cut the dims it averages, in rank
order, before dividing by the whole count — so every rank takes its
block of the one update.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch

from ..dist import collectives as coll
from ..tree import tree_leaves, tree_map, tree_unflatten

F32 = torch.float32


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable
    update: Callable   # (grads, state, params, step) -> (params, state)


def _as_step(step, device=None):
    """``step`` (an int or a tensor) as an f32 0-d tensor on ``device``."""
    if isinstance(step, torch.Tensor):
        return step.to(device=device or step.device, dtype=F32)
    return torch.full((), float(step), dtype=F32, device=device)


def _div(x, d: int):
    """x / d as a true division on x's device (see the module
    docstring)."""
    return x / torch.full((), float(d), dtype=F32, device=x.device)


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """lr(step) as an f32 0-d tensor: linear warmup from 0 over
    ``warmup`` steps, then a half cosine to 0 at ``total``."""
    def lr(step):
        step = _as_step(step)
        warm = _div(base_lr * step, max(warmup, 1))
        prog = torch.clamp(_div(step - warmup, max(total - warmup, 1)), 0.0,
                           1.0)
        cos = base_lr * 0.5 * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def _leaves_up_to(struct, tree) -> list:
    """``tree``'s subtrees at the positions of ``struct``'s leaves (a leaf's
    state may itself be a dict)."""
    if isinstance(struct, dict):
        return [x for k in struct for x in _leaves_up_to(struct[k], tree[k])]
    if isinstance(struct, list):
        return [x for s, t in zip(struct, tree) for x in _leaves_up_to(s, t)]
    return [tree]


def _map_leaves(fn, grads, *rest):
    """``fn(g, *r)`` per leaf of ``grads``, where the ``rest`` trees are
    flattened up to grads' structure; ``fn`` returns a tuple, and each of
    its positions comes back as a tree of grads' structure."""
    rest_leaves = [_leaves_up_to(grads, r) for r in rest]
    out = [fn(g, *(r[i] for r in rest_leaves))
           for i, g in enumerate(tree_leaves(grads))]
    return tuple(tree_unflatten(grads, [o[j] for o in out])
                 for j in range(len(out[0])))


def _device(tree):
    return tree_leaves(tree)[0].device


def _whole_shape(x, axes) -> tuple:
    """The whole leaf's shape from its block ``x`` and the axes that cut
    each dim (``axes`` None: ``x`` is whole)."""
    if axes is None:
        return tuple(x.shape)
    return tuple(d * math.prod(a.size for a in ax)
                 for d, ax in zip(x.shape, axes))


def _mean(x, dims: tuple, axes):
    """The mean of the whole leaf over ``dims`` from its block ``x``: the
    block's sum summed over the axes that cut those dims (in rank order),
    over the whole count; ``x.mean(dims)`` where no axis cuts them."""
    cut = [] if axes is None else [a for d in dims for a in axes[d]]
    if not cut:
        return x.mean() if len(dims) == x.dim() else x.mean(dims)
    total = x.sum(dims)
    for a in cut:
        total = coll.psum(total, a, site="opt.mean")
    whole = _whole_shape(x, axes)
    return _div(total, math.prod(whole[d] for d in dims))


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
          schedule=None):
    """AdamW with bias corrections; weight decay on every leaf, as in the
    reference."""
    sched = schedule or (lambda s: lr)

    def init(params, axes=None):
        def z(p):
            return torch.zeros(p.shape, dtype=F32, device=p.device)
        return {"m": tree_map(z, params), "v": tree_map(z, params)}

    def update(grads, state, params, step, axes=None):
        step = _as_step(step, _device(params))
        stepf = step + 1.0
        lr_t = sched(step)
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf

        def upd(g, m, v, p):
            g = g.to(F32)
            m2 = b1 * m + (1 - b1) * g
            v2 = b2 * v + (1 - b2) * g * g
            delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps) \
                + weight_decay * p.to(F32)
            return (p.to(F32) - lr_t * delta).to(p.dtype), m2, v2

        p2, m2, v2 = _map_leaves(upd, grads, state["m"], state["v"], params)
        return p2, {"m": m2, "v": v2}

    return Optimizer("adamw", init, update)


def adafactor(lr=1e-2, decay=0.8, eps=1e-30, clip_rms=1.0,
              min_factor_dim=128, weight_decay=0.0, schedule=None):
    """Factored second-moment Adafactor (β1 = 0, Shazeer & Stern 2018): a
    leaf whose two trailing dims are both ≥ ``min_factor_dim`` keeps row
    and column means of g², any other leaf the full g²."""
    sched = schedule or (lambda s: lr)

    def factored(shape):
        return len(shape) >= 2 and shape[-1] >= min_factor_dim \
            and shape[-2] >= min_factor_dim

    def init(params, axes=None):
        def z(p, ax=None):
            def zeros(shape):
                return torch.zeros(shape, dtype=F32, device=p.device)
            if factored(_whole_shape(p, ax)):
                return {"vr": zeros(p.shape[:-1]),
                        "vc": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}
        if axes is None:
            return {"f": tree_map(z, params)}
        return {"f": tree_unflatten(params, [
            z(p, ax) for p, ax in zip(tree_leaves(params),
                                      tree_leaves(axes))])}

    def update(grads, state, params, step, axes=None):
        step = _as_step(step, _device(params))
        stepf = step + 1.0
        lr_t = sched(step)
        beta = 1.0 - stepf ** (-decay)

        def upd(g, f, p, ax):
            g = g.to(F32)
            g2 = g * g + eps
            if "vr" in f:
                vr = beta * f["vr"] + (1 - beta) * _mean(g2, (-1,), ax)
                vc = beta * f["vc"] + (1 - beta) * _mean(g2, (-2,), ax)
                row = _mean(vr, (-1,), None if ax is None else ax[:-1])
                denom = vr[..., None] * vc[..., None, :] \
                    / torch.clamp(row[..., None, None], min=eps)
                u = g * torch.rsqrt(denom + eps)
                f2 = {"vr": vr, "vc": vc}
            else:
                v = beta * f["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                f2 = {"v": v}
            rms = torch.sqrt(_mean(u * u, tuple(range(u.dim())), ax) + eps)
            u = u / torch.clamp(rms / clip_rms, min=1.0)
            if weight_decay:
                u = u + weight_decay * p.to(F32)
            return (p.to(F32) - lr_t * u).to(p.dtype), f2

        axes_tree = axes if axes is not None else tree_map(
            lambda _g: None, grads)
        p2, f2 = _map_leaves(upd, grads, state["f"], params, axes_tree)
        return p2, {"f": f2}

    return Optimizer("adafactor", init, update)


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"adamw": adamw, "adafactor": adafactor}[name](**kw)
