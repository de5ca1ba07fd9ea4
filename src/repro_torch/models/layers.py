"""Building blocks of the LM stack (port of ``repro.models.layers``).

Parameters are nested dicts of tensors, as in the reference; every layer
is an ``*_init`` / apply pair.  ``*_init`` draws from an explicit
``torch.Generator`` (the reference's ``jax.random`` keys give other
numbers; tests carry the reference's weights across with
``repro_torch.convert.lm_params_from_reference``).  Weights are
(d_in, d_out), applied as ``x @ w``.

The tensor-parallel halves (``models.lm`` runs them under an active
``dist.sharding.use_rules`` context): a column-parallel product is
``linear_cols`` on this rank's columns of w (and of the whole bias); ``gather_cols`` joins the ranks'
columns of one or more products in one call; ``linear_rows`` is the row-parallel product (this rank's rows
of w against its slice of the features, the partial products summed
over the axis in rank order, then the bias once); ``embed`` with an
axis is the vocab-parallel lookup; ``ffn`` with an axis runs gate and up
column-parallel and down row-parallel.  Every axis argument is a bound
one-axis ``dist.mesh.Mesh``, or None on one device (the plain layer).

Each of these points carries a gradient (``dist.collectives``' autograd
forms): a row-parallel sum and the vocab-parallel lookup's sum pass the
gradient through as it is (every rank uses the sum alike); the input of
a column-parallel product is summed over the axis in the backward
(``copy_grad``: each rank's columns give a partial gradient); the whole
bias a rank slices gets its gradient gathered over the axis; a gather of
the ranks' columns reduce-scatters its gradient, or keeps the rank's
slice where every rank uses the whole alike.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..dist import collectives as coll

Params = dict[str, Any]


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _normal(gen, shape, dtype, std):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype).mul_(std)


def linear_init(gen, d_in: int, d_out: int, bias: bool = False,
                dtype=torch.float32) -> Params:
    p = {"w": _normal(gen, (d_in, d_out), dtype, 1.0 / math.sqrt(d_in))}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=torch.float32, device=gen.device)
    return p


def linear(p: Params, x):
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def linear_cols(p: Params, x, axis):
    """Column-parallel ``linear``: w holds this rank's columns of the
    whole (split over ``axis``); the bias is whole (``param_specs`` keeps
    1-D leaves whole) and the rank adds its columns of it, whose gradient
    is gathered back whole over the axis.  ``x`` is taken as it is: the
    caller sums its gradient over the axis (``copy_grad``) once for every
    product it feeds.  ``linear`` when ``axis`` is None."""
    n = p["w"].shape[1]
    if axis is None or "b" not in p or p["b"].shape[0] == n:
        return linear(p, x)
    return linear({"w": p["w"],
                   "b": coll.slice_grad(p["b"], axis, site="bias")}, x)


def linear_rows(p: Params, x, axis, *, site: str):
    """Row-parallel ``linear``: x holds this rank's slice of the features
    and w its rows; the partial products are summed over ``axis`` in rank
    order (``collectives.psum``; the gradient passes through as it is),
    then the bias (replicated) is added once.  ``linear`` when ``axis``
    is None."""
    if axis is None:
        return linear(p, x)
    y = coll.psum_grad(x @ p["w"].to(x.dtype), axis, site=site)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def gather_cols(ys: list, axis, *, site: str, alike: bool = False) -> list:
    """Column-parallel products (each this rank's columns of its whole;
    their leading dims may differ) → the whole products, each the ranks'
    columns joined in rank order, in one all-gather; ``ys`` as they are
    when ``axis`` is None.  The
    gradient is reduce-scattered back to the columns (the ranks use
    different parts of the whole), or cut to them where every rank uses
    the whole ``alike``."""
    if axis is None:
        return list(ys)
    g = coll.all_gather_grad(torch.cat([y.reshape(-1) for y in ys])[None],
                             axis, 0, site=site, alike=alike)
    out, at = [], 0
    for y in ys:
        n = y.numel()
        parts = g[:, at:at + n].reshape(axis.size, *y.shape)
        out.append(torch.cat(list(parts.unbind(0)), -1))
        at += n
    return out


def rmsnorm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x, eps: float = 1e-6, *, axis=None,
            site: str = "norm"):
    """RMSNorm in f32 over x's last dim.  ``axis``: x holds this rank's
    columns of rows split evenly over it, and ``p`` the whole scale; the
    mean of squares is the ranks' sums of squares summed in rank order
    (``site``) over the whole width, each rank scaling its columns."""
    xf = x.to(torch.float32)
    scale = p["scale"]
    if axis is None:
        var = xf.square().mean(-1, keepdim=True)
    else:
        n = x.shape[-1]
        var = coll.psum(xf.square().sum(-1, keepdim=True), axis,
                        site=site) / (n * axis.size)
        scale = scale[axis.rank * n:(axis.rank + 1) * n]
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def layernorm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device),
            "bias": torch.zeros(d, dtype=torch.float32, device=device)}


def layernorm(p: Params, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(x.dtype)


def embedding_init(gen, vocab: int, d: int, dtype=torch.float32) -> Params:
    return {"table": _normal(gen, (vocab, d), dtype, 0.02)}


def embed(p: Params, tokens, dtype=torch.bfloat16, axis=None):
    """The reference casts the table, then gathers; gathering first and
    casting the rows is the same function without a copy of the table.
    With ``axis`` the table holds this rank's rows [r·n, (r + 1)·n) of
    the vocabulary: the tokens this rank owns are looked up, the others
    get zeros, and the rows are summed over the axis (one owner a token,
    so the sum is exact)."""
    table = p["table"]
    if axis is None:
        return table[tokens].to(dtype)
    n = table.shape[0]
    local = tokens - axis.rank * n
    own = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)].to(dtype)
    rows = torch.where(own[..., None], rows, torch.zeros((), dtype=dtype,
                                                         device=rows.device))
    return coll.psum_grad(rows, axis, site="embed")


# --------------------------------------------------------------------- RoPE

def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., S, H, Dh); positions: (..., S) integer.  Split halves
    (not interleaved), f32 angles from the positions."""
    dh = x.shape[-1]
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=x.device) / dh
    inv = 1.0 / (theta ** exps)
    ang = positions[..., None].to(torch.float32) * inv    # (..., S, Dh/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def swiglu(gate, up):
    return F.silu(gate) * up


def gelu_ffn_apply(p: Params, x, axis=None):
    # jax.nn.gelu defaults to the tanh approximation
    x = coll.copy_grad(x, axis, site="ffn.in")
    return linear_rows(p["down"], F.gelu(linear_cols(p["up"], x, axis),
                                         approximate="tanh"), axis,
                       site="ffn.down")


def ffn_init(gen, d_model: int, d_ff: int, gated: bool = True,
             dtype=torch.float32) -> Params:
    if gated:
        return {"gate": linear_init(gen, d_model, d_ff, dtype=dtype),
                "up": linear_init(gen, d_model, d_ff, dtype=dtype),
                "down": linear_init(gen, d_ff, d_model, dtype=dtype)}
    return {"up": linear_init(gen, d_model, d_ff, dtype=dtype),
            "down": linear_init(gen, d_ff, d_model, dtype=dtype)}


def ffn(p: Params, x, axis=None):
    """The gated (SwiGLU) or GELU FFN; with ``axis``, this rank's columns
    of gate and up and rows of down, summed over the axis (and the
    gradient of ``x`` summed over it in the backward)."""
    if "gate" in p:
        x = coll.copy_grad(x, axis, site="ffn.in")
        return linear_rows(p["down"],
                           swiglu(linear_cols(p["gate"], x, axis),
                                  linear_cols(p["up"], x, axis)), axis,
                           site="ffn.down")
    return gelu_ffn_apply(p, x, axis)
