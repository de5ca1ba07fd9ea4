"""Building blocks of the LM stack (port of ``repro.models.layers``).

Parameters are nested dicts of tensors, as in the reference; every layer
is an ``*_init`` / apply pair.  ``*_init`` draws from an explicit
``torch.Generator`` (the reference's ``jax.random`` keys give other
numbers; tests carry the reference's weights across with
``repro_torch.convert.lm_params_from_reference``).  Weights are
(d_in, d_out), applied as ``x @ w``.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

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


def rmsnorm_init(d: int, device=None) -> Params:
    return {"scale": torch.ones(d, dtype=torch.float32, device=device)}


def rmsnorm(p: Params, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


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


def embed(p: Params, tokens, dtype=torch.bfloat16):
    """The reference casts the table, then gathers; gathering first and
    casting the rows is the same function without a copy of the table."""
    return p["table"][tokens].to(dtype)


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


def gelu_ffn_apply(p: Params, x):
    # jax.nn.gelu defaults to the tanh approximation
    return linear(p["down"], F.gelu(linear(p["up"], x), approximate="tanh"))


def ffn_init(gen, d_model: int, d_ff: int, gated: bool = True,
             dtype=torch.float32) -> Params:
    if gated:
        return {"gate": linear_init(gen, d_model, d_ff, dtype=dtype),
                "up": linear_init(gen, d_model, d_ff, dtype=dtype),
                "down": linear_init(gen, d_ff, d_model, dtype=dtype)}
    return {"up": linear_init(gen, d_model, d_ff, dtype=dtype),
            "down": linear_init(gen, d_ff, d_model, dtype=dtype)}


def ffn(p: Params, x):
    if "gate" in p:
        return linear(p["down"], swiglu(linear(p["gate"], x),
                                        linear(p["up"], x)))
    return gelu_ffn_apply(p, x)
