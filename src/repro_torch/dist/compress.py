"""Error-feedback int8 compression — port of ``repro.dist.compress``.

  zero_residual(tree)                    — initial residual state
  compress_with_error_feedback(g, res)   — (compressed, new_residual)
  make_grad_compressor()                 — stateless grads → grads callable
  quantize_rows(x) / dequantize_rows(c, s)
                                         — int8 codes + a max-abs scale per
                                           trailing row; the lane-group
                                           quantizer of the quantized halo
                                           and ragged wires

A tree is a tensor or a dict, list or tuple of trees.  Every scale is
``amax / qmax`` divided by a tensor on ``amax``'s device: on CUDA a
division by a Python scalar becomes a multiply by its reciprocal, which
moves the last bit of a scale and with it every code.
``compressed_psum`` needs a collective and is not ported.
"""
from __future__ import annotations

import torch

_QMAX = 127.0


def _tree_map(fn, *trees):
    head = trees[0]
    if isinstance(head, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(_tree_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def _div(amax, qmax: float):
    """``amax / qmax`` as a true division (see the module docstring); the
    divisor is filled on the device, with no copy from the host (which
    waits for the device)."""
    return amax / torch.full((), qmax, dtype=amax.dtype, device=amax.device)


def _scale_of(x):
    amax = torch.max(torch.abs(x))
    return torch.where(amax > 0, _div(amax, _QMAX), 1.0)


def _quantize_dequantize(x):
    scale = _scale_of(x)
    q = torch.clamp(torch.round(x / scale), -_QMAX, _QMAX)
    return q * scale


def quantize_rows(x, qmax: float = _QMAX):
    """Max-abs int8 quantization per trailing row: ``x`` (..., n) →
    (codes int8 (..., n), scales f32 (...)).  All-zero rows take scale 1,
    so they dequantize exactly."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1)
    scales = torch.where(amax > 0, _div(amax, qmax), 1.0)
    codes = torch.clamp(torch.round(xf / scales[..., None]), -qmax, qmax)
    return codes.to(torch.int8), scales


def dequantize_rows(codes, scales):
    """Inverse of ``quantize_rows``: (..., n) int8 × (...) scales → f32."""
    return codes.to(torch.float32) * scales[..., None]


def zero_residual(grads):
    """Residual tree of f32 zeros matching ``grads``."""
    return _tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                           device=g.device), grads)


def compress_with_error_feedback(grads, residual):
    """(compressed, new_residual) per leaf: t = g + residual, compressed =
    Q(t), new_residual = t − Q(t)."""
    totals = _tree_map(lambda g, r: g.to(torch.float32) + r, grads,
                       residual)
    compressed = _tree_map(_quantize_dequantize, totals)
    new_residual = _tree_map(lambda t, c: t - c, totals, compressed)
    return compressed, new_residual


def make_grad_compressor():
    """Stateless per-leaf int8 quantize-dequantize, grads → grads (no
    residual carried across steps)."""
    def compress(grads):
        return _tree_map(_quantize_dequantize, grads)
    return compress


def compressed_psum(x, axis_name):
    raise ValueError(
        "compressed_psum is not ported yet (ROADMAP, Queue 1: the sharded "
        "partitioner and the multi-GPU engine): it needs a collective")
