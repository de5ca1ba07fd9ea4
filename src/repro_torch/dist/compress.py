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
``compressed_psum(x, axis)`` is the int8-quantized sum over a mesh.
On a mesh, where each gradient leaf is a rank's block, the compressor
takes the leaves' axes (``train.shardings.leaf_axes``) and each leaf's
scale is the max over the whole leaf (a ``pmax`` over its axes, the
leaves cut alike in one call), so the codes are one device's.
"""
from __future__ import annotations

import torch

from ..tree import tree_leaves, tree_unflatten
from . import collectives as coll

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


def _scale_of(x, amax=None):
    amax = torch.max(torch.abs(x)) if amax is None else amax
    return torch.where(amax > 0, _div(amax, _QMAX), 1.0)


def _quantize_dequantize(x, amax=None):
    scale = _scale_of(x, amax)
    q = torch.clamp(torch.round(x / scale), -_QMAX, _QMAX)
    return q * scale


def _whole_amax(leaves: list, axes: list) -> list:
    """Each block's max |x| taken over its whole leaf: a ``pmax`` over the
    axes that cut it, one call for the leaves cut by the same axes."""
    return coll.over_axes(
        [torch.max(torch.abs(x)) for x in leaves],
        [sorted((a for dim in ax for a in dim), key=lambda a: a.axis)
         for ax in axes], coll.pmax, site="compress.scale")


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
    residual carried across steps).  On a mesh ``compress(grads, axes=)``
    takes the blocks' axes and scales each by its whole leaf's max."""
    def compress(grads, axes=None):
        if axes is None:
            return _tree_map(_quantize_dequantize, grads)
        leaves = tree_leaves(grads)
        amax = _whole_amax(leaves, tree_leaves(axes))
        return tree_unflatten(grads, [_quantize_dequantize(x, m)
                                      for x, m in zip(leaves, amax)])
    return compress


def compressed_psum(x, axis):
    """int8-quantized sum over the ranks of ``axis`` (a bound
    ``dist.mesh.Mesh``): agree on a global scale (the max of |x| over
    the ranks), quantize locally to int8 codes, sum the codes as int16
    (overflow-safe up to 256 ranks: 256·127 < 2¹⁵), dequantize.  The
    payload is the int16 code tensor and one scalar."""
    xf = x.to(torch.float32)
    amax = coll.pmax(torch.max(torch.abs(xf)), axis,
                     site="compressed_psum.scale")
    scale = torch.where(amax > 0, _div(amax, _QMAX), 1.0)
    q = torch.clamp(torch.round(xf / scale), -_QMAX, _QMAX)
    total = coll.psum(q.to(torch.int16), axis, site="compressed_psum")
    return (total.to(torch.float32) * scale).to(x.dtype)
