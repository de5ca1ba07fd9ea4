"""K4 — flash attention (causal or not, GQA) and its plain version.

Port of ``repro.kernels.flash_attention``: q (B, Hq, Sq, D), k
(B, Hkv, Skv, D), v (B, Hkv, Skv, Dv), Hq % Hkv == 0, q head h reads KV
head h // (Hq // Hkv); online softmax with f32 state, masked scores −1e30,
l clamped at 1e-20, output (B, Hq, Sq, Dv) in q's dtype.
``flash_attention`` runs the plain version on CPU tensors and launches
``csrc/flash_attention.cu`` on CUDA tensors (f32 or bf16; (D, Dv) in
``HEAD_DIMS``: D = Dv in 32, 64, 128, 160 (pixtral), or MLA's (192,
128); any Sq and Skv, Sq = 1 included).  bf16 runs the Hopper kernel: a
producer warp loads Q and a ring of K/V tiles with TMA, two consumer
warpgroups run both products on wgmma (128-row q tiles, 128-row KV tiles
or 64-row at Dv 160); f32 runs a plain FMA kernel (no TF32).

The kernel reads q, k, v (through TMA tensor maps in bf16) and writes o
through their element strides, so a (B, S, H, D) activation passes as its
``transpose(1, 2)`` view without a copy, and v may be a slice of wider
rows (MLA's ``kv_b`` output past its nope columns); the output keeps q's
order of dims with Dv columns.  A tensor map that cannot be encoded
raises.

Gradients: when a gradient is being taken through q, k or v,
``flash_attention`` runs as a ``torch.autograd.Function``.  Its forward is
K4 on CUDA tensors (the kernel then also writes the rows' log-sum-exp,
f32 (B, Hq, Sq)) and the plain version on CPU tensors; its backward is
``flash_attention_backward``, tensor code by KV blocks (the TPU kernel
has no backward: the reference differentiates ``chunked_attention``).
The serving path, which takes no gradient, launches the kernel with no
log-sum-exp buffer.
"""
from __future__ import annotations

import math

import torch

from . import _build

NEG_INF = -1e30
# (D of q and k, Dv of v and o) pairs the kernel is built for
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (160, 160), (192, 128))


# KV rows a step of ``flash_attention_backward`` takes at once
BACKWARD_BLOCK_KV = 512


def kernel_block_kv(dv: int) -> int:
    """The KV rows over which the bf16 kernel rounds p against one running
    max: its KV tiles, 128 rows, or 64 when Dv is 160 (the larger
    accumulator leaves room for 64 score columns only)."""
    return 64 if dv > 128 else 128
_INT_MAX = 2**31 - 1


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          sm_scale: float | None = None,
                          block_kv: int = 1024, p_dtype=None,
                          return_lse: bool = False):
    """The same function in PyTorch, by KV blocks like the reference's
    ``chunked_attention``, with GQA folded (k/v stay at Hkv heads) and q
    scaled in f32 as the TPU kernel does; p stays f32.  With
    ``block_kv=kernel_block_kv(Dv), p_dtype=torch.bfloat16`` p is rounded
    before P·V as the kernel's bf16 path rounds it (against the same
    running max, over the same KV rows), so a reference can carry that
    difference.  ``return_lse`` also returns the rows' log-sum-exp of the
    scaled scores, f32 (B, Hq, Sq), as the kernel writes it."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[-1]
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    qf = (q.to(torch.float32) * scale).reshape(B, Hkv, group, Sq, D)
    kf = k.to(torch.float32)[:, :, None]
    vf = v.to(torch.float32)[:, :, None]
    qpos = torch.arange(Sq, device=q.device)
    m = torch.full((B, Hkv, group, Sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, group, Sq, Dv), dtype=torch.float32,
                      device=q.device)
    for start in range(0, Skv, block_kv):
        kblk = kf[:, :, :, start:start + block_kv]
        s = qf @ kblk.transpose(-1, -2)
        if causal:
            kpos = start + torch.arange(kblk.shape[3], device=q.device)
            s = s.masked_fill(kpos[None, :] > qpos[:, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        if p_dtype is not None:
            p = p.to(p_dtype).to(torch.float32)
        acc = acc * alpha[..., None] + p @ vf[:, :, :, start:start + block_kv]
        m = m_new
    l = torch.clamp(l, min=1e-20)
    out = (acc / l[..., None]).reshape(B, Hq, Sq, Dv).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l)).reshape(B, Hq, Sq)
    return out


def flash_attention_backward(q, k, v, o, lse, do, causal: bool = True,
                             sm_scale: float | None = None):
    """The gradient of ``flash_attention`` with respect to (q, k, v), given
    its output ``o``, the rows' log-sum-exp ``lse`` (B, Hq, Sq) and the
    output's gradient ``do``; tensor code by KV blocks of
    ``BACKWARD_BLOCK_KV`` rows, in f32.  Per block: P = exp(S·scale −
    lse) recomputed in f32, dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P ∘ (dP −
    rowsum(dO ∘ O)), dQ += dS·K·scale, dK = dSᵀ·Q·scale; the q heads of a GQA group are stacked as rows of
    their KV head, so dK and dV come out summed over the group at Hkv
    heads.  Under ``causal`` the q rows that lie wholly before a block
    (they see none of it) are skipped.  This is the gradient the reference
    gets by autodiff of ``chunked_attention``; the forward rounds p to
    bf16 before P·V on the kernel's bf16 path, the backward recomputes it
    in f32.  Returns (dq, dk, dv) in the dtypes of q, k, v."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    g = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    f32, dev = torch.float32, q.device
    qf = (q.to(f32) * scale).reshape(B, Hkv, g, Sq, D)
    dof = do.to(f32).reshape(B, Hkv, g, Sq, Dv)
    delta = (dof * o.to(f32).reshape(B, Hkv, g, Sq, Dv)).sum(-1)
    lse = lse.reshape(B, Hkv, g, Sq)
    qpos = torch.arange(Sq, device=dev)
    dq = torch.zeros((B, Hkv, g, Sq, D), dtype=f32, device=dev)
    dk = torch.zeros((B, Hkv, Skv, D), dtype=f32, device=dev)
    dv = torch.zeros((B, Hkv, Skv, Dv), dtype=f32, device=dev)
    for start in range(0, Skv, BACKWARD_BLOCK_KV):
        end = min(start + BACKWARD_BLOCK_KV, Skv)
        q0 = min(start, Sq) if causal else 0
        n = Sq - q0
        if n == 0:                       # no q row sees this block
            continue

        def rows(t):                     # (B, Hkv, g, Sq, ·) → (.., g·n, ·)
            return t[:, :, :, q0:].reshape(B, Hkv, g * n, *t.shape[4:])

        kb = k[:, :, start:end].to(f32)
        vb = v[:, :, start:end].to(f32)
        qs, dos = rows(qf), rows(dof)
        s = qs @ kb.transpose(-1, -2)                # (B, Hkv, g·n, end-start)
        if causal:
            kpos = torch.arange(start, end, device=dev)
            s.view(B, Hkv, g, n, end - start).masked_fill_(
                kpos[None, :] > qpos[q0:, None], NEG_INF)
        p = s.sub_(rows(lse[..., None])).exp_()
        dv[:, :, start:end] = p.transpose(-1, -2) @ dos
        ds = (dos @ vb.transpose(-1, -2)).sub_(rows(delta[..., None])).mul_(p)
        del p, s
        dq[:, :, :, q0:] += (ds @ kb).view(B, Hkv, g, n, D)
        dk[:, :, start:end] = ds.transpose(-1, -2) @ qs
    return ((dq * scale).reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError("flash_attention: q (B, Hq, Sq, D), k "
                         "(B, Hkv, Skv, D) and v (B, Hkv, Skv, Dv)")
    B, Hq, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or k.shape[1] == 0 \
            or Hq % k.shape[1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} do not pair (Hq % Hkv != 0?)")
    if (D, v.shape[3]) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dims (D {D}, Dv "
                         f"{v.shape[3]}) not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.float32, torch.bfloat16):
        raise ValueError("flash_attention: q, k, v must share f32 or bf16")
    align = 16 // q.element_size()       # 16-byte rows and TMA strides
    for t in (q, k, v):
        if not t.is_cuda or t.device != q.device:
            raise ValueError("flash_attention: inputs must lie on one CUDA "
                             "device (CPU inputs take the plain version)")
        if t.stride(3) != 1 or any(s % align for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError("flash_attention: the head dim must be "
                             "contiguous and rows 16-byte aligned")
        if max((n - 1) * s for n, s in zip(t.shape, t.stride())) > _INT_MAX:
            raise ValueError("flash_attention: offsets exceed int32")


def _kernel(q, k, v, causal: bool, sm_scale, with_lse: bool):
    """Launch K4 on CUDA tensors: (o, lse), lse None unless asked for."""
    _check(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    if q.stride(1) < q.stride(2):        # heads inside rows: (B, S, H, D)
        o = q.new_empty((B, Sq, Hq, Dv)).transpose(1, 2)
    else:
        o = q.new_empty((B, Hq, Sq, Dv))
    fn = "k4_flash_attention_bf16" if q.dtype == torch.bfloat16 \
        else "k4_flash_attention_f32"
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = [int(s) for t in (q, k, v, o) for s in t.stride()[:3]]
    _build.launch("flash_attention", fn, q, k, v, o, lse, B, Hq, Hkv, Sq,
                  Skv, D, Dv, int(causal), float(scale), *strides)
    return o, lse


class FlashAttention(torch.autograd.Function):
    """K4 with a gradient: the forward is the kernel (writing the rows'
    log-sum-exp) on CUDA tensors and the plain version on CPU tensors; the
    backward is ``flash_attention_backward``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        if q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v, causal=causal,
                                           sm_scale=sm_scale, return_lse=True)
        else:
            o, lse = _kernel(q, k, v, causal, sm_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do, ctx.causal,
                                              ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    sm_scale: float | None = None):
    """q (B, Hq, Sq, D), k (B, Hkv, Skv, D), v (B, Hkv, Skv, Dv) →
    (B, Hq, Sq, Dv) in q's dtype and order of dims: a transposed view of
    (B, Sq, Hq, Dv) when q is one of (B, Sq, Hq, D).  Differentiable
    (``FlashAttention``) when a gradient is being taken through q, k or
    v."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, sm_scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale)
    return _kernel(q, k, v, causal, sm_scale, with_lse=False)[0]
