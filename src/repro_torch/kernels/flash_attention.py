"""K4 — flash attention (causal or not, GQA) and its plain version.

Port of ``repro.kernels.flash_attention``: q (B, Hq, Sq, D), k
(B, Hkv, Skv, D), v (B, Hkv, Skv, Dv), Hq % Hkv == 0, q head h reads KV
head h // (Hq // Hkv); online softmax with f32 state, masked scores −1e30,
l clamped at 1e-20, output (B, Hq, Sq, Dv) in q's dtype.
``flash_attention`` runs the plain version on CPU tensors (and on meta
tensors, which compute nothing: the shapes of a dry run) and launches
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
``flash_attention_backward`` (the TPU kernel has no backward: the
reference differentiates ``chunked_attention``): on bf16 CUDA tensors
the Hopper kernel ``csrc/flash_attention_bwd.cu`` (every (D, Dv) in
``HEAD_DIMS``), on f32 CUDA tensors and on CPU tensors the plain
version, tensor code by KV blocks.  The serving path, which takes no
gradient, launches the forward kernel with no log-sum-exp buffer.
"""
from __future__ import annotations

import math

import torch

from . import _build

NEG_INF = -1e30
# (D of q and k, Dv of v and o) pairs the kernel is built for
HEAD_DIMS = ((32, 32), (64, 64), (128, 128), (160, 160), (192, 128))
# the pairs the bf16 backward kernel is built for: every pair the forward
# takes (32-row steps at (160, 160) and (192, 128); csrc/
# flash_attention_bwd.cu)
BWD_HEAD_DIMS = HEAD_DIMS


# KV rows a step of ``flash_attention_backward_plain`` takes at once
BACKWARD_BLOCK_KV = 512


def kernel_block_kv(dv: int) -> int:
    """The KV rows over which the bf16 kernel rounds p against one running
    max: its KV tiles, 128 rows, or 64 when Dv is 160 (the larger
    accumulator leaves room for 64 score columns only)."""
    return 64 if dv > 128 else 128
_INT_MAX = 2**31 - 1
# devices whose tensors take the plain version; every other one launches
PLAIN_DEVICES = ("cpu", "meta")


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


def flash_attention_backward_plain(q, k, v, o, lse, do, causal: bool = True,
                                   sm_scale: float | None = None,
                                   round_dtype=None):
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
    bf16 before P·V on the kernel's bf16 path, and with ``round_dtype=None``
    the backward recomputes it in f32.  ``round_dtype=torch.bfloat16``
    rounds P before dV = Pᵀ·dO and dS before dQ and dK, as the bf16
    backward kernel does (dS is formed from the unrounded P).  Returns
    (dq, dk, dv) in the dtypes of q, k, v."""
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
        pr = p if round_dtype is None else p.to(round_dtype).to(f32)
        dv[:, :, start:end] = pr.transpose(-1, -2) @ dos
        ds = (dos @ vb.transpose(-1, -2)).sub_(rows(delta[..., None])).mul_(p)
        del p, pr, s
        if round_dtype is not None:
            ds = ds.to(round_dtype).to(f32)
        dq[:, :, :, q0:] += (ds @ kb).view(B, Hkv, g, n, D)
        dk[:, :, start:end] = ds.transpose(-1, -2) @ qs
    return ((dq * scale).reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_backward(q, k, v, o, lse, do, causal: bool = True,
                             sm_scale: float | None = None):
    """The gradient of ``flash_attention`` with respect to (q, k, v) (see
    ``flash_attention_backward_plain``), by the dtype and device of q:
    CPU and meta tensors take the plain version; bf16 CUDA tensors launch
    the Hopper kernel ``csrc/flash_attention_bwd.cu`` (P and dS rounded to
    bf16 before their products, as ``round_dtype=torch.bfloat16`` rounds
    them) at every head-dim pair of ``HEAD_DIMS``, or raise when it does
    not take their layout; f32
    CUDA tensors take the plain version on the card (no f32 backward
    kernel yet: ROADMAP's open item "K4's f32 backward kernel"), as the
    f32 gradient checks of training expect its exact f32 arithmetic."""
    if q.device.type in PLAIN_DEVICES or q.dtype == torch.float32:
        return flash_attention_backward_plain(q, k, v, o, lse, do, causal,
                                              sm_scale)
    return _backward_kernel(q, k, v, o, lse, do, causal, sm_scale)


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
    for t in (q, k, v):
        _check_layout(t, q.device)


def _check_layout(t, device):
    """A kernel operand: on ``device`` (CUDA), the head dim contiguous,
    rows and TMA strides 16-byte aligned, offsets within int32."""
    align = 16 // t.element_size()       # 16-byte rows and TMA strides
    if not t.is_cuda or t.device != device:
        raise ValueError("flash_attention: inputs must lie on one CUDA "
                         "device (CPU inputs take the plain version)")
    if t.stride(3) != 1 or any(s % align for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError("flash_attention: the head dim must be "
                         "contiguous and rows 16-byte aligned")
    if max((n - 1) * s for n, s in zip(t.shape, t.stride())) > _INT_MAX:
        raise ValueError("flash_attention: offsets exceed int32")


def _like(t, d):
    """An empty (B, H, S, d) tensor in ``t``'s dtype, device and order of
    dims: a transposed view of (B, S, H, d) when ``t`` is one."""
    B, H, S = t.shape[:3]
    if t.stride(1) < t.stride(2):        # heads inside rows: (B, S, H, D)
        return t.new_empty((B, S, H, d)).transpose(1, 2)
    return t.new_empty((B, H, S, d))


def _kernel(q, k, v, causal: bool, sm_scale, with_lse: bool):
    """Launch K4 on CUDA tensors: (o, lse), lse None unless asked for."""
    _check(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    o = _like(q, Dv)
    fn = "k4_flash_attention_bf16" if q.dtype == torch.bfloat16 \
        else "k4_flash_attention_f32"
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    strides = [int(s) for t in (q, k, v, o) for s in t.stride()[:3]]
    _build.launch("flash_attention", fn, q, k, v, o, lse, B, Hq, Hkv, Sq,
                  Skv, D, Dv, int(causal), float(scale), *strides)
    return o, lse


def _backward_kernel(q, k, v, o, lse, do, causal: bool, sm_scale):
    """Launch K4's backward on bf16 CUDA tensors: (dq, dk, dv), each in the
    order of dims of its input.  ``do`` in a layout the tensor maps cannot
    read (an expanded or sliced gradient) is copied to a contiguous one
    first; every other operand is checked as the forward's are."""
    _check(q, k, v)
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype != torch.bfloat16:
        raise ValueError("flash_attention_backward: the kernel takes bf16 "
                         "(f32 CUDA inputs take the plain version)")
    for t, name in ((o, "o"), (do, "do")):
        if t.shape != (B, Hq, Sq, Dv) or t.dtype != q.dtype:
            raise ValueError(f"flash_attention_backward: {name} must be "
                             f"bf16 of {(B, Hq, Sq, Dv)}, not {t.dtype} of "
                             f"{tuple(t.shape)}")
    align = 8                            # bf16 elements in 16 bytes
    if do.stride(3) != 1 or do.data_ptr() % 16 or any(
            s == 0 or s % align for s in do.stride()[:3]):
        do = do.contiguous()
    for t in (o, do):
        _check_layout(t, q.device)
    if lse.shape != (B, Hq, Sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("flash_attention_backward: lse must be contiguous "
                         f"f32 of {(B, Hq, Sq)} on the inputs' device")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    dq, dk, dv = _like(q, D), _like(k, D), _like(v, Dv)
    if Sq == 0 or Skv == 0 or B == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    sq_pad = -(-Sq // 128) * 128          # the kernel's stats rows a head
    if B * Hq * 2 * sq_pad > _INT_MAX:
        raise ValueError("flash_attention_backward: offsets exceed int32")
    stats = torch.empty(B * Hq * 2 * sq_pad, dtype=torch.float32,
                        device=q.device)
    strides = [int(s) for t in (q, k, v, o, do, dq, dk, dv)
               for s in t.stride()[:3]]
    _build.launch("flash_attention_bwd", "k4_flash_attention_bwd_bf16", q, k,
                  v, o, do, lse, dq, dk, dv, stats, B, Hq, Hkv, Sq, Skv, D,
                  Dv, int(causal), float(scale), *strides)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K4 with a gradient: the forward is the kernel (writing the rows'
    log-sum-exp) on CUDA tensors and the plain version on CPU and meta
    tensors; the backward is ``flash_attention_backward`` (the backward
    kernel on bf16 CUDA tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        if q.device.type in PLAIN_DEVICES:
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
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, causal=causal,
                                     sm_scale=sm_scale)
    return _kernel(q, k, v, causal, sm_scale, with_lse=False)[0]
