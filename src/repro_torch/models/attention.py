"""GQA attention (optional QKV bias, RoPE) and MLA (DeepSeek's latent KV):
port of ``repro.models.attention``.

Prefill attention goes through K4 (``kernels.flash_attention``): on CUDA
tensors the hand-written kernel reads k/v at their Hkv heads (GQA folded,
nothing expanded in device memory), and MLA's decompressed heads at its
(192, 128) head dims; on CPU tensors its plain version runs.
``chunked_attention`` and ``full_attention`` are the reference's plain
block form and einsum oracle, kept for the tests.  MLA's decode runs in
the latent space (``models.lm``'s absorbed form over
``dist.decode.sp_decode_attention_latent``).

Head padding: the reference pads Q heads up to a multiple of the
model-axis size; one card has no model axis, so Hq is never padded here.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import (NEG_INF, flash_attention,
                                       flash_attention_plain)
from .layers import Params, apply_rope, linear, linear_init


def gqa_init(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
             qkv_bias: bool = False, dtype=torch.float32) -> Params:
    return {
        "q": linear_init(gen, d_model, n_heads * head_dim, qkv_bias, dtype),
        "k": linear_init(gen, d_model, n_kv * head_dim, qkv_bias, dtype),
        "v": linear_init(gen, d_model, n_kv * head_dim, qkv_bias, dtype),
        "o": linear_init(gen, n_heads * head_dim, d_model, False, dtype),
    }


def gqa_project(p: Params, x, *, n_heads, n_kv, head_dim, positions,
                rope_theta=10000.0):
    """x (B, S, d_model) → q (B, S, Hq, Dh), k/v (B, S, Hkv, Dh), RoPE
    applied to q and k."""
    B, S, _ = x.shape
    q = linear(p["q"], x).reshape(B, S, n_heads, head_dim)
    k = linear(p["k"], x).reshape(B, S, n_kv, head_dim)
    v = linear(p["v"], x).reshape(B, S, n_kv, head_dim)
    return (apply_rope(q, positions, rope_theta),
            apply_rope(k, positions, rope_theta), v)


def expand_kv(k, n_q_heads: int):
    """(B, S, Hkv, Dh) → (B, S, Hq, Dh), Q head h reading KV head
    h // (Hq / Hkv) — K4's mapping when no heads are padded."""
    reps = -(-n_q_heads // k.shape[2])
    return k.repeat_interleave(reps, dim=2)[:, :, :n_q_heads]


def chunked_attention(q, k, v, *, causal: bool, block_kv: int = 1024,
                      sm_scale: float | None = None):
    """The reference's online-softmax attention, q (B, Sq, H, Dh) and k/v
    (B, Skv, H, Dh) already group-expanded.  It scales q in q's dtype
    before the f32 cast (K4 scales in f32: in bf16 the two round apart)."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    out = flash_attention_plain(
        (q * scale).to(torch.float32).transpose(1, 2), k.transpose(1, 2),
        v.transpose(1, 2), causal=causal, sm_scale=1.0, block_kv=block_kv)
    return out.transpose(1, 2).to(q.dtype)


def full_attention(q, k, v, *, causal: bool,
                   sm_scale: float | None = None):
    """Reference einsum attention (small S; the oracle of the tests)."""
    Sq, Skv = q.shape[1], k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        qpos = torch.arange(Sq, device=q.device)
        mask = torch.arange(Skv, device=q.device)[None, :] <= qpos[:, None]
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)


# ------------------------------------------------------------------- MLA

def mla_init(gen, d_model: int, n_heads: int, *, q_lora: int, kv_lora: int,
             nope_dim: int, rope_dim: int, v_dim: int,
             dtype=torch.float32) -> Params:
    """The reference's tree: ``q_a`` (D, q_lora), ``q_b`` (q_lora,
    H·(nope + rope)), ``kv_a`` (D, kv_lora + rope), ``kv_b`` (kv_lora,
    H·(nope + v)), ``o`` (H·v, D); no biases, no latent norms."""
    return {
        "q_a": linear_init(gen, d_model, q_lora, dtype=dtype),
        "q_b": linear_init(gen, q_lora, n_heads * (nope_dim + rope_dim),
                           dtype=dtype),
        "kv_a": linear_init(gen, d_model, kv_lora + rope_dim, dtype=dtype),
        "kv_b": linear_init(gen, kv_lora, n_heads * (nope_dim + v_dim),
                            dtype=dtype),
        "o": linear_init(gen, n_heads * v_dim, d_model, dtype=dtype),
    }


def mla_attention(p: Params, x, *, n_heads, q_lora, kv_lora, nope_dim,
                  rope_dim, v_dim, positions, causal=True):
    """DeepSeek-V3 Multi-head Latent Attention in the decompressed form:
    x (B, S, D) → (B, S, D).  ``q_b(q_a(x))`` splits into nope and rope
    heads, ``kv_a(x)`` into the latent and one shared rope head, and
    ``kv_b(latent)`` into k_nope and v; RoPE at the default θ on both rope
    parts, as the reference applies it.  The shared rope head is
    broadcast into every head of k (materialised, as the reference does),
    and the attention is K4 at (nope + rope, v) head dims, scale
    1/sqrt(nope + rope), reading v in place as a slice of kv_b's rows."""
    B, S, _ = x.shape
    q = linear(p["q_b"], linear(p["q_a"], x)).reshape(
        B, S, n_heads, nope_dim + rope_dim)
    q_nope, q_rope = q[..., :nope_dim], q[..., nope_dim:]
    kv = linear(p["kv_a"], x)
    latent, k_rope = kv[..., :kv_lora], kv[..., kv_lora:]
    k_rope = apply_rope(k_rope[:, :, None, :], positions)     # shared head
    q_rope = apply_rope(q_rope, positions)
    kvb = linear(p["kv_b"], latent).reshape(B, S, n_heads, nope_dim + v_dim)
    k_nope, v = kvb[..., :nope_dim], kvb[..., nope_dim:]
    qf = torch.cat([q_nope, q_rope], -1)
    kf = torch.cat([k_nope, k_rope.expand(B, S, n_heads, rope_dim)], -1)
    scale = 1.0 / math.sqrt(nope_dim + rope_dim)
    out = flash_attention(qf.transpose(1, 2), kf.transpose(1, 2),
                          v.transpose(1, 2), causal=causal,
                          sm_scale=scale).transpose(1, 2)
    return linear(p["o"], out.reshape(B, S, n_heads * v_dim))
