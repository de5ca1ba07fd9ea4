"""GQA attention (optional QKV bias, RoPE) and MLA (DeepSeek's latent KV):
port of ``repro.models.attention``.  The GQA projection is
``models.lm.gqa_project``, which prefill and decode share (it reads the
mesh plan).

Prefill attention goes through K4 (``kernels.flash_attention``): on CUDA
tensors the hand-written kernel reads k/v at their Hkv heads (GQA folded,
nothing expanded in device memory), and MLA's decompressed heads at its
(192, 128) head dims; on CPU tensors its plain version runs.
``chunked_attention`` and ``full_attention`` are the reference's plain
block form and einsum oracle, kept for the tests.  MLA's decode runs in
the latent space (``models.lm``'s absorbed form over
``dist.decode.sp_decode_attention_latent``).

Head padding: as in the reference, Q heads are padded up to a multiple of
``pad_heads_to`` (the model axis's size, ``mp``) so head-sharded products
divide the mesh; the padded heads are drawn like the others (their
weights are not zero), and a Q head h reads KV head h // ceil(Hp / Hkv),
the reference's ``expand_kv`` map.  ``kv_index`` says which KV heads the
Q heads a rank attends read, as a slice when they form K4's map (q head
h of a launch reads KV head h // (Hq / Hkv)) and else as a list (K4 then
runs at group 1 on the picked heads): without padding the two maps are
one.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import (NEG_INF, flash_attention,
                                       flash_attention_plain)
from .layers import (Params, apply_rope, linear, linear_init, linear_rows,
                     round_up)


def gqa_init(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
             qkv_bias: bool = False, dtype=torch.float32,
             pad_heads_to: int = 1) -> Params:
    hp = round_up(n_heads, pad_heads_to)
    return {
        "q": linear_init(gen, d_model, hp * head_dim, qkv_bias, dtype),
        "k": linear_init(gen, d_model, n_kv * head_dim, qkv_bias, dtype),
        "v": linear_init(gen, d_model, n_kv * head_dim, qkv_bias, dtype),
        "o": linear_init(gen, hp * head_dim, d_model, False, dtype),
    }


def expand_kv(k, n_q_heads_padded: int):
    """(B, S, Hkv, Dh) → (B, S, Hp, Dh) by repeating groups: Q head h
    reads KV head h // ceil(Hp / Hkv) (the reference's map; K4's when Hkv
    divides Hp)."""
    reps = -(-n_q_heads_padded // k.shape[2])
    return k.repeat_interleave(reps, dim=2)[:, :, :n_q_heads_padded]


def kv_index(h0: int, hl: int, hp: int, n_kv: int, kv0: int = 0,
             held: int | None = None):
    """The held KV heads (global heads kv0, ..., kv0 + held − 1; all from
    kv0 when ``held`` is None) that the Q heads
    [h0, h0 + hl) of a model with Hp heads read under ``expand_kv``'s map:
    ``slice(a, b)`` when they form K4's map over b − a held heads (Q head i
    reads held head a + i // (hl / (b − a))), else a list with one held
    head a Q head.  Raises when a Q head reads a head not held."""
    reps = -(-hp // n_kv)
    need = [h // reps - kv0 for h in range(h0, h0 + hl)]
    if need[0] < 0 or need[-1] >= (n_kv - kv0 if held is None else held):
        raise ValueError(f"q heads [{h0}, {h0 + hl}) read KV heads "
                         f"{need} past the held ones from {kv0}")
    a, n = need[0], need[-1] + 1 - need[0]
    if hl % n == 0 and need == [a + i // (hl // n) for i in range(hl)]:
        return slice(a, a + n)
    return need


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
             nope_dim: int, rope_dim: int, v_dim: int, pad_heads_to: int = 1,
             dtype=torch.float32) -> Params:
    """The reference's tree: ``q_a`` (D, q_lora), ``q_b`` (q_lora,
    Hp·(nope + rope)), ``kv_a`` (D, kv_lora + rope), ``kv_b`` (kv_lora,
    Hp·(nope + v)), ``o`` (Hp·v, D); no biases, no latent norms.  Hp is
    ``n_heads`` padded to a multiple of ``pad_heads_to``; the padded
    heads are drawn like the others, as the reference draws them."""
    hp = round_up(n_heads, pad_heads_to)
    return {
        "q_a": linear_init(gen, d_model, q_lora, dtype=dtype),
        "q_b": linear_init(gen, q_lora, hp * (nope_dim + rope_dim),
                           dtype=dtype),
        "kv_a": linear_init(gen, d_model, kv_lora + rope_dim, dtype=dtype),
        "kv_b": linear_init(gen, kv_lora, hp * (nope_dim + v_dim),
                            dtype=dtype),
        "o": linear_init(gen, hp * v_dim, d_model, dtype=dtype),
    }


def mla_attention(p: Params, x, *, n_heads, q_lora, kv_lora, nope_dim,
                  rope_dim, v_dim, positions, causal=True, axis=None):
    """DeepSeek-V3 Multi-head Latent Attention in the decompressed form:
    x (B, S, D) → (B, S, D).  ``q_b(q_a(x))`` splits into nope and rope
    heads, ``kv_a(x)`` into the latent and one shared rope head, and
    ``kv_b(latent)`` into k_nope and v; RoPE at the default θ on both rope
    parts, as the reference applies it.  The shared rope head is
    broadcast into every head of k (materialised, as the reference does),
    and the attention is K4 at (nope + rope, v) head dims, scale
    1/sqrt(nope + rope), reading v in place as a slice of kv_b's rows.

    ``n_heads`` are the heads this call attends, the columns of ``q_b``
    and ``kv_b`` it is given.  Under a mesh (``axis``, the bound "model"
    axis) they are this rank's block of the padded heads: ``q_a`` and
    ``kv_a`` are whole on every rank, the shared rope head is broadcast
    into the rank's heads only, and ``o`` (its rows of those heads) is
    row-parallel, the partial products summed over the axis in rank order
    (``attn.o``)."""
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
    return linear_rows(p["o"], out.reshape(B, S, n_heads * v_dim), axis,
                       site="attn.o")
