"""The LM stack of every assigned family (port of ``repro.models.lm``):
GQA attention with optional QKV bias and RoPE, or MLA (DeepSeek's latent
KV), RMSNorm or LayerNorm, SwiGLU or GELU FFN or a routed MoE layer with
an optional shared expert — qwen2, qwen1.5, command-r, stablelm (dense),
llama4-scout (MoE), deepseek-v3 (MLA + MoE after ``first_k_dense`` dense
layers) —, Mamba-2 SSD layers (``models.mamba``): mamba2-130m (``ssd``
layers only) and jamba (``hyb`` periods: ``attn_period`` sublayers,
sublayer ``attn_index`` GQA attention and the rest SSD, each followed by
an FFN, an MoE one at every sublayer i with i % ``moe.every`` == 1), the
encoder–decoder seamless-m4t (``enc`` layers over the stub frontend's
``src_embeds``: non-causal self-attention, then the FFN; ``dec`` layers:
causal self-attention, cross-attention over the encoder's output, then
the FFN) and the VLM pixtral (dense layers over ``prefix_embeds`` from the
stub frontend followed by the token embeddings, positions over both).

Entry points:
  init_params(cfg, gen, dtype)        — random weights from a Generator
  forward(params, batch, cfg, dtype)  — final hidden states (B, S, D)
  encode(params, src_embeds, cfg, dtype) — encdec: the encoder's output,
                                        the decoder's memory
  prefill(params, batch, cfg, dtype)  — (last-position logits, hidden)
  init_cache(cfg, B, max_len, ...)    — zeroed KV (GQA), latent (MLA) or
                                        SSM state cache of each layer
                                        group (on ``cuda`` unless a device
                                        is named)
  decode_step(params, cache, ..., memory) — one token; writes the cache in
                                        place; encdec attends ``memory``
  lm_loss(params, x, labels, cfg, chunk) — chunked cross-entropy
  forward_train(params, batch, cfg, dtype, loss_chunk) — the training loss

Prefill attention runs through K4 (``kernels.flash_attention``; MLA in
its decompressed form at (192, 128) head dims; jamba's one attention
sublayer a period at group 8; pixtral at head dim 160; the encoder's
self-attention and the decoder's cross-attention non-causal, the latter
over Skv = Sm memory rows), decode attention through ``dist.decode``
(MLA absorbed: attention over the latent cache, with ``kv_b`` split into
W_uk and W_uv) except the decoder's cross-attention, which recomputes k
and v from the memory every step, as the reference does, and runs on K4
at Sq = 1; the MoE layer is ``models.moe``, whose expert products are
batched matrix products (the reference's are einsums outside any Pallas
kernel), and the SSD layer ``models.mamba`` (einsums and a loop over
chunks, as the reference's).  Prefill emits no cache, as in the
reference: a server fills the KV cache or SSM state by repeated decode.
Parameters are the reference's tree with each stacked layer group
(``g_dense``, and ``g_moe`` after it for an MoE config; ``g_ssd``;
``g_hyb``, whose layer is ``{"sub": [one dict a sublayer]}``; ``g_enc``
and ``g_dec``, the latter with a second GQA projection set ``xattn``; a
leading layer axis walked by ``lax.scan``) as a list of per-layer dicts
walked by a Python loop; the cache is keyed by group as the reference's
is.  The reference's lowering knobs (head padding ``mp``, ``block_kv``,
``unroll``) and its ``shard`` constraints have no counterpart on one
card, and neither has the reference's ``remat`` switch: when a gradient
is being taken, each layer always runs under ``torch.utils.checkpoint``
(non-reentrant), as the reference's ``_scan_group`` wraps its body in
``jax.checkpoint`` by default, so only the layers' inputs are kept and
each layer is run again in the backward (K4 twice a layer: its
``FlashAttention`` forward, then the recompute).  Training's
loss (``lm_loss``, ``forward_train``) is the reference's chunked
cross-entropy, each chunk's logits recomputed in the backward.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..core.partitioner import resolve_device
from ..dist import decode as DEC
from ..kernels.flash_attention import flash_attention
from . import attention as A
from . import layers as L
from . import mamba as SSM
from . import moe as M
from .config import ModelConfig

Params = dict[str, Any]


# ---------------------------------------------------------------- structure

def layer_groups(cfg: ModelConfig) -> list[tuple[str, int]]:
    if cfg.family == "encdec":
        return [("enc", cfg.n_encoder_layers), ("dec", cfg.n_layers)]
    if cfg.family == "hybrid":
        assert cfg.n_layers % cfg.attn_period == 0
        return [("hyb", cfg.n_layers // cfg.attn_period)]
    if cfg.family == "ssm":
        return [("ssd", cfg.n_layers)]
    if cfg.moe is not None:
        fk = cfg.moe.first_k_dense
        out = []
        if fk:
            out.append(("dense", fk))
        out.append(("moe", cfg.n_layers - fk))
        return out
    return [("dense", cfg.n_layers)]


FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


def require_ported(cfg: ModelConfig) -> None:
    """Raise for a configuration of a family the port does not know; every
    family of the assigned configurations runs."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}, not "
                         f"one of {FAMILIES}")


def _gated(cfg: ModelConfig) -> bool:
    return cfg.norm == "rmsnorm"


def _kind(group: str) -> str:
    return "moe" if group == "moe" else "ffn"


def _sub_kind(cfg: ModelConfig, i: int) -> str:
    """The FFN of a hybrid period's sublayer i."""
    return "moe" if (cfg.moe and i % cfg.moe.every == 1) else "ffn"


def _ssd_dims(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    return {"d_inner": s.expand * cfg.d_model, "d_state": s.d_state,
            "head_dim": s.head_dim}


def _norm_init(cfg, d, device):
    return (L.rmsnorm_init(d, device) if cfg.norm == "rmsnorm"
            else L.layernorm_init(d, device))


def _norm(cfg, p, x):
    return L.rmsnorm(p, x) if cfg.norm == "rmsnorm" else L.layernorm(p, x)


def _attn_init(cfg: ModelConfig, gen, dtype) -> Params:
    if cfg.mla is not None:
        m = cfg.mla
        return A.mla_init(gen, cfg.d_model, cfg.n_heads, q_lora=m.q_lora,
                          kv_lora=m.kv_lora, nope_dim=m.nope_dim,
                          rope_dim=m.rope_dim, v_dim=m.v_dim, dtype=dtype)
    return A.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      cfg.qkv_bias, dtype)


def _ffn_init(cfg: ModelConfig, kind: str, gen, dtype) -> Params:
    if kind == "moe":
        mo = cfg.moe
        return M.moe_init(gen, cfg.d_model, mo.d_expert, mo.n_experts,
                          mo.n_shared, dtype)
    return L.ffn_init(gen, cfg.d_model, cfg.d_ff, gated=_gated(cfg),
                      dtype=dtype)


def _ssd_init(cfg: ModelConfig, gen, dtype) -> Params:
    return SSM.ssd_init(gen, cfg.d_model, **_ssd_dims(cfg), dtype=dtype)


def _init_one_layer(cfg: ModelConfig, group: str, gen, dtype) -> Params:
    d, dev = cfg.d_model, gen.device
    if group == "ssd":
        return {"ln1": _norm_init(cfg, d, dev),
                "ssd": _ssd_init(cfg, gen, dtype)}
    if group == "hyb":
        sub = []
        for i in range(cfg.attn_period):
            mix = ({"attn": _attn_init(cfg, gen, dtype)}
                   if i == cfg.attn_index else
                   {"ssd": _ssd_init(cfg, gen, dtype)})
            sub.append({"ln1": _norm_init(cfg, d, dev),
                        "ln2": _norm_init(cfg, d, dev), **mix,
                        "ffn": _ffn_init(cfg, _sub_kind(cfg, i), gen,
                                         dtype)})
        return {"sub": sub}
    if group == "dec":
        return {"ln1": _norm_init(cfg, d, dev), "ln2": _norm_init(cfg, d, dev),
                "ln3": _norm_init(cfg, d, dev),
                "attn": _attn_init(cfg, gen, dtype),
                "xattn": _attn_init(cfg, gen, dtype),
                "ffn": _ffn_init(cfg, "ffn", gen, dtype)}
    return {"ln1": _norm_init(cfg, d, dev), "ln2": _norm_init(cfg, d, dev),
            "attn": _attn_init(cfg, gen, dtype),
            "ffn": _ffn_init(cfg, _kind(group), gen, dtype)}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.float32) -> Params:
    """Random weights on ``gen``'s device.  Matrices take ``dtype`` (the
    reference serves with weights in the compute type, ``abstract_params
    (dtype=...)``); norm scales and biases stay f32."""
    require_ported(cfg)
    d = cfg.d_model
    p: Params = {
        "embed": L.embedding_init(gen, cfg.padded_vocab, d, dtype),
        "lm_head": L.linear_init(gen, d, cfg.padded_vocab, dtype=dtype),
        "ln_f": _norm_init(cfg, d, gen.device),
    }
    for group, count in layer_groups(cfg):
        p[f"g_{group}"] = [_init_one_layer(cfg, group, gen, dtype)
                           for _ in range(count)]
    return p


def _ffn_param_count(cfg: ModelConfig, kind: str) -> int:
    d = cfg.d_model
    if kind == "moe":
        mo = cfg.moe
        n = d * mo.n_experts + 3 * mo.n_experts * d * mo.d_expert
        return n + 3 * d * mo.n_shared * mo.d_expert
    return (3 if _gated(cfg) else 2) * d * cfg.d_ff


def _attn_param_count(cfg: ModelConfig) -> int:
    d, H = cfg.d_model, cfg.n_heads
    if cfg.mla is not None:
        m = cfg.mla
        return (d * m.q_lora + m.q_lora * H * (m.nope_dim + m.rope_dim)
                + d * (m.kv_lora + m.rope_dim)
                + m.kv_lora * H * (m.nope_dim + m.v_dim) + H * m.v_dim * d)
    q, kv = H * cfg.hd, cfg.n_kv_heads * cfg.hd
    attn = d * q + 2 * d * kv + q * d
    if cfg.qkv_bias:
        attn += q + 2 * kv
    return attn


def _norm_param_count(cfg: ModelConfig) -> int:
    return cfg.d_model if cfg.norm == "rmsnorm" else 2 * cfg.d_model


def _layer_param_count(cfg: ModelConfig, group: str) -> int:
    norm = _norm_param_count(cfg)
    ssd = (SSM.ssd_param_count(cfg.d_model, **_ssd_dims(cfg))
           if cfg.ssm is not None else 0)
    if group == "ssd":
        return norm + ssd
    if group == "hyb":
        return sum(2 * norm + _ffn_param_count(cfg, _sub_kind(cfg, i))
                   + (_attn_param_count(cfg) if i == cfg.attn_index else ssd)
                   for i in range(cfg.attn_period))
    if group == "dec":              # a third norm, the cross-attention
        return 3 * norm + 2 * _attn_param_count(cfg) + _ffn_param_count(
            cfg, "ffn")
    return 2 * norm + _attn_param_count(cfg) + _ffn_param_count(
        cfg, _kind(group))


def param_count(cfg: ModelConfig) -> int:
    """Number of parameters of ``init_params(cfg, ...)``, from the config
    alone."""
    require_ported(cfg)
    return 2 * cfg.padded_vocab * cfg.d_model + _norm_param_count(cfg) + sum(
        count * _layer_param_count(cfg, group)
        for group, count in layer_groups(cfg))


def tree_leaves(tree) -> list:
    """The tensors of a parameter tree (nested dicts and lists)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


# ---------------------------------------------------------------- blocks

def _self_attention(p, x, cfg: ModelConfig, positions, causal: bool = True):
    if cfg.mla is not None:
        m = cfg.mla
        return A.mla_attention(p, x, n_heads=cfg.n_heads, q_lora=m.q_lora,
                               kv_lora=m.kv_lora, nope_dim=m.nope_dim,
                               rope_dim=m.rope_dim, v_dim=m.v_dim,
                               positions=positions, causal=causal)
    B, S, _ = x.shape
    q, k, v = A.gqa_project(p, x, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                            head_dim=cfg.hd, positions=positions,
                            rope_theta=cfg.rope_theta)
    # K4 takes (B, H, S, D); the transposed views are read in place and the
    # output keeps q's layout, so it is (B, S, H, D) again below
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal).transpose(1, 2)
    return L.linear(p["o"], out.reshape(B, S, cfg.n_heads * cfg.hd))


def _cross_attention(p, x, memory, cfg: ModelConfig):
    """A decoder layer's attention over the encoder's output: q from x
    (B, S, D) with no RoPE, k and v from ``memory`` (B, Sm, D) at the KV
    heads, non-causal on K4 (Sq = S, Skv = Sm; the group folded in the
    kernel).  The memory is cast to x's dtype first (the reference
    promotes a mixed pair instead; the two agree where they match, as in
    every caller here)."""
    B, S, _ = x.shape
    mem = memory.to(x.dtype)
    Sm = mem.shape[1]
    q = L.linear(p["q"], x).reshape(B, S, cfg.n_heads, cfg.hd)
    k = L.linear(p["k"], mem).reshape(B, Sm, cfg.n_kv_heads, cfg.hd)
    v = L.linear(p["v"], mem).reshape(B, Sm, cfg.n_kv_heads, cfg.hd)
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=False).transpose(1, 2)
    return L.linear(p["o"], out.reshape(B, S, cfg.n_heads * cfg.hd))


def _ffn_apply(p, x, cfg: ModelConfig, kind: str):
    if kind == "moe":
        mo = cfg.moe
        return M.moe_apply(p, x, n_experts=mo.n_experts, top_k=mo.top_k,
                           capacity_factor=mo.capacity_factor,
                           router_softmax_after_topk=mo.softmax_after_topk)
    return L.ffn(p, x)


def _block(x, lp, cfg: ModelConfig, positions, kind: str,
           causal: bool = True):
    x = x + _self_attention(lp["attn"], _norm(cfg, lp["ln1"], x), cfg,
                            positions, causal)
    return x + _ffn_apply(lp["ffn"], _norm(cfg, lp["ln2"], x), cfg, kind)


def _ssd_apply(p, x, cfg: ModelConfig):
    return SSM.ssd_apply(p, x, **_ssd_dims(cfg), chunk=cfg.ssm.chunk)


def _layer(x, lp, cfg: ModelConfig, positions, group: str, memory=None):
    """One layer of ``group``: a dense or MoE block, an SSD layer (no FFN),
    a hybrid period (each sublayer attention or SSD, then its FFN), an
    encoder layer (non-causal self-attention, then the FFN) or a decoder
    layer (causal self-attention, cross-attention over ``memory``, then
    the FFN after a third norm)."""
    if group == "ssd":
        return x + _ssd_apply(lp["ssd"], _norm(cfg, lp["ln1"], x), cfg)
    if group == "enc":
        return _block(x, lp, cfg, positions, "ffn", causal=False)
    if group == "dec":
        x = x + _self_attention(lp["attn"], _norm(cfg, lp["ln1"], x), cfg,
                                positions)
        x = x + _cross_attention(lp["xattn"], _norm(cfg, lp["ln2"], x),
                                 memory, cfg)
        return x + L.ffn(lp["ffn"], _norm(cfg, lp["ln3"], x))
    if group != "hyb":
        return _block(x, lp, cfg, positions, _kind(group))
    for i, sub in enumerate(lp["sub"]):
        h = _norm(cfg, sub["ln1"], x)
        x = x + (_self_attention(sub["attn"], h, cfg, positions)
                 if i == cfg.attn_index else _ssd_apply(sub["ssd"], h, cfg))
        x = x + _ffn_apply(sub["ffn"], _norm(cfg, sub["ln2"], x), cfg,
                           _sub_kind(cfg, i))
    return x


# ---------------------------------------------------------------- forward

def embed_inputs(params, batch, cfg: ModelConfig, dtype):
    """Returns (x, memory) (the reference also returns the batch's labels,
    which only training reads): the stub frontends hand over precomputed
    embeddings.  encdec: x embeds ``tokens`` and the memory is
    ``src_embeds`` (B, Sm, D) in ``dtype`` (the encoder's input); vlm:
    ``prefix_embeds`` (B, P, D), where the batch has them, go ahead of the
    token embeddings."""
    x = L.embed(params["embed"], batch["tokens"], dtype)
    memory = None
    if cfg.family == "encdec":
        memory = batch["src_embeds"].to(dtype)
    elif cfg.prefix_tokens and "prefix_embeds" in batch:
        x = torch.cat([batch["prefix_embeds"].to(dtype), x], 1)
    return x, memory


def _needs_grad(*trees) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for tree in trees for t in tree_leaves(tree)
        if isinstance(t, torch.Tensor))


def _run_layer(x, lp, cfg: ModelConfig, pos, group: str, memory=None):
    """One layer; when a gradient is being taken, inside a non-reentrant
    checkpoint (only its inputs are saved; it runs again in the
    backward)."""
    if _needs_grad(x, lp, memory):
        return checkpoint(_layer, x, lp, cfg, pos, group, memory,
                          use_reentrant=False)
    return _layer(x, lp, cfg, pos, group, memory)


def encode(params, src_embeds, cfg: ModelConfig,
           dtype=torch.bfloat16) -> torch.Tensor:
    """encdec: ``src_embeds`` (B, Sm, D) through the encoder layers (RoPE
    positions 0..Sm-1, non-causal attention; no final norm, as in the
    reference) → the decoder's memory (B, Sm, D) in ``dtype``; decode
    takes it as ``memory``."""
    x = src_embeds.to(dtype)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    for lp in params["g_enc"]:
        x = _run_layer(x, lp, cfg, pos, "enc")
    return x


def forward(params, batch, cfg: ModelConfig,
            dtype=torch.bfloat16) -> torch.Tensor:
    """batch {"tokens": (B, S) integer; encdec: "src_embeds" (B, Sm, D);
    vlm: "prefix_embeds" (B, P, D), optional} → final hidden states (B, S,
    D), S counting a vlm's prefix positions.  Each layer is checkpointed
    when a gradient is being taken (``_run_layer``)."""
    require_ported(cfg)
    x, memory = embed_inputs(params, batch, cfg, dtype)
    if cfg.family == "encdec":
        memory = encode(params, memory, cfg, dtype)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    for group, _count in layer_groups(cfg):
        if group == "enc":
            continue
        for lp in params[f"g_{group}"]:
            x = _run_layer(x, lp, cfg, pos, group, memory)
    return _norm(cfg, params["ln_f"], x)


def _ce_chunk(w, xb, lb):
    """(summed CE, label count) of one chunk: logits (B, chunk, V) in f32
    from the compute-dtype product, labels −1 masked."""
    logits = (xb @ w.to(xb.dtype)).to(torch.float32)
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, lb.clamp(min=0).long()[..., None])[..., 0]
    mask = lb >= 0
    return (torch.where(mask, lse - gold, 0.0).sum(),
            mask.sum(dtype=torch.float32))


def lm_loss(params, x, labels, cfg: ModelConfig, chunk: int = 512):
    """Chunked CE (the reference's ``lm_loss``): x (B, S, D) and labels
    (B, S), label −1 masked; S padded to whole chunks of ``chunk`` rows
    (pad labels −1); the mean over the unmasked labels, ``tot / max(cnt,
    1)``.  No (B, S, V) tensor is alive at once: each chunk's logits are
    reduced to a sum at once and, when a gradient is being taken,
    recomputed in the backward (a non-reentrant checkpoint a chunk)."""
    B, S, _ = x.shape
    nch = -(-S // chunk)
    pad = nch * chunk - S
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    w = params["lm_head"]["w"]
    grad = _needs_grad(x, w)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nch):
        xb, lb = x[:, c * chunk:(c + 1) * chunk], labels[:, c * chunk:
                                                          (c + 1) * chunk]
        t, n = (checkpoint(_ce_chunk, w, xb, lb, use_reentrant=False)
                if grad else _ce_chunk(w, xb, lb))
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def forward_train(params, batch, cfg: ModelConfig, dtype=torch.bfloat16,
                  loss_chunk: int = 512):
    """The training loss of ``batch`` (its "labels" (B, S), −1 masked):
    ``forward``, then ``lm_loss``."""
    x = forward(params, batch, cfg, dtype)
    return lm_loss(params, x, batch["labels"], cfg, loss_chunk)


# ---------------------------------------------------------------- serving

def _attn_decode(lp, x, ck, cv, cfg: ModelConfig, index: int):
    """x (B, 1, D); ck/cv (B, Smax, Hkv, Dh), written in place at index."""
    B = x.shape[0]
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q, k, v = A.gqa_project(lp, x, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                            head_dim=cfg.hd, positions=pos,
                            rope_theta=cfg.rope_theta)
    ck = DEC.sp_cache_update(ck, k, index)
    cv = DEC.sp_cache_update(cv, v, index)
    out = DEC.sp_decode_attention(q, ck, cv, index)
    return L.linear(lp["o"], out.reshape(B, 1, cfg.n_heads * cfg.hd))


def _mla_decode(lp, x, clat, crope, cfg: ModelConfig, index: int):
    """The absorbed form: x (B, 1, D); clat (B, Smax, kv_lora) and crope
    (B, Smax, rope), written in place at index.  q_nope is taken into the
    latent space through W_uk and the latent output out of it through
    W_uv (both split out of ``kv_b``), in f32; the result is cast to x's
    dtype before ``o``."""
    m = cfg.mla
    B, H = x.shape[0], cfg.n_heads
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q = L.linear(lp["q_b"], L.linear(lp["q_a"], x)).reshape(
        B, 1, H, m.nope_dim + m.rope_dim)
    q_nope, q_rope = q[..., :m.nope_dim], q[..., m.nope_dim:]
    q_rope = L.apply_rope(q_rope, pos)
    kv = L.linear(lp["kv_a"], x)
    lat_row, k_rope_row = kv[..., :m.kv_lora], kv[..., m.kv_lora:]
    k_rope_row = L.apply_rope(k_rope_row[:, :, None, :], pos)[:, :, 0, :]
    clat = DEC.sp_latent_cache_update(clat, lat_row, index)
    crope = DEC.sp_latent_cache_update(crope, k_rope_row, index)
    # W_uk (kv_lora, H, nope) and W_uv (kv_lora, H, v)
    wkv = lp["kv_b"]["w"].reshape(m.kv_lora, H, m.nope_dim + m.v_dim)
    w_uk, w_uv = wkv[..., :m.nope_dim], wkv[..., m.nope_dim:]
    q_lat = torch.einsum("bhd,chd->bhc", q_nope[:, 0].to(torch.float32),
                         w_uk.to(torch.float32))
    o_lat = DEC.sp_decode_attention_latent(
        q_lat, q_rope[:, 0], clat, crope, index, nope_dim=m.nope_dim,
        rope_dim=m.rope_dim)
    o = torch.einsum("bhc,chv->bhv", o_lat, w_uv.to(torch.float32))
    return L.linear(lp["o"], o.reshape(B, 1, H * m.v_dim).to(x.dtype))


def _decode_layer(x, lp, c, i: int, cfg: ModelConfig, group: str,
                  index: int, memory=None):
    """One layer of ``group`` at one token; ``c`` is the group's cache and
    ``i`` the layer's row in it.  A hybrid period's SSD sublayers take the
    rows of its state in order; a decoder layer attends ``memory`` on K4
    at Sq = 1, its k and v recomputed from it (as in the reference)."""
    if group == "ssd":
        return x + SSM.ssd_decode_step(lp["ssd"], _norm(cfg, lp["ln1"], x),
                                       c["state"][i], **_ssd_dims(cfg))[0]
    if group == "dec":
        x = x + _attn_decode(lp["attn"], _norm(cfg, lp["ln1"], x), c["k"][i],
                             c["v"][i], cfg, index)
        x = x + _cross_attention(lp["xattn"], _norm(cfg, lp["ln2"], x),
                                 memory, cfg)
        return x + L.ffn(lp["ffn"], _norm(cfg, lp["ln3"], x))
    if group != "hyb":
        h = _norm(cfg, lp["ln1"], x)
        if cfg.mla is not None:
            x = x + _mla_decode(lp["attn"], h, c["lat"][i], c["rope"][i],
                                cfg, index)
        else:
            x = x + _attn_decode(lp["attn"], h, c["k"][i], c["v"][i], cfg,
                                 index)
        return x + _ffn_apply(lp["ffn"], _norm(cfg, lp["ln2"], x), cfg,
                              _kind(group))
    states = iter(c["state"][i])
    for j, sub in enumerate(lp["sub"]):
        h = _norm(cfg, sub["ln1"], x)
        x = x + (_attn_decode(sub["attn"], h, c["k"][i], c["v"][i], cfg,
                              index) if j == cfg.attn_index else
                 SSM.ssd_decode_step(sub["ssd"], h, next(states),
                                     **_ssd_dims(cfg))[0])
        x = x + _ffn_apply(sub["ffn"], _norm(cfg, sub["ln2"], x), cfg,
                           _sub_kind(cfg, j))
    return x


def init_cache(cfg: ModelConfig, batch_size: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> dict:
    """Zeroed caches of every layer, keyed by layer group as the
    reference's cache is: GQA ``{group: {"k", "v"}}``, each (layers, B,
    max_len, Hkv, Dh); MLA ``{group: {"lat", "rope"}}``, (layers, B,
    max_len, kv_lora) and (layers, B, max_len, rope); SSD ``{"ssd":
    {"state"}}``, (layers, B, H, N, dh) in f32; hybrid ``{"hyb": {"k",
    "v", "state"}}``, the attention sublayer's KV of each period and the
    state of its other sublayers, (periods, period − 1, B, H, N, dh) in
    f32; encdec ``{"dec": {"k", "v"}}`` (the encoder keeps no cache).  On
    ``device``: ``cuda`` unless the caller names another; raises without a
    card."""
    require_ported(cfg)
    device = resolve_device(device)
    cache = {}
    for group, count in layer_groups(cfg):
        if group == "enc":
            continue
        rows = (count, batch_size, max_len)
        if cfg.mla is not None:
            shapes = {"lat": (*rows, cfg.mla.kv_lora),
                      "rope": (*rows, cfg.mla.rope_dim)}
        elif group == "ssd":
            shapes = {}
        else:
            kv = (*rows, cfg.n_kv_heads, cfg.hd)
            shapes = {"k": kv, "v": kv}
        cache[group] = {name: torch.zeros(shape, dtype=dtype, device=device)
                        for name, shape in shapes.items()}
        if group in ("ssd", "hyb"):
            s = cfg.ssm
            per = () if group == "ssd" else (cfg.attn_period - 1,)
            state = (count, *per, batch_size,
                     s.expand * cfg.d_model // s.head_dim, s.d_state,
                     s.head_dim)
            cache[group]["state"] = torch.zeros(
                state, dtype=torch.float32, device=device)
    return cache


def decode_step(params, cache, tokens, index: int, cfg: ModelConfig,
                dtype=torch.bfloat16, memory=None):
    """tokens (B, 1) → (logits (B, 1, V), cache).  ``index`` is the
    position being written; unlike the reference, the cache's tensors (KV
    rows and SSM states) are written in place and the same dict is
    returned.  encdec needs ``memory`` (B, Sm, D), the encoder's output
    (``encode``); a vlm's decode embeds tokens only, as the reference's
    does."""
    require_ported(cfg)
    if cfg.family == "encdec" and memory is None:
        raise ValueError(f"{cfg.name}: an encdec decode step needs memory")
    x = L.embed(params["embed"], tokens, dtype)
    for group, _count in layer_groups(cfg):
        if group == "enc":
            continue
        for i, lp in enumerate(params[f"g_{group}"]):
            x = _decode_layer(x, lp, cache[group], i, cfg, group, index,
                              memory)
    x = _norm(cfg, params["ln_f"], x)
    return L.linear(params["lm_head"], x), cache


def prefill(params, batch, cfg: ModelConfig, dtype=torch.bfloat16):
    """Forward pass returning (last-position logits (B, 1, V), final
    hidden (B, S, D)), as the reference's code does (its module docstring
    speaks of emitted caches; the code emits none)."""
    x = forward(params, batch, cfg, dtype)
    return L.linear(params["lm_head"], x[:, -1:]), x
