"""One-token decode attention over a KV cache or an MLA latent cache (the
single-device halves of ``repro.dist.decode``).

The reference shards the cache's sequence dim over a mesh axis and lets
GSPMD turn the softmax into flash-decoding's per-shard partials and
logsumexp merge; on one card the cache is whole and these are plain
PyTorch (the reference has no kernel here).  Both forms attend over the
whole ``max_len`` in f32, masked by ``arange(S) <= index``, and the cache
updates write in place.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import NEG_INF


def sp_decode_attention(q, k_cache, v_cache, index, *,
                        sm_scale: float | None = None):
    """One-token GQA attention over the cache prefix [0, index].

    q: (B, 1, Hq, Dh); k_cache/v_cache: (B, Smax, Hkv, Dh).  Returns
    (B, 1, Hq, Dh).  Slots past ``index`` (zeros, not yet written) are
    masked.  Q head h reads KV head h // (Hq / Hkv), as the reference's
    ``expand_kv`` maps them on one card; the group is folded into a
    reshape instead of repeating the cache.
    """
    B, S, Hkv, Dh = k_cache.shape
    Hq = q.shape[2]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Dh)
    qg = (q.to(torch.float32) * scale).reshape(B, Hkv, Hq // Hkv, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(torch.float32))
    mask = torch.arange(S, device=q.device) <= index
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32)) \
        / torch.clamp(p.sum(-1, keepdim=True), min=1e-20)
    return out.reshape(B, 1, Hq, Dh).to(q.dtype)


def sp_cache_update(cache, new, index: int):
    """Write one token's KV row: cache (B, Smax, Hkv, Dh), new
    (B, 1, Hkv, Dh) at sequence position ``index``.  Unlike the
    reference's pure ``dynamic_update_slice``, this writes into ``cache``
    in place and returns it."""
    cache[:, index:index + 1].copy_(new)
    return cache


def sp_decode_attention_latent(q_lat, q_rope, lat_cache, rope_cache, index,
                               *, nope_dim: int, rope_dim: int):
    """MLA absorbed decode: attention in the latent space.

    q_lat: (B, H, C), q_nope already absorbed through W_uk; q_rope:
    (B, H, R); lat_cache: (B, Smax, C); rope_cache: (B, Smax, R).  Returns
    o_lat (B, H, C) in f32 (the caller applies W_uv).  The scale is
    1/sqrt(nope + rope), the decompressed head's."""
    S = lat_cache.shape[1]
    lat = lat_cache.to(torch.float32)
    rope = rope_cache.to(torch.float32)
    scale = 1.0 / math.sqrt(nope_dim + rope_dim)
    s = (torch.einsum("bhc,bsc->bhs", q_lat.to(torch.float32), lat)
         + torch.einsum("bhr,bsr->bhs", q_rope.to(torch.float32), rope))
    s = s * scale
    mask = torch.arange(S, device=s.device) <= index
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return torch.einsum("bhs,bsc->bhc", p, lat) \
        / torch.clamp(p.sum(-1, keepdim=True), min=1e-20)


def sp_latent_cache_update(cache, new, index: int):
    """Latent-cache variant of ``sp_cache_update``: cache (B, Smax, C),
    new (B, 1, C), written in place at ``index`` and returned."""
    return sp_cache_update(cache, new, index)
