"""Sequence-parallel decode: flash-decoding over sharded KV and latent
caches (port of ``repro.dist.decode``).

Decode reads one query token against a long cache, so the cache — not
the heads — is the tensor worth sharding: its sequence dim lands on the
mesh axis of the tag ``sp_seq`` ("model" under ``SINGLE_POD_RULES``).
Under such rules a rank holds its block of ``max_len`` rows (and its
batch rows), computes the partial attention over it for every q head —
the running max m, the sum l and the unnormalised output acc — and the
partials are merged across the axis in one all-gather: m is the largest
of the ranks' maxima, each rank's l and acc are rescaled by exp(m_r − m)
and summed in rank order.  A rank whose rows lie wholly past ``index``
has m_r = −1e30, so its weight is exactly 0.  A cache write touches only
the rank that owns position ``index``.  Where ``resolve_spec`` drops the
axis (``max_len`` does not divide it) the cache is whole on every rank
and the single-device form runs.  The reference lets GSPMD lower its
explicit max-shifted softmax to this combine; PyTorch has no GSPMD, so
the combine is written out.

Outside a ``use_rules`` context every function is the single-device form
(the oracle the tests hold the ranks against); there the cache is whole
and ``max_len`` defaults to its length.  Everything is plain PyTorch (the
reference has no kernel here) in f32, masked by position <= index; the
cache updates write in place.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attention import NEG_INF
from . import collectives as coll
from .mesh import as_axis
from .sharding import active_rules, active_spec


def seq_block(length: int, max_len: int | None):
    """(axis, offset) of a cache block of ``length`` rows whose whole has
    ``max_len`` rows (None: the block is the whole): the bound one-axis
    view of the axis ``sp_seq`` lands on and the block's first position,
    or (None, 0) when the cache is whole."""
    max_len = length if max_len is None else max_len
    entry = active_spec((max_len,), "sp_seq")[0]
    if entry is None:
        if length != max_len:
            raise ValueError(f"a cache of {length} rows where the whole "
                             f"has {max_len} is not sharded by the rules")
        return None, 0
    if isinstance(entry, tuple):
        raise ValueError(f"sp_seq over several axes {entry} is not ported")
    ax = as_axis(active_rules()[1], entry)
    if length * ax.size != max_len:
        raise ValueError(f"a block of {length} rows of {max_len} does not "
                         f"match {ax.size} ranks on {entry!r}")
    return ax, ax.rank * length


def _merge(m, l, acc, ax):
    """out = acc / l over the whole sequence from each rank's partial (m, l
    and acc over its rows; m and l with a last dim of 1)."""
    if ax is not None:
        parts = coll.all_gather(torch.cat([m, l, acc], -1), ax,
                                site="decode.merge")
        pm, pl, pacc = parts[..., :1], parts[..., 1:2], parts[..., 2:]
        w = torch.exp(pm - pm.amax(0))      # 0 for a rank past index
        l, acc = w[0] * pl[0], w[0] * pacc[0]
        for r in range(1, ax.size):         # in rank order
            l, acc = l + w[r] * pl[r], acc + w[r] * pacc[r]
    return acc / torch.clamp(l, min=1e-20)


def _partials(s, v, mask):
    """(m, l, acc) of scores s (..., Sl) masked by ``mask`` over values
    v (..., Sl, D), all f32."""
    s = s.masked_fill(~mask, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    return m, p.sum(-1, keepdim=True), p @ v


def sp_decode_attention(q, k_cache, v_cache, index, *,
                        sm_scale: float | None = None,
                        max_len: int | None = None):
    """One-token GQA attention over the cache prefix [0, index].

    q: (B, 1, Hq, Dh), every head; k_cache/v_cache: (B, Sl, Hkv, Dh), this
    rank's block of a cache of ``max_len`` rows (the whole when
    ``max_len`` is None or the rules do not shard it).  Returns (B, 1, Hq,
    Dh) in q's dtype, the same on every rank of the axis.  Slots past
    ``index`` (zeros, not yet written) are masked.  Q head h reads KV head
    h // ceil(Hq / Hkv), the reference's ``expand_kv`` map; where Hkv
    divides Hq the group is folded into a reshape instead of repeating the
    cache.
    """
    B, Sl, Hkv, Dh = k_cache.shape
    Hq = q.shape[2]
    ax, off = seq_block(Sl, max_len)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(Dh)
    kf, vf = k_cache.to(torch.float32), v_cache.to(torch.float32)
    if Hq % Hkv:                  # padded heads past whole groups
        idx = torch.arange(Hq, device=q.device) // -(-Hq // Hkv)
        kf, vf, Hkv = kf[:, :, idx], vf[:, :, idx], Hq
    qg = (q.to(torch.float32) * scale).reshape(B, Hkv, Hq // Hkv, Dh)
    s = torch.einsum("bkgd,bskd->bkgs", qg, kf)
    mask = torch.arange(off, off + Sl, device=q.device) <= index
    m, l, acc = _partials(s, vf.permute(0, 2, 1, 3), mask)
    return _merge(m, l, acc, ax).reshape(B, 1, Hq, Dh).to(q.dtype)


def sp_cache_update(cache, new, index: int, *, max_len: int | None = None):
    """Write one token's KV row: cache (B, Sl, Hkv, Dh), this rank's block
    of ``max_len`` rows, new (B, 1, Hkv, Dh) at sequence position
    ``index`` — on the rank that owns it; the others keep their block as
    it was.  Unlike the reference's pure ``dynamic_update_slice`` it
    writes into ``cache`` in place and returns it, and a position outside
    the whole cache raises (the reference clamps it to the last row; on
    a mesh no rank would own it)."""
    whole = cache.shape[1] if max_len is None else max_len
    if not 0 <= index < whole:
        raise IndexError(f"cache position {index} outside its {whole} rows")
    _ax, off = seq_block(cache.shape[1], max_len)
    if off <= index < off + cache.shape[1]:
        cache[:, index - off:index - off + 1].copy_(new)
    return cache


def sp_decode_attention_latent(q_lat, q_rope, lat_cache, rope_cache, index,
                               *, nope_dim: int, rope_dim: int,
                               max_len: int | None = None):
    """MLA absorbed decode: attention in the latent space.

    q_lat: (B, H, C), q_nope already absorbed through W_uk; q_rope:
    (B, H, R); lat_cache: (B, Sl, C); rope_cache: (B, Sl, R), this rank's
    block of ``max_len`` rows.  Returns o_lat (B, H, C) in f32 (the caller
    applies W_uv).  The scale is 1/sqrt(nope + rope), the decompressed
    head's; the merge across ranks is the GQA form's."""
    Sl = lat_cache.shape[1]
    ax, off = seq_block(Sl, max_len)
    lat = lat_cache.to(torch.float32)
    rope = rope_cache.to(torch.float32)
    scale = 1.0 / math.sqrt(nope_dim + rope_dim)
    s = (torch.einsum("bhc,bsc->bhs", q_lat.to(torch.float32), lat)
         + torch.einsum("bhr,bsr->bhs", q_rope.to(torch.float32), rope))
    mask = torch.arange(off, off + Sl, device=s.device) <= index
    m, l, acc = _partials(s * scale, lat, mask)
    return _merge(m, l, acc, ax)


def sp_latent_cache_update(cache, new, index: int, *,
                           max_len: int | None = None):
    """Latent-cache variant of ``sp_cache_update``: cache (B, Sl, C), new
    (B, 1, C), written in place at ``index`` on the rank owning it."""
    return sp_cache_update(cache, new, index, max_len=max_len)
