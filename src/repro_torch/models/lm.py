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
  lm_loss(params, x, labels, cfg, chunk, mp, rows) — chunked cross-entropy
  forward_train(params, batch, cfg, dtype, loss_chunk, mp, gather, rows)
                                      — the training loss

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
is.  ``mp`` pads the q heads to a multiple of it, as the reference's does
(``attention`` module docstring); the reference's other lowering knobs
(``block_kv``, ``unroll``) have no counterpart, and neither has its
``remat`` switch: when a gradient
is being taken, each layer always runs under ``torch.utils.checkpoint``
(non-reentrant), as the reference's ``_scan_group`` wraps its body in
``jax.checkpoint`` by default, so only the layers' inputs are kept and
each layer is run again in the backward (K4 twice a layer: its
``FlashAttention`` forward, then the recompute).  Training's
loss (``lm_loss``, ``forward_train``) is the reference's chunked
cross-entropy, each chunk's logits recomputed in the backward.

Under a mesh (an active ``dist.sharding.use_rules(rules, mesh)`` on a
bound mesh with a "model" axis; the dense GQA families, qwen2 and the
like, the VLM, and llama4-scout's MoE family for serving) each rank
holds its blocks of the parameters
(``train.shardings.param_specs``: columns of q, k, v, gate and up, rows
of o and down, rows of the embedding table, columns of ``lm_head``, each
split over "model" where it divides) and runs on its batch rows; the
step builders (``train.step``) and the launcher (``launch.serve``) split
the batch over "data" and gather what comes back.  PyTorch has no GSPMD,
so at each of the reference's ``shard`` points the collective its
compiler would insert is made here, through ``dist.collectives`` and
named by call site (``TensorParallel`` holds the decisions):

- ``repro/models/lm.py:319``, after the embedding: the table's rows are split over
  the vocabulary; each rank looks up the tokens it owns, zeros the rest
  and the rows are summed over "model" (``embed``).
- ``:182``, q on "heads": the rank's heads are its columns of q and
  of its bias (where the heads do not divide the axis but q's columns
  do, the columns are gathered over "model", ``attn.qkv``).
- ``:187-188``, k and v: where KV heads divide the axis
  (``kv_heads_sharded``) they are the rank's own heads; else they are
  replicated, and where ``param_specs`` still split their columns (Hkv ·
  Dh divides the axis) the columns are gathered over "model" before RoPE
  (``attn.qkv``, the GQA all-gather of ``:183-185``; q's and k/v's
  gathers are one call).  The q heads a
  rank attends read KV heads by ``expand_kv``'s map
  (``attention.kv_index``).
- ``:191`` then ``:214``: o and down are row-parallel; the partial
  products are summed over "model" in rank order (``attn.o``,
  ``ffn.down``) and a replicated bias is added once, after the sum.
- ``:351``, logits on "vocab": ``prefill`` returns its last
  position's logits gathered over "model" (``logits``), (B, 1, Vp) of
  the rank's batch rows; ``decode_step`` returns the rank's columns, and
  ``launch.serve.generate`` takes the greedy argmax across the axis.
  ``lm_loss`` is vocab-parallel there: the row max is a ``pmax`` over
  "model" (detached), the sum of exponentials and the gold logit (from
  the rank that owns the label's column) are summed over it, and the
  loss's numerator and label count are summed over the axes the batch
  rows are split on (``rows``) before the division.
- ``repro/models/moe.py:96-116``, experts on "model": model rank r owns
  experts [r·E/n, (r + 1)·E/n) (``param_specs`` splits the banks); the
  router is replicated, so every rank builds the same dispatch tables,
  reads its experts' slots from its own (whole) activations, and adds
  its experts' gated outputs into the f32 combine buffer, which is
  summed over "model" in rank order (``moe.combine``).  The reference's
  data → experts all-to-all is that local read (ROADMAP, Queue 3).
- Decode (``:385``): the projections run as in prefill, then q, k
  and v are gathered over "model" in one call (``decode.qkv``) to every
  head, since ``cache_specs`` keeps heads whole and splits the sequence;
  the owner of position ``index`` writes the k/v row into its block,
  every rank attends its block for every head and the partials are
  merged (``dist.decode``, ``decode.merge``); each rank keeps its own
  heads' rows for the row-parallel o.

Training under a mesh (the dense GQA families) takes the gradient
through every one of these points (``layers``' module docstring gives
each backward).  With ZeRO-3 placement (``train.shardings.place_params(
mesh, zero=True)``) each weight's block is also cut over "data": the
blocks are cast to the compute dtype first (``train.step``), then
gathered over "data" inside each layer's checkpoint (``gather_blocks``,
the plan ``train.shardings.gather_plan`` gives), so the gathered layer
lives only while it runs and is gathered again in the recompute; the
gradient comes back reduce-scattered over "data" in rank order.  The
table and ``lm_head`` are gathered once a step, outside the loss's
chunk checkpoints.

bf16 partial sums are added in rank order in f32 and rounded once, where
the reference's GSPMD sums in its own order (ROADMAP, Queue 3).  MLA,
SSD, the hybrid and the encoder–decoder raise under a mesh (MLA's
tensor-parallel path is not ported), MoE raises there when a gradient
is taken, and so do context-parallel rules (``CP_SERVE_RULES``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from ..core.partitioner import resolve_device
from ..dist import collectives as coll
from ..dist import decode as DEC
from ..dist.mesh import as_axis
from ..dist.sharding import active_rules, active_spec, entry_axes
from ..kernels.flash_attention import flash_attention
from ..tree import tree_leaves
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


def _require_unpadded_mla(cfg: ModelConfig, mp: int) -> None:
    if cfg.mla is not None and mp != 1:
        raise ValueError(f"{cfg.name}: MLA with padded heads (mp={mp}) is "
                         "part of MLA's tensor-parallel path, not ported")


def _attn_init(cfg: ModelConfig, gen, dtype, mp: int) -> Params:
    if cfg.mla is not None:
        _require_unpadded_mla(cfg, mp)
        m = cfg.mla
        return A.mla_init(gen, cfg.d_model, cfg.n_heads, q_lora=m.q_lora,
                          kv_lora=m.kv_lora, nope_dim=m.nope_dim,
                          rope_dim=m.rope_dim, v_dim=m.v_dim, dtype=dtype)
    return A.gqa_init(gen, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                      cfg.qkv_bias, dtype, pad_heads_to=mp)


def _ffn_init(cfg: ModelConfig, kind: str, gen, dtype) -> Params:
    if kind == "moe":
        mo = cfg.moe
        return M.moe_init(gen, cfg.d_model, mo.d_expert, mo.n_experts,
                          mo.n_shared, dtype)
    return L.ffn_init(gen, cfg.d_model, cfg.d_ff, gated=_gated(cfg),
                      dtype=dtype)


def _ssd_init(cfg: ModelConfig, gen, dtype) -> Params:
    return SSM.ssd_init(gen, cfg.d_model, **_ssd_dims(cfg), dtype=dtype)


def init_layer(cfg: ModelConfig, group: str, gen, dtype=torch.float32,
               mp: int = 1) -> Params:
    """One layer of ``group`` with random weights from ``gen`` (the draws
    ``init_params`` makes for each layer of the group, in its order)."""
    d, dev = cfg.d_model, gen.device
    if group == "ssd":
        return {"ln1": _norm_init(cfg, d, dev),
                "ssd": _ssd_init(cfg, gen, dtype)}
    if group == "hyb":
        sub = []
        for i in range(cfg.attn_period):
            mix = ({"attn": _attn_init(cfg, gen, dtype, mp)}
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
                "attn": _attn_init(cfg, gen, dtype, mp),
                "xattn": _attn_init(cfg, gen, dtype, mp),
                "ffn": _ffn_init(cfg, "ffn", gen, dtype)}
    return {"ln1": _norm_init(cfg, d, dev), "ln2": _norm_init(cfg, d, dev),
            "attn": _attn_init(cfg, gen, dtype, mp),
            "ffn": _ffn_init(cfg, _kind(group), gen, dtype)}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.float32, mp: int = 1, place=None) -> Params:
    """Random weights on ``gen``'s device, q heads padded to a multiple of
    ``mp``.  Matrices take ``dtype`` (the reference serves with weights in
    the compute type, ``abstract_params(dtype=...)``); norm scales and
    biases stay f32.  ``place(path, part)``, when given, maps each part
    right after it is drawn (the embedding, the head, the final norm, one
    layer; its path in the reference's key notation, ``['g_dense'][3]``)
    and its result is kept: ``train.shardings.place_params`` keeps a
    rank's blocks, so a rank replays every draw of the whole tree with one
    part whole at a time."""
    require_ported(cfg)
    keep = place or (lambda _path, part: part)
    d = cfg.d_model
    p: Params = {
        "embed": keep("['embed']",
                      L.embedding_init(gen, cfg.padded_vocab, d, dtype)),
        "lm_head": keep("['lm_head']", L.linear_init(
            gen, d, cfg.padded_vocab, dtype=dtype)),
        "ln_f": keep("['ln_f']", _norm_init(cfg, d, gen.device)),
    }
    for group, count in layer_groups(cfg):
        p[f"g_{group}"] = [keep(f"['g_{group}'][{i}]",
                                init_layer(cfg, group, gen, dtype, mp))
                           for i in range(count)]
    return p


def _ffn_param_count(cfg: ModelConfig, kind: str) -> int:
    d = cfg.d_model
    if kind == "moe":
        mo = cfg.moe
        n = d * mo.n_experts + 3 * mo.n_experts * d * mo.d_expert
        return n + 3 * d * mo.n_shared * mo.d_expert
    return (3 if _gated(cfg) else 2) * d * cfg.d_ff


def _attn_param_count(cfg: ModelConfig, mp: int) -> int:
    d, H = cfg.d_model, L.round_up(cfg.n_heads, mp)
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


def _layer_param_count(cfg: ModelConfig, group: str, mp: int) -> int:
    norm = _norm_param_count(cfg)
    ssd = (SSM.ssd_param_count(cfg.d_model, **_ssd_dims(cfg))
           if cfg.ssm is not None else 0)
    if group == "ssd":
        return norm + ssd
    if group == "hyb":
        return sum(2 * norm + _ffn_param_count(cfg, _sub_kind(cfg, i))
                   + (_attn_param_count(cfg, mp) if i == cfg.attn_index
                      else ssd)
                   for i in range(cfg.attn_period))
    if group == "dec":              # a third norm, the cross-attention
        return 3 * norm + 2 * _attn_param_count(cfg, mp) + _ffn_param_count(
            cfg, "ffn")
    return 2 * norm + _attn_param_count(cfg, mp) + _ffn_param_count(
        cfg, _kind(group))


def param_count(cfg: ModelConfig, mp: int = 1) -> int:
    """Number of parameters of ``init_params(cfg, ..., mp=mp)``, from the
    config alone."""
    require_ported(cfg)
    _require_unpadded_mla(cfg, mp)
    return 2 * cfg.padded_vocab * cfg.d_model + _norm_param_count(cfg) + sum(
        count * _layer_param_count(cfg, group, mp)
        for group, count in layer_groups(cfg))


# ------------------------------------------------------ tensor parallel

@dataclass(frozen=True)
class TensorParallel:
    """This rank's share of a model: the decisions at the reference's
    ``shard`` points (module docstring), made once from the config, the
    active rules and the mesh.  ``model`` is the bound "model" axis (None:
    one device, every weight whole, every field below the plain
    layer's)."""
    hp: int                      # q heads, padded to a multiple of mp
    n_kv: int
    hd: int
    model: Any = None
    heads: tuple = (0, 0)        # (first, count): the q heads attended here
    q_gather: bool = False       # q's columns split, its heads not
    kv: tuple = (0, 0)           # (first, count): the KV heads held here
    kv_gather: bool = False      # k/v columns split, their heads not
    rows: bool = False           # q columns / o rows split (row-parallel o)
    ffn: bool = False            # gate/up columns and down rows split
    vocab: bool = False          # table rows and lm_head columns split
    experts: bool = False        # the expert banks split (by expert)
    shared: bool = False         # the shared expert's columns/rows split

    @property
    def kv_cols(self) -> bool:
        """k/v columns split over the model axis."""
        return self.kv_gather or self.kv[1] < self.n_kv

    def axis(self, split: bool):
        """The axis a split part is summed or gathered over."""
        return self.model if split else None

    def o_input(self, out):
        """An attention output (…, heads · Dh) cut to the rows of o this
        rank holds: where it has every head and o's rows are split, this
        rank's block of them (the heads this rank attends, when split,
        are that block already)."""
        if self.rows and out.shape[-1] == self.hp * self.hd:
            n = out.shape[-1] // self.model.size
            return out[..., self.model.rank * n:(self.model.rank + 1) * n]
        return out


def tensor_parallel(cfg: ModelConfig, mp: int = 1) -> TensorParallel:
    """The plan of ``cfg`` (q heads padded to a multiple of ``mp``) under
    the active ``use_rules`` context; the whole model outside one.  Weights
    are split over "model" where ``train.shardings.param_specs`` splits
    them and the dim divides; q and k/v activations follow the rules'
    "heads" and ``kv_heads(_sharded)`` tags, as the reference's ``shard``
    points resolve them.  Raises for what does not run under a mesh (a
    gradient through MoE there raises in ``_ffn_apply``)."""
    _require_unpadded_mla(cfg, mp)
    hp, n_kv, hd = L.round_up(cfg.n_heads, mp), cfg.n_kv_heads, cfg.hd
    whole = TensorParallel(hp, n_kv, hd, heads=(0, hp), kv=(0, n_kv))
    ctx = active_rules()
    if ctx is None:
        return whole
    rules, mesh = ctx
    if cfg.family not in ("dense", "vlm", "moe") or cfg.mla:
        raise ValueError(f"{cfg.name}: under a mesh only the dense GQA "
                         "families and GQA MoE run (MLA's tensor-parallel "
                         "path and the SSD, hybrid and encoder–decoder "
                         "families are not ported)")
    if rules.get("seq") is not None:
        raise ValueError("context-parallel rules (the sequence on a mesh "
                         "axis) are not ported")
    n = mesh.shape.get("model", 1)
    if n == 1:
        return whole
    if not mesh.bound:
        raise ValueError("a model runs on a bound mesh (inside a rank)")
    model = as_axis(mesh, "model")
    heads_on = active_spec((1, 1, hp, hd), "batch", "seq", "heads", None)[2]
    kv_tag = "kv_heads_sharded" if n_kv % mp == 0 else "kv_heads"
    kv_on = active_spec((1, 1, n_kv, hd), "batch", None, kv_tag, None)[2]
    if {heads_on, kv_on} - {None, "model"}:
        raise ValueError(f"heads on {heads_on!r} and KV heads on {kv_on!r}: "
                         "only the model axis is ported")
    r = model.rank
    heads = (r * hp // n, hp // n) if heads_on else (0, hp)
    kv = (r * n_kv // n, n_kv // n) if kv_on else (0, n_kv)
    reps = -(-hp // n_kv)           # expand_kv's map
    if kv_on and not (kv[0] <= heads[0] // reps
                      and (sum(heads) - 1) // reps < sum(kv)):
        kv, kv_on = (0, n_kv), None   # the heads read KV heads held elsewhere
    rows = hp * hd % n == 0
    mo = cfg.moe
    return TensorParallel(hp, n_kv, hd, model, heads,
                          q_gather=rows and not heads_on, kv=kv,
                          kv_gather=n_kv * hd % n == 0 and not kv_on,
                          rows=rows, ffn=cfg.d_ff % n == 0,
                          vocab=cfg.padded_vocab % n == 0,
                          experts=mo is not None and mo.n_experts % n == 0,
                          shared=mo is not None
                          and mo.n_shared * mo.d_expert % n == 0)


# ---------------------------------------------------------------- blocks

def _attend(q, k, v, tp: TensorParallel, causal: bool):
    """q (B, S, the attended heads, Dh), k/v (B, Skv, the held KV heads,
    Dh) on K4, each q head reading its KV head by ``expand_kv``'s map →
    (B, S, heads · Dh)."""
    h0, hl = tp.heads
    idx = A.kv_index(h0, hl, tp.hp, tp.n_kv, *tp.kv)
    out = flash_attention(q.transpose(1, 2), k[:, :, idx].transpose(1, 2),
                          v[:, :, idx].transpose(1, 2),
                          causal=causal).transpose(1, 2)
    return out.reshape(*out.shape[:2], -1)


def gqa_project(p, x, tp: TensorParallel, positions, rope_theta: float,
                *, every_head: bool = False):
    """x (B, S, d_model) → q, k, v (B, S, heads, Dh), RoPE applied to q
    and k: this rank's columns of q, k and v (each with its columns of the
    bias), then one all-gather over the model axis of those that must come
    back whole — in prefill q where its heads are not split (``q_gather``)
    and k/v where their columns are split and their heads not
    (``kv_gather``): q at the heads this rank attends, k/v at the KV heads
    it holds; with ``every_head`` (decode, whose cache keeps heads whole)
    every split one, so q, k and v come back at every head.

    Gradients: where o is row-parallel (``tp.rows``) each rank's
    attention carries the gradient of its own heads only, so what the
    ranks share — ``x`` and any k/v projection left whole — has its
    gradient summed over "model" (``copy_grad``) and the gathers
    reduce-scatter theirs; otherwise every rank runs the whole attention
    alike and a gather keeps the rank's slice of its gradient."""
    B, S, _ = x.shape
    part = tp.axis(tp.rows)
    x = coll.copy_grad(x, part, site="attn.in")
    split = {"q": tp.rows, "k": tp.kv_cols, "v": tp.kv_cols}

    def shared(n):                  # a projection every rank holds whole
        if split[n] or part is None:
            return p[n]
        return {k: coll.copy_grad(t, part, site="attn.kv")
                for k, t in p[n].items()}
    y = {n: L.linear_cols(shared(n), x, tp.axis(s))
         for n, s in split.items()}
    whole = ({"q": tp.rows, "k": tp.kv_cols, "v": tp.kv_cols} if every_head
             else {"q": tp.q_gather, "k": tp.kv_gather, "v": tp.kv_gather})
    names = [n for n, w in whole.items() if w]
    if names:
        y.update(zip(names, L.gather_cols(
            [y[n] for n in names], tp.model,
            site="decode.qkv" if every_head else "attn.qkv",
            alike=part is None)))
    q, k, v = (y[n].reshape(B, S, -1, tp.hd) for n in ("q", "k", "v"))
    return (L.apply_rope(q, positions, rope_theta),
            L.apply_rope(k, positions, rope_theta), v)


def _self_attention(p, x, cfg: ModelConfig, tp: TensorParallel, positions,
                    causal: bool = True):
    if cfg.mla is not None:
        m = cfg.mla
        return A.mla_attention(p, x, n_heads=cfg.n_heads, q_lora=m.q_lora,
                               kv_lora=m.kv_lora, nope_dim=m.nope_dim,
                               rope_dim=m.rope_dim, v_dim=m.v_dim,
                               positions=positions, causal=causal)
    q, k, v = gqa_project(p, x, tp, positions, cfg.rope_theta)
    out = _attend(q, k, v, tp, causal)
    return L.linear_rows(p["o"], tp.o_input(out), tp.axis(tp.rows),
                         site="attn.o")


def _cross_attention(p, x, memory, cfg: ModelConfig, tp: TensorParallel):
    """A decoder layer's attention over the encoder's output: q from x
    (B, S, D) with no RoPE, k and v from ``memory`` (B, Sm, D) at the KV
    heads, non-causal on K4 (Sq = S, Skv = Sm; the group folded in the
    kernel).  The memory is cast to x's dtype first (the reference
    promotes a mixed pair instead; the two agree where they match, as in
    every caller here)."""
    B, S, _ = x.shape
    mem = memory.to(x.dtype)
    Sm = mem.shape[1]
    q = L.linear(p["q"], x).reshape(B, S, tp.hp, cfg.hd)
    k = L.linear(p["k"], mem).reshape(B, Sm, cfg.n_kv_heads, cfg.hd)
    v = L.linear(p["v"], mem).reshape(B, Sm, cfg.n_kv_heads, cfg.hd)
    return L.linear(p["o"], _attend(q, k, v, tp, causal=False))


def _ffn_apply(p, x, cfg: ModelConfig, tp: TensorParallel, kind: str):
    if kind == "moe":
        if active_rules() is not None and _needs_grad(x, p):
            raise ValueError(f"{cfg.name}: a gradient through MoE under a "
                             "mesh is not ported (serving only)")
        mo = cfg.moe
        return M.moe_apply(p, x, n_experts=mo.n_experts, top_k=mo.top_k,
                           capacity_factor=mo.capacity_factor,
                           router_softmax_after_topk=mo.softmax_after_topk,
                           axis=tp.axis(tp.experts),
                           shared_axis=tp.axis(tp.shared))
    return L.ffn(p, x, tp.axis(tp.ffn))


def _block(x, lp, cfg: ModelConfig, tp: TensorParallel, positions,
           kind: str, causal: bool = True):
    x = x + _self_attention(lp["attn"], _norm(cfg, lp["ln1"], x), cfg, tp,
                            positions, causal)
    return x + _ffn_apply(lp["ffn"], _norm(cfg, lp["ln2"], x), cfg, tp, kind)


def _ssd_apply(p, x, cfg: ModelConfig):
    return SSM.ssd_apply(p, x, **_ssd_dims(cfg), chunk=cfg.ssm.chunk)


def gather_blocks(tree, plan):
    """ZeRO-3: each leaf of ``tree`` (this rank's block) gathered along the
    (dim, axis) pairs of its ``plan`` entry (``train.shardings.
    gather_plan``), in one all-gather a pair; the gradient comes back
    reduce-scattered in rank order.  ``tree`` as it is when ``plan`` is
    None."""
    if plan is None:
        return tree
    if isinstance(tree, dict):
        return {k: gather_blocks(v, plan[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [gather_blocks(v, q) for v, q in zip(tree, plan)]
    for d, axis in plan:
        tree = coll.all_gather_grad(tree, axis, d, site="zero.gather")
    return tree


def _layer(x, lp, cfg: ModelConfig, tp: TensorParallel, positions,
           group: str, memory=None, plan=None):
    """One layer of ``group``: a dense or MoE block, an SSD layer (no FFN),
    a hybrid period (each sublayer attention or SSD, then its FFN), an
    encoder layer (non-causal self-attention, then the FFN) or a decoder
    layer (causal self-attention, cross-attention over ``memory``, then
    the FFN after a third norm).  With a ZeRO ``plan`` the layer's blocks
    are gathered first, here, inside the layer's checkpoint."""
    lp = gather_blocks(lp, plan)
    if group == "ssd":
        return x + _ssd_apply(lp["ssd"], _norm(cfg, lp["ln1"], x), cfg)
    if group == "enc":
        return _block(x, lp, cfg, tp, positions, "ffn", causal=False)
    if group == "dec":
        x = x + _self_attention(lp["attn"], _norm(cfg, lp["ln1"], x), cfg,
                                tp, positions)
        x = x + _cross_attention(lp["xattn"], _norm(cfg, lp["ln2"], x),
                                 memory, cfg, tp)
        return x + L.ffn(lp["ffn"], _norm(cfg, lp["ln3"], x))
    if group != "hyb":
        return _block(x, lp, cfg, tp, positions, _kind(group))
    for i, sub in enumerate(lp["sub"]):
        h = _norm(cfg, sub["ln1"], x)
        x = x + (_self_attention(sub["attn"], h, cfg, tp, positions)
                 if i == cfg.attn_index else _ssd_apply(sub["ssd"], h, cfg))
        x = x + _ffn_apply(sub["ffn"], _norm(cfg, sub["ln2"], x), cfg, tp,
                           _sub_kind(cfg, i))
    return x


# ---------------------------------------------------------------- forward

def embed_inputs(params, batch, cfg: ModelConfig, dtype,
                 tp: TensorParallel):
    """Returns (x, memory) (the reference also returns the batch's labels,
    which only training reads): the stub frontends hand over precomputed
    embeddings.  encdec: x embeds ``tokens`` and the memory is
    ``src_embeds`` (B, Sm, D) in ``dtype`` (the encoder's input); vlm:
    ``prefix_embeds`` (B, P, D), where the batch has them, go ahead of the
    token embeddings.  Under a mesh (``tp``) the lookup is
    vocab-parallel."""
    x = L.embed(params["embed"], batch["tokens"], dtype, tp.axis(tp.vocab))
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


def _run_layer(x, lp, cfg: ModelConfig, pos, group: str, tp, memory=None,
               plan=None):
    """One layer; when a gradient is being taken, inside a non-reentrant
    checkpoint (only its inputs — the blocks as this rank holds them —
    are saved; it runs again in the backward, its ZeRO gathers too)."""
    if _needs_grad(x, lp, memory):
        return checkpoint(_layer, x, lp, cfg, tp, pos, group, memory, plan,
                          use_reentrant=False)
    return _layer(x, lp, cfg, tp, pos, group, memory, plan)


def run_layers(x, layers, cfg: ModelConfig, group: str = "dense",
               mp: int = 1, memory=None, plan=None):
    """x (B, S, D) through ``layers`` (a list of layers of ``group``, in
    order; positions 0..S−1) — a pipeline stage's part of the model
    (``dist.pipeline_parallel``).  ``plan``: the layers' ZeRO gather
    plans (``gather_blocks``)."""
    tp = tensor_parallel(cfg, mp)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    for lp, lplan in zip(layers, plan or [None] * len(layers)):
        x = _run_layer(x, lp, cfg, pos, group, tp, memory, lplan)
    return x


def encode(params, src_embeds, cfg: ModelConfig, dtype=torch.bfloat16,
           mp: int = 1) -> torch.Tensor:
    """encdec: ``src_embeds`` (B, Sm, D) through the encoder layers (RoPE
    positions 0..Sm-1, non-causal attention; no final norm, as in the
    reference) → the decoder's memory (B, Sm, D) in ``dtype``; decode
    takes it as ``memory``."""
    return run_layers(src_embeds.to(dtype), params["g_enc"], cfg, "enc", mp)


def forward(params, batch, cfg: ModelConfig, dtype=torch.bfloat16,
            mp: int = 1, gather=None) -> torch.Tensor:
    """batch {"tokens": (B, S) integer; encdec: "src_embeds" (B, Sm, D);
    vlm: "prefix_embeds" (B, P, D), optional} → final hidden states (B, S,
    D), S counting a vlm's prefix positions.  Each layer is checkpointed
    when a gradient is being taken (``_run_layer``).  Under a mesh
    ``params`` are the rank's blocks, the batch its rows, and the hidden
    states the same on every rank of the model axis; ``gather`` is the
    ZeRO gather plan of ``params`` (``train.shardings.gather_plan``): the
    table is gathered once here, each layer inside its checkpoint."""
    require_ported(cfg)
    tp = tensor_parallel(cfg, mp)
    plan = gather or {}
    x, memory = embed_inputs(
        {"embed": gather_blocks(params["embed"], plan.get("embed"))}, batch,
        cfg, dtype, tp)
    if cfg.family == "encdec":
        memory = encode(params, memory, cfg, dtype, mp)
    for group, _count in layer_groups(cfg):
        if group != "enc":
            x = run_layers(x, params[f"g_{group}"], cfg, group, mp, memory,
                           plan.get(f"g_{group}"))
    return _norm(cfg, gather_blocks(params["ln_f"], plan.get("ln_f")), x)


def _ce_chunk(w, xb, lb):
    """(summed CE, label count) of one chunk: logits (B, chunk, V) in f32
    from the compute-dtype product, labels −1 masked."""
    logits = (xb @ w.to(xb.dtype)).to(torch.float32)
    lse = torch.logsumexp(logits, -1)
    gold = logits.gather(-1, lb.clamp(min=0).long()[..., None])[..., 0]
    mask = lb >= 0
    return (torch.where(mask, lse - gold, 0.0).sum(),
            mask.sum(dtype=torch.float32))


def _ce_chunk_vocab(w, xb, lb, model):
    """``_ce_chunk`` where w holds this rank's columns of the vocabulary
    (``model``'s rank r: columns [r·n, (r + 1)·n)): the row max is a
    ``pmax`` over the axis (detached; any shift gives the same function),
    the sum of exponentials and the gold logit (the owner's, zeros
    elsewhere) are summed over it; both sums pass their gradient through
    as it is (every rank uses them alike)."""
    logits = (xb @ w.to(xb.dtype)).to(torch.float32)
    top = coll.pmax(logits.detach().amax(-1), model, site="loss.max")
    sumexp = coll.psum_grad((logits - top[..., None]).exp().sum(-1), model,
                            site="loss.sumexp")
    lse = top + torch.log(sumexp)
    n = w.shape[1]
    local = lb.long() - model.rank * n
    own = (local >= 0) & (local < n)
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = coll.psum_grad(torch.where(own, gold, 0.0), model,
                          site="loss.gold")
    mask = lb >= 0
    return (torch.where(mask, lse - gold, 0.0).sum(),
            mask.sum(dtype=torch.float32))


def lm_loss(params, x, labels, cfg: ModelConfig, chunk: int = 512,
            mp: int = 1, rows: tuple = ()):
    """Chunked CE (the reference's ``lm_loss``): x (B, S, D) and labels
    (B, S), label −1 masked; S padded to whole chunks of ``chunk`` rows
    (pad labels −1); the mean over the unmasked labels, ``tot / max(cnt,
    1)``.  No (B, S, V) tensor is alive at once: each chunk's logits are
    reduced to a sum at once and, when a gradient is being taken,
    recomputed in the backward (a non-reentrant checkpoint a chunk).
    Under a mesh whose "model" axis splits ``lm_head``'s columns the
    chunks are vocab-parallel (``_ce_chunk_vocab``; x's gradient summed
    over the axis once, outside the chunks); ``rows``: the bound axes the
    batch rows are split over, across which tot and cnt are summed before
    the division, so every rank returns the whole batch's loss."""
    B, S, _ = x.shape
    nch = -(-S // chunk)
    pad = nch * chunk - S
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    w = params["lm_head"]["w"]
    grad = _needs_grad(x, w)
    tp = tensor_parallel(cfg, mp)
    model = tp.axis(tp.vocab)
    fn, extra = _ce_chunk, ()
    if model is not None:
        x = coll.copy_grad(x, model, site="loss.in")
        fn, extra = _ce_chunk_vocab, (model,)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(nch):
        xb, lb = x[:, c * chunk:(c + 1) * chunk], labels[:, c * chunk:
                                                          (c + 1) * chunk]
        t, n = (checkpoint(fn, w, xb, lb, *extra, use_reentrant=False)
                if grad else fn(w, xb, lb, *extra))
        tot, cnt = tot + t, cnt + n
    if rows:
        both = torch.stack([tot, cnt])
        for axis in rows:
            both = coll.psum_grad(both, axis, site="loss.rows")
        tot, cnt = both[0], both[1]
    return tot / torch.clamp(cnt, min=1.0)


def forward_train(params, batch, cfg: ModelConfig, dtype=torch.bfloat16,
                  loss_chunk: int = 512, mp: int = 1, gather=None,
                  rows: tuple = ()):
    """The training loss of ``batch`` (its "labels" (B, S), −1 masked):
    ``forward``, then ``lm_loss``.  Under a mesh: ``gather`` is the ZeRO
    gather plan of ``params`` (``lm_head`` is gathered once, before the
    loss's chunks) and ``rows`` the axes the batch's rows are split
    over."""
    plan = gather or {}
    x = forward(params, batch, cfg, dtype, mp, gather)
    head = gather_blocks(params["lm_head"], plan.get("lm_head"))
    return lm_loss({"lm_head": head}, x, batch["labels"], cfg, loss_chunk,
                   mp, rows)


# ---------------------------------------------------------------- serving

def _attn_decode(lp, x, ck, cv, cfg: ModelConfig, tp: TensorParallel,
                 index: int, max_len: int | None = None):
    """x (B, 1, D); ck/cv (B, Sl, Hkv, Dh), this rank's block of the
    cache (the whole on one device), written in place at index by its
    owner.  Every head attends (q, k and v gathered over the model axis),
    then o is row-parallel."""
    B = x.shape[0]
    pos = torch.full((B, 1), index, dtype=torch.int32, device=x.device)
    q, k, v = gqa_project(lp, x, tp, pos, cfg.rope_theta, every_head=True)
    ck = DEC.sp_cache_update(ck, k, index, max_len=max_len)
    cv = DEC.sp_cache_update(cv, v, index, max_len=max_len)
    out = DEC.sp_decode_attention(q, ck, cv, index, max_len=max_len)
    return L.linear_rows(lp["o"], tp.o_input(out.reshape(B, 1, -1)),
                         tp.axis(tp.rows), site="attn.o")


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
                  index: int, tp: TensorParallel, max_len: int | None,
                  memory=None):
    """One layer of ``group`` at one token; ``c`` is the group's cache and
    ``i`` the layer's row in it.  A hybrid period's SSD sublayers take the
    rows of its state in order; a decoder layer attends ``memory`` on K4
    at Sq = 1, its k and v recomputed from it (as in the reference)."""
    if group == "ssd":
        return x + SSM.ssd_decode_step(lp["ssd"], _norm(cfg, lp["ln1"], x),
                                       c["state"][i], **_ssd_dims(cfg))[0]
    if group == "dec":
        x = x + _attn_decode(lp["attn"], _norm(cfg, lp["ln1"], x), c["k"][i],
                             c["v"][i], cfg, tp, index, max_len)
        x = x + _cross_attention(lp["xattn"], _norm(cfg, lp["ln2"], x),
                                 memory, cfg, tp)
        return x + L.ffn(lp["ffn"], _norm(cfg, lp["ln3"], x))
    if group != "hyb":
        h = _norm(cfg, lp["ln1"], x)
        if cfg.mla is not None:
            x = x + _mla_decode(lp["attn"], h, c["lat"][i], c["rope"][i],
                                cfg, index)
        else:
            x = x + _attn_decode(lp["attn"], h, c["k"][i], c["v"][i], cfg,
                                 tp, index, max_len)
        return x + _ffn_apply(lp["ffn"], _norm(cfg, lp["ln2"], x), cfg, tp,
                              _kind(group))
    states = iter(c["state"][i])
    for j, sub in enumerate(lp["sub"]):
        h = _norm(cfg, sub["ln1"], x)
        x = x + (_attn_decode(sub["attn"], h, c["k"][i], c["v"][i], cfg,
                              tp, index, max_len) if j == cfg.attn_index else
                 SSM.ssd_decode_step(sub["ssd"], h, next(states),
                                     **_ssd_dims(cfg))[0])
        x = x + _ffn_apply(sub["ffn"], _norm(cfg, sub["ln2"], x), cfg, tp,
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
    card.  Under a mesh each tensor is this rank's block: its batch rows
    ("batch") and, for KV and latent caches, its rows of the sequence
    ("sp_seq"), where the rules put them and the dims divide, as
    ``train.shardings.cache_specs`` places them."""
    require_ported(cfg)
    device = resolve_device(device)
    ctx = active_rules()

    def local(n, tag):              # this rank's share of a dim of n
        for a in entry_axes(active_spec((n,), tag)[0]):
            n //= ctx[1].shape[a]
        return n

    B, S = local(batch_size, "batch"), local(max_len, "sp_seq")
    cache = {}
    for group, count in layer_groups(cfg):
        if group == "enc":
            continue
        rows = (count, B, S)
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
            state = (count, *per, B, s.expand * cfg.d_model // s.head_dim,
                     s.d_state, s.head_dim)
            cache[group]["state"] = torch.zeros(
                state, dtype=torch.float32, device=device)
    return cache


def decode_step(params, cache, tokens, index: int, cfg: ModelConfig,
                dtype=torch.bfloat16, memory=None, mp: int = 1,
                max_len: int | None = None):
    """tokens (B, 1) → (logits (B, 1, V), cache).  ``index`` is the
    position being written; unlike the reference, the cache's tensors (KV
    rows and SSM states) are written in place and the same dict is
    returned.  encdec needs ``memory`` (B, Sm, D), the encoder's output
    (``encode``); a vlm's decode embeds tokens only, as the reference's
    does.  Under a mesh ``params``, ``cache`` and ``tokens`` are the
    rank's (``max_len`` the whole cache's rows: a block's rows do not say
    whether the rules split them), and the logits are the rank's columns
    of the vocabulary (B, 1, V / model) where ``lm_head``'s are split."""
    require_ported(cfg)
    if cfg.family == "encdec" and memory is None:
        raise ValueError(f"{cfg.name}: an encdec decode step needs memory")
    tp = tensor_parallel(cfg, mp)
    x = L.embed(params["embed"], tokens, dtype, tp.axis(tp.vocab))
    for group, _count in layer_groups(cfg):
        if group == "enc":
            continue
        for i, lp in enumerate(params[f"g_{group}"]):
            x = _decode_layer(x, lp, cache[group], i, cfg, group, index, tp,
                              max_len, memory)
    x = _norm(cfg, params["ln_f"], x)
    return L.linear(params["lm_head"], x), cache


def prefill(params, batch, cfg: ModelConfig, dtype=torch.bfloat16,
            mp: int = 1):
    """Forward pass returning (last-position logits (B, 1, V), final
    hidden (B, S, D)), as the reference's code does (its module docstring
    speaks of emitted caches; the code emits none).  Under a mesh the
    logits are gathered over the model axis (every column), of the rank's
    batch rows."""
    tp = tensor_parallel(cfg, mp)
    x = forward(params, batch, cfg, dtype, mp)
    (logits,) = L.gather_cols([L.linear(params["lm_head"], x[:, -1:])],
                              tp.axis(tp.vocab), site="logits")
    return logits, x
