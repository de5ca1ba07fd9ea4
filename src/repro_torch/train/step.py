"""Serving step builders (port of ``make_prefill_step`` and
``make_decode_fn`` of ``repro.train.step``): the functions the serving
launcher and ``chip_smoke.py`` run, for every family ``models.lm`` runs
(dense and MoE, with GQA or MLA attention; SSM and hybrid; the
encoder–decoder, whose decode step takes the encoder's output as
``memory``; the VLM, whose prefill batch may carry ``prefix_embeds``).
PyTorch runs eagerly, so there is nothing to jit; the reference's ``mp``,
``block_kv`` and ``unroll`` are lowering knobs with no counterpart on one
card."""
from __future__ import annotations

import torch

from ..models import decode_step as _decode_step
from ..models import prefill as _prefill
from ..models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, *, dtype=torch.bfloat16):
    """Returns prefill_step(params, batch) → last-position logits
    (B, 1, V).  ``batch`` passes through whole: "tokens", and an
    encdec's "src_embeds" or a vlm's "prefix_embeds".  Its attention is
    K4, once an attention layer (none in an SSM model, once a period in a
    hybrid one, three times an encoder–decoder layer pair: encoder,
    decoder and cross-attention)."""
    def prefill_step(params, batch):
        logits, _hidden = _prefill(params, batch, cfg, dtype=dtype)
        return logits

    return prefill_step


def make_decode_fn(cfg: ModelConfig, *, dtype=torch.bfloat16):
    """Returns serve_step(params, cache, tokens, index, memory=None) →
    (logits, cache); the cache (KV rows, SSM states) is written in place;
    an encdec step attends ``memory``, the encoder's output."""
    def serve_step(params, cache, tokens, index, memory=None):
        return _decode_step(params, cache, tokens, index, cfg, dtype=dtype,
                            memory=memory)

    return serve_step
