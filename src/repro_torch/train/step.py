"""Serving step builders (port of ``make_prefill_step`` and
``make_decode_fn`` of ``repro.train.step``): the functions the serving
launcher and ``chip_smoke.py`` run, for every family ``models.lm`` runs
(dense and MoE, with GQA or MLA attention; SSM and hybrid).  PyTorch
runs eagerly, so there is nothing to jit; the reference's ``mp``,
``block_kv`` and ``unroll`` are lowering knobs with no counterpart on one
card."""
from __future__ import annotations

import torch

from ..models import decode_step as _decode_step
from ..models import prefill as _prefill
from ..models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, *, dtype=torch.bfloat16):
    """Returns prefill_step(params, batch) → last-position logits
    (B, 1, V); its attention is K4, once an attention layer (none in an
    SSM model, once a period in a hybrid one)."""
    def prefill_step(params, batch):
        logits, _hidden = _prefill(params, batch, cfg, dtype=dtype)
        return logits

    return prefill_step


def make_decode_fn(cfg: ModelConfig, *, dtype=torch.bfloat16):
    """Returns serve_step(params, cache, tokens, index) → (logits, cache);
    the cache (KV rows, SSM states) is written in place."""
    def serve_step(params, cache, tokens, index):
        return _decode_step(params, cache, tokens, index, cfg, dtype=dtype)

    return serve_step
