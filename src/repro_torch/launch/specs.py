"""The dry-run's inputs: every (arch × shape) cell's tensors on the meta
device (port of ``repro.launch.specs``).

Shapes (the reference's, letter for letter):
  train_4k     seq_len=4096    global_batch=256   (training)
  prefill_32k  seq_len=32768   global_batch=32    (inference-prefill)
  decode_32k   seq_len=32768   global_batch=128   (decode: 1 new token)
  long_500k    seq_len=524288  global_batch=1     (long-context decode —
               sub-quadratic archs only; full-attention archs are recorded
               as skipped)

``decode_*``/``long_*`` run ``serve_step`` (one decode step over a cache of
seq_len rows); an encoder–decoder decodes against a stub encoder memory.
Where the reference hands ``jax.ShapeDtypeStruct`` stand-ins to a
compiler, the port hands tensors on ``device`` — the meta device by
default, which holds shapes and dtypes and no bytes; on any other device
every tensor is zeros (valid token ids, an empty cache).
"""
from __future__ import annotations

import torch

from ..dist.sharding import no_rules
from ..models import init_cache
from ..models.config import ModelConfig

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


def cell_is_skipped(cfg: ModelConfig, shape_name: str) -> str | None:
    """Returns a skip reason or None."""
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return "skipped(full-attention: 500k dense KV is out of scope)"
    return None


def input_specs(cfg: ModelConfig, shape_name: str, mp: int = 1,
                dtype=torch.bfloat16, device="meta",
                sizes: dict | None = None) -> dict:
    """The cell's inputs, whole (under any active rule table too): train
    and prefill ``{"batch": {...}}`` (tokens, and labels to train; an
    encoder–decoder's ``src_embeds`` and tokens of S // 2 positions each;
    a VLM's ``prefix_embeds`` of ``cfg.prefix_tokens`` positions ahead of
    S − P tokens, its labels over all S); decode ``{"tokens": (B, 1),
    "cache": models.init_cache(cfg, B, S), "index": ()}`` and an
    encoder–decoder's ``memory`` (B, S // 2, d_model).  ``mp`` is the
    reference's argument, which its cache ignores too; ``sizes`` (a
    ``{"seq_len", "global_batch"}``) replaces the shape's sizes, its kind
    kept (the tests' small cells)."""
    sh = {**SHAPES[shape_name], **(sizes or {})}
    B, S = sh["global_batch"], sh["seq_len"]
    kind = sh["kind"]
    i32 = torch.int32

    def sds(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    if kind in ("train", "prefill"):
        if cfg.family == "encdec":
            half = S // 2
            batch = {"src_embeds": sds((B, half, cfg.d_model), dtype),
                     "tokens": sds((B, half), i32)}
            if kind == "train":
                batch["labels"] = sds((B, half), i32)
            return {"batch": batch}
        if cfg.family == "vlm":
            P = cfg.prefix_tokens
            batch = {"prefix_embeds": sds((B, P, cfg.d_model), dtype),
                     "tokens": sds((B, S - P), i32)}
            if kind == "train":
                batch["labels"] = sds((B, S), i32)
            return {"batch": batch}
        batch = {"tokens": sds((B, S), i32)}
        if kind == "train":
            batch["labels"] = sds((B, S), i32)
        return {"batch": batch}

    # decode: token + cache (+ encoder memory for encdec)
    with no_rules():
        cache = init_cache(cfg, B, S, dtype=dtype, device=device)
    out = {"tokens": sds((B, 1), i32), "cache": cache,
           "index": sds((), i32)}
    if cfg.family == "encdec":
        out["memory"] = sds((B, S // 2, cfg.d_model), dtype)
    return out
