"""Serving launcher: a prompt batch by repeated decode, then greedy decode
(port of ``repro.launch.serve``).

``python -m repro_torch.launch.serve --arch qwen2-7b --no-reduced`` serves
the full-width model with random weights from ``--seed`` and reports the
time per token-step; ``--arch`` takes every config ``models.lm`` runs
(the dense family and MoE, e.g. ``llama4-scout-17b-a16e``,
``deepseek_v3_671b`` with MLA, decoded from its latent cache, the SSM
and hybrid families, ``mamba2-130m`` and ``jamba-1.5-large-398b``, decoded
from their SSM state, the encoder–decoder ``seamless-m4t-large-v2``,
whose decoder attends the reference launcher's stub memory, zeros of
(B, 8, d_model), and the VLM ``pixtral-12b``, whose decode embeds tokens
only; the prompt fills the cache or state one step a token).  It runs on
``cuda`` unless ``--device cpu`` is given.  ``--reduced`` (the
default) serves the smoke-test variant; unlike the reference, whose
``--reduced`` cannot be switched off, ``--no-reduced`` serves the
published widths.  Weights and cache are f32, as in the reference's
launcher.

``generate`` also runs on a mesh of ranks: called in every rank under
``dist.sharding.use_rules(SINGLE_POD_RULES, mesh)`` with the rank's
blocks of the parameters (``train.shardings.place_params``) and the whole
prompt, each rank decodes its rows of the batch from its block of the
cache (its rows of the sequence: flash-decoding, ``dist.decode``), the
greedy token is the argmax across the model axis over the
vocabulary-parallel logits (ties to the lowest index, as ``argmax`` of
the whole row), and the tokens and prompt logits come back whole on
every rank.
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import numpy as np
import torch

from ..configs import get_config
from ..core.partitioner import resolve_device
from ..dist import collectives as coll
from ..dist.sharding import active_rules
from ..models import init_cache, init_params
from ..models import layers as L
from ..models.config import ModelConfig
from ..models.lm import TensorParallel, tensor_parallel
from ..train import make_decode_fn
from ..train.step import batch_rows, gather_rows


class Generation(NamedTuple):
    tokens: torch.Tensor         # (B, new_tokens) greedy tokens
    prompt_logits: torch.Tensor  # (B, V) logits after the last prompt token
    seconds: float               # wall time of all steps, synchronized
    steps: int                   # decode steps: prompt + new tokens
    finite: bool                 # every step's logits were finite


def greedy_tokens(logits, cfg: ModelConfig, tp: TensorParallel):
    """(B, 1) argmax of the last position's logits over the unpadded
    vocabulary, the first index of the largest.  Where the logits are this
    rank's columns of the vocabulary (``tp.vocab``), each rank takes its
    own largest and the ranks' (value, index) pairs are gathered: the
    first rank holding the largest value wins, as ``argmax`` of the whole
    row takes its lowest index."""
    row = logits[:, -1]
    axis = tp.axis(tp.vocab)
    if axis is None:
        return row[:, :cfg.vocab].argmax(-1)[:, None]
    n = row.shape[-1]
    lo = axis.rank * n
    valid = max(0, min(n, cfg.vocab - lo))
    idx = row[:, :max(valid, 1)].argmax(-1)
    val = row.gather(1, idx[:, None])[:, 0].to(torch.float64)
    if not valid:
        val = torch.full_like(val, -torch.inf)
    parts = coll.all_gather(torch.stack([val, (idx + lo).to(torch.float64)],
                                        -1), axis, site="serve.argmax")
    best = parts[..., 0] == parts[..., 0].amax(0)
    first = best.to(torch.int8).argmax(0)         # the first rank holding it
    return parts[..., 1].gather(0, first[None])[0].long()[:, None]


def generate(params, cfg: ModelConfig, prompt, new_tokens: int, *,
             dtype=torch.float32, memory=None, mp: int = 1) -> Generation:
    """The reference launcher's loop: ``prompt`` (B, P) integer tokens go
    in one decode step each (exact; the batched prefill is
    ``train.make_prefill_step``), then ``new_tokens`` greedy tokens, each
    the argmax over the unpadded vocabulary, each decoded in turn; an
    encdec model's every step attends ``memory`` (B, Sm, D).  Every
    step's logits are tested for finiteness on the device; the host reads
    the result once, after the timed loop.  Under a mesh (module
    docstring) the tokens and prompt logits are the whole batch's."""
    B, P = prompt.shape
    dev = prompt.device
    rows, spec = batch_rows({"tokens": prompt} if memory is None
                            else {"tokens": prompt, "memory": memory})
    prompt, memory = rows["tokens"], rows.get("memory")
    tp = tensor_parallel(cfg, mp)
    cache = init_cache(cfg, B, P + new_tokens, dtype=dtype, device=dev)
    step = make_decode_fn(cfg, dtype=dtype, mp=mp, max_len=P + new_tokens)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for t in range(P):
        logits, cache = step(params, cache, prompt[:, t:t + 1], t, memory)
        finite &= torch.isfinite(logits).all()
    prompt_logits = logits[:, -1]
    out = []
    for t in range(new_tokens):
        nxt = greedy_tokens(logits, cfg, tp)
        out.append(nxt)
        logits, cache = step(params, cache, nxt, P + t, memory)
        finite &= torch.isfinite(logits).all()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    (prompt_logits,) = L.gather_cols([prompt_logits], tp.axis(tp.vocab),
                                     site="logits")
    tokens = gather_rows(torch.cat(out, 1), spec)
    ctx = active_rules()
    if ctx is not None and ctx[1].bound:       # every rank's logits
        finite = coll.pmin(finite.to(torch.int32), ctx[1]) > 0
    return Generation(tokens, gather_rows(prompt_logits, spec), seconds,
                      P + new_tokens, bool(finite))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b",
                    help="a config of repro_torch.configs: the dense and "
                    "MoE families (deepseek_v3_671b with MLA), mamba2-130m "
                    "(SSM), jamba-1.5-large-398b (hybrid), "
                    "seamless_m4t_large_v2 (encdec: the stub memory) and "
                    "pixtral_12b (vlm)")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(
        args.seed))
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))).to(dev)
    # the reference launcher's stub memory for an encoder–decoder
    memory = (torch.zeros((args.batch, 8, cfg.d_model), device=dev)
              if cfg.family == "encdec" else None)
    g = generate(params, cfg, prompt, args.tokens, memory=memory)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} batch={args.batch} {g.steps} steps in "
          f"{g.seconds:.2f}s ({1000 * g.seconds / g.steps:.1f} "
          f"ms/token-step) on {where}")
    print("sample:", g.tokens[0][:16].tolist())


if __name__ == "__main__":
    main()
