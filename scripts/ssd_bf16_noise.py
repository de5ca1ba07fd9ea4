#!/usr/bin/env python3
"""How far a random SSD stack's bf16 prefill parts from its f32 twin on
the card, and how far the (data, model) mesh's parts from one card's, by
depth: mamba2-130m at 1, 2, 4 and 24 layers (4 × 128 and 4 × 2,048
tokens) on ``make_test_mesh(2, 4)``, and the 2-sublayer jamba period of
``chip_smoke.py``'s ``[family-mesh]`` f32 check on ``make_test_mesh(1,
4)``; each from the card generator's seed-1 f32 draws, cast to bf16 as
``chip_smoke.as_bf16`` casts them.  Prints one line a case: the one
card's and the mesh's distance to the f32 twin and the mesh's to the
one card, each as max |d| over the largest |logit|.

    python3 scripts/ssd_bf16_noise.py

Needs a card; exits 2 without one.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as C  # noqa: E402


def mesh_logits(mesh, cases):
    """On one rank: each case's bf16 prefill logits on the mesh (the
    seed-1 draws placed, cast to bf16), whole."""
    from repro_torch.dist.sharding import SINGLE_POD_RULES, use_rules
    from repro_torch.models import lm
    from repro_torch.train import make_prefill_step, place_params
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    with use_rules(SINGLE_POD_RULES, mesh):
        for cfg, tokens in cases:
            p = C.in_turns(torch, mesh, lambda: lm.init_params(
                cfg, torch.Generator(device=mesh.device).manual_seed(1),
                place=place_params(mesh)))
            out.append(make_prefill_step(cfg, dtype=torch.bfloat16)(
                C.as_bf16(torch, p), {"tokens": tokens.to(mesh.device)})
                .float().cpu())
            del p
            torch.cuda.empty_cache()
    return out


def rel(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


def main() -> int:
    if not torch.cuda.is_available():
        print("ssd_bf16_noise: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.dist.mesh import run_on_ranks
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_params
    from repro_torch.train import make_prefill_step
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    C.log(C.smi("name,power.limit"))
    mb = get_config("mamba2_130m")
    period = C.family_mesh_models(get_config)[3][2]
    rng = np.random.default_rng(13)
    cases = []
    for cfg, S in [(dataclasses.replace(mb, n_layers=n), S)
                   for n in (1, 2, 4, 24) for S in (128, 2048)] + [
                       (period, 128)]:
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, S)))
        p32 = init_params(cfg, torch.Generator(device=dev).manual_seed(1))
        t = {"tokens": tokens.to(dev)}
        twin = make_prefill_step(cfg, dtype=torch.float32)(p32, t).cpu()
        one = make_prefill_step(cfg, dtype=torch.bfloat16)(
            C.as_bf16(torch, p32), t).float().cpu()
        cases.append((cfg, tokens, one, twin))
        del p32
        torch.cuda.empty_cache()
    for dims, family in (((2, 4), "ssm"), ((1, 4), "hybrid")):
        mine = [c for c in cases if c[0].family == family]
        t = time.perf_counter()
        got = run_on_ranks(mesh_logits, make_test_mesh(*dims),
                           [(c[0], c[1]) for c in mine])
        C.log(f"spawn {dims} {time.perf_counter() - t:.1f} s")
        for (cfg, tokens, one, twin), mesh in zip(mine, got):
            C.log(f"{cfg.name} layers {cfg.n_layers} S {tokens.shape[1]} "
                  f"mesh {dims}: one-twin {rel(one, twin):.3e} mesh-twin "
                  f"{rel(mesh, twin):.3e} mesh-one {rel(mesh, one):.3e}")
    return 0


if __name__ == "__main__":          # the spawned ranks import this file
    sys.exit(main())
