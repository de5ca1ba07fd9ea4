#!/usr/bin/env python3
"""Time K4 (``repro_torch.kernels.flash_attention``) at every serving shape
of ``chip_smoke.py``'s ``kernels`` line (derived from that script's
constants and the model configs), from one source tree, on one GPU.

    python3 scripts/k4_ab.py --src SRC_DIR --tag NAME [--reps 20] [--out FILE]

``SRC_DIR`` is the ``src`` directory of the tree to time: this checkout's,
or another commit's unpacked with ``git archive`` (its kernels build into
that tree's own ``build/``).  The script uses only the public
``flash_attention(q, k, v, causal=...)``, so it times any commit of the
port.  To compare two commits, run it in one process per tree inside one
session on one card, in turns (A, B, B, A).  Per shape, ``ms`` is the
mean time a call over ``--reps`` back-to-back calls (CUDA events: the
wrapper's host time shows where it exceeds the kernel's) and
``device_ms`` the mean duration of the K4 kernel's launches in the
profiler's trace of as many calls (the kernel alone).  Prints one JSON
line ``{"tag", "card", "shapes": [{"name", "ms", "device_ms", ...}]}``,
also written to ``--out`` when given.  Needs a card; exits 2 without
one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def serving_shapes(get_config):
    """(name, B, Hq, Hkv, Sq, Skv, D, Dv, causal, dtype) of every K4 shape
    on ``chip_smoke.py``'s kernels line, from its constants and the
    configs: the prefill of qwen2-7b (group 7), llama4-scout (group 5),
    deepseek-v3 (MLA's 192/128), jamba (group 8) and pixtral (head dim
    160); seamless's encoder and its decode's cross-attention (Sq = 1),
    both non-causal; and the f32 check's shape."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    def gqa(name, arch):
        c = get_config(arch)
        return (name, cs.PREFILL_B, c.n_heads, c.n_kv_heads, cs.PREFILL_S,
                cs.PREFILL_S, c.hd, c.hd, True, "bf16")
    lm, mla, enc = (get_config(a) for a in (cs.LM_ARCH, cs.MLA_ARCH,
                                            cs.ENCDEC_ARCH))
    m = mla.mla
    return [
        gqa("group7", cs.LM_ARCH), gqa("group5", cs.MOE_ARCH),
        ("mla", cs.PREFILL_B, mla.n_heads, mla.n_heads, cs.PREFILL_S,
         cs.PREFILL_S, m.nope_dim + m.rope_dim, m.v_dim, True, "bf16"),
        gqa("group8", cs.HYB_ARCH), gqa("d160", cs.VLM_ARCH),
        ("encdec", cs.PREFILL_B, enc.n_heads, enc.n_kv_heads, cs.ENCDEC_SRC,
         cs.ENCDEC_SRC, enc.hd, enc.hd, False, "bf16"),
        ("sq1", cs.SERVE_B, enc.n_heads, enc.n_kv_heads, 1, cs.ENCDEC_SRC,
         enc.hd, enc.hd, False, "bf16"),
        ("f32", cs.CHECK_B, lm.n_heads, lm.n_kv_heads, cs.F32_S, cs.F32_S,
         lm.hd, lm.hd, True, "f32"),
    ]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    if not torch.cuda.is_available():
        print("k4_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    ops.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for name, B, Hq, Hkv, Sq, Skv, D, Dv, causal, dt in serving_shapes(
            get_config):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32

        def act(h, S, d):           # the model's (B, S, H, D) layout
            return torch.randn(B, S, h, d, generator=gen, device=dev,
                               dtype=dtype).transpose(1, 2)
        q, k, v = act(Hq, Sq, D), act(Hkv, Skv, D), act(Hkv, Skv, Dv)

        def run():
            return ops.flash_attention(q, k, v, causal=causal)
        for _ in range(3):
            run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            run()
        end.record()
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                run()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA and "flash_" in e.name]
        out.append(dict(name=name, q_shape=list(q.shape),
                        kv_shape=list(k.shape), head_dims=[D, Dv],
                        causal=causal, dtype=dt,
                        ms=start.elapsed_time(end) / args.reps,
                        device_ms=sum(us) / len(us) / 1e3 if us else None,
                        device_launches=len(us)))
        del q, k, v
    line = json.dumps({"tag": args.tag, "card": card, "shapes": out})
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
