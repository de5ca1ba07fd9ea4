#!/usr/bin/env python3
"""Time the stacked GAS engine's device loop (``simulate_gas[_many]``'s
``_sim_gas``/``_sim_gas_many`` on cached tables) on ``chip_smoke.py``'s
graph-path layout, from one source tree, on one GPU.

    python3 scripts/gas_ab.py --src SRC_DIR --tag NAME [--reps 3] [--out FILE]

``SRC_DIR`` is the ``src`` directory of the tree to time: this checkout's,
or another commit's unpacked with ``git archive`` (its kernels build into
that tree's own ``build/``).  The graph, the configuration and the
iteration counts are ``chip_smoke.py``'s (``web_graph`` at ``SCALE``,
``CLUGPConfig.optimized(K, restream=1)`` through a torch-backend
``GraphSession``, halo layout; cc at the session's 30 iterations).  For
pagerank, centrality and cc on every wire, and the f32 bundle (pagerank,
ppr, centrality) fused on halo and dense, ``ms_iter`` is the least over
``--reps`` synchronized runs of the loop's wall time over its iterations
(one untimed run first).  To compare two commits, run it in one process
per tree inside one session on one card, in turns (A, B, B, A).  Prints
one JSON line ``{"tag", "card", "ms_iter": {"wire/program": ms}}``, also
written to ``--out`` when given.  Needs a card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WIRES = ("dense", "halo", "quantized", "ragged", "ragged_quantized")
PROGRAMS = ("pagerank", "centrality", "cc")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("gas_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(a.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core import CLUGPConfig, web_graph
    from repro_torch.dist.halo import get_exchange
    from repro_torch.graph import engine as eng
    from repro_torch.session import GraphSession, SessionConfig

    g = web_graph(scale=cs.SCALE, edge_factor=cs.EDGE_FACTOR, seed=0)
    V = g.num_vertices
    sess = GraphSession(SessionConfig(
        clugp=CLUGPConfig.optimized(cs.K, restream=1), backend="torch",
        exchange="halo", iters=30))
    sess.partition(g.src, g.dst, V).layout()
    lay = sess.partition_layout

    def best_ms(prog, ex, iters):
        dev = eng.stack_dev(lay, ex, sess.device)
        run = eng._sim_gas_many if isinstance(prog, eng.FusedGAS) \
            else eng._sim_gas
        wire = get_exchange(ex, lay)
        times = []
        for _ in range(a.reps + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            run(prog, dev, iters, wire)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3 / iters)
        return min(times[1:])

    ms = {}
    for ex in WIRES:
        for name in PROGRAMS:
            ms[f"{ex}/{name}"] = best_ms(eng.get_program(name, V), ex,
                                         cs.GAS_ITERS.get(name, 30))
    bundle = eng.fuse_programs([eng.get_program(p, V)
                                for p in cs.GAS_F32_BUNDLE])
    for ex in ("halo", "dense"):
        ms[f"{ex}/f32-bundle"] = best_ms(bundle, ex, 30)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    line = json.dumps({"tag": a.tag, "card": card, "ms_iter": ms})
    print(line)
    if a.out:
        Path(a.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
