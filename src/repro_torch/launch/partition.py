"""Graph-partitioning launcher (port of ``repro.launch.partition``).

    python -m repro_torch.launch.partition --scale 13 --k 16 --algo clugp-opt
    python -m repro_torch.launch.partition --device cpu --pagerank
    python -m repro_torch.launch.partition --backend sharded --nodes 4

partitions a synthetic web crawl and prints RF / balance / runtime, then
(``--pagerank``) runs PageRank on the result through the session's GAS
engine, with the reference's output lines.

The reference's flags, with one default changed: ``--backend`` defaults
to ``jit``, the port's ``torch`` backend (the CLUGP pipeline on
``--device``), so the launcher runs on the card unless told ``--device
cpu``.  Its game is the one the reference's ``jit`` plays off a TPU: the
Gauss–Seidel scan on G, which falls back to the Jacobi CSR game above the
pair-key limit.  ``--backend np`` is the host oracle, run only when
named; ``--backend sharded`` spawns ``--nodes`` ranks, one stream slice
each, on ``--device`` (several ranks on one card share it over gloo;
the line names the transport).  ``--nodes`` is also the stream split of
``--algo clugp-parallel`` on the np backend (its host combine).
``--unroll`` is accepted only so the reference's command lines run, and
changes nothing.  ``--device`` (default ``cuda``) is the port's
own flag.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np

ALGOS = ["clugp", "clugp-opt", "clugp-parallel", "hashing", "dbh", "greedy",
         "hdrf", "mint"]
_BACKENDS = {"np": "np", "jit": "torch", "sharded": "sharded"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=13)
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--algo", default="clugp-opt", choices=ALGOS)
    ap.add_argument("--backend", default="jit",
                    choices=["np", "jit", "sharded"],
                    help="partitioner for the clugp algos: jit = the torch "
                         "backend on --device, np = the host oracle, "
                         "sharded = --nodes ranks on --device")
    ap.add_argument("--nodes", type=int, default=4,
                    help="sharded rank count; clugp-parallel node count "
                         "(np host combine)")
    ap.add_argument("--restream", type=int, default=0,
                    help="extra prioritized-restream passes")
    ap.add_argument("--unroll", type=int, default=1,
                    help="accepted for the reference's command lines; "
                         "no effect")
    ap.add_argument("--graph", default="web", choices=["web", "social"])
    ap.add_argument("--pagerank", action="store_true")
    ap.add_argument("--exchange", default="halo",
                    choices=["dense", "halo", "quantized"],
                    help="mirror-sync wire format for --pagerank")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    return ap


def session_for(args, g):
    """Build the session this invocation describes and partition the
    graph.  Baseline algos adopt their assignment into the same session
    type, so the layout, engine and byte accounting are the same for
    every algo."""
    from ..core import CLUGPConfig, baselines, random_stream
    from ..session import GraphSession, SessionConfig

    algo, k, seed = args.algo, args.k, args.seed
    if algo.startswith("clugp"):
        cfg = (CLUGPConfig.optimized(k) if algo == "clugp-opt"
               else CLUGPConfig.paper(k))
        # the game the reference's jit resolves to off a TPU (the np
        # backend plays its host game whatever the kernel)
        cfg = dataclasses.replace(cfg, restream=args.restream, kernel="scan")
        backend = _BACKENDS[args.backend]
        # the reference's clugp-parallel alias: the np host combine
        nodes = args.nodes if backend == "sharded" or (
            backend == "np" and algo == "clugp-parallel") else 1
        sess = GraphSession(SessionConfig(clugp=cfg, backend=backend,
                                          nodes=nodes,
                                          exchange=args.exchange),
                            device=args.device)
        return sess.partition(g.src, g.dst, g.num_vertices)
    gr = random_stream(g, seed=seed)
    a = baselines.ALL_BASELINES[algo](gr.src, gr.dst, g.num_vertices, k)
    # map back to the original stream order for downstream use
    out = np.zeros_like(a)
    perm = np.random.default_rng(seed).permutation(g.num_edges)
    out[perm] = a
    sess = GraphSession(SessionConfig(clugp=CLUGPConfig(k=k),
                                      exchange=args.exchange),
                        device=args.device)
    return sess.with_partition(g.src, g.dst, g.num_vertices, out)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.nodes < 1:
        sys.exit(f"error: --nodes must be >= 1, got {args.nodes}")
    from ..core import web_graph
    from ..core.graphgen import social_graph

    g = (web_graph(scale=args.scale, seed=args.seed) if args.graph == "web"
         else social_graph(n=1 << args.scale, seed=args.seed))
    print(f"graph: V={g.num_vertices} E={g.num_edges}")
    t0 = time.time()
    sess = session_for(args, g)
    dt = time.time() - t0
    label = args.algo if not args.algo.startswith("clugp") \
        else f"{args.algo}[{args.backend}, restream={args.restream}]"
    print(f"{label}: rf={sess.stats['rf']:.3f} "
          f"balance={sess.stats['balance']:.3f} "
          f"time={dt:.2f}s ({1e6*dt/g.num_edges:.2f} µs/edge)")
    if "mesh" in sess.stats:
        m = sess.stats["mesh"]
        print(f"sharded: {m['ranks']} ranks on {m['device']} over "
              f"{m['transport']}, clusters per node "
              f"{[n['clusters'] for n in sess.stats['per_node']]}")

    if args.pagerank:
        from ..graph.engine import reference_pagerank
        sess.layout()
        st = sess.partition_layout.interior_frontier_stats()
        print(f"interior/frontier: frac={st['interior_frac']:.3f} "
              f"min={st['interior_frac_min']:.3f} "
              f"(overlap headroom — interior rows compute during the "
              f"ring hops)")
        t0 = time.time()
        pr = sess.run("pagerank", iters=30)
        dt = time.time() - t0
        ref = reference_pagerank(g.src, g.dst, g.num_vertices, iters=30)
        cb = sess.comm_bytes()
        print(f"pagerank[{args.exchange}]: {dt:.2f}s  "
              f"max|err|={np.abs(pr-ref).max():.2e}  "
              f"comm/iter: ideal={cb['ideal']/1e6:.2f}MB "
              f"quantized={cb['quantized']/1e6:.2f}MB "
              f"halo={cb['halo']/1e6:.2f}MB "
              f"dense-gather={cb['dense_gather']/1e6:.2f}MB "
              f"allreduce={cb['allreduce']/1e6:.2f}MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
