"""Compare all partitioners across k on the PyTorch port — a minified Fig.
3/7, plus the per-iteration GAS wire cost each partition would pay on
the engine's exchanges, via the session façade: CLUGP runs
``GraphSession.partition``, baselines adopt their assignment with
``with_partition``, and the comm table is ``session.comm_bytes()`` either
way.  The twin of ``examples/partition_compare.py``, with its own copy of
what that example takes from ``benchmarks/common.py``.

    PYTHONPATH=src python examples/partition_compare_torch.py   # the card
    PYTHONPATH=src python examples/partition_compare_torch.py --device cpu

``--scale`` and ``--ks`` shrink the run (defaults: the reference's 12
and 4, 16, 64).
"""
import argparse
import time

from repro_torch.core import (CLUGPConfig, baselines, metrics,
                              random_stream, web_graph)
from repro_torch.session import GraphSession, SessionConfig

ALGOS = ("clugp", "clugp-opt", "hashing", "dbh", "greedy", "hdrf", "mint")


def run_partitioner(name: str, g, k: int, seed: int = 0, device=None):
    """Returns (assign, seconds, extra).  CLUGP streams in crawl order
    through a session on ``device`` (extra: the session); baselines get
    their best order (random — paper §VI-A; extra: that stream)."""
    t0 = time.time()
    if name.startswith("clugp"):
        cfg = (CLUGPConfig.optimized(k) if name == "clugp-opt"
               else CLUGPConfig.paper(k))
        sess = GraphSession(cfg, device=device)
        sess.partition(g.src, g.dst, g.num_vertices)
        return sess.assign, time.time() - t0, sess
    gr = random_stream(g, seed=seed)
    t0 = time.time()
    a = baselines.ALL_BASELINES[name](gr.src, gr.dst, g.num_vertices, k,
                                      seed=seed)
    return a, time.time() - t0, (gr.src, gr.dst)


def stream_for(name: str, g, out):
    """The (src, dst) edge stream an assignment from ``run_partitioner``
    indexes: CLUGP's is the crawl order, a baseline's its random
    re-stream, carried in out[2]."""
    if name.startswith("clugp"):
        return g.src, g.dst
    return out[2]


def quality_row(name, g, k, out):
    """Quality metrics of one ``run_partitioner`` result."""
    assign, dt = out[0], out[1]
    src, dst = stream_for(name, g, out)
    rf = metrics.replication_factor(src, dst, assign, g.num_vertices, k)
    bal = metrics.load_balance(assign, k)
    return {"algo": name, "k": k, "rf": round(rf, 4),
            "balance": round(bal, 4), "seconds": round(dt, 4),
            "us_per_edge": round(1e6 * dt / g.num_edges, 3)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=12)
    ap.add_argument("--ks", type=int, nargs="+", default=[4, 16, 64])
    args = ap.parse_args(argv)

    g = web_graph(scale=args.scale, edge_factor=8, seed=0)
    print(f"web graph: |V|={g.num_vertices} |E|={g.num_edges}")
    print(f"{'algo':12s} {'k':>4s} {'RF':>8s} {'balance':>8s} "
          f"{'µs/edge':>9s} {'dense B/it':>11s} {'halo B/it':>10s} "
          f"{'ideal B/it':>11s}")
    for k in args.ks:
        for algo in ALGOS:
            out = run_partitioner(algo, g, k, 0, device=args.device)
            r = quality_row(algo, g, k, out)
            src, dst = stream_for(algo, g, out)
            sess = GraphSession(SessionConfig(clugp=CLUGPConfig(k=k)),
                                device=args.device)
            sess.with_partition(src, dst, g.num_vertices, out[0])
            cb = sess.comm_bytes()
            print(f"{r['algo']:12s} {r['k']:>4d} {r['rf']:>8.3f} "
                  f"{r['balance']:>8.3f} {r['us_per_edge']:>9.2f} "
                  f"{cb['dense_gather']:>11d} {cb['halo']:>10d} "
                  f"{cb['ideal']:>11d}")


if __name__ == "__main__":
    main()
