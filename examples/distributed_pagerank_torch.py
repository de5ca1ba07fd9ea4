"""The paper's end-to-end scenario on the PyTorch port: CLUGP-partition a
web graph, deploy it on the k-partition GAS engine, run PageRank and
connected components, and show the comm-volume dependence on partition
quality (Fig. 8's mechanism).  The twin of
``examples/distributed_pagerank.py``; every step goes through
``GraphSession``, the engine stacked on ``--device``.

    PYTHONPATH=src python examples/distributed_pagerank_torch.py
    PYTHONPATH=src python examples/distributed_pagerank_torch.py \\
        --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import CLUGPConfig, baselines, random_stream, web_graph
from repro_torch.graph import reference_cc, reference_pagerank
from repro_torch.session import GraphSession

K = 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    g = web_graph(scale=11, edge_factor=8, seed=2)
    print(f"web graph: |V|={g.num_vertices} |E|={g.num_edges}, k={K}")

    sess = GraphSession(CLUGPConfig.optimized(K), device=device)
    sess.partition(g.src, g.dst, g.num_vertices)

    gr = random_stream(g, seed=1)
    h = baselines.hashing(gr.src, gr.dst, g.num_vertices, K)
    hashed = GraphSession(CLUGPConfig(k=K), device=device).with_partition(
        gr.src, gr.dst, g.num_vertices, h)

    print(f"{'partitioner':10s} {'mirrors':>9s} {'ideal B/it':>11s} "
          f"{'quant B/it':>11s} {'halo B/it':>10s} {'dense B/it':>11s}")
    for name, s in (("clugp", sess), ("hashing", hashed)):
        cb = s.comm_bytes()
        print(f"{name:10s} {s.partition_layout.mirrors_total:>9d} "
              f"{cb['ideal']:>11d} {cb['quantized']:>11d} "
              f"{cb['halo']:>10d} {cb['dense_gather']:>11d}")

    ref = reference_pagerank(g.src, g.dst, g.num_vertices, iters=30)
    for exchange in ("halo", "quantized"):
        pr = sess.run("pagerank", iters=30, exchange=exchange)
        print(f"pagerank[{exchange}]: max|err|="
              f"{np.abs(pr - ref).max():.2e} (30 iters)")

    # pagerank to convergence rather than a fixed sweep count: tol makes
    # 60 a cap and the early-exit loop reports the executed count
    pr, it = sess.run("pagerank", iters=60, exchange="ragged", tol=1e-6,
                      return_iters=True)
    print(f"pagerank[ragged, tol=1e-6]: max|err|="
          f"{np.abs(pr - ref).max():.2e} ({it} of 60 capped iters)")

    cc, it = sess.run("cc", iters=30, tol=0, return_iters=True)
    rcc = reference_cc(g.src, g.dst, g.num_vertices)
    print(f"connected components: label match="
          f"{np.mean(cc == rcc) * 100:.1f}% ({len(np.unique(rcc))} "
          f"components, {it} sweeps to fixed point)")


if __name__ == "__main__":
    main()
