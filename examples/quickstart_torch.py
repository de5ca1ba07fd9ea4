"""Quickstart on the PyTorch port: the GraphSession façade — partition a
synthetic web crawl with CLUGP, build the vertex-cut layout, and run
PageRank and connected components one partition a rank, all from one
serializable session config.  The twin of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The GAS programs run on K ranks (``launch.mesh.make_graph_mesh``: gloo
ranks on the CPU, or ranks sharing the card), where the reference runs
them on 8 virtual devices.
"""
import argparse

import numpy as np

from repro_torch.core import (CLUGPConfig, baselines, metrics,
                              random_stream, web_graph)
from repro_torch.graph import reference_cc, reference_pagerank
from repro_torch.launch.mesh import make_graph_mesh
from repro_torch.session import GraphSession, SessionConfig

K = 8


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args(argv).device

    g = web_graph(scale=12, edge_factor=8, seed=0)
    print(f"web graph: |V|={g.num_vertices} |E|={g.num_edges}")

    for name, cfg in [("CLUGP (paper)", CLUGPConfig.paper(K)),
                      ("CLUGP (optimized)", CLUGPConfig.optimized(K))]:
        sess = GraphSession(cfg, device=device).partition(
            g.src, g.dst, g.num_vertices)
        print(f"{name:20s} RF={sess.stats['rf']:.3f} "
              f"balance={sess.stats['balance']:.3f} "
              f"clusters={sess.stats['num_clusters']} "
              f"game_rounds={sess.stats['game_rounds']}")

    gr = random_stream(g, seed=1)
    for name in ("hdrf", "hashing"):
        a = baselines.ALL_BASELINES[name](gr.src, gr.dst, g.num_vertices, K)
        rf = metrics.replication_factor(gr.src, gr.dst, a, g.num_vertices,
                                        K)
        print(f"{name:20s} RF={rf:.3f} "
              f"balance={metrics.load_balance(a, K):.3f}")

    # the whole pipeline as ONE object — and the config round-trips
    # through JSON, so this exact run is reproducible from a blob
    sess = GraphSession(SessionConfig(clugp=CLUGPConfig.optimized(K),
                                      backend="torch", exchange="quantized"),
                        device=device)
    sess = GraphSession.from_json(sess.to_json(), device=device)
    sess.partition(g.src, g.dst, g.num_vertices).layout()

    # one partition a rank: K ranks spawned for each run
    mesh = make_graph_mesh(K, device=device)
    where = f"{K} ranks on {device}"
    pr = sess.run("pagerank", iters=30, mesh=mesh)
    ref = reference_pagerank(g.src, g.dst, g.num_vertices, iters=30)
    print(f"pagerank ({where}): max|err| vs single-machine oracle = "
          f"{np.abs(pr - ref).max():.2e}")
    # convergence is the intent here, so let tol stop the loop: iters is
    # just the cap, and iters_run reports how many sweeps CC actually took
    cc, iters_run = sess.run("cc", iters=40, mesh=mesh, tol=0,
                             return_iters=True)
    rcc = reference_cc(g.src, g.dst, g.num_vertices)
    print(f"cc ({where}): label match vs oracle = "
          f"{np.mean(cc == rcc) * 100:.1f}% (converged in {iters_run} "
          f"sweeps)")

    cb = sess.comm_bytes()
    print("mirror-sync comm/iter (bytes): "
          f"quantized={cb['quantized']} halo={cb['halo']} "
          f"dense_gather={cb['dense_gather']} "
          f"(ragged ideal={cb['ideal']}, allreduce={cb['allreduce']})")


if __name__ == "__main__":
    main()
