"""Graph-serving launcher: drive a resident GraphServer end to end (port
of ``repro.launch.serve_graph``).

    python -m repro_torch.launch.serve_graph --device cpu --scale 10 --k 4 \
        --window 256 --iters 100 --smoke --tol 1e-6 --ckpt-dir /tmp/ck

builds a web graph, partitions it, stands up
``repro_torch.serve.GraphServer`` in-process (no sockets: the launcher is
the event loop), then:

1. **queries**: submits a mix of score, owner and neighbors requests,
   serves them microbatch by microbatch and (``--smoke``) holds every
   score reply against a direct ``GraphSession.run_many`` on the same
   layout with the server's (combine, dtype) grouping;
2. **ingestion**: streams random edge arrivals through the window
   buffer, recording the RF trace as windows flush and the watermark
   triggers restreams (``--smoke``: at least one restream, leaving RF ≤
   the drifted RF).  With ``--tol`` the server runs the early-exit loop
   (``--iters`` becomes a cap) and, after ingestion, replays the same
   query mix cold (program inits) and warm (pre-swap fixed points as
   seeds); ``--smoke`` requires warm to run fewer iterations and fewer
   ms per query than cold, as the reference launcher does;
3. **preemption** (``--smoke`` with ``--ckpt-dir``): a child copy of this
   launcher (``--child-snapshot``) builds the same server, checkpoints
   through ``dist.ft.ServiceFT`` and SIGKILLs itself; the parent resumes
   from the snapshot and requires the identical config blob and
   assignment and the same replies as a freshly built server.

Replies are compared as the device allows: integer programs exactly;
pagerank within ``REPLY_RTOL`` at fixed iterations and within
``REPLY_L1`` with ``--tol``, since on the card its float sums are
float atomics in a varying order (on the CPU they match bit for bit).

Runs on the card unless ``--device`` names another device.  Writes
``results/BENCH_serve_torch.json`` (query latency, RF trace summary).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from ..core import CLUGPConfig, web_graph
from ..dist.ft import ServiceFT
from ..serve import GraphServer
from ..session import GraphSession, SessionConfig, resolve_program

SCORE_PROGRAMS = ("pagerank", "degree", "cc", "labelprop")
REPLY_RTOL = 1e-5     # pagerank at fixed iterations
REPLY_L1 = 1e-4       # pagerank with early exit (the runs may stop apart)


def gate(cond: bool, msg: str) -> None:
    """A smoke gate: raises (not ``assert``, which ``-O`` removes)."""
    if not cond:
        raise AssertionError(f"serve_graph: {msg}")


def build_server(args, ft=None) -> GraphServer:
    """Deterministic graph → session → server from the CLI args: the
    parent, the ``--child-snapshot`` child and the resumed server all
    rebuild the same state from the same flags."""
    g = web_graph(scale=args.scale, seed=args.seed)
    cfg = SessionConfig(clugp=CLUGPConfig(k=args.k), backend=args.backend,
                        exchange=args.exchange, iters=args.iters)
    sess = GraphSession(cfg, device=args.device).partition(
        g.src, g.dst, g.num_vertices)
    sess.layout()
    return GraphServer(sess, max_batch=args.max_batch, window=args.window,
                       rf_watermark=args.watermark,
                       restream_passes=args.restream_passes,
                       iters=args.iters, tol=args.tol, ft=ft)


def replies_agree(got, want, tol) -> bool:
    """Integer replies equal; float replies within ``REPLY_RTOL`` at fixed
    iterations or ``REPLY_L1`` (summed) with early exit."""
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    if np.issubdtype(got.dtype, np.integer):
        return bool(np.array_equal(got, want))
    if tol is None:
        return bool(np.allclose(got, want, rtol=REPLY_RTOL, atol=0.0))
    return float(np.abs(got.astype(np.float64) - want).sum()) <= REPLY_L1


def direct_run(sess, args, seeds=None) -> dict:
    """Every score program of the mix run directly on the session, grouped
    into the server's (combine, dtype) cells; with ``--tol`` from
    ``seeds`` (program → warm vector; missing = cold)."""
    cells: dict = {}
    for p in SCORE_PROGRAMS:
        prog = resolve_program(p, sess.num_vertices)
        cells.setdefault((prog.combine, str(prog.dtype)), []).append(p)
    out = {}
    for progs in cells.values():
        if args.tol is None:
            outs = sess.run_many(progs, iters=args.iters,
                                 exchange=args.exchange)
        else:
            init = [(seeds or {}).get(p, np.zeros(0)) for p in progs]
            outs, _ = sess.run_many(progs, iters=args.iters,
                                    exchange=args.exchange, tol=args.tol,
                                    init_values=init, return_iters=True)
        out.update(zip(progs, outs))
    return out


def submit_mix(srv: GraphServer, args, seed: int, hosts: bool = True):
    """The query mix: ``--queries`` score queries over
    ``SCORE_PROGRAMS``, 4 random vertices each, then (``hosts``) 4 owner
    and 4 neighbors queries.  Returns [(ticket, kind, program, verts)]."""
    rng = np.random.default_rng(seed)
    n = srv.sess.num_vertices
    tickets = []
    for i in range(args.queries):
        prog = SCORE_PROGRAMS[i % len(SCORE_PROGRAMS)]
        verts = rng.integers(0, n, 4)
        tickets.append((srv.submit("score", program=prog, vertices=verts),
                        "score", prog, verts))
    if hosts:
        for v in rng.integers(0, n, 4):
            tickets.append((srv.submit("owner", vertices=[v]), "owner",
                            None, [v]))
            tickets.append((srv.submit("neighbors", vertices=[v]),
                            "neighbors", None, [v]))
    return tickets


def serve_mix(srv: GraphServer, tickets) -> tuple:
    """Serve the queue; returns ({ticket: Reply}, ms per query)."""
    t0 = time.perf_counter()
    served = srv.serve_pending()
    dt = time.perf_counter() - t0
    replies = {t: srv.result(t) for t, *_ in tickets}
    bad = [t for t, r in replies.items() if r is None or r.error]
    gate(not bad, f"the serve loop dropped or failed requests {bad}")
    return replies, dt * 1e3 / max(served, 1)


def check_replies(srv: GraphServer, tickets, replies, direct, tol) -> None:
    """Score replies against ``direct``; owner and neighbors replies
    against the edges and the layout's master tables."""
    src, dst = srv.sess.edges
    lay = srv.sess.partition_layout
    for t, kind, prog, verts in tickets:
        got = replies[t].value
        if kind == "score":
            want = direct[prog][np.asarray(verts)]
            gate(replies_agree(got, want, tol),
                 f"{prog} reply {got} differs from the direct run {want}")
        elif kind == "owner":
            for v, p in zip(verts, got):
                gate(v in lay.vert_gid[p][lay.is_master[p]],
                     f"owner of {v} is not partition {p}'s master")
        else:
            v = int(verts[0])
            want = np.unique(np.concatenate([dst[src == v], src[dst == v]]))
            gate(np.array_equal(got[0], want), f"neighbors of {v} differ")


def drive_queries(srv: GraphServer, args, check: bool) -> dict:
    """Submit the query mix, serve it, optionally hold the replies
    against direct runs on the same layout."""
    tickets = submit_mix(srv, args, args.seed + 1)
    replies, query_ms = serve_mix(srv, tickets)
    if check:
        check_replies(srv, tickets, replies, direct_run(srv.sess, args),
                      args.tol)
        print(f"[serve] {args.queries} score replies agree with direct "
              f"run_many ({args.exchange} exchange), owner and neighbors "
              "replies with the tables")
    return {"served": len(tickets), "query_ms": query_ms,
            "microbatches": srv.stats["microbatches"]}


def arrival_chunks(seed: int, n: int, window: int):
    """Random edge arrivals in chunks of a quarter window, forever."""
    rng = np.random.default_rng(seed + 2)
    chunk = max(1, window // 4)
    while True:
        yield rng.integers(0, n, chunk), rng.integers(0, n, chunk)


def drive_ingest(srv: GraphServer, args) -> dict:
    """Stream arrivals until ``--ingest-windows`` windows have flushed;
    return the RF drift and repair summary."""
    target = srv.stats["windows"] + args.ingest_windows
    for s, d in arrival_chunks(args.seed, srv.sess.num_vertices,
                               args.window):
        if srv.stats["windows"] >= target:
            break
        srv.ingest(s, d)
    drifted = [v for e, v in srv.rf_trace if e == "window"]
    repaired = [v for e, v in srv.rf_trace if e == "restream"]
    return {"rf_base": srv.rf_trace[0][1],
            "rf_drifted": max(drifted) if drifted else srv.rf_base,
            "rf_post_restream": repaired[-1] if repaired else None,
            "restreams": srv.stats["restreams"],
            "ingested_edges": srv.stats["ingested_edges"]}


def drive_warm_cold(srv: GraphServer, args, check: bool) -> list[dict]:
    """After ingestion, with ``--tol``: the same query mix cold (the warm
    seeds set aside, every program from its init) and warm (the seeds
    restored).  ``check`` holds both rounds' replies against direct runs
    from the same seeds and requires warm to run fewer iterations than
    cold.  Returns the cold and the warm row."""
    def round_(warm: bool):
        srv.last_iters_run.clear()
        tickets = submit_mix(srv, args, args.seed + 3, hosts=False)
        replies, query_ms = serve_mix(srv, tickets)
        row = {"warm": warm, "query_ms": query_ms,
               "iters_run": max(srv.last_iters_run.values()),
               "cells": {"/".join(c[:2]): i
                         for c, i in srv.last_iters_run.items()}}
        return row, tickets, replies

    stash = dict(srv._warm)
    srv._warm.clear()
    srv._values.clear()
    cold, cold_t, cold_r = round_(warm=False)
    srv._warm.update(stash)
    srv._values.clear()          # the warm round recomputes
    warm, warm_t, warm_r = round_(warm=True)
    print(f"[serve] post-ingest cold: {cold['iters_run']} iterations "
          f"{cold['query_ms']:.3f} ms/query; warm: {warm['iters_run']} "
          f"iterations {warm['query_ms']:.3f} ms/query (iterations per "
          f"cell: cold {cold['cells']}, warm {warm['cells']})")
    if check:
        seeds = {p: v for (p, ex), v in stash.items() if ex == args.exchange}
        check_replies(srv, cold_t, cold_r, direct_run(srv.sess, args),
                      args.tol)
        check_replies(srv, warm_t, warm_r,
                      direct_run(srv.sess, args, seeds), args.tol)
        gate(warm["iters_run"] < cold["iters_run"],
             f"warm start ran {warm['iters_run']} iterations, cold "
             f"{cold['iters_run']}")
        print(f"[serve] cold and warm replies agree with direct runs; warm "
              f"{warm['iters_run']} < cold {cold['iters_run']} iterations")
    return [cold, warm]


def child_snapshot(args) -> None:
    """The preemption victim: build the server, serve one microbatch,
    checkpoint, then SIGKILL this very process."""
    ft = ServiceFT(args.ckpt_dir)
    srv = build_server(args, ft=ft)
    srv.submit("score", program="pagerank", vertices=[0, 1])
    srv.step()
    srv.checkpoint()
    ft.wait()
    print("[serve-child] snapshot written, dying", flush=True)
    os.kill(os.getpid(), signal.SIGKILL)


def kill_resume_check(args) -> dict:
    """Spawn the child, require that it died by SIGKILL, resume from its
    snapshot and require the state and replies of a freshly built
    server.  Returns the child's exit code and the resumed reply."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve_graph",
           "--child-snapshot", "--ckpt-dir", args.ckpt_dir,
           "--scale", str(args.scale), "--k", str(args.k),
           "--exchange", args.exchange, "--backend", args.backend,
           "--iters", str(args.iters), "--seed", str(args.seed),
           "--window", str(args.window)]
    if args.tol is not None:
        cmd += ["--tol", str(args.tol)]
    if args.device is not None:
        cmd += ["--device", str(args.device)]
    src_dir = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src_dir, os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=900)
    gate(proc.returncode == -signal.SIGKILL,
         f"the child should die by SIGKILL, it exited {proc.returncode}:\n"
         f"{proc.stdout}{proc.stderr}")
    ref = build_server(args)
    srv = GraphServer.resume(ServiceFT(args.ckpt_dir), device=args.device,
                             iters=args.iters, tol=args.tol)
    gate(srv.sess.to_json() == ref.sess.to_json(), "config blob drifted")
    gate(np.array_equal(srv.sess.assign, ref.sess.assign),
         "resumed assignment differs from the pre-kill partition")
    ta = srv.submit("score", program="pagerank", vertices=[0, 1])
    srv.step()
    tb = ref.submit("score", program="pagerank", vertices=[0, 1])
    ref.step()
    got, want = srv.result(ta).value, ref.result(tb).value
    gate(replies_agree(got, want, args.tol),
         f"resumed reply {got} differs from a fresh server's {want}")
    print("[serve] SIGKILL'd child resumed from its snapshot: identical "
          "config and assignment, replies agree")
    return {"child_returncode": proc.returncode, "reply": got.tolist()}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; the card unless named (cpu runs "
                         "the kernels' plain versions)")
    ap.add_argument("--scale", type=int, default=13)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--exchange", default="halo")
    ap.add_argument("--backend", default="torch")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--tol", type=float, default=None,
                    help="early-exit tolerance: --iters becomes a cap, the "
                         "value caches become warm-start seeds across "
                         "swaps, and the results gain post-ingest cold and "
                         "warm rows (query_ms, iters_run)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--window", type=int, default=2048)
    ap.add_argument("--ingest-windows", type=int, default=3)
    ap.add_argument("--watermark", type=float, default=1.02)
    ap.add_argument("--restream-passes", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="check the replies, the restream and warm start")
    ap.add_argument("--child-snapshot", action="store_true",
                    help=argparse.SUPPRESS)   # the preemption victim
    ap.add_argument("--out", default=None,
                    help="instead of results/BENCH_serve_torch.json")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.child_snapshot:
        child_snapshot(args)
        return 0                    # not reached: SIGKILL above

    srv = build_server(args)
    q = drive_queries(srv, args, check=args.smoke)
    ing = drive_ingest(srv, args)
    wc = (drive_warm_cold(srv, args, check=args.smoke)
          if args.tol is not None else [])
    if args.smoke:
        if wc:
            cold, warm = wc
            gate(warm["query_ms"] < cold["query_ms"],
                 f"warm {warm['query_ms']:.3f} ms/query not below cold "
                 f"{cold['query_ms']:.3f}")
        gate(ing["restreams"] >= 1,
             f"the RF watermark never tripped: trace {srv.rf_trace}")
        gate(ing["rf_post_restream"] <= ing["rf_drifted"] + 1e-9,
             f"restream left RF above the drift: {ing}")
        t = srv.submit("score", program="pagerank", vertices=[0])
        srv.step()
        gate(srv.result(t).error is None, "the grown graph does not serve")
        print(f"[serve] drift {ing['rf_drifted']:.4f} repaired to "
              f"{ing['rf_post_restream']:.4f} over {ing['restreams']} "
              "restream(s)")
    if args.ckpt_dir and args.smoke:
        kill_resume_check(args)

    row = {"bench": "serve", "device": str(srv.sess.device),
           "scale": args.scale, "k": args.k, "exchange": args.exchange,
           "window": args.window, "queries": q["served"],
           "microbatches": q["microbatches"], "query_ms": q["query_ms"],
           "rf_base": ing["rf_base"], "rf_drifted": ing["rf_drifted"],
           "rf_post_restream": ing["rf_post_restream"],
           "restreams": ing["restreams"],
           "ingested_edges": ing["ingested_edges"]}
    rows = [row]
    if args.tol is not None:
        row.update({"tol": args.tol, "warm": False})
        for r in wc:
            rows.append({"bench": "serve_post_ingest",
                         "device": row["device"], "scale": args.scale,
                         "k": args.k, "exchange": args.exchange,
                         "window": args.window, "tol": args.tol,
                         "warm": r["warm"], "iters_cap": args.iters,
                         "iters_run": r["iters_run"],
                         "cells": r["cells"], "query_ms": r["query_ms"]})
    out = (Path(args.out) if args.out else
           Path(__file__).resolve().parents[3] / "results"
           / "BENCH_serve_torch.json")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    for r in rows:
        print(",".join(f"{k}={v}" for k, v in r.items()))
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
