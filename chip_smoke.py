#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Print the card's name and power limit; build the four CUDA kernels
   (one ``nvcc`` per source, in parallel, into ``build/repro_torch/``).
2. The main path at full size: ``web_graph(scale=20)`` (1,048,576
   vertices, ~6.4 M edges) → ``GraphSession`` CLUGP partition at k = 64
   (one restream) → ``build_layout`` → 30 PageRank iterations over the
   halo exchange.  Launch counts are zeroed just before and read just
   after: every kernel must have launched.  Checks: RF below a uniform
   random assignment's, every partition load ≤ τ·E/k + 1, PageRank
   finite and within L1 1e-4 of the float64 oracle.
3. Every kernel against its plain PyTorch version on the card at the
   main path's shapes (K1 on recorded blocks of the scale-20 stream, K2
   at M = the run's m_cap and k = 64, K3 on the run's row-split ELL, T on
   the scale-20 restream inputs), timed with CUDA events, beside the
   least time the card could take for their bytes and operations (and,
   for K1 and T, whose dependent per-edge chain is what limits them, a
   latency floor) and, for K3, one PyTorch sparse call.
4. At scale 16 the kernel path and the plain path on the card: the
   clustering state and the game-off assignment must match bit for bit.
5. The ``kernels`` JSON line, then the device JSON line last.

The script imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCALE, EDGE_FACTOR, K = 20, 8, 64
SMALL_SCALE = 16
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
K1_OPS_PER_EDGE = 150            # ALU operations of one edge's decisions
T_OPS_PER_EDGE = 8               # compares/selects/increment of one edge
K2_OPS_PER_LANE = 8              # flops of one (row, partition) cost
# K1 and T are one dependent chain of shared-memory steps, so their floor
# is latency, not bytes or operations: dependent edges x steps per edge x
# the load-to-use latency of one shared-memory read (about 29 cycles on
# Hopper in published microbenchmarks) at the card's top SM clock.
SMEM_STEP_CYCLES = 29
K1_STEPS_PER_EDGE = 2            # slot read -> volume read at that slot
T_STEPS_PER_EDGE = 1             # loads read -> +1 the next edge reads


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def latency_ms(edges, steps_per_edge, sm_hz):
    return edges * steps_per_edge * SMEM_STEP_CYCLES / sm_hz * 1e3


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"nvidia-smi: {out.stderr.strip()}"


def event_ms(torch, fn, reps, warmup=2):
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn, reps=1):
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.core import CLUGPConfig, metrics, web_graph
    from repro_torch.core.clustering import streaming_clustering
    from repro_torch.core.partitioner import partition
    from repro_torch.core.transform import majority_vertex_map
    from repro_torch.graph.engine import reference_pagerank
    from repro_torch.kernels import ops
    from repro_torch.session import GraphSession, SessionConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---------------------------------------------------------- phase 1
    log(smi("name,power.limit"))
    sm_mhz = smi("clocks.max.sm")
    sm_hz = float(sm_mhz.split()[0]) * 1e6
    log(f"top SM clock {sm_mhz}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t = time.perf_counter()
    report = ops.build_all()
    log(f"[build] {time.perf_counter() - t:.1f} s")
    for name, r in report.items():
        regs = [ln.strip() for ln in r["ptxas"].splitlines() if "Used" in ln]
        log(f"[build] {name}: {r['seconds']:.1f} s "
            f"{'cached' if r['cached'] else ''} {' | '.join(regs)}")

    # ---------------------------------------------------------- phase 2
    t = time.perf_counter()
    g = web_graph(scale=SCALE, edge_factor=EDGE_FACTOR, seed=0)
    E, V = g.num_edges, g.num_vertices
    log(f"[graph] scale {SCALE}: V={V} E={E}, top in-degree "
        f"{int(np.bincount(g.dst).max())} ({time.perf_counter() - t:.1f} s)")
    cfg = CLUGPConfig.optimized(K, restream=1)
    sess = GraphSession(SessionConfig(clugp=cfg, backend="torch",
                                      exchange="halo", iters=30))
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sess.partition(g.src, g.dst, V)
    t1 = time.perf_counter()
    sess.layout()
    t2 = time.perf_counter()
    pr = sess.run("pagerank")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = ops.launch_counts()
    log(f"[main] launches {json.dumps(launches)}")
    for name in ops.KERNELS:
        check(launches.get(name, 0) > 0, f"kernel {name} never launched "
              "on the main path")
    t = time.perf_counter()
    sess.run("pagerank")
    torch.cuda.synchronize()
    pr_steady = time.perf_counter() - t
    log(f"[main] pagerank again on the cached device tables: "
        f"{pr_steady * 1e3 / 30:.3f} ms/iteration")
    st = sess.stats
    stages = dict(st["stage_seconds"])
    stages.update(layout=t2 - t1, pagerank=t3 - t2)
    log("[main] seconds " + json.dumps(
        {k: round(v, 4) for k, v in stages.items()}))
    log("[main] us/edge " + json.dumps(
        {k: round(v * 1e6 / E, 4) for k, v in stages.items()}))
    log(f"[main] partition {t1 - t0:.3f} s, layout {t2 - t1:.3f} s, "
        f"pagerank {t3 - t2:.3f} s, total {t3 - t0:.3f} s = "
        f"{(t3 - t0) * 1e6 / E:.3f} us/edge; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rng = np.random.default_rng(0)
    rf_random = metrics.replication_factor(
        g.src, g.dst, rng.integers(0, K, E).astype(np.int32), V, K)
    log(f"[main] rf {st['rf']:.4f} (uniform random {rf_random:.4f}), "
        f"balance {st['balance']:.4f}, clusters {st['num_clusters']}, "
        f"m_cap {st['m_cap']}, id_cap {st['id_cap']}, "
        f"game rounds {st['game_rounds']}, cap retries {st['cap_retries']}")
    check(st["rf"] < rf_random, "RF not below a random assignment's")
    check(max(st["sizes"]) <= cfg.tau * E / K + 1, "balance cap broken")
    check(pr.shape == (V,) and np.isfinite(pr).all(), "PageRank not finite")
    ref = reference_pagerank(g.src, g.dst, V, 30)
    l1 = float(np.abs(pr.astype(np.float64) - ref).sum())
    log(f"[main] pagerank L1 vs float64 oracle {l1:.3e}")
    check(l1 <= 1e-4, f"PageRank L1 {l1} > 1e-4")

    # ---------------------------------------------------------- phase 3
    rows = []
    vmax = max(2.0, E / float(K))
    B = 128
    src_t = torch.from_numpy(g.src).to(dev)
    dst_t = torch.from_numpy(g.dst).to(dev)

    # K1 on recorded blocks of the scale-20 stream
    nb = -(-E // B)
    want = sorted({0, 1, nb // 4, nb // 2, nb - 2})
    prefix = (want[-1] + 1) * B
    recorded = []

    def record(b, ints, buf, scal):
        if b in want:
            recorded.append((ints.clone(), buf.clone(), scal.clone()))

    streaming_clustering(src_t[:prefix], dst_t[:prefix], V, vmax,
                         split_degree_factor=cfg.split_degree_factor,
                         id_cap=st["id_cap"], on_block=record)
    err = 0
    for ints, buf, scal in recorded:
        got = ops.cluster_scatter(ints, buf, scal, vmax)
        exp = ops.cluster_scatter_plain(ints, buf, scal, vmax)
        for a, b in zip(got, exp):
            err = max(err, int((a.long() - b.long()).abs().max()))
    check(err == 0, f"K1 differs from its plain version (max |d| {err})")
    ints, buf, scal = recorded[len(recorded) // 2]
    ms = event_ms(torch, lambda: ops.cluster_scatter(ints, buf, scal, vmax),
                  200)
    plain = host_ms(torch, lambda: ops.cluster_scatter_plain(
        ints, buf, scal, vmax), 5)
    live = int(ints[:, 2].sum())
    nbytes = 4 * (3 * B + 10 * B + 4 + 1) + 4 * (10 * B + 4 + B)
    bms, by = bound_ms(nbytes, K1_OPS_PER_EDGE * live)
    lat = latency_ms(live, K1_STEPS_PER_EDGE, sm_hz)
    rows.append(dict(name="cluster_scatter", route="cuda",
                     source="src/repro_torch/csrc/cluster_scatter.cu",
                     replaces="src/repro/kernels/cluster_scatter.py:188",
                     launches=launches["cluster_scatter"], max_abs_err=err,
                     ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=None, latency_bound_ms=lat,
                     limited_by="latency"))
    log(f"[K1] {len(recorded)} recorded blocks bit-identical; "
        f"{ms:.5f} ms/launch; latency floor {lat:.6f} ms ({live} live "
        f"edges x {K1_STEPS_PER_EDGE} x {SMEM_STEP_CYCLES} cycles)")

    # K2 at M = m_cap, k = 64 (the game passes kpad = k)
    M = st["m_cap"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    aff = torch.randint(0, 4, (M, K), generator=gen, device=dev
                        ).to(torch.float32)
    sizes = torch.randint(1, 200, (M,), generator=gen, device=dev
                          ).to(torch.float32)
    row_tot = aff.sum(1) + torch.randint(0, 8, (M,), generator=gen,
                                         device=dev).to(torch.float32)
    cur = torch.randint(0, K, (M,), generator=gen, device=dev,
                        dtype=torch.int32)
    loads = torch.randint(150000, 250000, (K,), generator=gen,
                          device=dev).to(torch.float32)
    lam = torch.tensor([0.05], device=dev)
    kb, kc = ops.game_bestresponse(aff, sizes, row_tot, cur, loads, lam=lam,
                                   k=K)
    pb, pc = ops.game_bestresponse_plain(aff, sizes, row_tot, cur, loads,
                                         lam=lam, k=K)
    differ = kb != pb
    near_tie = (pc[differ] - kc[differ]).abs() <= 1e-6 * kc[differ].abs()
    check(bool(near_tie.all()), "K2 best differs beyond near-ties")
    torch.testing.assert_close(kc, pc, rtol=1e-6, atol=0.0)
    k2_err = float((kc - pc).abs().max())
    ms = event_ms(torch, lambda: ops.game_bestresponse(
        aff, sizes, row_tot, cur, loads, lam=lam, k=K), 50)
    plain = event_ms(torch, lambda: ops.game_bestresponse_plain(
        aff, sizes, row_tot, cur, loads, lam=lam, k=K), 10)
    nbytes = M * K * 4 + M * 12 + K * 4 + 4 + M * 8
    bms, by = bound_ms(nbytes, K2_OPS_PER_LANE * M * K)
    rows.append(dict(name="game_bestresponse", route="cuda",
                     source="src/repro_torch/csrc/game_bestresponse.cu",
                     replaces="src/repro/kernels/game_bestresponse.py:52",
                     launches=launches["game_bestresponse"],
                     max_abs_err=k2_err, ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None,
                     limited_by="bytes"))
    log(f"[K2] M={M} k={K}: {int(differ.sum())} best flips (all "
        f"near-ties), cost max |d| {k2_err:.3e}; {ms:.4f} ms/launch")

    # K3 on the run's row-split ELL table
    lay = sess.partition_layout
    ell = lay.cache[(str(dev), "halo")]["ell"]
    R, W = ell.vals.shape
    N = lay.k * (lay.l_max + 1)
    x = torch.rand(N, generator=gen, device=dev)
    y = ops.ell_spmv(ell.vals, ell.cols, x)
    yp = ops.ell_spmv_plain(ell.vals, ell.cols, x)
    torch.testing.assert_close(y, yp, rtol=1e-5, atol=1e-6)
    k3_err = float((y - yp).abs().max())
    ms = event_ms(torch, lambda: ops.ell_spmv(ell.vals, ell.cols, x), 50)
    plain = event_ms(torch, lambda: ops.ell_spmv_plain(ell.vals, ell.cols,
                                                       x), 10)
    # the same function as a CSR matrix of the real lanes (PyTorch's CSR
    # wants sorted, distinct columns per row; pad lanes add 0 anyway)
    real = ell.vals.reshape(-1) != 0
    r_idx = torch.arange(R, device=dev).repeat_interleave(W)[real]
    c_idx = ell.cols.reshape(-1).long()[real]
    order = torch.argsort(r_idx * N + c_idx)
    crow = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(r_idx, minlength=R), 0)
    with warnings.catch_warnings():      # "beta state" notices
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.sparse_csr_tensor(crow, c_idx[order],
                                      ell.vals.reshape(-1)[real][order],
                                      size=(R, N), check_invariants=True)
    xs = x[:, None]
    lib = event_ms(torch, lambda: torch.sparse.mm(csr, xs), 20)
    torch.testing.assert_close(torch.sparse.mm(csr, xs)[:, 0], yp,
                               rtol=1e-5, atol=1e-6)
    bms, by = bound_ms(R * W * 8 + N * 4 + R * 4, 2 * R * W)
    rows.append(dict(name="ell_spmv", route="cuda",
                     source="src/repro_torch/csrc/ell_spmv.cu",
                     replaces="src/repro/kernels/ell_spmv.py:30",
                     launches=launches["ell_spmv"], max_abs_err=k3_err,
                     ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=lib, limited_by="bytes"))
    log(f"[K3] R={R} W={W} N={N}: max |d| {k3_err:.3e}; {ms:.4f} ms/launch, "
        f"torch.sparse.mm {lib:.4f} ms")

    # T on the scale-20 restream inputs
    clus = sess.result.clustering
    vp = majority_vertex_map(src_t, dst_t,
                             torch.from_numpy(sess.assign).to(dev), V, K)
    pu, pv, nm = ops.transform_inputs(
        src_t.long(), dst_t.long(), vp,
        torch.from_numpy(clus.deg).to(dev),
        torch.from_numpy(clus.divided).to(dev))
    lmax = cfg.tau * E / K
    got = ops.transform_scan(pu, pv, nm, K, lmax)
    t = time.perf_counter()
    exp = ops.transform_scan_plain(pu, pv, nm, K, lmax)
    plain = (time.perf_counter() - t) * 1e3
    t_err = int((got.long() - exp.long()).abs().max())
    check(t_err == 0, "T differs from its plain version")
    ms = event_ms(torch, lambda: ops.transform_scan(pu, pv, nm, K, lmax), 3,
                  warmup=1)
    real = int((nm >= 0).sum())
    bms, by = bound_ms(E * 16, T_OPS_PER_EDGE * real)
    lat = latency_ms(real, T_STEPS_PER_EDGE, sm_hz)
    rows.append(dict(name="transform_scan", route="cuda",
                     source="src/repro_torch/csrc/transform_scan.cu",
                     replaces="src/repro/core/transform.py:93",
                     launches=launches["transform_scan"], max_abs_err=t_err,
                     ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=None, latency_bound_ms=lat,
                     limited_by="latency"))
    log(f"[T] E={E}: bit-identical; {ms:.3f} ms/launch, plain loop "
        f"{plain:.0f} ms; latency floor {lat:.3f} ms ({real} edges x "
        f"{T_STEPS_PER_EDGE} x {SMEM_STEP_CYCLES} cycles)")

    # ---------------------------------------------------------- phase 4
    gs = web_graph(scale=SMALL_SCALE, edge_factor=EDGE_FACTOR, seed=0)
    ss = torch.from_numpy(gs.src).to(dev)
    sd = torch.from_numpy(gs.dst).to(dev)
    vs = max(2.0, gs.num_edges / float(K))
    t = time.perf_counter()
    a = streaming_clustering(ss, sd, gs.num_vertices, vs, kernel="cuda")
    t_kernel = time.perf_counter() - t
    t = time.perf_counter()
    b = streaming_clustering(ss, sd, gs.num_vertices, vs, kernel="torch")
    t_plain = time.perf_counter() - t
    for x_, y_ in zip(a, b):
        check(torch.equal(x_, y_), "scale-16 clustering state differs")
    results = {}
    for mode in ("cuda", "torch"):
        c = CLUGPConfig.optimized(K, restream=1, game=False, kernel=mode,
                                  cluster_kernel=mode)
        results[mode] = partition(gs.src, gs.dst, gs.num_vertices, c)
    check(np.array_equal(results["cuda"].assign, results["torch"].assign),
          "scale-16 game-off assignment differs between kernel and plain")
    log(f"[scale16] V={gs.num_vertices} E={gs.num_edges}: clustering state "
        f"and game-off assignment bit-identical (clustering {t_kernel:.2f} s "
        f"kernel, {t_plain:.2f} s plain; rf {results['cuda'].stats['rf']:.4f})")

    # ---------------------------------------------------------- phase 5
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
