#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. Print the card's name and power limit; build the six CUDA kernels
   (one ``nvcc`` per source, in parallel, into ``build/repro_torch/``).
2. The graph path at full size: ``web_graph(scale=20)`` (1,048,576
   vertices, ~6.4 M edges) → ``GraphSession`` CLUGP partition at k = 64
   (one restream) → ``build_layout`` → 30 PageRank iterations over the
   halo exchange.  Launch counts are zeroed just before and read just
   after: every graph kernel (K1, the fused K2 over the CSR, K3, T) must
   have launched, K4 and the dense K2 not, and K1 exactly once per
   clustering pass (its pass walks the whole stream in one launch).
   Checks: RF below a uniform random assignment's, every partition load
   ≤ τ·E/k + 1, PageRank finite and within L1 1e-4 of the float64 oracle.
3. The GAS program library on the same scale-20 layout (``[gas]``): all
   eight programs through ``sess.run`` on the halo and the dense
   exchange (f32 programs 30 iterations, min programs 40, degree 1, cc to
   its fixed point under a cap), each against its numpy oracle (integer
   programs equal, pagerank and ppr L1 ≤ 1e-4, centrality L1 relative to
   the oracle's ≤ 1e-4) and the integer ones equal across the exchanges;
   the fused bundles (pagerank, ppr, centrality) and (cc, labelprop,
   sssp, bfs) against their single runs and timed against them; pagerank
   and labelprop with early exit, then warm-started from their result
   (labelprop must end after one iteration with identical output,
   pagerank in fewer iterations than cold; the timed device loop of
   pagerank to tol within one iteration of ``sess.run``'s count and L1
   1e-4 of its vector).  Every run is counted on its
   own: K3 exactly once an iteration for each program that gathers on it
   (pagerank, ppr, centrality), no other kernel.  ms/iteration of every
   program and bundle (the second, synchronized run on the cached
   tables) and the oracles' host seconds.
3b. The other three wire formats on the same layout (``[exchange]``,
   nothing cut): the ring schedule (populated hops, sum of H_s), the
   lanes each exchange moves a phase, the interior share and the
   ``comm_bytes()`` table; every program through ``sess.run`` on
   quantized, ragged and ragged_quantized with ms/iteration of the device
   loop beside ``[gas]``'s halo and dense; ``overlap=True`` on the ragged
   two; both bundles on all three; pagerank to tol 1e-6 on quantized,
   cold and warm; the phase's peak memory (the profiler's device
   activities an iteration on all five wires are read after phase 4's
   kernel timings, in one session).  Counts zeroed before the phase
   and read after: K3 once an iteration of pagerank, ppr and centrality,
   no other kernel.  Checks: integer programs equal halo's with and
   without overlap; ragged (and its overlap) within rtol 1e-5 of halo;
   quantized and ragged_quantized pagerank's max-abs error to the float64
   oracle at 100 iterations below 1e-6 and below its error at 30
   (ragged_quantized overlapped too), the fused quantized pagerank within
   5e-4; in the byte model ragged <= halo <= dense and quantized < halo.
4. Every graph kernel against its plain PyTorch version on the card at
   the graph path's shapes (K1's pass on the first 2,048 blocks of the
   scale-20 stream: clu, deg, vol, scal and packed bit for bit, then timed
   over the whole stream; the dense K2 at M = the run's m_cap and k = 64;
   the fused K2 on every live batch of the run's game (its cluster CSR,
   assignment and loads), bit for bit on best, cost and the current cost;
   K3 on the run's row-split ELL; T on the inputs of both of the path's
   walks, the first pass's and the restream's, bit for bit against the
   plain walk and the tiered emulation, with its tier counts), timed on
   the device — CUDA events, or for K2, its CSR form and K3, whose
   launches are shorter than their wrappers' host time, the profiler's
   kernel times (the events' back-to-back rate beside them) — beside the
   least time the card could take for their bytes and operations (and,
   for K1 and T, whose dependent chains are what limits them, a latency
   floor) and, for K3, one PyTorch sparse call.
4b. Graph serving on the same resident session (``[graph-serve]``): a
   ``GraphServer`` answers the reference launcher's query mix (64 score
   queries over pagerank, degree, cc and labelprop, 4 vertices each, 4
   owner and 4 neighbors queries; microbatches of 16, 30 iterations),
   takes 3 windows of 65,536 uniformly random arrivals (each flush
   assigned on T from the resident loads under the grown cap; a
   restream of 2 passes whenever RF passes 1.02 × its baseline), serves
   the grown graph, then the same score mix cold and warm to tol 1e-6
   (cap 200).  Counts zeroed before and read after: T once a flush plus
   2 a restream, K3 once an iteration of every pagerank run, no other
   kernel.  Checks: integer replies equal direct runs and the host
   tables, pagerank within rtol 1e-5 (L1 1e-4 at tol; float atomics on
   the card), every load ≤ τ·E/k + 1 after each swap, RF after a
   restream ≤ the drift, warm fewer iterations than cold.  Then T from
   seeded loads on the first flush's inputs (under the grown cap and
   under the resident one, where the partitions at the balance start
   full) against its plain walk and the tiered emulation, tier counts
   included; and the kill/resume check at scale 16, k 64, through the
   launcher's child (``--child-snapshot``), which must die by SIGKILL.
   Prints the query ms, each swap's assign / RF / layout seconds, the RF
   trace, cold and warm iterations and ms, each round split into seed
   tables, device loop and collection, and the phase's peak memory; then
   drops the grown session, so the later phases hold no graph state.
5. At scale 16 the kernel path and the plain path on the card: the
   clustering state, the game-off assignment and the game-on assignment
   (the CSR game on the fused K2 against the dense plain game) must match
   bit for bit.  The same two partitions on the CPU are printed beside
   them (RF, edges assigned elsewhere).
6. The LM serving path: qwen2-7b at full width and depth (28 layers,
   7.6 B parameters) in bf16 from a seeded generator.  ``make_prefill_step``
   on 4 prompts of 2,048 tokens with the counts zeroed before and read
   after: K4 must launch once per layer, the graph kernels never; prefill
   tokens/s.  Then the serving launcher's loop (``launch.serve.generate``:
   4 prompts of 16 tokens by repeated decode, 32 greedy tokens), which
   launches no K4; ms/token-step beside its floor, the 15.2 GB of weights
   each step reads at 3.35 TB/s.  Logits finite throughout.
7. Cross-check: qwen2-7b cut to 2 layers at full width in f32; the last
   logits of ``prefill`` (K4) against the decode loop's logits at the last
   prompt position (dense attention, no K4) within 2e-3, the JAX package's
   own tolerance for decode against forward.
8. K4 against its plain version at the prefill shape (q 4×28×2048×128,
   k/v 4×4×2048×128, bf16, causal) within 2e-2 and at one f32 shape within
   2e-5; timed with CUDA events beside its bound (tensor-core operations)
   and ``scaled_dot_product_attention`` as a yardstick the port never
   calls, with K4's share of the prefill.
9. The ``kernels`` JSON line (six rows; K3's row also carries the
   ``[gas]`` and ``[exchange]`` phases' launches, T's the seeded walk of
   ``[graph-serve]``),
   then the device JSON line last.

The script imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SCALE, EDGE_FACTOR, K = 20, 8, 64
SMALL_SCALE = 16
PASS_PREFIX = 2048               # blocks of K1's pass held against plain
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 dense tensor cores
K1_OPS_PER_EDGE = 150            # ALU operations of one edge's decisions
T_OPS_PER_EDGE = 8               # compares/selects/increment of one edge
K2_OPS_PER_LANE = 8              # flops of one (row, partition) cost
K2_OPS_PER_ENTRY = 4             # the fused K2's gather, match, add per entry
T_ONE_THREAD_MS = 744.63         # T when one thread walked every edge (PERF.md §6)
# K1 is one dependent chain of shared-memory steps, so its floor is
# latency, not bytes or operations: dependent edges x steps per edge x
# the load-to-use latency of one shared-memory read (about 29 cycles on
# Hopper in published microbenchmarks) at the card's top SM clock.  T's
# chain runs only through the chunks its warp walks (the frozen and exact
# tiers): one dependent step per 32-edge walk step and one per both-full
# edge (each reads the loads the one before wrote).
SMEM_STEP_CYCLES = 29
K1_STEPS_PER_EDGE = 2            # slot read -> volume read at that slot
T_WALK_STEP = 32                 # edges a walk step decides together
# the GAS phase on the graph path's layout: iterations per program (the
# min programs need their frontier to move; degree is exact after one),
# the programs that gather on K3, the fused bundles, the caps of the runs
# that end at a fixed point or a residual, and pagerank's tolerance
GAS_ITERS = {"pagerank": 30, "ppr": 30, "centrality": 30, "labelprop": 40,
             "sssp": 40, "bfs": 40, "degree": 1}
GAS_K3 = ("pagerank", "ppr", "centrality")
GAS_ITERS_ALL = tuple(GAS_ITERS) + ("cc",)
GAS_F32_BUNDLE = ("pagerank", "ppr", "centrality")
GAS_I32_BUNDLE = ("cc", "labelprop", "sssp", "bfs")
CC_CAP = GAS_CAP = 200
# pagerank's tolerance stays clear of the f32 noise of the hub's rank
# (191,269 in-edges summed by float atomics in a varying order): on an
# H100 at 1e-7, a restart from a vector converged to 1e-7 took 8
# iterations, the residual meeting the tolerance by chance
PR_TOL = 1e-6
# the graph-serving phase on the same resident session: the reference
# launcher's query mix (64 score queries over its four programs, 4
# vertices each, plus 4 owner and 4 neighbors queries; microbatches of 16,
# 30 iterations), then 3 windows of 65,536 uniformly random arrivals fed in
# quarter-window chunks (RF watermark 1.02, 2 restream passes), then the
# same score mix cold and warm to tol 1e-6 under a cap of 200; the
# kill/resume check runs the launcher's child at scale 16
SERVE_QUERIES, SERVE_BATCH, SERVE_ITERS = 64, 16, 30
SERVE_WINDOW, SERVE_WINDOWS = 65536, 3
SERVE_WATERMARK, SERVE_PASSES = 1.02, 2
SERVE_TOL, SERVE_CAP = 1e-6, 200
RESUME_SCALE = 16
# the LM serving path: qwen2-7b at full width and depth
LM_ARCH = "qwen2_7b"
PREFILL_B, PREFILL_S = 4, 2048
SERVE_B, SERVE_PROMPT, SERVE_TOKENS = 4, 16, 32
CHECK_LAYERS, CHECK_B, CHECK_PROMPT = 2, 2, 100   # the f32 cross-check
F32_S = 300                                       # K4's f32 shape: S


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*a):
    print(*a, flush=True)


def bound_ms(nbytes, nops, ops_per_s=F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def latency_ms(edges, steps_per_edge, sm_hz):
    return edges * steps_per_edge * SMEM_STEP_CYCLES / sm_hz * 1e3


def check_path_launches(ops, launches, path):
    """Every kernel of ``path`` launched in its run, no other kernel."""
    for name in ops.KERNELS[path]:
        check(launches.get(name, 0) > 0, f"kernel {name} never launched "
              f"on the {path} path")
    others = {n for p, names in ops.KERNELS.items() if p != path
              for n in names} - set(ops.KERNELS[path])
    check(not others & {n for n, c in launches.items() if c},
          f"the {path} path launched another path's kernel: {launches}")


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


def device_ms(torch, fn, reps, kernel):
    """Mean device time of one launch of the kernels whose name holds
    ``kernel``, over ``reps`` calls of ``fn`` traced by torch.profiler.  A
    kernel shorter than its wrapper's host-side launch cost is timed
    alone here; CUDA events around back-to-back calls would read the
    host's launch rate instead."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():      # the profiler's one-cycle notice
        warnings.simplefilter("ignore", UserWarning)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and kernel in e.name]
    check(len(us) >= reps, f"the profiler saw {len(us)} launches of "
          f"{kernel} in {reps} calls")
    return sum(us) / len(us) / 1e3


def host_ms(torch, fn, reps=1):
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3 / reps


def gas_phase(torch, ops, sess, g) -> dict:
    """The GAS program library on the session's scale-20 layout: every
    program through ``sess.run`` on both exchanges against its numpy
    oracle (sssp and bfs also from the vertex of largest out-degree), the
    fused bundles against their single runs, early exit and warm start.
    Each run is counted on its own: K3 exactly once an iteration for each
    program that gathers on it, no other kernel.  ms/iteration is the
    device loop alone (init and the iterations on the cached tables,
    synchronized), beside ``sess.run``'s end-to-end time, which adds the
    collection of the master values to the host.  Returns the phase's K3
    launches and its timings."""
    import numpy as np
    from repro_torch.dist.halo import get_exchange
    from repro_torch.graph import engine as eng
    V = g.num_vertices
    lay = sess.partition_layout
    hub = int(np.bincount(g.src, minlength=V).argmax())
    oracles = {
        "pagerank": lambda: eng.reference_pagerank(g.src, g.dst, V,
                                                   GAS_ITERS["pagerank"]),
        "ppr": lambda: eng.reference_ppr(g.src, g.dst, V, GAS_ITERS["ppr"]),
        "centrality": lambda: eng.reference_centrality(
            g.src, g.dst, V, GAS_ITERS["centrality"]),
        "cc": lambda: eng.reference_cc(g.src, g.dst, V),
        "labelprop": lambda: eng.reference_labelprop(g.src, g.dst, V,
                                                     GAS_ITERS["labelprop"]),
        "sssp": lambda: eng.reference_sssp(g.src, g.dst, V,
                                           GAS_ITERS["sssp"]),
        "bfs": lambda: eng.reference_bfs(g.src, g.dst, V, GAS_ITERS["bfs"]),
        "degree": lambda: eng.reference_degree(g.src, g.dst, V),
        "sssp@hub": lambda: eng.reference_sssp(g.src, g.dst, V,
                                               GAS_ITERS["sssp"], hub),
        "bfs@hub": lambda: eng.reference_bfs(g.src, g.dst, V,
                                             GAS_ITERS["bfs"], hub)}
    refs, oracle_s = {}, {}
    for name, fn in oracles.items():
        t = time.perf_counter()
        refs[name] = fn()
        oracle_s[name] = time.perf_counter() - t
    log("[gas] oracle host seconds " + json.dumps(
        {k: round(v, 3) for k, v in oracle_s.items()}))
    k3_total = 0

    def counted(fn, k3, what):
        """``fn()`` with the counts zeroed before and read after: K3
        exactly ``k3`` times (or ``k3(out)``), no other kernel."""
        nonlocal k3_total
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        if callable(k3):
            k3 = k3(out)
        launched = {n: c for n, c in ops.launch_counts().items() if c}
        check(set(launched) <= set(ops.KERNELS["gas"]),
              f"{what} launched a kernel off the gas path: {launched}")
        check(launched.get("ell_spmv", 0) == k3, f"{what}: K3 launched "
              f"{launched.get('ell_spmv', 0)} times, not {k3}")
        k3_total += k3
        return out

    def timed(fn, k3, what):
        """``counted`` on an idle card, synchronized: (out, ms)."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = counted(fn, k3, what)
        return out, (time.perf_counter() - t) * 1e3

    def loop(prog, it, ex, tol=None):
        """The device loop alone on the cached tables: (values, iters)."""
        dev = eng.stack_dev(lay, ex, sess.device)
        run = eng._sim_gas_many if isinstance(prog, eng.FusedGAS) \
            else eng._sim_gas
        return run(prog, dev, it, get_exchange(ex), tol)

    def per_iter(out):
        return out[1]

    ms_iter, iters_run, results = {}, {}, {}
    for ex in ("halo", "dense"):
        for name in ("pagerank", "ppr", "centrality", "labelprop", "sssp",
                     "bfs", "degree", "cc"):
            k3 = name in GAS_K3
            if name == "cc":
                def run(ex=ex):
                    return sess.run("cc", iters=CC_CAP, tol=0.0,
                                    exchange=ex, return_iters=True)
                out, it = counted(run, 0, f"cc on {ex}")
                check(it < CC_CAP, f"cc on {ex} did not reach its fixed "
                      f"point in {CC_CAP} iterations")
                (out2, _), run_ms = timed(run, 0, f"cc on {ex}")
            else:
                it = GAS_ITERS[name]

                def run(name=name, ex=ex, it=it):
                    return sess.run(name, iters=it, exchange=ex)
                out = counted(run, k3 * it, f"{name} on {ex}")
                out2, run_ms = timed(run, k3 * it, f"{name} on {ex}")
            _, loop_ms = timed(lambda: loop(eng.get_program(name, V), it, ex),
                               k3 * it, f"{name}'s loop on {ex}")
            check(out.shape == (V,), f"{name} on {ex}: shape {out.shape}")
            if name in GAS_K3:
                check(bool(np.isfinite(out).all()), f"{name} not finite")
            else:
                check(np.array_equal(out, out2), f"{name} on {ex} differs "
                      "between two runs")
            results[name, ex] = out
            iters_run[name, ex] = it
            ms_iter[name, ex] = loop_ms / it
            ref = refs[name]
            if name in GAS_K3:
                l1 = float(np.abs(out.astype(np.float64) - ref).sum())
                if name == "centrality":
                    l1 /= float(np.abs(ref).sum())
                check(l1 <= 1e-4, f"{name} on {ex}: L1 {l1:.3e} > 1e-4")
                err = f"L1 {l1:.3e}" + (" (relative)" if name == "centrality"
                                        else "")
            else:
                check(np.array_equal(out, ref), f"{name} on {ex} differs "
                      "from its numpy oracle")
                err = "equal to the oracle"
                if name != "degree":
                    err += (f"; {int((out != eng.CC_SENTINEL).sum())} of {V}"
                            " reached")
            log(f"[gas] {name} on {ex}: {it} iterations, {ms_iter[name, ex]:.4f}"
                f" ms/iteration (device loop {loop_ms:.3f} ms; sess.run "
                f"{run_ms:.3f} ms end to end), {err}")
        for name in ("sssp", "bfs"):
            prog = getattr(eng, f"{name}_program")(hub)
            out = counted(lambda prog=prog, ex=ex: sess.run(
                prog, iters=GAS_ITERS[name], exchange=ex), 0,
                f"{name} from {hub} on {ex}")
            check(np.array_equal(out, refs[f"{name}@hub"]), f"{name} from "
                  f"vertex {hub} on {ex} differs from its numpy oracle")
            log(f"[gas] {name} from vertex {hub} (largest out-degree) on "
                f"{ex}: equal to the oracle; "
                f"{int((out != eng.CC_SENTINEL).sum())} of {V} reached")
    for name in ("cc", "labelprop", "sssp", "bfs", "degree"):
        check(np.array_equal(results[name, "halo"], results[name, "dense"]),
              f"{name}: halo and dense differ")
    check(iters_run["cc", "halo"] == iters_run["cc", "dense"],
          "cc: halo and dense reach the fixed point in different counts")
    lanes = {ex: eng.stack_dev(lay, ex, sess.device)[route].numel()
             for ex, route in (("halo", "mirror"), ("dense", "gathered"))}
    log(f"[gas] every integer program equal on halo and dense; cc's fixed "
        f"point after {iters_run['cc', 'halo']} iterations; lanes a phase: "
        f"halo {lanes['halo']} (k^2 x H_max = {lay.k}^2 x {lay.h_max}) for "
        f"{lay.mirrors_total} mirrors, dense reduce {lanes['dense']} (one a "
        f"replica), dense broadcast {lay.k * lay.l_max} (k x L_max)")

    # the fused bundles: one exchange per phase for the whole bundle
    fused_ms = {}
    for ex in ("halo", "dense"):
        cc40 = counted(lambda ex=ex: sess.run(
            "cc", iters=GAS_ITERS["labelprop"], exchange=ex), 0, f"cc on {ex}")
        for bundle, it in ((GAS_F32_BUNDLE, 30), (GAS_I32_BUNDLE, 40)):
            k3 = it * sum(p in GAS_K3 for p in bundle)
            what = f"{'+'.join(bundle)} on {ex}"
            outs = counted(lambda bundle=bundle, it=it, ex=ex: sess.run_many(
                bundle, iters=it, exchange=ex), k3, what)
            fused = eng.fuse_programs([eng.get_program(p, V) for p in bundle])
            _, ms = timed(lambda fused=fused, it=it, ex=ex: loop(fused, it, ex),
                          k3, f"{what}, its loop")
            for name, out in zip(bundle, outs):
                single = cc40 if name == "cc" else results[name, ex]
                if name in GAS_K3:
                    d = float(np.abs(out.astype(np.float64) - single).sum()
                              / np.abs(single.astype(np.float64)).sum())
                    check(d <= 1e-5, f"fused {name} on {ex}: relative L1 "
                          f"{d:.3e} from its single run")
                else:
                    check(np.array_equal(out, single), f"fused {name} on "
                          f"{ex} differs from its single run")
            sep = sum(ms_iter[p, ex] for p in bundle)
            fused_ms["+".join(bundle), ex] = (ms / it, sep)
            log(f"[gas] fused {'+'.join(bundle)} on {ex}: {ms / it:.4f} "
                f"ms/iteration against {sep:.4f} run separately "
                f"({ms / it / sep:.2f}x); "
                + ("within relative L1 1e-5 of" if bundle == GAS_F32_BUNDLE
                   else "equal to") + " the single runs")

    # early exit and warm start: K3 once for each iteration run
    pr, pr_it = counted(lambda: sess.run("pagerank", iters=GAS_CAP,
                                         tol=PR_TOL, return_iters=True),
                        per_iter, "pagerank with tol")
    check(pr_it < GAS_CAP, f"pagerank did not reach tol {PR_TOL} in "
          f"{GAS_CAP} iterations")
    _, pr_wit = counted(lambda: sess.run("pagerank", iters=GAS_CAP,
                                         tol=PR_TOL, init_values=pr,
                                         return_iters=True),
                        per_iter, "warm pagerank")
    check(pr_wit < pr_it, f"warm pagerank took {pr_wit} iterations, cold "
          f"{pr_it}")
    lp, lp_it = counted(lambda: sess.run("labelprop", iters=GAS_CAP, tol=0.0,
                                         return_iters=True), 0,
                        "labelprop to its fixed point")
    check(lp_it < GAS_CAP, "labelprop did not reach its fixed point")
    lp_w, lp_wit = counted(lambda: sess.run(
        "labelprop", iters=GAS_CAP, tol=0.0, init_values=lp,
        return_iters=True), 0, "warm labelprop")
    check(lp_wit == 1 and np.array_equal(lp_w, lp),
          f"labelprop from its fixed point: {lp_wit} iterations, output "
          f"{'identical' if np.array_equal(lp_w, lp) else 'changed'}")
    log(f"[gas] early exit: pagerank at tol {PR_TOL} after {pr_it} "
        f"iterations, from its converged vector after {pr_wit}; labelprop's "
        f"fixed point after {lp_it} iterations, from it after {lp_wit} with "
        "identical output")
    (pr_loop, pr_loop_it), pr_ms = timed(
        lambda: loop(eng.get_program("pagerank", V), GAS_CAP, "halo",
                     PR_TOL), per_iter, "pagerank's loop with tol")
    # the hub's rank is summed by float atomics in a varying order on the
    # card, so two runs of one f32 early-exit loop may stop an iteration
    # apart (the port's rule for f32 tol exits, ROADMAP Queue 3); the
    # vector it stops at is held to sess.run's at the rule's L1 1e-4
    pr_loop_l1 = float(np.abs(eng.collect_master_values(lay, pr_loop)
                              .astype(np.float64) - pr).sum())
    check(abs(pr_loop_it - pr_it) <= 1 and pr_loop_l1 <= 1e-4,
          f"pagerank's loop with tol ran {pr_loop_it} iterations to L1 "
          f"{pr_loop_l1:.3e} of sess.run's vector, sess.run {pr_it}")
    (_, it), lp_ms = timed(lambda: loop(eng.get_program("labelprop", V),
                                        GAS_CAP, "halo", 0.0),
                           0, "labelprop's loop with tol")
    check(it == lp_it, "labelprop's loop with tol ran another count")
    tol_ms = {"pagerank": pr_ms / pr_loop_it, "labelprop": lp_ms / lp_it}
    log(f"[gas] early exit reads the residual back once an iteration: "
        f"pagerank {tol_ms['pagerank']:.4f} ms/iteration with tol ({pr_loop_it}"
        f" iterations this run, sess.run {pr_it}, L1 {pr_loop_l1:.3e} to its "
        f"vector) against "
        f"{ms_iter['pagerank', 'halo']:.4f} without, labelprop "
        f"{tol_ms['labelprop']:.4f} against {ms_iter['labelprop', 'halo']:.4f}")
    log(f"[gas] K3 launches in the phase {k3_total}")
    # what only this phase built goes (the dense exchange's tables, the
    # bundles' routes), so the later phases' memory readings hold what
    # they held before it
    lay.cache.pop((str(sess.device), "dense"))
    lay.cache[(str(sess.device), "halo")]["routes"].clear()
    torch.cuda.empty_cache()
    return dict(k3=k3_total, ms_iter={f"{n}/{e}": v
                                      for (n, e), v in ms_iter.items()},
                fused={f"{n}/{e}": v for (n, e), v in fused_ms.items()},
                tol_ms_iter=tol_ms,
                iters={"cc": iters_run["cc", "halo"], "pagerank_tol": pr_it,
                       "pagerank_warm": pr_wit, "labelprop_fixed": lp_it,
                       "labelprop_warm": lp_wit},
                oracle_s=oracle_s,
                halo={n: results[n, "halo"] for n in GAS_ITERS_ALL},
                cc40=cc40, refs=refs)


def exchange_activities(torch, sess, iters=3) -> dict:
    """Device activities (kernels, copies, fills) an iteration of pagerank
    and labelprop's device loops on all five wires of the session's
    layout, from one profiler session after a warm-up step: each loop
    runs ``iters`` and then 2·``iters`` iterations, each run followed by a
    marker kernel (``torch.cuda._sleep``), and the difference of a pair
    over ``iters`` leaves out the run's set-up.  The card's profiler loses
    records in some sessions (it lost 1–2 of 50 in the K2 timing after
    twenty short sessions), so a session whose markers do not all arrive
    is run again, twice at most, and then reads "not measured".  Builds
    and then drops the other wires' tables."""
    from torch.autograd import DeviceType
    from repro_torch.dist.halo import EXCHANGE_NAMES, get_exchange
    from repro_torch.graph import engine as eng
    lay = sess.partition_layout
    runs = {}
    for ex in EXCHANGE_NAMES:
        dev = eng.stack_dev(lay, ex, sess.device)
        for name in ("pagerank", "labelprop"):
            prog = eng.get_program(name, sess.num_vertices)
            runs[name, ex] = (lambda n, prog=prog, dev=dev, ex=ex: eng._sim_gas(
                prog, dev, n, get_exchange(ex, lay)))
    for fn in runs.values():
        fn(iters)
    torch.cuda.synchronize()

    def marker():
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()

    want = 2 * len(runs) + 1
    for attempt in range(1, 4):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA],
                    schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                     active=1, repeat=1)
                    ) as prof:
                marker()
                prof.step()
                for _ in range(4):
                    marker()
                for fn in runs.values():
                    for n in (iters, 2 * iters):
                        fn(n)
                        torch.cuda.synchronize()
                        marker()
                prof.step()
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        between = []
        for e in events:
            if "spin_kernel" in e.name:
                between.append(0)
            elif between:
                between[-1] += 1
        complete = len(between) == want + 3
        log(f"[exchange] profiler session {attempt}: {len(between)} marker "
            f"kernels of {want + 3} sent, {len(events)} device activities"
            + ("" if complete else "; records lost"))
        if complete:
            break
    for ex in EXCHANGE_NAMES:
        if ex != "halo":
            lay.cache.pop((str(sess.device), ex))
    torch.cuda.empty_cache()
    if not complete:
        return {key: None for key in runs}
    counts = between[-want:-1]
    return {key: (counts[2 * i + 1] - counts[2 * i]) / iters
            for i, key in enumerate(runs)}


def exchange_phase(torch, ops, sess, g, gas) -> dict:
    """The quantized, ragged and ragged-quantized wires on the session's
    scale-20 layout, right after ``[gas]``: the ring schedule, the lanes
    each exchange moves, the interior share and the byte model; every
    program through ``sess.run`` on each (ms/iteration of the device loop
    beside ``[gas]``'s halo and dense), both fused bundles, ``overlap=True``
    on the ragged two, pagerank to tol on quantized and the phase's peak
    memory.  The counts are zeroed
    before the phase and read after: K3 once an iteration of each program
    that gathers on it, no other kernel.  Checks (the reference's bounds):
    integer programs equal halo's, with and without overlap; ragged within
    rtol 1e-5 of halo and its overlap of phase-ordered; the quantized and
    ragged-quantized pagerank's max-abs error to the float64 oracle at 100
    iterations below 1e-6 and below its error at 30, the ragged-quantized
    one overlapped too (the 30-iteration errors printed beside the
    reference's bound and the CPU's run on this layout); the fused
    quantized pagerank within 5e-4 of the oracle; ragged <= halo <= dense
    and quantized < halo in the byte model."""
    import numpy as np
    from repro_torch.dist.halo import get_exchange
    from repro_torch.graph import engine as eng
    V = g.num_vertices
    lay = sess.partition_layout
    dkey = str(sess.device)
    new = ("quantized", "ragged", "ragged_quantized")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    t_phase = time.perf_counter()

    sched = lay.halo_schedule()
    hops = [h for h in sched if h]
    ex_rq = get_exchange("ragged_quantized", lay)
    lanes = {"dense": (len(eng.stack_dev(lay, "dense", sess.device)
                           ["gathered"]), lay.k * lay.l_max),
             "halo": (lay.k * lay.k * lay.h_max,) * 2,
             "quantized": (lay.k * lay.k * lay.h_max,) * 2,
             "ragged": (len(eng.stack_dev(lay, "ragged", sess.device)
                            ["ring_mirror"]),) * 2,
             "ragged_quantized": (lay.k * sum(hops),) * 2}
    shipped = lay.k * sum(ex_rq._top(h) for h in hops)
    lay.cache.pop((dkey, "dense"))
    replicas = int(lay.vert_mask.sum())
    inter = lay.interior_frontier_stats()
    table = lay.comm_bytes()
    log(f"[exchange] ring schedule: {len(hops)} of {lay.k - 1} hops "
        f"populated, sum H_s {sum(hops)} (max H_s {max(hops)}, H_max "
        f"{lay.h_max}); {lay.mirrors_total} mirrors = {int(lay.halo_cnt.sum())}"
        f" halo_cnt lanes = {replicas} replica slots - {V} vertices")
    log("[exchange] lanes a phase (reduce, broadcast): " + "; ".join(
        f"{n} {a:,} / {b:,}" for n, (a, b) in lanes.items())
        + f" (ragged: the real lanes of the ring's {lay.k * sum(hops):,}; "
        f"ragged_quantized ships {shipped:,} of its lanes)")
    log(f"[exchange] interior share {inter['interior_frac']:.6f} (min over "
        f"partitions {inter['interior_frac_min']:.6f})")
    log("[exchange] comm_bytes per iteration " + json.dumps(table))
    check(table["ragged"] <= table["halo"] <= table["dense_gather"],
          f"byte model: ragged <= halo <= dense broken: {table}")
    check(table["quantized"] < table["halo"],
          f"byte model: quantized not below halo: {table}")

    k3_total = 0

    def counted(fn, k3, what):
        """``fn()`` with K3 launched ``k3`` times (or ``k3(out)``) in it
        and no other kernel: the counts' change over the call."""
        nonlocal k3_total
        before = ops.launch_counts()
        out = fn()
        torch.cuda.synchronize()
        if callable(k3):
            k3 = k3(out)
        delta = {n: c - before.get(n, 0)
                 for n, c in ops.launch_counts().items()
                 if c != before.get(n, 0)}
        check(set(delta) <= set(ops.KERNELS["gas"]),
              f"{what} launched a kernel off the gas path: {delta}")
        check(delta.get("ell_spmv", 0) == k3, f"{what}: K3 launched "
              f"{delta.get('ell_spmv', 0)} times, not {k3}")
        k3_total += k3
        return out

    def loop(prog, it, ex, tol=None, overlap=False):
        dev = eng.stack_dev(lay, ex, sess.device)
        run = eng._sim_gas_many if isinstance(prog, eng.FusedGAS) \
            else eng._sim_gas
        return run(prog, dev, it, get_exchange(ex, lay), tol, None, overlap)

    def timed_loop(prog, it, ex, k3, what, tol=None, overlap=False):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = counted(lambda: loop(prog, it, ex, tol, overlap), k3, what)
        return out, (time.perf_counter() - t) * 1e3

    refs = dict(gas["refs"])
    refs["pagerank@100"] = eng.reference_pagerank(g.src, g.dst, V, 100)

    def max_abs(out, ref):
        return float(np.abs(out.astype(np.float64) - ref).max())

    def rel_l1(out, ref):
        return float(np.abs(out.astype(np.float64) - ref).sum()
                     / np.abs(ref).sum())

    ms_iter, errs = {}, {}
    for ex in new:
        for name in ("pagerank", "ppr", "centrality", "labelprop", "sssp",
                     "bfs", "degree", "cc"):
            k3 = name in GAS_K3
            if name == "cc":
                out, it = counted(lambda ex=ex: sess.run(
                    "cc", iters=CC_CAP, tol=0.0, exchange=ex,
                    return_iters=True), 0, f"cc on {ex}")
                check(it == gas["iters"]["cc"], f"cc on {ex}: fixed point "
                      f"after {it} iterations, halo {gas['iters']['cc']}")
            else:
                it = GAS_ITERS[name]
                out = counted(lambda name=name, ex=ex, it=it: sess.run(
                    name, iters=it, exchange=ex), k3 * it, f"{name} on {ex}")
            _, ms = timed_loop(eng.get_program(name, V), it, ex, k3 * it,
                               f"{name}'s loop on {ex}")
            ms_iter[name, ex] = ms / it
            check(out.shape == (V,), f"{name} on {ex}: shape {out.shape}")
            halo = gas["halo"][name]
            if name in GAS_K3:
                check(bool(np.isfinite(out).all()), f"{name} on {ex} not "
                      "finite")
                if ex == "ragged":
                    check(np.allclose(out, halo, rtol=1e-5, atol=0.0),
                          f"{name} on ragged not within rtol 1e-5 of halo")
                errs[name, ex] = max_abs(out, refs[name])
                err = (f"max |d| {errs[name, ex]:.3e}, relative L1 "
                       f"{rel_l1(out, refs[name]):.3e} to the oracle")
            else:
                check(np.array_equal(out, halo), f"{name} on {ex} differs "
                      "from halo")
                err = "equal to halo"
            log(f"[exchange] {name} on {ex}: {it} iterations, "
                f"{ms_iter[name, ex]:.4f} ms/iteration (halo "
                f"{gas['ms_iter'][f'{name}/halo']:.4f}, dense "
                f"{gas['ms_iter'][f'{name}/dense']:.4f}); {err}")
    # the lossy wires converge on the fixed point instead of dithering at
    # a quantization step: the error at 100 iterations below 1e-6 and
    # below the error at 30 (the reference's bound at 30, 1e-5 for
    # quantized, was set on a 400-vertex graph; the same pagerank on the
    # CPU, on this layout, gives the 30-iteration error printed beside it)
    err100 = {}
    for ex in ("quantized", "ragged_quantized"):
        out = counted(lambda ex=ex: sess.run("pagerank", iters=100,
                                             exchange=ex), 100,
                      f"pagerank 100 on {ex}")
        err100[ex] = max_abs(out, refs["pagerank@100"])
        check(err100[ex] < 1e-6 and err100[ex] < errs["pagerank", ex],
              f"{ex} pagerank: max |d| {err100[ex]:.3e} at 100 iterations, "
              f"{errs['pagerank', ex]:.3e} at 30")
        if ex == "ragged_quantized":
            pr100 = out
    t = time.perf_counter()
    cpu_q = eng.simulate_gas(eng.get_program("pagerank", V), lay, 30,
                             "quantized", device="cpu")
    cpu_s = time.perf_counter() - t
    for key in [k for k in lay.cache if k[0] == "cpu"]:
        lay.cache.pop(key)
    log(f"[exchange] pagerank max |d| to the oracle at 30 iterations, then "
        f"100: quantized {errs['pagerank', 'quantized']:.3e} (the "
        f"reference's bound at 30: 1e-5; the CPU's run on this layout "
        f"{max_abs(cpu_q, refs['pagerank']):.3e}, {cpu_s:.1f} s), "
        f"{err100['quantized']:.3e}; ragged_quantized "
        f"{errs['pagerank', 'ragged_quantized']:.3e}, "
        f"{err100['ragged_quantized']:.3e}")

    # overlap on the ragged two: the interior applied apart from the ring
    over = {}
    for ex in ("ragged", "ragged_quantized"):
        for name in ("pagerank", "ppr", "centrality", "labelprop", "sssp",
                     "bfs", "degree"):
            it = GAS_ITERS[name]
            k3 = (name in GAS_K3) * it
            out = counted(lambda name=name, ex=ex, it=it: sess.run(
                name, iters=it, exchange=ex, overlap=True), k3,
                f"{name} on {ex} with overlap")
            _, ms = timed_loop(eng.get_program(name, V), it, ex, k3,
                               f"{name}'s overlapped loop on {ex}",
                               overlap=True)
            over[name, ex] = ms / it
            if name not in GAS_K3:
                check(np.array_equal(out, gas["halo"][name]), f"{name} on "
                      f"{ex} with overlap differs from halo")
            elif ex == "ragged":
                base = counted(lambda name=name, it=it: sess.run(
                    name, iters=it, exchange="ragged"), k3,
                    f"{name} on ragged")
                check(np.allclose(out, base, rtol=1e-5, atol=0.0),
                      f"{name} on ragged: overlap not within rtol 1e-5 of "
                      "phase-ordered")
            log(f"[exchange] {name} on {ex} with overlap: "
                f"{over[name, ex]:.4f} ms/iteration against "
                f"{ms_iter[name, ex]:.4f} phase-ordered")
        out, it = counted(lambda ex=ex: sess.run(
            "cc", iters=CC_CAP, tol=0.0, exchange=ex, overlap=True,
            return_iters=True), 0, f"cc on {ex} with overlap")
        check(np.array_equal(out, gas["halo"]["cc"])
              and it == gas["iters"]["cc"], f"cc on {ex} with overlap "
              "differs from halo")
    pr_over = counted(lambda: sess.run("pagerank", iters=100, overlap=True,
                                       exchange="ragged_quantized"), 100,
                      "overlapped pagerank 100 on ragged_quantized")
    over_err = max_abs(pr_over, refs["pagerank@100"])
    check(over_err < 1e-6 and over_err < errs["pagerank", "ragged_quantized"],
          f"overlapped ragged_quantized pagerank: max |d| {over_err:.3e} at "
          "100 iterations")
    log(f"[exchange] overlapped ragged_quantized pagerank at 100 iterations: "
        f"max |d| {over_err:.3e} to the oracle, {max_abs(pr_over, pr100):.3e}"
        f" to the phase-ordered run (float atomics vary the codes on the "
        "card)")

    # the fused bundles on the three wires
    fused_ms = {}
    for ex in new:
        for bundle, it in ((GAS_F32_BUNDLE, 30), (GAS_I32_BUNDLE, 40)):
            k3 = it * sum(p in GAS_K3 for p in bundle)
            what = f"{'+'.join(bundle)} on {ex}"
            outs = counted(lambda bundle=bundle, it=it, ex=ex: sess.run_many(
                bundle, iters=it, exchange=ex), k3, what)
            fused = eng.fuse_programs([eng.get_program(p, V) for p in bundle])
            _, ms = timed_loop(fused, it, ex, k3, f"{what}, its loop")
            notes = []
            for name, out in zip(bundle, outs):
                if name in GAS_K3:
                    check(bool(np.isfinite(out).all()), f"fused {name} on "
                          f"{ex} not finite")
                    notes.append(f"{name} max |d| "
                                 f"{max_abs(out, refs[name]):.3e}")
                    if ex == "ragged":
                        check(np.allclose(out, gas["halo"][name], rtol=1e-5,
                                          atol=0.0), f"fused {name} on "
                              "ragged not within rtol 1e-5 of halo")
                else:
                    single = gas["cc40"] if name == "cc" \
                        else gas["halo"][name]
                    check(np.array_equal(out, single), f"fused {name} on "
                          f"{ex} differs from halo")
            if ex == "quantized" and bundle == GAS_F32_BUNDLE:
                e = max_abs(outs[0], refs["pagerank"])
                check(e < 5e-4, f"fused quantized pagerank max |d| {e:.3e}")
            fused_ms["+".join(bundle), ex] = ms / it
            log(f"[exchange] fused {what}: {ms / it:.4f} ms/iteration "
                f"(halo {gas['fused']['+'.join(bundle) + '/halo'][0]:.4f}); "
                + ("; ".join(notes) if notes else "equal to halo"))

    # early exit and warm start on the quantized wire
    pr, pr_it = counted(lambda: sess.run(
        "pagerank", iters=GAS_CAP, tol=PR_TOL, exchange="quantized",
        return_iters=True), lambda out: out[1], "pagerank with tol on "
        "quantized")
    check(pr_it < GAS_CAP, "quantized pagerank did not reach its tol")
    _, pr_wit = counted(lambda: sess.run(
        "pagerank", iters=GAS_CAP, tol=PR_TOL, exchange="quantized",
        init_values=pr, return_iters=True), lambda out: out[1],
        "warm pagerank on quantized")
    log(f"[exchange] pagerank to tol {PR_TOL} on quantized: {pr_it} "
        f"iterations (halo {gas['iters']['pagerank_tol']}), warm from its "
        f"vector {pr_wit} (halo {gas['iters']['pagerank_warm']}; the lane "
        "references restart from zero)")

    launches = {n: c for n, c in ops.launch_counts().items() if c}
    check_path_launches(ops, launches, "gas")
    check(launches.get("ell_spmv", 0) == k3_total, f"K3 launched "
          f"{launches.get('ell_spmv', 0)} times in the phase, the runs "
          f"account for {k3_total}")
    peak = torch.cuda.max_memory_allocated()
    phase_s = time.perf_counter() - t_phase
    for ex in new:
        lay.cache.pop((dkey, ex))
    torch.cuda.empty_cache()
    log(f"[exchange] K3 launches in the phase {k3_total}; phase "
        f"{phase_s:.1f} s; peak device memory {peak / 2**30:.2f} GiB "
        f"({resident / 2**30:.3f} resident before it)")
    return dict(k3=k3_total, ms_iter={f"{n}/{e}": v
                                      for (n, e), v in ms_iter.items()},
                overlap_ms_iter={f"{n}/{e}": v for (n, e), v in over.items()},
                fused={f"{n}/{e}": v for (n, e), v in fused_ms.items()},
                lanes=lanes, peak_gib=peak / 2**30, phase_s=phase_s)


def graph_serve_phase(torch, ops, sess, g, t_row, event=None) -> dict:
    """Graph serving on the resident scale-20 session: the launcher's
    query mix before ingestion (replies against direct runs), three
    windows of live arrivals (each flush assigned on T from the resident
    loads; restreams past the RF watermark), the grown graph queried, the
    mix cold and warm to a tolerance, all with the launch counts zeroed
    before and read after: T once a flush plus ``SERVE_PASSES`` a restream,
    K3 once an iteration of every pagerank run, no other kernel.  Then T
    from seeded loads against its plain walk and the tiered emulation on
    the first flush's inputs, and the kill/resume check at scale 16 in a
    child process.  Adds the seeded walk to T's row (``t_row``)."""
    import argparse
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core.stages import stream_state
    from repro_torch.core.transform import host_exact_cap, majority_vertex_map
    from repro_torch.launch import serve_graph as sg
    from repro_torch.serve import GraphServer
    event = event or event_ms
    cfg = sess.cfg.clugp
    dev = sess.device
    args = argparse.Namespace(
        device=str(dev), scale=SCALE, k=K, exchange="halo", backend="torch",
        iters=SERVE_ITERS, tol=None, seed=0, queries=SERVE_QUERIES,
        max_batch=SERVE_BATCH, window=SERVE_WINDOW,
        ingest_windows=SERVE_WINDOWS, watermark=SERVE_WATERMARK,
        restream_passes=SERVE_PASSES, ckpt_dir=None)
    args_tol = argparse.Namespace(**{**vars(args), "tol": SERVE_TOL,
                                     "iters": SERVE_CAP})
    src0, dst0 = sess.edges
    assign0, E0, V = sess.assign, len(sess.edges[0]), sess.num_vertices

    # every K3 launch the phase should make: one an iteration of each run
    # that holds pagerank, the server's and the checks' direct runs alike
    k3_expected = 0
    inner = sess.run_many

    def counting_run_many(progs, **kw):
        nonlocal k3_expected
        want_iters = kw.pop("return_iters", False)
        outs, iters_run = inner(progs, return_iters=True, **kw)
        names = [p if isinstance(p, str) else p.name for p in progs]
        k3_expected += iters_run * sum(n in GAS_K3 for n in names)
        return (outs, iters_run) if want_iters else outs

    sess.run_many = counting_run_many
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = GraphServer(sess, max_batch=SERVE_BATCH, window=SERVE_WINDOW,
                      rf_watermark=SERVE_WATERMARK,
                      restream_passes=SERVE_PASSES, iters=SERVE_ITERS)
    ops.reset_launch_counts()
    t_phase = time.perf_counter()
    try:
        tickets = sg.submit_mix(srv, args, args.seed + 1)
        replies, query_ms = sg.serve_mix(srv, tickets)
        sg.check_replies(srv, tickets, replies, sg.direct_run(sess, args),
                         None)
        log(f"[graph-serve] before ingestion: {len(tickets)} queries in "
            f"{srv.stats['microbatches']} microbatches, {query_ms:.3f} "
            f"ms/query ({SERVE_ITERS} iterations); integer, owner and "
            f"neighbors replies equal the direct runs and the tables, "
            f"pagerank within rtol {sg.REPLY_RTOL}")
        ing = sg.drive_ingest(srv, args)
        check(ing["restreams"] >= 1, f"no restream fired: {srv.rf_trace}")
        check(ing["rf_post_restream"] <= ing["rf_drifted"],
              f"restream left RF above the drift: {ing}")
        for swap in srv.swap_log:
            check(swap["max_load"] <= cfg.tau * swap["edges"] / K + 1,
                  f"balance cap broken after a {swap['event']}: {swap}")
        t = time.perf_counter()
        tk = srv.submit("score", program="pagerank", vertices=[0])
        srv.step()
        check(srv.result(tk).error is None, "the grown graph does not serve")
        torch.cuda.synchronize()
        grown_s = time.perf_counter() - t
        srv.tol, srv.iters = SERVE_TOL, SERVE_CAP
        with round_split(torch) as split:
            cold, warm = sg.drive_warm_cold(srv, args_tol, check=True)
        torch.cuda.synchronize()
    finally:
        del sess.run_many
    phase_s = time.perf_counter() - t_phase
    launches = {n: c for n, c in ops.launch_counts().items() if c}
    peak = torch.cuda.max_memory_allocated() / 2**30
    windows = srv.stats["windows"]
    t_want = windows + SERVE_PASSES * srv.stats["restreams"]
    log(f"[graph-serve] launches {json.dumps(launches)}")
    check(windows == SERVE_WINDOWS, f"{windows} windows flushed")
    check(set(launches) <= {"transform_scan", "ell_spmv"},
          f"the serving path launched another kernel: {launches}")
    check(launches.get("transform_scan", 0) == t_want,
          f"T launched {launches.get('transform_scan', 0)} times, not once a "
          f"flush plus {SERVE_PASSES} a restream ({t_want})")
    check(launches.get("ell_spmv", 0) == k3_expected,
          f"K3 launched {launches.get('ell_spmv', 0)} times, not once an "
          f"iteration of every pagerank run ({k3_expected})")
    for swap in srv.swap_log:
        log(f"[graph-serve] {swap['event']}: assign {swap['assign']:.4f} s "
            f"(T + prior + state on the card), RF and balance "
            f"{swap['stats']:.4f} s (host), layout rebuild "
            f"{swap['layout']:.4f} s; {swap['edges']} edges, largest load "
            f"{swap['max_load']} <= {cfg.tau * swap['edges'] / K + 1:.1f}"
            + (f"; RF before each pass {swap['trace']}" if "trace" in swap
               else ""))
    log(f"[graph-serve] RF trace {json.dumps(srv.rf_trace)}; "
        f"{srv.stats['restreams']} restreams of {SERVE_PASSES} passes; drift "
        f"{ing['rf_drifted']:.4f} repaired to {ing['rf_post_restream']:.4f}")
    log(f"[graph-serve] the grown graph ({len(sess.edges[0])} edges) served "
        f"its first query in {grown_s:.3f} s (device tables built)")
    log(f"[graph-serve] after ingestion, tol {SERVE_TOL} (cap {SERVE_CAP}): "
        f"cold {cold['iters_run']} iterations {cold['query_ms']:.3f} "
        f"ms/query, warm {warm['iters_run']} iterations {warm['query_ms']:.3f}"
        f" ms/query (per cell: cold {json.dumps(cold['cells'])}, warm "
        f"{json.dumps(warm['cells'])}); replies within L1 {sg.REPLY_L1} of "
        "direct runs")
    for name, row in split.items():
        log(f"[graph-serve] {name} round split, ms: seed tables "
            f"{row['seeds']:.3f} (host cast, upload, gather), device loop "
            f"{row['loop']:.3f}, collection {row['collect']:.3f}, the rest "
            f"{row['round'] - row['seeds'] - row['loop'] - row['collect']:.3f}"
            f" (round {row['round']:.3f})")
    log(f"[graph-serve] phase {phase_s:.1f} s; peak device memory "
        f"{peak:.2f} GiB")

    # T from seeded loads on the first flush's inputs: the window, the
    # resident partition's loads and prior, and the grown cap; then the
    # same window under the resident cap, where the partitions at the
    # balance start full
    chunks = sg.arrival_chunks(args.seed, V, SERVE_WINDOW)
    first = [next(chunks) for _ in range(4)]
    ws = torch.from_numpy(np.concatenate([c[0] for c in first])).to(dev)
    wd = torch.from_numpy(np.concatenate([c[1] for c in first])).to(dev)
    s0 = torch.from_numpy(src0.astype(np.int32)).to(dev)
    d0 = torch.from_numpy(dst0.astype(np.int32)).to(dev)
    a0 = torch.from_numpy(assign0.astype(np.int32)).to(dev)
    st = stream_state(s0, d0, a0, V, K, device=dev)
    prior = majority_vertex_map(s0, d0, a0, V, K)
    loads0 = torch.bincount(a0.long(), minlength=K)
    pu, pv, nm = ops.transform_inputs(ws.long(), wd.long(), prior, st.deg,
                                      st.divided)
    W = int(pu.shape[0])
    seeded = {}
    for name, cap in (("grown cap", cfg.tau * (E0 + W) / K),
                      ("resident cap", cfg.tau * E0 / K)):
        hcap = host_exact_cap(cap)
        got, tiers = ops.transform_scan_tiers(pu, pv, nm, K, hcap, loads0)
        t = time.perf_counter()
        exp = ops.transform_scan_plain(pu, pv, nm, K, hcap, loads0)
        plain = (time.perf_counter() - t) * 1e3
        emu, emu_tiers = ops.transform_scan_tiered_plain(pu, pv, nm, K, hcap,
                                                         loads0)
        err = int((got.long() - exp.long()).abs().max())
        check(err == 0, f"seeded T differs from its plain walk ({name})")
        check(torch.equal(got, emu), f"seeded T differs from the tiered "
              f"emulation ({name})")
        check(tiers == emu_tiers, f"seeded T's tiers {tiers} differ from the "
              f"emulation's {emu_tiers} ({name})")
        ms = event(torch, lambda hcap=hcap: ops.transform_scan(
            pu, pv, nm, K, hcap, loads0), 5, warmup=1)
        full0 = int((loads0.double() >= cap).sum())
        fills = int(((loads0 + torch.bincount(got.long(), minlength=K))
                     .double() >= cap).sum()) - full0
        seeded[name] = dict(ms=ms, plain_ms=plain, tiers=tiers, err=err,
                            cap=cap, start_full=full0, filled=fills)
        log(f"[T-seeded] {name} {cap:.4f} (compared as {hcap:.0f}), window "
            f"{W}: bit-identical to the plain walk and the tiered emulation; "
            f"{full0} of {K} partitions full at the start, {fills} filled in "
            f"the window; tiers {json.dumps(tiers)}; {ms:.3f} ms/launch, "
            f"plain loop {plain:.0f} ms")
    g_row = seeded["grown cap"]
    nbytes, nops = W * 16 + K * 4, T_OPS_PER_EDGE * W
    bms, by = bound_ms(nbytes, nops)
    t_row.update(seeded_ms=g_row["ms"], seeded_plain_ms=g_row["plain_ms"],
                 seeded_bound_ms=bms, seeded_bound_by=by,
                 seeded_launches=launches.get("transform_scan", 0),
                 seeded_max_abs_err=g_row["err"], seeded_tiers=g_row["tiers"],
                 seeded_resident_cap=seeded["resident cap"])
    del s0, d0, a0, st, prior, pu, pv, nm, ws, wd

    # kill and resume at scale 16: the launcher's child SIGKILLs itself
    # after its snapshot; the resumed server against a freshly built one
    ck = Path(tempfile.mkdtemp(prefix="serve_ckpt_", dir=ROOT / "build"))
    try:
        args16 = argparse.Namespace(**{**vars(args), "scale": RESUME_SCALE,
                                       "window": 2048,
                                       "ckpt_dir": str(ck)})
        t = time.perf_counter()
        resumed = sg.kill_resume_check(args16)     # raises unless SIGKILL
        log(f"[graph-serve] kill/resume at scale {RESUME_SCALE}, k {K}: the "
            f"child died by SIGKILL (exit {resumed['child_returncode']}); the "
            f"resumed server has the identical config blob and assignment "
            f"and its replies agree with a freshly built server's "
            f"({time.perf_counter() - t:.1f} s)")
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    return dict(query_ms=query_ms, swaps=srv.swap_log, rf_trace=srv.rf_trace,
                cold=cold, warm=warm, split=split, peak_gib=peak,
                launches=launches, seeded=seeded, phase_s=phase_s)


@contextlib.contextmanager
def round_split(torch):
    """Inside, the launcher's cold and warm rounds (its first two
    ``serve_mix`` calls) are split, synchronized, into the engine's seed
    tables, device loop and collection to the host: yields
    {"cold"|"warm": {"seeds", "loop", "collect", "round"} in ms}."""
    from repro_torch.graph import engine as eng
    from repro_torch.launch import serve_graph as sg
    split, label, order = {}, [], iter(("cold", "warm"))

    def timed(fn, part):
        def wrapped(*a, **kw):
            if not label:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            split[label[0]][part] += (time.perf_counter() - t) * 1e3
            return out
        return wrapped

    def serve_mix(srv, tickets):
        label[:] = [next(order)]
        split[label[0]] = dict(seeds=0.0, loop=0.0, collect=0.0, round=0.0)
        try:
            return timed(orig["serve_mix"], "round")(srv, tickets)
        finally:
            label.clear()

    orig = {"serve_mix": sg.serve_mix}
    parts = {"_warm_tables_many": "seeds", "_sim_gas_many": "loop",
             "collect_master_values": "collect"}
    for name, part in parts.items():
        orig[name] = getattr(eng, name)
        setattr(eng, name, timed(orig[name], part))
    sg.serve_mix = serve_mix
    try:
        yield split
    finally:
        sg.serve_mix = orig.pop("serve_mix")
        for name, fn in orig.items():
            setattr(eng, name, fn)


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
    from repro_torch.core.clustering import (localize_stream,
                                             streaming_clustering)
    from repro_torch.core.game import cluster_csr
    from repro_torch.core.partitioner import partition
    from repro_torch.core.stages import (cluster_graph_arrays,
                                         lambda_from_totals)
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
    check_path_launches(ops, launches, "graph")
    check(launches.get("game_bestresponse", 0) == 0,
          "the game launched the dense K2 (it runs the CSR form)")
    passes = 1 + sess.stats["cap_retries"]    # one clustering pass a try
    check(launches["cluster_scatter"] == passes,
          f"K1 launched {launches['cluster_scatter']} times for {passes} "
          "clustering passes, not once per pass")
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
    gas = gas_phase(torch, ops, sess, g)
    exch = exchange_phase(torch, ops, sess, g, gas)
    del gas["halo"], gas["cc40"], gas["refs"]

    # ---------------------------------------------------------- phase 4
    rows = []
    vmax = max(2.0, E / float(K))
    src_t = torch.from_numpy(g.src).to(dev)
    dst_t = torch.from_numpy(g.dst).to(dev)

    # K1: the pass over the scale-20 stream (one launch), held against its
    # plain version on the first PASS_PREFIX blocks, timed over the whole
    # stream
    ints, uvg = localize_stream(src_t, dst_t, V)
    nb, B = ints.shape[0], ints.shape[1]
    cap = st["id_cap"]

    def fresh_state():
        return (torch.full((V + 1,), -1, dtype=torch.int32, device=dev),
                torch.zeros(V + 1, dtype=torch.int32, device=dev),
                torch.zeros(cap, dtype=torch.int32, device=dev),
                torch.zeros(4, dtype=torch.int32, device=dev))

    def run_pass(fn, n, state):
        return fn(ints[:n], uvg[:n], *state, vmax,
                  split_degree_factor=cfg.split_degree_factor)
    pre = min(PASS_PREFIX, nb)
    got_state, exp_state = fresh_state(), fresh_state()
    got = (*got_state, run_pass(ops.cluster_pass, pre, got_state))
    torch.cuda.synchronize()
    t = time.perf_counter()
    exp = (*exp_state, run_pass(ops.cluster_pass_plain, pre, exp_state))
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t) * 1e3
    err = 0
    for name, a, b_ in zip(("clu", "deg", "vol", "scal", "packed"), got, exp):
        d = int((a.long() - b_.long()).abs().max())
        check(d == 0, f"K1 pass differs from its plain version in {name} "
              f"(max |d| {d}) on the first {pre} blocks")
        err = max(err, d)
    prefix_ms = event_ms(torch, lambda: run_pass(ops.cluster_pass, pre,
                                                 fresh_state()), 3, warmup=1)
    runs = []
    for _ in range(2):               # the whole stream, from fresh state
        state = fresh_state()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_pass(ops.cluster_pass, nb, state)
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    ms = sum(runs) / len(runs)
    live = int(ints[..., 2].sum())
    # each input read once, each output written once: the localized rows
    # and slots, clu/deg (V + 1) and vol (cap) read and written, scal,
    # packed
    nbytes = 4 * (ints.numel() + uvg.numel() + 4 * (V + 1) + 2 * cap + 8
                  + nb * B)
    bms, by = bound_ms(nbytes, K1_OPS_PER_EDGE * live)
    lat = latency_ms(live, K1_STEPS_PER_EDGE, sm_hz)
    rows.append(dict(name="cluster_scatter", route="cuda",
                     source="src/repro_torch/csrc/cluster_scatter.cu",
                     replaces="src/repro/kernels/cluster_scatter.py:188",
                     launches=launches["cluster_scatter"], max_abs_err=err,
                     ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                     library_ms=None, latency_bound_ms=lat,
                     limited_by="latency", blocks=nb, plain_blocks=pre,
                     prefix_ms=prefix_ms))
    log(f"[K1] pass over {nb} blocks ({live} live edges): {ms:.3f} ms "
        f"(runs {', '.join(f'{r:.3f}' for r in runs)}) = "
        f"{ms * 1e3 / nb:.3f} us/block; bit-identical to the plain pass on "
        f"the first {pre} blocks (kernel {prefix_ms:.3f} ms, plain "
        f"{plain:.1f} ms); bound {bms:.5f} ms ({by}), latency floor "
        f"{lat:.3f} ms ({live} live edges x {K1_STEPS_PER_EDGE} x "
        f"{SMEM_STEP_CYCLES} cycles)")
    del ints, uvg, got, exp, got_state, exp_state

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
    def dense():
        return ops.game_bestresponse(aff, sizes, row_tot, cur, loads,
                                     lam=lam, k=K)
    ms = device_ms(torch, dense, 50, "game_bestresponse_kernel")
    launch_ms = event_ms(torch, dense, 50)
    plain = event_ms(torch, lambda: ops.game_bestresponse_plain(
        aff, sizes, row_tot, cur, loads, lam=lam, k=K), 10)
    nbytes = M * K * 4 + M * 12 + K * 4 + 4 + M * 8
    bms, by = bound_ms(nbytes, K2_OPS_PER_LANE * M * K)
    rows.append(dict(name="game_bestresponse", route="cuda",
                     source="src/repro_torch/csrc/game_bestresponse.cu",
                     replaces="src/repro/kernels/game_bestresponse.py:52",
                     launches=launches.get("game_bestresponse", 0),
                     max_abs_err=k2_err, ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None,
                     limited_by="bytes", launch_ms=launch_ms))
    log(f"[K2] M={M} k={K}: {int(differ.sum())} best flips (all "
        f"near-ties), cost max |d| {k2_err:.3e}; {ms:.4f} ms/launch on the "
        f"device ({launch_ms:.4f} ms a call back to back)")
    del aff

    # the fused K2 on every live batch of the run's game: its cluster CSR,
    # final assignment and the loads that assignment gives
    clus = sess.result.clustering
    gstate = cluster_graph_arrays(src_t, dst_t,
                                  torch.from_numpy(clus.clu).to(dev), M,
                                  cfg.effective_sizes)
    real = (gstate.xs < M) & (gstate.xd < M)
    rowptr, col = cluster_csr(gstate.xs[real].long(), gstate.xd[real].long(),
                              M)
    n_cross = int(real.sum())
    m = st["num_clusters"]
    g_assign = torch.zeros(M, dtype=torch.int32, device=dev)
    g_assign[:m] = torch.from_numpy(sess.result.cluster_assign).to(dev)
    g_loads = torch.zeros(K, device=dev).index_add_(0, g_assign.long(),
                                                    gstate.sizes)
    g_lam = lambda_from_totals(gstate.sizes.sum(), gstate.n_cross, K,
                               cfg.relative_weight).reshape(1)
    bs = cfg.batch_size
    batches = [(r0, min(r0 + bs, M)) for r0 in range(0, m, bs)]
    n_batches = -(-M // bs)
    csr_err = 0.0
    for r0, r1 in batches:
        got = ops.game_bestresponse_csr(rowptr, col, g_assign, gstate.sizes,
                                        gstate.row_tot, g_loads, lam=g_lam,
                                        k=K, row0=r0, row1=r1)
        exp = ops.game_bestresponse_csr_plain(
            rowptr, col, g_assign, gstate.sizes, gstate.row_tot, g_loads,
            lam=g_lam, k=K, row0=r0, row1=r1)
        for name, a_, b_ in zip(("best", "cost", "cost_cur"), got, exp):
            check(torch.equal(a_, b_), f"fused K2 differs from its plain "
                  f"version in {name} on rows {r0}..{r1}")
            csr_err = max(csr_err, float((a_.double() - b_.double())
                                         .abs().max()))

    def all_batches(fn):
        return lambda: [fn(rowptr, col, g_assign, gstate.sizes,
                           gstate.row_tot, g_loads, lam=g_lam, k=K, row0=r0,
                           row1=r1) for r0, r1 in batches]
    ms = device_ms(torch, all_batches(ops.game_bestresponse_csr), 20,
                   "game_bestresponse_csr_kernel")
    launch_ms = event_ms(torch, all_batches(ops.game_bestresponse_csr), 20) \
        / len(batches)
    per_batch = [device_ms(torch, lambda r0=r0, r1=r1: ops.game_bestresponse_csr(
        rowptr, col, g_assign, gstate.sizes, gstate.row_tot, g_loads,
        lam=g_lam, k=K, row0=r0, row1=r1), 10, "game_bestresponse_csr_kernel")
        for r0, r1 in batches]
    row_len = (rowptr[1:] - rowptr[:-1]).long()
    longest = int(row_len.max())
    log(f"[K2-CSR] ms per live batch {[round(x, 4) for x in per_batch]}; "
        f"longest row {longest} entries (row {int(row_len.argmax())}), "
        f"rows over 4,096 entries: {int((row_len > 4096).sum())}")
    plain = event_ms(torch, all_batches(ops.game_bestresponse_csr_plain), 3,
                     warmup=1) / len(batches)
    rp = rowptr.long()
    entries = int(rp[batches[-1][1]] - rp[0])      # every live row's entries
    rows_live = batches[-1][1]
    # per launch: the CSR entries and one assign gather each, each row's
    # rowptr pair, size, row total and own assign, three outputs, the loads
    nbytes = (8 * entries + 4 * (rows_live + len(batches)) + 12 * rows_live
              + 12 * rows_live + (4 * K + 4) * len(batches)) / len(batches)
    nops = (K2_OPS_PER_ENTRY * entries + K2_OPS_PER_LANE * rows_live * K) \
        / len(batches)
    bms, by = bound_ms(nbytes, nops)
    rows.append(dict(name="game_bestresponse_csr", route="cuda",
                     source="src/repro_torch/csrc/game_bestresponse_csr.cu",
                     replaces="src/repro/kernels/game_bestresponse.py:52",
                     launches=launches["game_bestresponse_csr"],
                     max_abs_err=csr_err, ms=ms, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=None,
                     launch_ms=launch_ms, live_batches=len(batches),
                     batches=n_batches, n_cross=n_cross,
                     batch_ms=per_batch))
    log(f"[K2-CSR] {len(batches)} of {n_batches} batches hold a live row "
        f"({m} clusters, m_cap {M}); n_cross {n_cross} ({2 * n_cross} CSR "
        f"entries, {entries} in the live rows); bit-identical on best, cost "
        f"and cost_cur; {ms:.4f} ms/launch on the device (mean over the live "
        f"batches; {launch_ms:.4f} ms a call back to back), plain "
        f"{plain:.3f} ms; bound {bms:.5f} ms ({by}) = "
        f"{bms / ms:.1%}; the game's {launches['game_bestresponse_csr']} "
        f"launches x {ms:.4f} ms = "
        f"{launches['game_bestresponse_csr'] * ms / 1e3:.3f} s")
    del gstate, rowptr, col, rp

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
    ms = device_ms(torch, lambda: ops.ell_spmv(ell.vals, ell.cols, x), 50,
                   "ell_spmv_kernel")
    launch_ms = event_ms(torch, lambda: ops.ell_spmv(ell.vals, ell.cols, x),
                         50)
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
                     library_ms=lib, limited_by="bytes", launch_ms=launch_ms,
                     gas_launches=gas["k3"], exchange_launches=exch["k3"]))
    log(f"[K3] R={R} W={W} N={N}: max |d| {k3_err:.3e}; {ms:.4f} ms/launch "
        f"on the device ({launch_ms:.4f} ms a call back to back), "
        f"torch.sparse.mm {lib:.4f} ms")

    # T on the main path's two walks: the first pass's inputs (the game's
    # cluster partitions as the prior) and the restream pass's (the first
    # pass's majority map); its time depends on the data through the tiers
    lmax = cfg.tau * E / K
    deg_t = torch.from_numpy(clus.deg).to(dev)
    div_t = torch.from_numpy(clus.divided).to(dev)
    ca = torch.from_numpy(sess.result.cluster_assign).to(dev)
    priors = {
        "first": ca[torch.from_numpy(clus.clu).to(dev).clamp(0, m - 1).long()],
        "restream": majority_vertex_map(
            src_t, dst_t, torch.from_numpy(sess.assign).to(dev), V, K)}
    t_rows = {}
    for name, vp in priors.items():
        pu, pv, nm = ops.transform_inputs(src_t.long(), dst_t.long(), vp,
                                          deg_t, div_t)
        got, tiers = ops.transform_scan_tiers(pu, pv, nm, K, lmax)
        t = time.perf_counter()
        exp = ops.transform_scan_plain(pu, pv, nm, K, lmax)
        plain = (time.perf_counter() - t) * 1e3
        t_err = int((got.long() - exp.long()).abs().max())
        check(t_err == 0, f"T differs from its plain version ({name} pass)")
        t = time.perf_counter()
        emu, emu_tiers = ops.transform_scan_tiered_plain(pu, pv, nm, K, lmax)
        emu_s = time.perf_counter() - t
        check(torch.equal(got, emu), f"T differs from the tiered emulation "
              f"({name} pass)")
        check(tiers == emu_tiers, f"T's tier counts {tiers} differ from the "
              f"emulation's {emu_tiers} ({name} pass)")
        ms = event_ms(torch, lambda: ops.transform_scan(pu, pv, nm, K, lmax),
                      5, warmup=1)
        steps = (tiers["frozen_edges"] + tiers["exact_edges"]) \
            / T_WALK_STEP + tiers["both_edges"]
        lat = latency_ms(steps, 1, sm_hz)
        t_rows[name] = dict(ms=ms, plain=plain, tiers=tiers, lat=lat,
                            real=int((nm >= 0).sum()), err=t_err)
        log(f"[T] {name} pass, E={E}: bit-identical to the plain walk and the "
            f"tiered emulation ({emu_s:.1f} s); tiers {json.dumps(tiers)}; "
            f"{ms:.3f} ms/launch (the one-thread walk: {T_ONE_THREAD_MS} ms, "
            f"{T_ONE_THREAD_MS / ms:.1f}x), plain loop {plain:.0f} ms; latency "
            f"floor {lat:.3f} ms ({steps:.0f} dependent steps x "
            f"{SMEM_STEP_CYCLES} cycles)")
        del pu, pv, nm, got, exp, emu
    ms = sum(r["ms"] for r in t_rows.values()) / len(t_rows)
    real = sum(r["real"] for r in t_rows.values()) / len(t_rows)
    bms, by = bound_ms(E * 16, T_OPS_PER_EDGE * real)
    lat = sum(r["lat"] for r in t_rows.values()) / len(t_rows)
    rows.append(dict(name="transform_scan", route="cuda",
                     source="src/repro_torch/csrc/transform_scan.cu",
                     replaces="src/repro/core/transform.py:93",
                     launches=launches["transform_scan"],
                     max_abs_err=max(r["err"] for r in t_rows.values()),
                     ms=ms, plain_ms=sum(r["plain"] for r in t_rows.values())
                     / len(t_rows), bound_ms=bms, bound_by=by,
                     library_ms=None, latency_bound_ms=lat,
                     limited_by="latency",
                     passes={n: dict(ms=r["ms"], tiers=r["tiers"])
                             for n, r in t_rows.items()}))
    log(f"[T] mean over the path's two walks {ms:.3f} ms/launch; bound "
        f"{bms:.4f} ms ({by}) plus the walks' dependent steps {lat:.3f} ms")

    # the wires' device activities an iteration, profiled after the
    # kernel timings above
    per_iter = exchange_activities(torch, sess)
    log("[exchange] device activities an iteration (profiler): " + "; ".join(
        f"{n} on {e} " + ("not measured" if c is None else f"{c:.1f}")
        for (n, e), c in per_iter.items()))

    # ---------------------------------------------------------- phase 4b
    # the serving phase swaps the session's layout: drop what phase 4 held
    # of the old one first
    del lay, ell, x, y, yp, csr, crow, r_idx, c_idx, order, xs, real
    del src_t, dst_t, deg_t, div_t, ca, priors, clus
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated()
    graph_serve_phase(torch, ops, sess, g, rows[-1])
    # the grown session goes with its layout and device tables, so the
    # LM phases' peaks hold no graph state (the resident memory it held
    # is logged here)
    grown = torch.cuda.memory_allocated()
    del sess
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[graph-serve] resident device memory: {resident / 2**30:.3f} GiB "
        f"before the phase, {grown / 2**30:.3f} after it, "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} with the session "
        "dropped")

    # ---------------------------------------------------------- phase 5
    gs = web_graph(scale=SMALL_SCALE, edge_factor=EDGE_FACTOR, seed=0)
    ss = torch.from_numpy(gs.src).to(dev)
    sd = torch.from_numpy(gs.dst).to(dev)
    vs = max(2.0, gs.num_edges / float(K))
    t_kernel = host_ms(torch, lambda: streaming_clustering(
        ss, sd, gs.num_vertices, vs, kernel="cuda")) / 1e3
    a = streaming_clustering(ss, sd, gs.num_vertices, vs, kernel="cuda")
    t = time.perf_counter()
    b = streaming_clustering(ss, sd, gs.num_vertices, vs, kernel="torch")
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t
    for x_, y_ in zip(a, b):
        check(torch.equal(x_, y_), "scale-16 clustering state differs")
    results = {}
    for game in (False, True):
        for mode in ("cuda", "torch"):
            c = CLUGPConfig.optimized(K, restream=1, game=game, kernel=mode,
                                      cluster_kernel=mode)
            results[game, mode] = partition(gs.src, gs.dst, gs.num_vertices,
                                            c)
        check(np.array_equal(results[game, "cuda"].assign,
                             results[game, "torch"].assign),
              f"scale-16 assignment (game={game}) differs between kernel "
              "and plain")
    on = results[True, "cuda"].stats
    # the same partitions on the CPU (the game's start and damping draws
    # come from a torch.Generator, whose stream is the device's own)
    for game in (False, True):
        c = CLUGPConfig.optimized(K, restream=1, game=game, kernel="torch",
                                  cluster_kernel="torch")
        cpu = partition(gs.src, gs.dst, gs.num_vertices, c, device="cpu")
        log(f"[scale16] game={game} on the CPU: rf {cpu.stats['rf']:.4f} "
            f"against the card's {results[game, 'cuda'].stats['rf']:.4f}; "
            f"{int((cpu.assign != results[game, 'cuda'].assign).sum())} of "
            f"{gs.num_edges} edges assigned elsewhere")
    log(f"[scale16] V={gs.num_vertices} E={gs.num_edges}: clustering state, "
        f"game-off and game-on assignments bit-identical (clustering "
        f"{t_kernel:.2f} s kernel, {t_plain:.2f} s plain; game-off rf "
        f"{results[False, 'cuda'].stats['rf']:.4f}; game-on rf "
        f"{on['rf']:.4f}, {on['game_rounds']} rounds, game "
        f"{on['stage_seconds']['game']:.3f} s on the CSR kernel, "
        f"{results[True, 'torch'].stats['stage_seconds']['game']:.3f} s "
        f"dense plain)")

    # ---------------------------------------------------------- phase 6
    import dataclasses
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import (init_params, param_count, prefill,
                                    tree_leaves)
    from repro_torch.train import make_prefill_step

    cfg = get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in tree_leaves(params))
    check(n_params == param_count(cfg), "parameter count differs")
    weight_bytes = sum(x.numel() * x.element_size()
                       for x in tree_leaves(params))
    # a decode step reads every weight but the embedding table (B rows)
    step_bytes = weight_bytes - params["embed"]["table"].numel() * 2
    log(f"[lm] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {n_params} parameters "
        f"({weight_bytes / 1e9:.3f} GB bf16) built in "
        f"{time.perf_counter() - t:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    lm_rng = np.random.default_rng(0)
    tokens = torch.from_numpy(lm_rng.integers(
        0, cfg.vocab, (PREFILL_B, PREFILL_S))).to(dev)
    prefill_step = make_prefill_step(cfg, dtype=torch.bfloat16)
    prefill_step(params, {"tokens": tokens})        # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    logits = prefill_step(params, {"tokens": tokens})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t
    lm_launches = ops.launch_counts()
    log(f"[prefill] launches {json.dumps(lm_launches)}")
    check_path_launches(ops, lm_launches, "lm")
    check(lm_launches["flash_attention"] == cfg.n_layers,
          f"K4 launched {lm_launches['flash_attention']} times, not once "
          "per layer")
    check(logits.shape == (PREFILL_B, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits).all()), "prefill logits")
    log(f"[prefill] B={PREFILL_B} S={PREFILL_S}: {t_prefill * 1e3:.3f} ms, "
        f"{PREFILL_B * PREFILL_S / t_prefill:.1f} tokens/s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    prompt = torch.from_numpy(lm_rng.integers(
        0, cfg.vocab, (SERVE_B, SERVE_PROMPT))).to(dev)
    generate(params, cfg, prompt[:, :2], 2, dtype=torch.bfloat16)  # warm-up
    ops.reset_launch_counts()
    served = generate(params, cfg, prompt, SERVE_TOKENS, dtype=torch.bfloat16)
    check(not any(ops.launch_counts().values()), "decode launched a kernel")
    check(bool(torch.isfinite(served.prompt_logits).all())
          and served.tokens.shape == (SERVE_B, SERVE_TOKENS)
          and int(served.tokens.max()) < cfg.vocab, "decode output")
    ms_step = served.seconds * 1e3 / served.steps
    floor_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[serve] B={SERVE_B}, prompt {SERVE_PROMPT} + {SERVE_TOKENS} tokens: "
        f"{served.steps} steps in {served.seconds:.3f} s = {ms_step:.3f} "
        f"ms/token-step (floor: {step_bytes / 1e9:.3f} GB of weights per "
        f"step at 3.35 TB/s = {floor_ms:.3f} ms); first tokens "
        f"{served.tokens[0][:16].tolist()}")
    del params, logits, served
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 7
    small = dataclasses.replace(cfg, n_layers=CHECK_LAYERS)
    p32 = init_params(small, torch.Generator(device=dev).manual_seed(1))
    prompt = torch.from_numpy(lm_rng.integers(
        0, cfg.vocab, (CHECK_B, CHECK_PROMPT))).to(dev)
    ops.reset_launch_counts()
    pre, _ = prefill(p32, {"tokens": prompt}, small, dtype=torch.float32)
    check(ops.launch_counts().get("flash_attention") == CHECK_LAYERS,
          "the f32 prefill did not run on K4")
    dec = generate(p32, small, prompt, 1, dtype=torch.float32)
    torch.testing.assert_close(dec.prompt_logits, pre[:, -1], rtol=2e-3,
                               atol=2e-3)
    log(f"[check] {CHECK_LAYERS} layers at full width, f32, B={CHECK_B}, "
        f"prompt {CHECK_PROMPT}: prefill (K4) vs decode loop last logits "
        f"max |d| {float((dec.prompt_logits - pre[:, -1]).abs().max()):.3e} "
        f"(tolerance 2e-3)")
    del p32, pre, dec
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- phase 8
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator(device=dev).manual_seed(2)

    def qkv(B, S, dtype):
        return [torch.randn(B, h, S, D, generator=gen, device=dev,
                            dtype=dtype) for h in (Hq, Hkv, Hkv)]

    q, k, v = qkv(PREFILL_B, PREFILL_S, torch.bfloat16)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    k4_err = float((got.float() - want.float()).abs().max())
    ms = event_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True),
                  20)
    plain = event_ms(torch, lambda: ops.flash_attention_plain(
        q, k, v, causal=True), 3, warmup=1)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                              enable_gqa=True)
    torch.testing.assert_close(sdpa().float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    lib = event_ms(torch, sdpa, 20)
    pairs = PREFILL_S * (PREFILL_S + 1) // 2        # unmasked (q, k) pairs
    flops = 4 * D * pairs * PREFILL_B * Hq
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())    # q, o, k, v in bf16
    bms, by = bound_ms(nbytes, flops, BF16_OPS_PER_S)
    rows.append(dict(name="flash_attention", route="cuda",
                     source="src/repro_torch/csrc/flash_attention.cu",
                     replaces="src/repro/kernels/flash_attention.py:70",
                     launches=lm_launches["flash_attention"],
                     max_abs_err=k4_err, ms=ms, plain_ms=plain, bound_ms=bms,
                     bound_by=by, library_ms=lib))
    log(f"[K4] bf16 q {tuple(q.shape)} k/v {tuple(k.shape)} causal: max |d| "
        f"{k4_err:.3e}; {ms:.4f} ms/launch = {flops / ms / 1e9:.1f} "
        f"TFLOP/s; bound {bms:.4f} ms ({by}); plain {plain:.3f} ms; "
        f"scaled_dot_product_attention {lib:.4f} ms; {cfg.n_layers} launches "
        f"= {cfg.n_layers * ms / (t_prefill * 1e3):.1%} of the prefill")
    # the same shape without the causal mask: twice the work, no diagonal
    # tiles and every q tile the same length
    full_ms = event_ms(torch, lambda: ops.flash_attention(q, k, v,
                                                          causal=False), 20)
    full_lib = event_ms(torch, lambda: F.scaled_dot_product_attention(
        q, k, v, enable_gqa=True), 20)
    full_flops = 4 * D * PREFILL_S * PREFILL_S * PREFILL_B * Hq
    log(f"[K4] bf16 same shape, not causal: {full_ms:.4f} ms/launch = "
        f"{full_flops / full_ms / 1e9:.1f} TFLOP/s; "
        f"scaled_dot_product_attention {full_lib:.4f} ms = "
        f"{full_flops / full_lib / 1e9:.1f} TFLOP/s")
    del q, k, v, got, want
    q, k, v = qkv(CHECK_B, F32_S, torch.float32)
    got = ops.flash_attention(q, k, v, causal=True)
    want = ops.flash_attention_plain(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    ms32 = event_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True),
                    20)
    log(f"[K4] f32 q {tuple(q.shape)} k/v {tuple(k.shape)} causal: max |d| "
        f"{float((got - want).abs().max()):.3e}; {ms32:.4f} ms/launch")

    # ---------------------------------------------------------- phase 9
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
