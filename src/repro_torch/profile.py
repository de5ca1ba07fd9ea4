"""Where the port's paths spend their time on the card.

    python -m repro_torch.profile [--scale 20] [--k 64] [--blocks N]
    python -m repro_torch.profile --path gas [--scale 20] [--k 64]
    python -m repro_torch.profile --path lm
    python -m repro_torch.profile --path train

The graph path: partitions ``web_graph(scale)`` once through
``GraphSession`` (not profiled), then runs ``torch.profiler`` (CPU and
CUDA activities) over four windows of the graph path at full size:

- ``cluster``: the clustering pass over the whole stream (or its first
  ``--blocks`` 128-edge blocks): the batched localization, the one K1
  launch that walks every block, and the replica count;
- ``game``: four rounds of the batched best-response game on the run's
  cluster graph: the CSR built once, then one fused K2 launch over each
  batch's rows where the batch holds a live cluster;
- ``transform``: one transform walk (T, its chunks in tiers);
- ``pagerank``: 30 PageRank iterations on the cached device tables.

The GAS path (``--path gas``): the same partition and layout, then two
windows on the halo exchange, each run once before it is profiled (the
device tables and routes are built then):

- ``labelprop``: 40 labelprop iterations (min combine, no kernel);
- ``fused_f32``: 30 iterations of the fused (pagerank, ppr, centrality)
  bundle (three K3 launches an iteration, one exchange per phase).

The LM path (``--path lm``): qwen2-7b at full width and depth in bf16
from a seeded generator, then two windows, each after a warm-up:

- ``prefill``: one ``make_prefill_step`` call on 4 prompts of 2,048
  tokens (K4 once per layer);
- ``decode``: 8 decode steps at batch 4 (positions 16–23 of the cache).

The training path (``--path train``): stablelm-1.6b at full width and
depth, f32 masters, bf16 compute, AdamW (``make_train_step``), one
window:

- ``train_step``: one step of 8 × 2,048 tokens of ``batch_at``'s stream,
  after two warm-up steps (K4 48 launches: forward and remat recompute;
  its backward kernel 24; the chunked CE; AdamW).

Its device time is also summed by kind: K4's kernel, K4's backward
kernel (its three launches), the matrix products (cuBLAS and CUTLASS
kernels) and the rest.

For each window it prints the wall time, the device busy time (the union
of the device-side kernel, copy and fill events, so no work is counted
twice), the device idle share, the host operations with the most self
time and the device kernels with the most time.  Needs a GPU.
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from .core import CLUGPConfig, web_graph
from .core.clustering import streaming_clustering
from .core.game import game_rounds
from .core.stages import cluster_graph_arrays, lambda_from_totals
from .core.transform import majority_vertex_map, transform
from .session import GraphSession, SessionConfig

# the training window's run, which chip_smoke.py's [train] drives too:
# stablelm-1.6b at full width and depth, TRAIN_B × TRAIN_S tokens a step
# of batch_at's stream, AdamW at TRAIN_LR under the cosine schedule of a
# TRAIN_STEPS-step run (warmup TRAIN_STEPS // 10), bf16 compute
TRAIN_ARCH = "stablelm_1_6b"
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 8, 2048, 10, 3e-3


def _device_events(prof):
    """The device-side events (kernels, copies, fills) of a trace; the
    host-side operator that launched each is a separate event."""
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _busy_us(events) -> float:
    """Length of the union of the events' time ranges: the time the
    device ran anything, overlapping work counted once."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def _profile(name: str, fn, top: int = 6, kind=None) -> dict:
    """Profile one call of ``fn``; ``kind(kernel name)`` (optional) sorts
    the device time into named kinds."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    dev_events = _device_events(prof)
    busy = _busy_us(dev_events) * 1e-6
    if busy > wall:
        raise RuntimeError(f"profile {name}: device busy {busy:.6f} s is "
                           f"more than the window's wall time {wall:.6f} s")
    per_kernel = collections.defaultdict(lambda: [0, 0.0])
    for e in dev_events:
        acc = per_kernel[e.name]
        acc[0] += 1
        acc[1] += e.time_range.elapsed_us()
    by_host = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                     reverse=True)[:top]
    by_dev = sorted(per_kernel.items(), key=lambda kv: kv[1][1],
                    reverse=True)[:top]
    out = {
        "window": name, "wall_s": wall, "device_busy_s": busy,
        "device_idle_share": 1.0 - busy / wall,
        "device_events": len(dev_events),
        "top_host": [(e.key, e.count, e.self_cpu_time_total * 1e-3)
                     for e in by_host],
        "top_device": [(k, n, us * 1e-3) for k, (n, us) in by_dev],
    }
    if kind is not None:
        kinds = collections.Counter()
        for k, (_n, us) in per_kernel.items():
            kinds[kind(k)] += us * 1e-3
        out["device_ms_by_kind"] = dict(kinds.most_common())
    print(json.dumps(out), flush=True)
    return out


def _profile_lm(dev) -> None:
    from .configs import get_config
    from .models import init_cache, init_params
    from .train import make_decode_fn, make_prefill_step
    cfg = get_config("qwen2_7b")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         dtype=torch.bfloat16)
    B, S, P, steps = 4, 2048, 16, 8
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (B, S))).to(dev)
    print(json.dumps({"arch": cfg.name, "layers": cfg.n_layers,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    prefill = make_prefill_step(cfg, dtype=torch.bfloat16)
    prefill(params, {"tokens": tokens})                  # warm-up
    _profile("prefill", lambda: prefill(params, {"tokens": tokens}))
    decode = make_decode_fn(cfg, dtype=torch.bfloat16)
    cache = init_cache(cfg, B, P + steps, dtype=torch.bfloat16, device=dev)
    for t in range(P):                                   # warm-up
        decode(params, cache, tokens[:, t:t + 1], t)

    def decode_steps():
        for t in range(P, P + steps):
            decode(params, cache, tokens[:, t:t + 1], t)
    _profile("decode", decode_steps)


def _kernel_kind(name: str) -> str:
    if "bwd_prep_kernel" in name or "bwd_dkdv_kernel" in name \
            or "bwd_dq_kernel" in name:
        return "K4 backward"
    if "flash_" in name:
        return "K4"
    if any(t in name for t in ("gemm", "xmma", "nvjet", "cutlass", "Gemm")):
        return "matrix products"
    return "other"


def _profile_train(dev) -> None:
    from .configs import get_config
    from .data import DataConfig, batch_at
    from .models import init_params
    from .train import adamw, cosine_schedule, make_train_step
    cfg = get_config(TRAIN_ARCH)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt = adamw(schedule=cosine_schedule(TRAIN_LR, TRAIN_STEPS // 10,
                                         TRAIN_STEPS))
    state = opt.init(params)
    step = make_train_step(cfg, opt, dtype=torch.bfloat16)
    dcfg = DataConfig(cfg.vocab, TRAIN_S, TRAIN_B, seed=0)
    batches = [{k: torch.from_numpy(v).to(dev)
                for k, v in batch_at(dcfg, i).items()} for i in range(3)]
    print(json.dumps({"arch": cfg.name, "layers": cfg.n_layers,
                      "tokens_a_step": TRAIN_B * TRAIN_S,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    for i in range(2):                                   # warm-up
        params, state, _ = step(params, state, batches[i], i)

    def one_step():
        step(params, state, batches[2], 2)
    _profile("train_step", one_step, top=12, kind=_kernel_kind)


def _profile_gas(sess, g) -> None:
    bundle = ("pagerank", "ppr", "centrality")
    sess.run("labelprop", iters=40)                      # warm-up
    sess.run_many(bundle, iters=30)
    print(json.dumps({"V": g.num_vertices, "E": g.num_edges,
                      "k": sess.k, "exchange": sess.cfg.exchange,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    _profile("labelprop", lambda: sess.run("labelprop", iters=40))
    _profile("fused_f32", lambda: sess.run_many(bundle, iters=30))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("graph", "gas", "lm", "train"),
                    default="graph")
    ap.add_argument("--scale", type=int, default=20)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--blocks", type=int, default=0,
                    help="cluster window: the first N blocks (0: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("repro_torch.profile needs a CUDA device")
    dev = torch.device("cuda")
    if args.path == "lm":
        _profile_lm(dev)
        return 0
    if args.path == "train":
        _profile_train(dev)
        return 0
    g = web_graph(scale=args.scale, edge_factor=8, seed=0)
    cfg = CLUGPConfig.optimized(args.k, restream=1)
    sess = GraphSession(SessionConfig(clugp=cfg, iters=30))
    sess.partition(g.src, g.dst, g.num_vertices).layout()
    sess.run("pagerank")                       # builds the device tables
    if args.path == "gas":
        _profile_gas(sess, g)
        return 0
    st = sess.stats
    src = torch.from_numpy(g.src).to(dev)
    dst = torch.from_numpy(g.dst).to(dev)
    E, V = g.num_edges, g.num_vertices
    n = min(E, args.blocks * 128) if args.blocks > 0 else E
    vmax = max(2.0, E / float(args.k))
    print(json.dumps({"scale": args.scale, "V": V, "E": E, "k": args.k,
                      "device": torch.cuda.get_device_name(0),
                      "stage_seconds": st["stage_seconds"]}), flush=True)

    _profile("cluster", lambda: streaming_clustering(
        src[:n], dst[:n], V, vmax, id_cap=st["id_cap"]))
    clus = sess.result.clustering
    compact = torch.from_numpy(clus.clu).to(dev)
    gstate = cluster_graph_arrays(src, dst, compact, st["m_cap"],
                                  cfg.effective_sizes)
    lam = lambda_from_totals(gstate.sizes.sum(), gstate.n_cross, args.k,
                             None)
    _profile("game", lambda: game_rounds(
        gstate.xs, gstate.xd, gstate.sizes, gstate.row_tot, args.k, lam,
        batch_size=cfg.batch_size, max_rounds=4, seed=0))
    vp = majority_vertex_map(src, dst, torch.from_numpy(sess.assign).to(dev),
                             V, args.k)
    deg = torch.from_numpy(clus.deg).to(dev)
    div = torch.from_numpy(clus.divided).to(dev)
    _profile("transform", lambda: transform(src, dst, vp, deg, div, args.k,
                                            cfg.tau))
    _profile("pagerank", lambda: sess.run("pagerank"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
