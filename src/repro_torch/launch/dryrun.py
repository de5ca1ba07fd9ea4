"""The dry-run: every (arch × shape × mesh) LM cell run as one rank on the
meta device, and every (program × wire) graph cell's wire bytes, counted
on ranks and held to the layout's byte model.

Port of ``repro.launch.dryrun``.  The reference lowers and compiles each
cell against stand-ins of its inputs and reads its memory, cost and
collective bytes out of the compiler; the port compiles nothing, so it
finds answers of its own that real ranks can check.

**The LM cells** (``--arch``, ``--shape``, ``--mesh``, ``--all``,
``--probe``, ``--rules``, ``--compress-grads``): ``run_cell`` builds rank
(0, 0)'s program of the cell on the production mesh
(``make_production_mesh``, (16, 16) over ("data", "model")), under the
reference's rule table, and runs it once on the meta device inside
``collectives.dry`` (no process group; nothing allocated).  ``build_cell``
is the reference's: train cells the ZeRO-3 step (f32 masters,
``zero_default``, ``optimizer_default``), serving cells bf16 weights (the
reference's ``abstract_params(dtype=bf16)``: every f32 leaf of a layer
cast) with data-axis weight sharding kept only where the bf16 weights do
not fit a rank replicated over "data", prefill the prefill step, decode
one decode step at the last position of a cache of ``seq_len`` rows
(``index`` = S − 1; the reference's index is a traced scalar).  A record
(``{arch}__{shape}__{mesh}[__tag].json`` under ``results/dryrun_torch``)
holds, for that rank:

- ``collective_bytes``: the bytes it hands to other ranks, under the
  reference's ``COLLECTIVE_KINDS`` keys plus ``total`` (``psum``,
  ``pmax``, ``pmin`` → all-reduce; ``all_gather``, ``gather_to_root``,
  ``broadcast`` → all-gather; ``reduce_scatter``; ``all_to_all``;
  ``ring_hop`` → collective-permute), and ``by_site``: bytes, calls and
  ops by call site.  These are the port's own bytes (its float ``psum``
  gathers every rank's part: (n − 1)× the payload), counted by the byte
  rules the real calls count by, so a real rank's ``counts()`` equal
  them; they are not the reference's HLO bytes.
- ``memory``: ``argument_bytes`` (exact: the rank's parameters, optimizer
  state, batch rows, cache and memory blocks; each group in
  ``arguments``), ``output_bytes`` (exact: what the step returns, the
  decode cache it writes in place included), and ``temp_bytes`` and
  ``peak_bytes`` (argument bytes + temp bytes): an eager estimate, the
  largest sum of the storages the step's ops had made and not yet freed
  (``Meter``).
- ``flops``: ``torch.utils.flop_counter.FlopCounterMode`` over the run:
  the plain twins' products, K4's masked blocks included.
- ``bytes_accessed``: the operand plus result bytes of every aten op that
  is not a view, unfused.
- ``n_devices``, ``status``, ``lower_s`` (the meta run's seconds) and
  ``compile_s`` (0: nothing compiles).

A cell the port refuses is recorded, not dropped: where the model path
raises ``dist.sharding.NotPorted`` (context-parallel rules, a gradient
through MoE or through the MLA, SSD, hybrid or encoder–decoder layers
under a mesh, the multi-pod placement) the status is
``skipped(not ported: ROADMAP Queue 1 item N)``.  Any other exception is
``FAIL: ...`` with its traceback, and ``main`` exits 1.  ``--probe`` is
the reference's extrapolation from layer counts 1 and 2; on the meta
device each layer costs the same, so its totals equal the full-depth
cell's (the probe configurations keep the full one's ZeRO and optimizer
choices, where the reference's decide their own).  The reference's
``block_kv``, ``unroll`` and ``mp_override`` have no counterpart.

    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k \
        --mesh single
    python -m repro_torch.launch.dryrun --all --mesh single

**The graph cells** (``--graph``): the eight programs on the five wires,
the fused quantized bundle, the overlapped ragged cells and the executed
early-exit cell, with the same records under the same keys and the same
regression gate (``check_graph_ordering``).

    python -m repro_torch.launch.dryrun --graph --graph-scale 13 --check
    python -m repro_torch.launch.dryrun --device cpu --graph \
        --graph-scale 13 --graph-k 8 --check

The port runs each graph cell's step (``iters`` iterations, default 1)
one partition a rank on a k-rank graph mesh, through
``GraphSession.dryrun_step``, and reads what the ranks handed to the wire
(``dist.collectives`` counts every call by call site, from a reset just
before the cell's loop):

- ``collective_bytes_wire`` is the sum over the ranks of the bytes each
  handed to the other ranks at the mirror exchange's sites
  (``<wire>.reduce``, ``<wire>.broadcast``; the exact wire's sites where
  a quantized wire carries an exact payload), divided by ``iters``.  It
  is the byte model's quantity: it equals ``PartitionLayout.comm_bytes(
  exchange, lossy=...)`` on halo, quantized, ragged and ragged_quantized,
  and (k−1)/k of it on dense, whose model counts the block a rank
  gathers from itself, which never leaves it.
- ``collective_bytes_scalars`` is the same sum at the loop's other sites:
  the programs' global scalars (``gas.aux``: pagerank's and ppr's
  dangling mass, centrality's norm; 4 bytes from each rank to each
  other rank), which the model does not count.  ``collective_bytes_total``
  is the two together; ``collective_bytes_per_device`` each rank's bytes
  an iteration by site.
- ``collective_permute_count`` is the ``ring_hop`` calls of one
  iteration on a rank (the reference's collective-permutes of the loop
  body): the ragged wires' hops, 0 on dense, halo and quantized.
- ``compile_s`` keeps the reference's key: the cell's wall seconds on the
  ranks (nothing compiles).

A graph cell that fails raises, where the reference records the failure
and goes on: a rank that stops would leave its peers waiting in a
collective, so ``run_on_ranks`` stops every rank and raises.

The per-rank body (``graph_cells``: a bound mesh and a session holding
the layout in, every byte cell's record out on rank 0) is separate from
the spawn, so a caller that already runs ranks calls it inside them.
The early-exit cell runs the session's stacked ``run`` in the calling
process (``early_exit_cell``).  On the card K3's row → slot sum is float
atomics, so there the tol run is held to the fixed run within rtol 1e-5
(``early_exit_rtol``), not bit for bit; on the CPU bit for bit, as the
reference gates it.

``--device`` (default ``cuda``) places the graph session and its ranks
(the LM cells run on the meta device whatever it names); ``--assign``
adopts an edge → partition assignment of the graph's stream (a
``.npy``) in place of the session's own partition; ``--json`` moves
``results/BENCH_dryrun_torch.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import threading
import time
import traceback
import weakref
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, get_config
from ..dist import collectives as coll
from ..dist.compress import make_grad_compressor
from ..dist.halo import EXCHANGE_NAMES, lossy_payload
from ..dist.mesh import make_production_mesh
from ..dist.sharding import (CP_SERVE_RULES, MULTI_POD_RULES,
                             SINGLE_POD_RULES, NotPorted, use_rules)
from ..models import init_params, layer_groups, param_count
from ..train import (batch_specs, cache_specs, get_optimizer, local_tree,
                     make_decode_fn, make_prefill_step, make_train_step,
                     place_params, placed_specs)
from ..train.step import _compute_copy, mesh_axes
from .specs import SHAPES, cell_is_skipped, input_specs

RESULTS = Path(__file__).resolve().parents[3] / "results"
BENCH_JSON = "BENCH_dryrun_torch.json"

# every engine wire format, straight from the exchange registry
GRAPH_EXCHANGES = EXCHANGE_NAMES

# the reference's padded all_to_all wires count a self lane in their HLO
# output shape that never crosses the wire; the port counts what a rank
# hands to the others, which never includes it (kept for the reference's
# readers)
SELF_LANE_EXCHANGES = ("halo", "quantized")
# the fused-vs-separate gate runs this homogeneous (f32, sum) bundle as ONE
# fused step and compares its wire bytes against the sum of the three
# separate quantized steps (threshold FUSED_GATE_RATIO)
FUSED_BUNDLE = ("pagerank", "ppr", "centrality")
FUSED_GATE_RATIO = 0.6
# the overlapped ragged body re-orders interior compute around the k−1
# ring hops: wire bytes and ring-hop count must equal the phase-ordered
# cell's
OVERLAP_CELLS = (("pagerank", "ragged"), ("sssp", "ragged"),
                 ("pagerank", "ragged_quantized"))
# the early-exit cell EXECUTES pagerank under tol and gates iters_run
# strictly under the cap, the tol run's values equal to a fixed-iters run
# at the reported iters_run
EARLY_EXIT_TOL = 1e-6
EARLY_EXIT_CAP = 60
# on the card the two runs' float atomics add in different orders
EARLY_EXIT_RTOL = 1e-5

def _is_wire(site: str) -> bool:
    """A mirror exchange's call site (``halo.reduce``, ...)."""
    return site.split(".")[0] in EXCHANGE_NAMES


def wire_counts(reports: list, iters: int) -> dict:
    """A cell's record fields from every rank's report of its loop."""
    per_rank = [{s: v["bytes"] // iters for s, v in w["collectives"].items()}
                for w in reports]
    wire = sum(b for r in per_rank for s, b in r.items() if _is_wire(s))
    scalars = sum(b for r in per_rank for s, b in r.items()
                  if not _is_wire(s))
    hops = max(sum(v["ops"].get("ring_hop", 0)
                   for v in w["collectives"].values()) for w in reports)
    return {"collective_bytes_per_device": per_rank,
            "collective_bytes_total": wire + scalars,
            "collective_bytes_wire": wire,
            "collective_bytes_scalars": scalars,
            "collective_permute_count": hops // iters,
            "launches": [{n: c for n, c in w["launches"].items() if c}
                         for w in reports]}


def graph_base(sess, scale: int, iters: int) -> dict:
    """The keys every record of the session's layout shares."""
    lay = sess.partition_layout
    return {"bench": "graph_dryrun", "k": lay.k, "scale": scale,
            "iters": iters, "num_vertices": lay.num_vertices,
            "num_edges": int(sess.edges[0].shape[0]), "l_max": lay.l_max,
            "h_max": lay.h_max, "mirrors": lay.mirrors_total,
            "comm_bytes_ideal": lay.comm_bytes("ideal"),
            "device": sess.device.type}


def graph_cells(mesh, sess, scale: int, iters: int = 1) -> list | None:
    """Every byte cell, SPMD on a bound k-rank graph ``mesh`` (every rank
    calls it with the same session, whose layout it runs): the eight
    programs on the five wires, the ``FUSED_BUNDLE`` as one quantized
    step and the ``OVERLAP_CELLS``, each ``iters`` iterations through
    ``sess.dryrun_step``.  Returns the records on rank 0, None on the
    other ranks."""
    from ..graph.engine import PROGRAM_NAMES
    from ..session import resolve_program

    lay = sess.partition_layout
    V = lay.num_vertices
    base = graph_base(sess, scale, iters)
    recs = []

    def cell(rec, step, overlap=False):
        t = time.perf_counter()
        out = sess.dryrun_step(step, mesh=mesh, iters=iters,
                               exchange=rec["exchange"], overlap=overlap)
        if out is not None:
            rec.update(status="ok", compile_s=time.perf_counter() - t,
                       **wire_counts(out[1], iters))
            recs.append(rec)

    def model(pname, exchange):
        prog = resolve_program(pname, V)
        lossy = lossy_payload(prog.combine, prog.dtype)
        return {"lossy_payload": lossy,
                "comm_bytes_model": lay.comm_bytes(exchange, lossy=lossy)}

    for pname in PROGRAM_NAMES:
        for exchange in GRAPH_EXCHANGES:
            cell({**base, "program": pname, "exchange": exchange,
                  "fused": False, "overlap": False,
                  **model(pname, exchange)}, pname)
    cell({**base, "program": "+".join(FUSED_BUNDLE), "exchange": "quantized",
          "fused": True, "overlap": False,
          "fused_programs": list(FUSED_BUNDLE),
          "lossy_payload": model(FUSED_BUNDLE[0], "quantized")[
              "lossy_payload"],
          "comm_bytes_model": sess.comm_bytes(programs=FUSED_BUNDLE,
                                              exchange="quantized",
                                              fused=True)},
         list(FUSED_BUNDLE))
    for pname, exchange in OVERLAP_CELLS:
        cell({**base, "program": pname, "exchange": exchange,
              "fused": False, "overlap": True, **model(pname, exchange)},
             pname, overlap=True)
    return recs if mesh.rank == 0 else None


def early_exit_cell(sess, scale: int, iters: int = 1) -> dict:
    """The executed cell: pagerank on ragged under ``EARLY_EXIT_TOL``
    capped at ``EARLY_EXIT_CAP`` through the session's stacked ``run``,
    then a fixed run at the iterations it reported.  On the CPU the two
    must be bit-identical; on the card (``early_exit_rtol``) within
    ``EARLY_EXIT_RTOL``."""
    t = time.perf_counter()
    v_tol, iters_run = sess.run("pagerank", iters=EARLY_EXIT_CAP,
                                exchange="ragged", tol=EARLY_EXIT_TOL,
                                return_iters=True)
    v_fix = sess.run("pagerank", iters=int(iters_run), exchange="ragged")
    rec = {**graph_base(sess, scale, iters), "program": "pagerank",
           "exchange": "ragged", "fused": False, "overlap": False,
           "tol": EARLY_EXIT_TOL, "iters_cap": EARLY_EXIT_CAP,
           "iters_run": int(iters_run),
           "early_exit_bitmatch": bool(np.array_equal(v_tol, v_fix)),
           "status": "ok", "compile_s": time.perf_counter() - t}
    if sess.device.type != "cpu":
        rec["early_exit_rtol"] = EARLY_EXIT_RTOL
        rec["early_exit_close"] = bool(np.allclose(
            v_tol, v_fix, rtol=EARLY_EXIT_RTOL, atol=0.0))
    return rec


def _by_cell(recs):
    return {(r["program"], r["exchange"]): r for r in recs
            if r.get("status") == "ok" and not r.get("fused")
            and not r.get("overlap") and r.get("tol") is None}


def ratio_lines(recs: list) -> list[str]:
    """Each program's bytes an iteration on every wire with the
    reference's ratios, and the fused bundle against its separate
    steps."""
    by = _by_cell(recs)
    lines = []
    for prog in dict.fromkeys(p for p, _ in by):
        cells = [by.get((prog, e)) for e in GRAPH_EXCHANGES]
        if None in cells:
            continue
        w = {e: c["collective_bytes_wire"]
             for e, c in zip(GRAPH_EXCHANGES, cells)}
        d, h, q = w["dense"], w["halo"], w["quantized"]
        rg, rq = w["ragged"], w["ragged_quantized"]
        lines.append(
            f"{prog}: " + " ".join(f"{e} {b}" for e, b in w.items())
            + f" B/iter; dense→halo {h / max(d, 1):.3f}×  "
            f"halo→quantized {q / max(h, 1):.3f}×  "
            f"halo→ragged {rg / max(h, 1):.3f}×  "
            f"quantized→ragged_q {rq / max(q, 1):.3f}×  (ideal/dense = "
            f"{cells[0]['comm_bytes_ideal'] / max(d, 1):.3f})")
    for r in recs:
        sep = [by.get((p, "quantized")) for p in r.get("fused_programs", ())]
        if r.get("fused") and sep and None not in sep:
            total = sum(c["collective_bytes_wire"] for c in sep)
            lines.append(
                f"fused {r['program']}: {r['collective_bytes_wire']} B vs "
                f"separate {total} B → "
                f"{r['collective_bytes_wire'] / max(total, 1):.3f}× "
                f"(gate < {FUSED_GATE_RATIO})")
    return lines


def run_graph_cell(out_dir: Path, scale: int = 10, k: int = 8,
                   iters: int = 1, tag: str = "", device: str = "cuda",
                   assign=None, bench_json: Path | None = None
                   ) -> list[dict]:
    """The graph dry-run: partition ``web_graph(scale, 8, seed=0)`` with
    ``CLUGPConfig.optimized(k)`` through ``GraphSession`` (or adopt
    ``assign``), build the layout, run every byte cell on k ranks on
    ``device`` in one spawn (``graph_cells``), then the early-exit cell
    here.  One JSON record a cell in ``out_dir``; the table also lands in
    ``bench_json`` (default ``results/BENCH_dryrun_torch.json``)."""
    from ..core import CLUGPConfig, web_graph
    from ..dist.mesh import run_on_ranks
    from ..session import GraphSession, SessionConfig
    from .mesh import make_graph_mesh

    g = web_graph(scale=scale, edge_factor=8, seed=0)
    sess = GraphSession(SessionConfig(clugp=CLUGPConfig.optimized(k)),
                        device=device)
    if assign is None:
        sess.partition(g.src, g.dst, g.num_vertices)
    else:
        sess.with_partition(g.src, g.dst, g.num_vertices, assign)
    sess.layout()
    recs = run_on_ranks(graph_cells, make_graph_mesh(k, device=device),
                        sess, scale, iters)
    for r in recs:
        ov = " × overlap" if r["overlap"] else ""
        print(f"[graph × {r['program']} × {r['exchange']}{ov}] OK  "
              f"wire={r['collective_bytes_wire']} B/iter (counted on {k} "
              f"ranks)  model={r['comm_bytes_model']} B  "
              f"ideal={r['comm_bytes_ideal']} B  "
              f"ring hops/iter={r['collective_permute_count']}")
    for line in ratio_lines(recs):
        print(f"  {line}")
    rec = early_exit_cell(sess, scale, iters)
    recs.append(rec)
    match = ("bitmatch" if "early_exit_rtol" not in rec else
             f"within rtol {EARLY_EXIT_RTOL:g}")
    print(f"[graph × pagerank × ragged × tol={EARLY_EXIT_TOL}] OK  "
          f"iters_run={rec['iters_run']}/{EARLY_EXIT_CAP}  {match}="
          f"{rec.get('early_exit_close', rec['early_exit_bitmatch'])}")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"graph__gas__k{k}{('__' + tag) if tag else ''}.json") \
        .write_text(json.dumps(recs, indent=1))
    bench = Path(bench_json) if bench_json else RESULTS / BENCH_JSON
    bench.parent.mkdir(parents=True, exist_ok=True)
    bench.write_text(json.dumps(recs, indent=1))
    return recs


def check_graph_ordering(recs: list[dict]) -> list[str]:
    """The regression gate on the paper's headline quantity, the
    reference's rule for rule: **per program**, wire bytes/iter must order
    quantized < halo < dense, and ragged ≤ halo and, for lossy payloads,
    ragged_quantized < quantized.  Programs whose quantized cells ship an
    exact payload (min/int — the record's ``lossy_payload``) allow
    quantized == halo and require ragged_quantized == ragged.
    ragged_quantized vs ragged is deliberately NOT gated.  Fused rows gate
    the fused win: the fused step's wire bytes must be <
    ``FUSED_GATE_RATIO`` × the sum of its bundle programs' separate
    quantized steps.  Overlap rows must equal the phase-ordered cell in
    wire bytes and ring-hop count.  Early-exit rows (``tol`` set) gate
    ``iters_run`` strictly under the cap, the tol run bit-identical to a
    fixed-iters run at ``iters_run`` — or, where the record carries
    ``early_exit_rtol`` (a run on the card), within that rtol
    (``early_exit_close``).  Returns the violations (empty == pass)."""
    msgs = [f"{r.get('program', '?')}/{r.get('exchange', '?')}: "
            f"{r.get('status')}"
            for r in recs if r.get("status") != "ok"]
    by = _by_cell(recs)
    for prog in sorted({p for p, _ in by}):
        cells = {e: by.get((prog, e)) for e in GRAPH_EXCHANGES}
        if any(c is None for c in cells.values()):
            continue    # the missing cell is already reported above
        wire = {e: c["collective_bytes_wire"] for e, c in cells.items()}
        d, h, q = wire["dense"], wire["halo"], wire["quantized"]
        rg, rq = wire["ragged"], wire["ragged_quantized"]
        if h >= d:
            msgs.append(f"{prog}: halo bytes/iter {h} ≥ dense {d}")
        if rg > h:
            msgs.append(f"{prog}: ragged bytes/iter {rg} > halo {h}")
        if cells["quantized"].get("lossy_payload", True):
            if q >= h:
                msgs.append(f"{prog}: quantized bytes/iter {q} ≥ halo {h}")
            if rq >= q:
                msgs.append(f"{prog}: ragged_quantized bytes/iter {rq} "
                            f"≥ quantized {q}")
        else:
            if q > h:
                msgs.append(f"{prog}: quantized bytes/iter {q} > halo {h}")
            if rq != rg:
                msgs.append(f"{prog}: exact-payload ragged_quantized "
                            f"bytes/iter {rq} != ragged {rg}")
    for r in recs:
        if not r.get("fused") or r.get("status") != "ok":
            continue
        bundle = r.get("fused_programs") or r["program"].split("+")
        sep = [by.get((p, "quantized")) for p in bundle]
        if None in sep:
            missing = [p for p, c in zip(bundle, sep) if c is None]
            msgs.append(f"{r['program']}: fused gate needs separate "
                        f"quantized cells for {missing}")
            continue
        total_sep = sum(c["collective_bytes_wire"] for c in sep)
        fused_wire = r["collective_bytes_wire"]
        if fused_wire >= FUSED_GATE_RATIO * total_sep:
            msgs.append(
                f"{r['program']}: fused bytes/iter {fused_wire} ≥ "
                f"{FUSED_GATE_RATIO} × Σ separate ({total_sep})")
    for r in recs:
        if not r.get("overlap") or r.get("status") != "ok":
            continue
        ref = by.get((r["program"], r["exchange"]))
        if ref is None:
            msgs.append(f"{r['program']}/{r['exchange']}: overlap gate "
                        f"needs the phase-ordered cell")
            continue
        if r["collective_bytes_wire"] != ref["collective_bytes_wire"]:
            msgs.append(
                f"{r['program']}/{r['exchange']}: overlapped bytes/iter "
                f"{r['collective_bytes_wire']} != phase-ordered "
                f"{ref['collective_bytes_wire']}")
        if (r.get("collective_permute_count")
                != ref.get("collective_permute_count")):
            msgs.append(
                f"{r['program']}/{r['exchange']}: overlapped "
                f"collective-permute count "
                f"{r.get('collective_permute_count')} != phase-ordered "
                f"{ref.get('collective_permute_count')}")
    for r in recs:
        if (r.get("tol") is None or r.get("fused")
                or r.get("status") != "ok"):
            continue
        if not r["iters_run"] < r["iters_cap"]:
            msgs.append(
                f"{r['program']}/{r['exchange']}: tol={r['tol']} ran "
                f"iters_run={r['iters_run']} — not strictly under the "
                f"cap {r['iters_cap']}")
        if r.get("early_exit_rtol") is not None:
            if not r.get("early_exit_close"):
                msgs.append(
                    f"{r['program']}/{r['exchange']}: tol run not within "
                    f"rtol {r['early_exit_rtol']} of the fixed-iters run "
                    f"at iters_run={r.get('iters_run')}")
        elif not r.get("early_exit_bitmatch"):
            msgs.append(
                f"{r['program']}/{r['exchange']}: tol run not "
                f"bit-identical to fixed-iters run at "
                f"iters_run={r.get('iters_run')}")
    return msgs


# ------------------------------------------------------------ LM cells

# the reference's HLO collective kinds (``repro.analysis.ir``), and the
# kind of each of the port's primitives
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
KIND_OF = {"psum": "all-reduce", "pmax": "all-reduce", "pmin": "all-reduce",
           "all_gather": "all-gather", "gather_to_root": "all-gather",
           "broadcast": "all-gather", "reduce_scatter": "reduce-scatter",
           "all_to_all": "all-to-all", "ring_hop": "collective-permute"}
NOTES = {
    "collective_bytes": "this rank's bytes handed to other ranks by "
                        "dist.collectives' byte rules (a float psum gathers "
                        "every part: (n - 1)x its payload); not HLO bytes",
    "flops": "FlopCounterMode over the plain twins' products, K4's masked "
             "blocks included",
    "bytes_accessed": "operand + result bytes of every aten op that is not "
                      "a view, unfused",
    "memory": "argument and output bytes exact; temp_bytes an eager "
              "estimate (the largest sum of op outputs made and not yet "
              "freed), peak_bytes = argument_bytes + temp_bytes",
}


class _MetaGenerator(torch.Generator):
    """A generator for shapes only: ``init_params`` makes every draw on
    ``gen.device`` (its documented contract), and this one's reads meta,
    so the tree lands on the meta device with no values.  Its CPU state
    is never used (a meta draw reads no generator)."""

    @property
    def device(self):
        return torch.device("meta")


def meta_generator() -> torch.Generator:
    return _MetaGenerator()


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples (an op's
    arguments and results too; ``repro_torch.tree`` keeps tuples as
    leaves)."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def nbytes(tree) -> int:
    """The bytes of every tensor in a tree of dicts, lists and tuples."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class Meter(TorchDispatchMode):
    """Counts, over the aten ops run inside it, the operand plus result
    bytes of every op that is not a view (``bytes_accessed``) and the
    storages the ops make: each added when an op first returns it, dropped
    when it is freed (a finalizer on the storage, whose Python object
    lives as long as the storage does), the largest sum kept
    (``temp_bytes``).  The storages of ``keep`` (the arguments) are not
    counted.  A finalizer may run in another thread (the garbage
    collector's), so the sums are updated under a lock."""

    def __init__(self, keep=()):
        super().__init__()
        self.bytes_accessed = 0
        self.now = self.temp_bytes = 0
        self._live: dict = {}
        self._lock = threading.Lock()
        self._keep = [t.untyped_storage() for t in _tensors(keep)]
        self._kept = {id(st) for st in self._keep}

    def _free(self, key):
        with self._lock:
            self.now -= self._live.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        made = _tensors(out)
        if not func.is_view:
            self.bytes_accessed += sum(
                t.numel() * t.element_size()
                for t in _tensors(args) + _tensors(kwargs) + made)
        for t in made:
            st = t.untyped_storage()
            key = id(st)
            if key not in self._live and key not in self._kept:
                with self._lock:
                    self._live[key] = st.nbytes()
                    self.now += self._live[key]
                weakref.finalize(st, self._free, key)
        self.temp_bytes = max(self.temp_bytes, self.now)
        return out


def by_site(counts: dict) -> dict:
    """``collectives.counts()`` cut to what a dry run and a real rank must
    agree on: bytes, calls and ops (calls by primitive) of each site."""
    return {s: {"bytes": c["bytes"], "calls": c["calls"], "ops": c["ops"]}
            for s, c in sorted(counts.items())}


def collective_kinds(counts: dict) -> dict:
    """``collectives.counts()`` by the reference's collective kinds, plus
    ``total``."""
    out = dict.fromkeys(COLLECTIVE_KINDS, 0)
    for c in counts.values():
        for op, b in c["op_bytes"].items():
            out[KIND_OF[op]] += b
    out["total"] = sum(out.values())
    return out


def zero_default(cfg) -> bool:
    """ZeRO-shard anything ≥ ~8B parameters (replicated f32 would not fit
    a card)."""
    return param_count(cfg, mp=16) >= 8e9


def optimizer_default(cfg) -> str:
    return "adafactor" if param_count(cfg, mp=16) >= 3e10 else "adamw"


def serve_zero(cfg, mp: int, mesh) -> bool:
    """Serving keeps data-axis weight sharding only where the bf16 weights
    a model rank holds pass 8 GiB (the reference's rule)."""
    return 2 * param_count(cfg, mp=mp) / mesh.shape["model"] > 8 * 2**30


def cfg_with_counts(cfg, counts: dict):
    """A config whose ``layer_groups()`` counts equal ``counts`` — the
    probe models."""
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_encoder_layers=counts["enc"],
                                   n_layers=counts["dec"])
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg,
                                   n_layers=counts["hyb"] * cfg.attn_period)
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, n_layers=counts["ssd"])
    if cfg.moe is not None and cfg.moe.first_k_dense:
        moe = dataclasses.replace(cfg.moe, first_k_dense=counts["dense"])
        return dataclasses.replace(
            cfg, moe=moe, n_layers=counts["dense"] + counts["moe"])
    if cfg.moe is not None:
        return dataclasses.replace(cfg, n_layers=counts["moe"])
    return dataclasses.replace(cfg, n_layers=counts["dense"])


def build_cell(cfg, shape_name: str, mesh, rules, *, mp: int,
               multi_pod: bool, loss_chunk: int = 512,
               zero: bool | None = None, compress: bool = False,
               optimizer: str | None = None, sizes: dict | None = None):
    """This rank's step on the bound ``mesh`` (a spawned rank's, or the
    dry mode's ``simulate``), inside ``use_rules(rules, mesh)``: returns
    (fn, args, held), ``fn(*args)`` the step, ``held`` the bytes of each
    group of arguments this rank holds.  The parameters are drawn from
    seed 0 on the mesh's device (the same draws on every rank) and cut by
    ``place_params``; the inputs (``input_specs`` on that device, at
    ``sizes`` when given) are whole, and the rank holds its blocks of them
    (the reference's ``in_shardings``)."""
    kind = SHAPES[shape_name]["kind"]
    dev = mesh.device
    gen = meta_generator() if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(0)
    inputs = input_specs(cfg, shape_name, mp=mp, device=dev, sizes=sizes)
    train = kind == "train"
    if zero is None:
        zero = zero_default(cfg) if train else serve_zero(cfg, mp, mesh)
    place = place_params(mesh, zero=zero)
    params = init_params(cfg, gen, dtype=torch.float32 if train
                         else torch.bfloat16, mp=mp, place=place)
    specs = placed_specs(place)
    if not train:           # bf16 weights: every f32 leaf of a layer cast
        params = _compute_copy(params, torch.bfloat16)
    held = {"params": nbytes(params)}

    def rows(tree):         # this rank's blocks of whole batch tensors
        return local_tree(tree, batch_specs(tree, multi_pod=multi_pod),
                          mesh)

    if train:
        opt = get_optimizer(optimizer or optimizer_default(cfg))
        _mesh, axes = mesh_axes(specs)
        state = opt.init(params, axes=axes)
        held["opt_state"] = nbytes(state)
        held["batch"] = nbytes(rows(inputs["batch"]))
        step = make_train_step(
            cfg, opt, mp=mp, loss_chunk=loss_chunk, specs=specs,
            compress_grads=make_grad_compressor() if compress else None)
        return step, (params, state, inputs["batch"], 0), held
    serve = specs if zero else None
    if kind == "prefill":
        held["batch"] = nbytes(rows(inputs["batch"]))
        return (make_prefill_step(cfg, mp=mp, specs=serve),
                (params, inputs["batch"]), held)
    S = (sizes or SHAPES[shape_name])["seq_len"]
    cache = local_tree(inputs["cache"],
                       cache_specs(inputs["cache"], multi_pod=multi_pod),
                       mesh)
    args = [params, cache, rows({"t": inputs["tokens"]})["t"]]
    held.update(cache=nbytes(cache), tokens=nbytes(args[2]))
    if "memory" in inputs:
        args.append(rows({"m": inputs["memory"]})["m"])
        held["memory"] = nbytes(args[3])
    step = make_decode_fn(cfg, mp=mp, max_len=S, specs=serve)

    def decode(params, cache, tokens, memory=None):
        return step(params, cache, tokens, S - 1, memory)
    return decode, tuple(args), held


def measure(fn, args, flops: bool = True) -> tuple:
    """``fn(*args)`` under a ``Meter`` and, with ``flops``, a
    ``FlopCounterMode`` (its first use in a process costs ≈ 1 s): (its
    output, {"flops" (None without), "bytes_accessed", "temp_bytes",
    "output_bytes"})."""
    meter = Meter(keep=args)
    counter = FlopCounterMode(display=False) if flops else nullcontext()
    with counter, meter:
        out = fn(*args)
    return out, {"flops": float(counter.get_total_flops()) if flops
                 else None,
                 "bytes_accessed": float(meter.bytes_accessed),
                 "temp_bytes": meter.temp_bytes,
                 "output_bytes": nbytes(out)}


def dry_cell(cfg, shape_name: str, mesh, rules, *, coords=None,
             **kw) -> dict:
    """Rank ``coords`` (default rank 0) of the spec ``mesh`` runs its step
    of the cell once on the meta device (``collectives.dry``;
    ``build_cell``'s keywords in ``kw``): its record's numbers."""
    coords = coords if coords is not None else 0
    t = time.perf_counter()
    with coll.dry(mesh, coords) as rank, use_rules(rules, rank):
        fn, args, held = build_cell(cfg, shape_name, rank, rules, **kw)
        _out, m = measure(fn, args)
        counts = coll.counts()
        rec = {"coords": rank.coords}
    arg = sum(held.values())
    rec.update(
        lower_s=time.perf_counter() - t, compile_s=0.0, flops=m["flops"],
        bytes_accessed=m["bytes_accessed"],
        collective_bytes=collective_kinds(counts), by_site=by_site(counts),
        memory={"argument_bytes": arg, "output_bytes": m["output_bytes"],
                "temp_bytes": m["temp_bytes"],
                "peak_bytes": arg + m["temp_bytes"], "arguments": held},
        n_devices=mesh.size, notes=NOTES)
    return rec


def _mesh_and_rules(mesh_kind: str, rules_name: str):
    mesh = make_production_mesh(multi_pod=mesh_kind == "multi",
                                device="meta")
    rules = MULTI_POD_RULES if mesh_kind == "multi" else SINGLE_POD_RULES
    return mesh, (CP_SERVE_RULES if rules_name == "cp" else rules)


def _not_ported(e: NotPorted) -> str:
    return f"skipped(not ported: ROADMAP Queue 1 item {e.item})"


def _write(out_dir: Path, name: str, rec: dict) -> None:
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=1))


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: Path,
             loss_chunk: int = 512, tag: str = "",
             rules_name: str = "tp", compress: bool = False) -> dict:
    """One (arch × shape × mesh) cell as rank 0 of the production mesh on
    the meta device (``dry_cell``), recorded under the reference's keys
    in ``out_dir``; ``compress`` (train cells) runs the step with the
    int8 gradient compressor and again without it."""
    cfg = get_config(arch)
    compress = compress and SHAPES[shape_name]["kind"] == "train"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "tag": tag or "baseline", "compress_grads": compress}
    skip = cell_is_skipped(cfg, shape_name)
    if skip:
        rec["status"] = skip
        _write(out_dir, f"{arch}__{shape_name}__{mesh_kind}", rec)
        print(f"[{arch} × {shape_name} × {mesh_kind}] {skip}")
        return rec
    multi_pod = mesh_kind == "multi"
    mesh, rules = _mesh_and_rules(mesh_kind, rules_name)
    mp = 1 if rules_name == "cp" else mesh.shape["model"]
    kw = dict(mp=mp, multi_pod=multi_pod, loss_chunk=loss_chunk)
    try:
        rec.update(dry_cell(cfg, shape_name, mesh, rules, compress=compress,
                            **kw))
        if compress:
            base = dry_cell(cfg, shape_name, mesh, rules, **kw)
            rec["collective_bytes_uncompressed"] = base["collective_bytes"]
            rec["collective_delta_bytes"] = (
                base["collective_bytes"]["total"]
                - rec["collective_bytes"]["total"])
        rec["status"] = "ok"
        print(f"[{arch} × {shape_name} × {mesh_kind} × {rec['tag']}] OK  "
              f"meta run {rec['lower_s']:.1f}s  flops={rec['flops']:.3e}  "
              f"coll={rec['collective_bytes']['total']:.3e}B  "
              f"args={rec['memory']['argument_bytes']:.3e}B a rank")
    except NotPorted as e:
        rec["status"] = _not_ported(e)
        rec["reason"] = str(e)
        print(f"[{arch} × {shape_name} × {mesh_kind}] {rec['status']}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec["status"] = f"FAIL: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[{arch} × {shape_name} × {mesh_kind}] FAIL: {e}",
              file=sys.stderr)
    _write(out_dir, f"{arch}__{shape_name}__{mesh_kind}"
           f"{('__' + tag) if tag else ''}", rec)
    return rec


def _probe_numbers(rec: dict) -> dict:
    return {"flops": rec["flops"], "bytes": rec["bytes_accessed"],
            "coll": float(rec["collective_bytes"]["total"])}


def run_probe_cell(arch: str, shape_name: str, out_dir: Path,
                   loss_chunk: int = 512, tag: str = "",
                   rules_name: str = "tp") -> dict:
    """Per-layer cost extrapolation on the single-pod mesh, the
    reference's: total = outside + Σ_g L_g · layer_g, layer_g from the
    cells at counts[g] = 2 and counts = 1.  Each probe keeps the full
    configuration's ZeRO and optimizer choices, so the totals equal the
    full-depth cell's."""
    cfg = get_config(arch)
    rec = {"arch": arch, "shape": shape_name, "mesh": "single",
           "tag": (tag or "baseline") + "-probe"}
    skip = cell_is_skipped(cfg, shape_name)
    if skip:
        rec["status"] = skip
        return rec
    mesh, rules = _mesh_and_rules("single", rules_name)
    mp = 1 if rules_name == "cp" else mesh.shape["model"]
    train = SHAPES[shape_name]["kind"] == "train"
    kw = dict(mp=mp, multi_pod=False, loss_chunk=loss_chunk,
              zero=zero_default(cfg) if train else serve_zero(cfg, mp, mesh),
              optimizer=optimizer_default(cfg))
    groups = layer_groups(cfg)
    base_counts = {name: 1 for name, _ in groups}
    t0 = time.perf_counter()

    def probe(counts):
        return _probe_numbers(dry_cell(cfg_with_counts(cfg, counts),
                                       shape_name, mesh, rules, **kw))
    try:
        base = probe(base_counts)
        per_layer = {}
        for name, _ in groups:
            bumped = probe({**base_counts, name: 2})
            per_layer[name] = {k: bumped[k] - base[k] for k in base}
        outside = {k: base[k] - sum(per_layer[n][k] for n, _ in groups)
                   for k in base}
        totals = {k: outside[k] + sum(cnt * per_layer[n][k]
                                      for n, cnt in groups)
                  for k in base}
        rec.update(status="ok", probe_s=time.perf_counter() - t0,
                   base=base, per_layer=per_layer, outside=outside,
                   totals=totals, groups=dict(groups), n_devices=mesh.size)
        print(f"[probe {arch} × {shape_name} × {rec['tag']}] "
              f"flops={totals['flops']:.3e} bytes={totals['bytes']:.3e} "
              f"coll={totals['coll']:.3e} ({rec['probe_s']:.1f}s)")
    except NotPorted as e:
        rec["status"] = _not_ported(e)
        rec["reason"] = str(e)
        print(f"[probe {arch} × {shape_name}] {rec['status']}")
    except Exception as e:  # noqa: BLE001
        rec["status"] = f"FAIL: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[probe {arch} × {shape_name}] FAIL: {e}", file=sys.stderr)
    _write(out_dir, f"{arch}__{shape_name}__probe"
           f"{('__' + tag) if tag else ''}", rec)
    return rec


def cell_table(recs: list) -> list[str]:
    """One line a record: status, argument bytes a rank, collective bytes
    a rank and the meta run's seconds."""
    lines = ["arch | shape | mesh | status | argument B/rank | "
             "collective B/rank | s"]
    for r in recs:
        ok = r["status"] == "ok"
        lines.append(" | ".join([
            r["arch"], r["shape"], r["mesh"], r["status"],
            str(r["memory"]["argument_bytes"]) if ok else "-",
            str(r["collective_bytes"]["total"]) if ok else "-",
            f"{r['lower_s']:.2f}" if ok else "-"]))
    return lines


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None,
                    help="one arch (default: every arch of configs.ARCHS)")
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None],
                    help="one shape (default: every shape of specs.SHAPES)")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="every (arch × shape) cell")
    ap.add_argument("--probe", action="store_true",
                    help="per-layer cost probes (single-pod only)")
    ap.add_argument("--rules", default="tp", choices=["tp", "cp"])
    ap.add_argument("--loss-chunk", type=int, default=512)
    ap.add_argument("--compress-grads", action="store_true",
                    help="train cells: the int8 gradient compressor; the "
                         "record also holds the step's collective bytes "
                         "without it and the delta")
    ap.add_argument("--graph", action="store_true",
                    help="GAS-engine cells: run one step per (program × "
                         "wire) for the full program library plus the "
                         "fused 3-program bundle on k ranks, count the "
                         "wire bytes against the layout's modelled "
                         "volumes, and write results/" + BENCH_JSON)
    ap.add_argument("--graph-scale", type=int, default=10)
    ap.add_argument("--graph-k", type=int, default=8)
    ap.add_argument("--check", action="store_true",
                    help="with --graph: exit 1 unless wire bytes order "
                         "quantized < halo < dense per program (exact int "
                         "payloads allow quantized == halo), ragged ≤ halo "
                         "and ragged_quantized < quantized (== ragged for "
                         "exact payloads), the fused bundle ships < 0.6× "
                         "the bytes of its separate quantized steps, the "
                         "overlapped ragged cells match their phase-ordered "
                         "twins in bytes and ring hops, and the tol cell "
                         "early-exits under its cap matching the fixed run")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=None,
                    help="the records' directory (default "
                         "results/dryrun_torch)")
    ap.add_argument("--json", dest="bench_json", default=None,
                    help=f"the graph table's path (default results/"
                         f"{BENCH_JSON})")
    ap.add_argument("--assign", default=None,
                    help="a .npy edge → partition assignment of the "
                         "graph's stream, adopted in place of the "
                         "session's own partition")
    ap.add_argument("--device", default="cuda",
                    help="the graph session's and its ranks' device "
                         "(default cuda; cpu runs gloo ranks on the CPU); "
                         "the LM cells run on the meta device")
    return ap


def _graph_main(args) -> int:
    assign = None if args.assign is None else np.load(args.assign)
    recs = run_graph_cell(Path(args.out or RESULTS / "dryrun_torch"),
                          scale=args.graph_scale, k=args.graph_k,
                          tag=args.tag, device=args.device, assign=assign,
                          bench_json=args.bench_json)
    if not args.check:
        return 0
    msgs = check_graph_ordering(recs)
    for m in msgs:
        print(f"collective-bytes gate: {m}", file=sys.stderr)
    if not msgs:
        print("collective-bytes gate: quantized < halo < dense, ragged ≤ "
              "halo and ragged_quantized < quantized hold for every "
              f"program, the fused bundle ships < {FUSED_GATE_RATIO}× its "
              "separate steps, overlap cells match phase-ordered bytes "
              "and ring hops, and tol early-exits under the cap matching "
              "the fixed run")
    return 1 if msgs else 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.graph:
        return _graph_main(args)
    out_dir = Path(args.out or RESULTS / "dryrun_torch")
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    recs = []
    for arch in archs:
        for shape in shapes:
            if args.probe:
                recs.append(run_probe_cell(arch, shape, out_dir,
                                           loss_chunk=args.loss_chunk,
                                           tag=args.tag,
                                           rules_name=args.rules))
                continue
            for mk in meshes:
                recs.append(run_cell(arch, shape, mk, out_dir,
                                     loss_chunk=args.loss_chunk,
                                     tag=args.tag, rules_name=args.rules,
                                     compress=args.compress_grads))
    if not args.probe:
        for line in cell_table(recs):
            print(line)
    return 1 if any(str(r.get("status", "")).startswith("FAIL")
                    for r in recs) else 0


if __name__ == "__main__":
    sys.exit(main())
