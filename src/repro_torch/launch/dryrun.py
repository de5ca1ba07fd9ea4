"""Graph dry-run: every (program × wire) cell's wire bytes, counted on
ranks and held to the layout's byte model.

Port of ``repro.launch.dryrun``'s graph half (``--graph``): the eight
programs on the five wires, the fused quantized bundle, the overlapped
ragged cells and the executed early-exit cell, with the same records
under the same keys and the same regression gate
(``check_graph_ordering``).

    python -m repro_torch.launch.dryrun --graph --graph-scale 13 --check
    python -m repro_torch.launch.dryrun --device cpu --graph \\
        --graph-scale 13 --graph-k 8 --check

The reference lowers and compiles one GAS step a cell and parses the
collective bytes out of the post-SPMD HLO.  The port lowers nothing: it
runs each cell's step (``iters`` iterations, default 1) one partition a
rank on a k-rank graph mesh, through ``GraphSession.dryrun_step``, and
reads what the ranks handed to the wire (``dist.collectives`` counts
every call by call site, from a reset just before the cell's loop):

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

A cell that fails raises, where the reference records the failure and
goes on: a rank that stops would leave its peers waiting in a
collective, so ``run_on_ranks`` stops every rank and raises.

The per-rank body (``graph_cells``: a bound mesh and a session holding
the layout in, every byte cell's record out on rank 0) is separate from
the spawn, so a caller that already runs ranks calls it inside them.
The early-exit cell runs the session's stacked ``run`` in the calling
process (``early_exit_cell``).  On the card K3's row → slot sum is float
atomics, so there the tol run is held to the fixed run within rtol 1e-5
(``early_exit_rtol``), not bit for bit; on the CPU bit for bit, as the
reference gates it.

``--device`` (default ``cuda``) places the session and the ranks;
``--assign`` adopts an edge → partition assignment of the graph's stream
(a ``.npy``) in place of the session's own partition; ``--json`` moves
``results/BENCH_dryrun_torch.json``.  The LM cells (``--arch``,
``--shape``, ``--all``, ``--probe``) are not ported and raise.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

from ..dist.halo import EXCHANGE_NAMES, lossy_payload

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

LM_CELLS = ("the LM cells of the dry-run (--arch, --shape, --all, --probe) "
            "and launch/specs.py are not ported yet: ROADMAP Queue 1 item 3")


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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    for flag in ("--arch", "--shape"):
        ap.add_argument(flag, default=None, help=f"not ported: {LM_CELLS}")
    for flag in ("--all", "--probe"):
        ap.add_argument(flag, action="store_true",
                        help=f"not ported: {LM_CELLS}")
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
    ap.add_argument("--out", default=str(RESULTS / "dryrun_torch"))
    ap.add_argument("--json", dest="bench_json", default=None,
                    help=f"the table's path (default results/{BENCH_JSON})")
    ap.add_argument("--assign", default=None,
                    help="a .npy edge → partition assignment of the "
                         "graph's stream, adopted in place of the "
                         "session's own partition")
    ap.add_argument("--device", default="cuda",
                    help="the session's and the ranks' device (default "
                         "cuda; cpu runs gloo ranks on the CPU)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.arch or args.shape or args.all or args.probe or not args.graph:
        raise NotImplementedError(LM_CELLS)
    assign = None if args.assign is None else np.load(args.assign)
    recs = run_graph_cell(Path(args.out), scale=args.graph_scale,
                          k=args.graph_k, tag=args.tag, device=args.device,
                          assign=assign, bench_json=args.bench_json)
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


if __name__ == "__main__":
    sys.exit(main())
