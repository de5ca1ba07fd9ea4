"""The port's graph dry-run (``repro_torch.launch.dryrun --graph``): every
(program × wire) cell's wire bytes counted on 8 gloo ranks on the CPU
and held to the layout's byte model, the ordering, fused, overlap and
early-exit gates, and the reference's gate and halo cells as witnesses.

The graphs are ``web_graph(scale, 8, seed=0)`` at scale 13 (the
reference's CI cell) and 10, partitioned by the reference's
``GraphSession`` with ``CLUGPConfig.optimized(8)`` and adopted by the
port's launcher (``--assign``): the port's own partitioner draws its
game's start lanes from its own hash, so its own partition differs.
One CLI run a scale, each one spawn of 8 ranks.

Tolerances: bytes, ring hops and the gates' messages exactly; the
early-exit cell within ±1 iteration of the reference's ``sess.run`` and
bit for bit against the fixed run.

The LM cells' command line (``--arch``, ``--shape``, ``--mesh``,
``--rules``, ``--compress-grads``) writes its records under the
reference's keys, records the port's refusals as skipped with their
ROADMAP item, and exits 1 on a failing cell
(``tests/test_torch_dryrun_lm.py`` holds the cells' numbers).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.graph.engine import PROGRAM_NAMES  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:          # the property test below needs it
    given = None

REPO = Path(__file__).resolve().parents[1]
K = 8
# the reference's PartitionLayout.comm_bytes on its scale-13 partition
# (numpy 2.0.2): the issue's table; dense counts the rank's own block
TABLE_13 = {"dense": 970_752, "halo": 89_600, "quantized": 22_848,
            "ragged": 73_920, "ragged_quantized": 14_416}
FUSED_13 = 38_976
HALO_10 = 39_424
EXACT = ("cc", "labelprop", "sssp", "bfs", "degree")
# the exact payload's wire on each quantized one
EXACT_WIRE = {"quantized": "halo", "ragged_quantized": "ragged"}

REF_WITNESS = """
import json, sys
from pathlib import Path
import repro.launch.dryrun as D
out = Path(sys.argv[1])
D.RESULTS = out
recs = D.run_graph_cell(out / "dryrun", scale=10, k=8)
(out / "records.json").write_text(json.dumps(
    [{k: v for k, v in r.items() if k != "traceback"} for r in recs]))
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO / "src"),
                JAX_PLATFORMS="cpu")


@pytest.fixture(scope="module")
def witness(tmp_path_factory):
    """The reference's own ``run_graph_cell`` at scale 10, k = 8 in a
    subprocess (it sets ``XLA_FLAGS`` at import), its results under a
    temporary directory; started first, read when a test needs it."""
    out = tmp_path_factory.mktemp("ref_dryrun")
    proc = subprocess.Popen([sys.executable, "-c", REF_WITNESS, str(out)],
                            env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    box = {}

    def records():
        if "recs" not in box:
            log, _ = proc.communicate(timeout=300)
            assert proc.returncode == 0, log[-3000:]
            box["recs"] = json.loads((out / "records.json").read_text())
        return box["recs"]
    yield records
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def jref():
    """The reference's session and its gate (``repro.launch.dryrun`` sets
    ``XLA_FLAGS`` at import: put it back for the rest of the process)."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import check_graph_ordering
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    from repro.core import CLUGPConfig, web_graph
    from repro.session import GraphSession, SessionConfig
    return dict(check=check_graph_ordering, Config=CLUGPConfig,
                web_graph=web_graph, Session=GraphSession,
                SessionConfig=SessionConfig)


@pytest.fixture(scope="module")
def ref_sessions(jref):
    """The reference's sessions at scales 13 and 10, partitioned as its
    dry-run partitions."""
    out = {}
    for scale in (13, 10):
        g = jref["web_graph"](scale=scale, edge_factor=8, seed=0)
        out[scale] = jref["Session"](jref["SessionConfig"](
            clugp=jref["Config"].optimized(K)))
        out[scale].partition(g.src, g.dst, g.num_vertices)
    return out


@pytest.fixture(scope="module")
def cli(witness, ref_sessions, tmp_path_factory):
    """The port's CLI at scales 13 and 10 on 8 CPU ranks, on the
    reference's partition: (exit code, records, output) by scale."""
    out = {}
    for scale in (13, 10):
        tmp = tmp_path_factory.mktemp(f"dryrun{scale}")
        np.save(tmp / "assign.npy", ref_sessions[scale].assign)
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
             "cpu", "--graph", "--graph-scale", str(scale), "--graph-k",
             str(K), "--check", "--assign", str(tmp / "assign.npy"),
             "--out", str(tmp / "cells"), "--json", str(tmp / "bench.json")],
            env=_env(), capture_output=True, text=True, timeout=300,
            cwd=tmp)
        recs = json.loads((tmp / "bench.json").read_text())
        out[scale] = (proc.returncode, recs, proc.stdout + proc.stderr)
    return out


def _cells(recs):
    return {(r["program"], r["exchange"]): r for r in recs
            if not r["fused"] and not r["overlap"] and r.get("tol") is None}


BYTE_CELLS = [(p, e) for p in PROGRAM_NAMES for e in D.GRAPH_EXCHANGES]


@pytest.mark.parametrize("program,exchange", BYTE_CELLS)
def test_counted_wire_equals_the_byte_model(cli, program, exchange):
    """Scale 13: the bytes the 8 ranks handed to the wire in one
    iteration equal the table (the model; dense 7/8 of it), the exact
    programs riding halo's and ragged's bytes on the quantized wires."""
    rec = _cells(cli[13][1])[program, exchange]
    want = TABLE_13[exchange]
    if program in EXACT:
        want = TABLE_13[EXACT_WIRE.get(exchange, exchange)]
        assert not rec["lossy_payload"]
    if exchange == "dense":
        want = want * (K - 1) // K      # 849,408
    assert rec["collective_bytes_wire"] == want
    model = rec["comm_bytes_model"]
    assert rec["collective_bytes_wire"] == (
        model * (K - 1) // K if exchange == "dense" else model)
    assert rec["status"] == "ok" and rec["iters"] == 1
    # the aux scalars are counted apart, 4 bytes each rank to each other
    scalars = K * (K - 1) * 4 if program in ("pagerank", "ppr",
                                             "centrality") else 0
    assert rec["collective_bytes_scalars"] == scalars
    assert rec["collective_bytes_total"] == \
        rec["collective_bytes_wire"] + scalars
    assert sum(sum(r.values()) for r in
               rec["collective_bytes_per_device"]) == \
        rec["collective_bytes_total"]


def test_fused_cell_equals_its_model_under_the_gate(cli):
    fused = [r for r in cli[13][1] if r["fused"]]
    assert len(fused) == 1
    rec = fused[0]
    assert rec["collective_bytes_wire"] == rec["comm_bytes_model"] \
        == FUSED_13
    sep = sum(_cells(cli[13][1])[p, "quantized"]["collective_bytes_wire"]
              for p in D.FUSED_BUNDLE)
    assert sep == 3 * TABLE_13["quantized"]
    assert rec["collective_bytes_wire"] / sep == pytest.approx(0.5686,
                                                               abs=1e-4)
    assert rec["collective_bytes_wire"] < D.FUSED_GATE_RATIO * sep


def test_ring_hops_an_iteration(cli):
    """``collective_permute_count``: the ring's hops on the ragged wires
    (two phases; three messages a hop on the lossy one), none on the
    all-gather and all-to-all wires."""
    cells = _cells(cli[13][1])
    hops = cells["pagerank", "ragged"]["collective_permute_count"]
    assert 0 < hops <= 2 * (K - 1)
    for (p, e), r in cells.items():
        want = {"ragged": hops,
                "ragged_quantized": 3 * hops if r["lossy_payload"]
                else hops}.get(e, 0)
        assert r["collective_permute_count"] == want, (p, e)


@pytest.mark.parametrize("program,exchange", D.OVERLAP_CELLS)
def test_overlap_cells_equal_their_phase_ordered_cells(cli, program,
                                                       exchange):
    ov = [r for r in cli[13][1] if r["overlap"]
          and (r["program"], r["exchange"]) == (program, exchange)]
    assert len(ov) == 1
    ref = _cells(cli[13][1])[program, exchange]
    for key in ("collective_bytes_wire", "collective_permute_count"):
        assert ov[0][key] == ref[key]


def test_cli_scale_13_passes_every_gate(cli, jref):
    rc, recs, log = cli[13]
    assert rc == 0, log[-3000:]
    assert len(recs) == len(BYTE_CELLS) + 1 + len(D.OVERLAP_CELLS) + 1
    assert D.check_graph_ordering(recs) == []
    assert jref["check"](recs) == []


def test_cli_scale_10_fails_on_the_fused_gate_alone(cli, jref):
    """At scale 10 the model itself misses the fused gate (20,160 ≥ 0.6 ×
    3 × 10,304), so the CLI exits non-zero with that message only."""
    rc, recs, log = cli[10]
    assert rc != 0
    msgs = D.check_graph_ordering(recs)
    assert msgs == ["pagerank+ppr+centrality: fused bytes/iter 20160 ≥ "
                    "0.6 × Σ separate (30912)"]
    assert jref["check"](recs) == msgs
    assert msgs[0] in log


@pytest.mark.parametrize("scale", [13, 10])
def test_early_exit_matches_the_reference_session(cli, ref_sessions,
                                                  scale):
    """The session's stacked early exit stops under its cap within ±1 of
    the reference's ``sess.run`` on the same partition, bit for bit
    against the fixed run at the iterations it reported."""
    rec = [r for r in cli[scale][1] if r.get("tol") is not None]
    assert len(rec) == 1
    rec = rec[0]
    assert rec["iters_run"] < D.EARLY_EXIT_CAP
    assert rec["early_exit_bitmatch"] and "early_exit_rtol" not in rec
    _, it = ref_sessions[scale].run("pagerank", iters=D.EARLY_EXIT_CAP,
                                    exchange="ragged", tol=D.EARLY_EXIT_TOL,
                                    return_iters=True)
    assert abs(rec["iters_run"] - int(it)) <= 1


def test_reference_halo_cells_equal_the_ports(cli, witness):
    """The reference's own dry-run at scale 10 (its HLO parser): its halo
    cells that lower (all but degree's) read 39,424 bytes, each equal to
    the port's counted halo wire."""
    ref = _cells(witness())
    port = _cells(cli[10][1])
    lowered = [p for p in PROGRAM_NAMES
               if ref[p, "halo"]["status"] == "ok"]
    assert set(PROGRAM_NAMES) - set(lowered) <= {"degree"}
    assert len(lowered) >= 7
    for p in lowered:
        assert ref[p, "halo"]["collective_bytes_wire"] == HALO_10 == \
            port[p, "halo"]["collective_bytes_wire"], p


@pytest.mark.parametrize("scale", [13, 10])
def test_gate_matches_the_references_on_the_records(cli, jref, scale):
    recs = cli[scale][1]
    assert D.check_graph_ordering(recs) == jref["check"](recs)


def _plant(recs, plants):
    """The records with each (index, key, value) plant applied."""
    out = [dict(r) for r in recs]
    for i, key, value in plants:
        out[i % len(out)][key] = value
    return out


def test_gate_flags_the_planted_regressions(jref):
    """The reference test's plants (``tests/test_graph_quantized.py``),
    through both gates."""
    def rec(program, exchange, wire, lossy=True):
        return {"program": program, "exchange": exchange, "status": "ok",
                "lossy_payload": lossy, "collective_bytes_wire": wire}

    def prog(name, d, h, q, rg, rq, lossy=True):
        return [rec(name, e, w, lossy)
                for e, w in zip(D.GRAPH_EXCHANGES, (d, h, q, rg, rq))]

    good = prog("pagerank", 100, 40, 12, 30, 9) + \
        prog("cc", 100, 40, 40, 30, 30, lossy=False)
    cases = {"good": (good, 0),
             "bad": (prog("pagerank", 100, 100, 100, 100, 100), 3),
             "tie": (prog("pagerank", 100, 40, 40, 30, 9), 1),
             "fat": (prog("pagerank", 100, 40, 12, 41, 9), 1),
             "drift": (prog("cc", 100, 40, 40, 30, 29, lossy=False), 1),
             "over": (prog("pagerank", 100, 40, 12, 8, 9), 0),
             "failed": (good[:9] + [{"program": "cc",
                                     "exchange": "ragged_quantized",
                                     "status": "FAIL: boom"}], 1)}
    for name, (recs, n) in cases.items():
        msgs = D.check_graph_ordering(recs)
        assert len(msgs) == n, name
        assert msgs == jref["check"](recs), name


def test_gate_holds_a_card_run_to_its_rtol():
    """A record from the card carries ``early_exit_rtol``: the port's gate
    reads ``early_exit_close`` there, not the bit match."""
    rec = {"program": "pagerank", "exchange": "ragged", "status": "ok",
           "fused": False, "overlap": False, "tol": 1e-6, "iters_cap": 60,
           "iters_run": 38, "early_exit_bitmatch": False,
           "early_exit_rtol": 1e-5, "early_exit_close": True}
    assert D.check_graph_ordering([rec]) == []
    msgs = D.check_graph_ordering([{**rec, "early_exit_close": False}])
    assert msgs == ["pagerank/ragged: tol run not within rtol 1e-05 of the "
                    "fixed-iters run at iters_run=38"]
    assert D.check_graph_ordering([{**rec, "iters_run": 60}])[0] \
        .endswith("not strictly under the cap 60")


if given is not None:
    PLANT_KEYS = {"collective_bytes_wire": st.integers(0, 1_000_000),
                  "collective_permute_count": st.integers(0, 50),
                  "lossy_payload": st.booleans(),
                  "early_exit_bitmatch": st.booleans(),
                  "iters_run": st.integers(0, 80),
                  "status": st.sampled_from(["ok", "FAIL: planted"])}
    plant = st.sampled_from(sorted(PLANT_KEYS)).flatmap(
        lambda key: st.tuples(st.integers(0, 10_000), st.just(key),
                              PLANT_KEYS[key]))

    @settings(max_examples=60, deadline=None)
    @given(plants=st.lists(plant, max_size=6),
           drop=st.sets(st.integers(0, 10_000), max_size=3))
    def test_gate_matches_the_references_with_planted_regressions(
            cli, jref, plants, drop):
        """Regressions planted in the scale-13 records (a cell's bytes,
        ring hops, payload kind, status, the early exit; cells dropped):
        the port's gate gives the reference's messages."""
        recs = _plant(cli[13][1], plants)
        recs = [r for i, r in enumerate(recs)
                if i not in {d % len(recs) for d in drop}]
        assert D.check_graph_ordering(recs) == jref["check"](recs)


# the reference's keys of an ok LM record (src/repro/launch/dryrun.py:206,
# :253-270) and of its memory analysis
LM_KEYS = {"arch", "shape", "mesh", "tag", "compress_grads", "status",
           "lower_s", "compile_s", "flops", "bytes_accessed",
           "collective_bytes", "memory", "n_devices"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
KINDS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute", "total"}
# (case, argv, record file, status)
LM_CLI = [
    ("record", ["--arch", "stablelm_1_6b", "--shape", "decode_32k"],
     "stablelm_1_6b__decode_32k__single", "ok"),
    ("compress", ["--arch", "stablelm_1_6b", "--shape", "train_4k",
                  "--compress-grads", "--tag", "c"],
     "stablelm_1_6b__train_4k__single__c", "ok"),
    ("cp", ["--arch", "qwen2_7b", "--shape", "prefill_32k", "--rules", "cp"],
     "qwen2_7b__prefill_32k__single",
     "skipped(not ported: ROADMAP Queue 1 item 1.5)"),
    ("moe_train", ["--arch", "llama4_scout_17b_a16e", "--shape",
                   "train_4k"], "llama4_scout_17b_a16e__train_4k__single",
     "skipped(not ported: ROADMAP Queue 1 item 1.1)"),
    ("mla_train", ["--arch", "deepseek_v3_671b", "--shape", "train_4k"],
     "deepseek_v3_671b__train_4k__single",
     "skipped(not ported: ROADMAP Queue 1 item 2)"),
    ("multi", ["--arch", "qwen2_7b", "--shape", "decode_32k", "--mesh",
               "multi"], "qwen2_7b__decode_32k__multi",
     "skipped(not ported: ROADMAP Queue 1 item 1.6)"),
    ("long_500k", ["--arch", "qwen2_7b", "--shape", "long_500k"],
     "qwen2_7b__long_500k__single",
     "skipped(full-attention: 500k dense KV is out of scope)"),
]


@pytest.mark.parametrize("case,argv,name,status", LM_CLI,
                         ids=[c[0] for c in LM_CLI])
def test_lm_cells_record_under_the_references_keys(tmp_path, case, argv,
                                                   name, status):
    """``--arch/--shape`` writes ``{arch}__{shape}__{mesh}[__tag].json``
    under the reference's keys and exits 0; the port's refusals are
    recorded as skipped, naming their ROADMAP item, the full-attention
    archs at ``long_500k`` with the reference's reason."""
    assert D.main(argv + ["--out", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / f"{name}.json").read_text())
    assert rec["status"] == status
    if status != "ok":
        return
    assert LM_KEYS <= set(rec) and MEMORY_KEYS <= set(rec["memory"])
    assert set(rec["collective_bytes"]) == KINDS
    assert rec["compile_s"] == 0.0 and rec["n_devices"] == 256
    mem = rec["memory"]
    assert mem["argument_bytes"] == sum(mem["arguments"].values())
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert rec["collective_bytes"]["total"] == sum(
        c["bytes"] for c in rec["by_site"].values())
    if case == "compress":
        base = rec["collective_bytes_uncompressed"]["total"]
        assert rec["compress_grads"]
        assert rec["collective_delta_bytes"] == \
            base - rec["collective_bytes"]["total"]
        # the int8 scale is the compressor's one collective (its pmax)
        assert rec["by_site"]["compress.scale"]["ops"] == {"pmax": 1}


def test_a_failing_lm_cell_is_recorded_and_exits_1(tmp_path, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(D, "build_cell", broken)
    assert D.main(["--arch", "qwen2_7b", "--shape", "decode_32k", "--out",
                   str(tmp_path)]) == 1
    rec = json.loads((tmp_path / "qwen2_7b__decode_32k__single.json")
                     .read_text())
    assert rec["status"] == "FAIL: RuntimeError: planted"
    assert "planted" in rec["traceback"]
