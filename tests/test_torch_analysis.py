"""The port's source lint (``repro_torch.analysis``): the engine against
the reference's (``repro.analysis``) on the reference's own rules and
allowlist, each port rule on planted violations and their allowed forms,
the exact-count allowlist, and the CLI gate on the repository.

Everything is compared exactly: findings field for field, allowlist
errors message for message.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.analysis import Allow, run_lint  # noqa: E402
from repro_torch.analysis.rules import (DEFAULT_RULES,  # noqa: E402
                                        DeprecatedApi, RawCollective,
                                        SessionBypass, StagePlumb)

REPO = Path(__file__).resolve().parents[1]


def plant(root, relpath, source):
    p = root / relpath
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return p


def _fields(report):
    return ([(f.rule, f.path, f.line, f.col, f.key, f.message,
              f.severity, f.allowlisted, f.justification)
             for f in report.findings],
            report.errors, report.parse_failures, report.ok)


@pytest.fixture(scope="module")
def ref():
    """The reference's lint package (it imports no jax)."""
    import repro.analysis as R
    from repro.analysis.allowlist import ALLOWLIST
    from repro.analysis.rules import DEFAULT_RULES as REF_RULES
    return dict(run_lint=R.run_lint, Allow=R.Allow, rules=REF_RULES,
                allowlist=ALLOWLIST)


def test_engine_reproduces_the_reference_on_the_repository(ref):
    """Given the reference's rule objects and allowlist, the port's
    engine returns ``repro.analysis.run_lint()``'s findings on this
    tree, finding for finding, and the same reconciliation."""
    want = ref["run_lint"]()
    got = run_lint(rules=ref["rules"], allowlist=ref["allowlist"])
    assert _fields(got) == _fields(want)
    assert got.summary_rows() == want.summary_rows()
    assert got.format(verbose=True) == want.format(verbose=True)


@pytest.fixture
def ref_violations(tmp_path):
    """A tree with a violation of each reference rule and a file that
    does not parse."""
    plant(tmp_path, "src/repro/core/bad.py", """\
        import time
        import jax
        from jax import lax
        from jax.lax import ppermute

        @jax.jit
        def f(x):
            t = time.time()
            y = jax.lax.psum(x, "parts")
            return lax.all_gather(y, "parts") + t
        """)
    plant(tmp_path, "src/repro/core/partitioner.py", """\
        from .clustering import streaming_clustering

        def strategy(src, dst):
            return streaming_clustering(src, dst)
        """)
    plant(tmp_path, "examples/demo.py", """\
        from repro.graph import build_layout, simulate_pagerank
        lay = build_layout(src, dst, V, assign, k)
        pr = simulate_pagerank(lay, iters=30)
        """)
    plant(tmp_path, "tests/test_x.py", """\
        def test_x(lay):
            lay.comm_bytes_halo()
            lay.comm_bytes_halo()
        """)
    plant(tmp_path, "benchmarks/broken.py", "def (:\n")
    return tmp_path


@pytest.mark.parametrize("allow", ["none", "exact", "over", "under",
                                   "inactive"])
def test_engine_reproduces_the_reference_on_planted_trees(
        ref, ref_violations, allow):
    """Planted violations of every reference rule, reconciled against no
    allowlist, an exact one, counts off either way, and an entry for a
    rule that did not scan: the same findings and errors from both
    engines."""
    entries = {
        "none": [],
        "exact": [("SESSION-BYPASS", "examples/demo.py", "build_layout",
                   1), ("DEPRECATED-API", "tests/test_x.py",
                        "comm_bytes_halo", 2)],
        "over": [("DEPRECATED-API", "tests/test_x.py", "comm_bytes_halo",
                  3)],
        "under": [("DEPRECATED-API", "tests/test_x.py", "comm_bytes_halo",
                   1)],
        "inactive": [("NO-SUCH-RULE", "tests/test_x.py", "x", 1)],
    }[allow]
    allowlist = [ref["Allow"](*e, "planted") for e in entries]
    want = ref["run_lint"](root=ref_violations, rules=ref["rules"],
                           allowlist=allowlist)
    got = run_lint(root=ref_violations, rules=ref["rules"],
                   allowlist=allowlist)
    assert _fields(got) == _fields(want)
    assert want.findings and want.parse_failures
    assert bool(got.errors) == (allow in ("over", "under"))


def test_raw_collective_flags_every_import_form(tmp_path):
    plant(tmp_path, "src/repro_torch/core/bad.py", """\
        import torch
        import torch.distributed
        import torch.distributed as dist
        from torch import distributed as tdist
        from torch.distributed import batch_isend_irecv

        def f(x, ops):
            dist.all_reduce(x)
            torch.distributed.all_gather([x], x)
            tdist.send(x, 1)
            return batch_isend_irecv(ops)
        """)
    plant(tmp_path, "src/repro_torch/dist/halo.py", """\
        import torch.distributed as dist

        def hop(x):
            return dist.isend(x, 1)
        """)
    rep = run_lint(root=tmp_path, rules=[RawCollective()], allowlist=[])
    assert sorted((f.path, f.key) for f in rep.violations) == [
        ("src/repro_torch/core/bad.py", "all_gather"),
        ("src/repro_torch/core/bad.py", "all_reduce"),
        ("src/repro_torch/core/bad.py", "batch_isend_irecv"),
        ("src/repro_torch/core/bad.py", "send"),
        ("src/repro_torch/dist/halo.py", "isend")]


def test_raw_collective_allows_the_door_and_other_names(tmp_path):
    """``dist/collectives.py`` itself, the counted wrappers, a module's
    own functions of those names and non-collective queries pass."""
    plant(tmp_path, "src/repro_torch/dist/collectives.py", """\
        import torch.distributed as dist
        from torch.distributed import P2POp

        def psum(x, axis):
            dist.all_reduce(x, group=axis.group)
            return x
        """)
    plant(tmp_path, "src/repro_torch/graph/ok.py", """\
        import torch.distributed as dist
        from ..dist import collectives as coll

        def gather(x, axis):
            if dist.is_initialized():
                return coll.all_gather(x, axis, site="ok")
            return coll.ring_hop(x, axis, 1, site="ok")

        def all_reduce(x):
            return x

        class Wire:
            def send(self, x):
                return self.broadcast(x)
        """)
    rep = run_lint(root=tmp_path, rules=[RawCollective()], allowlist=[])
    assert rep.ok and not rep.findings, rep.format()


def test_session_bypass_scans_launchers_and_the_twins(tmp_path):
    src = """\
        from repro_torch.graph import build_layout, simulate_gas
        from repro_torch.graph.engine import gas_step_for_dryrun
        lay = build_layout(src, dst, assign, V, k)
        pr = simulate_gas(prog, lay, 30)
        out = gas_step_for_dryrun(prog, lay, mesh)
        """
    for rel in ("src/repro_torch/launch/demo.py", "examples/demo_torch.py",
                "examples/demo.py"):
        plant(tmp_path, rel, src)
    plant(tmp_path, "examples/fine_torch.py", """\
        from repro_torch.session import GraphSession
        sess = GraphSession(cfg, device="cpu")
        pr = sess.run("pagerank", iters=30)
        cells = sess.dryrun_step("pagerank", mesh=mesh)
        """)
    rep = run_lint(root=tmp_path, rules=[SessionBypass()], allowlist=[])
    assert sorted((f.path, f.key) for f in rep.violations) == sorted(
        (p, k) for p in ("examples/demo_torch.py",
                         "src/repro_torch/launch/demo.py")
        for k in ("build_layout", "gas_step_for_dryrun", "simulate_gas"))


def test_stage_plumb_flags_the_ports_pass_internals(tmp_path):
    plant(tmp_path, "src/repro_torch/core/partitioner.py", """\
        from .clustering import streaming_clustering, localize_stream
        from . import game, transform
        from ..kernels.cluster_scatter import cluster_pass

        def strategy(src, dst, ctx):
            clu = streaming_clustering(src, dst)
            a = game.game_rounds_gs(clu)
            return transform.transform_scan(a), transform.transform_np(a)
        """)
    rep = run_lint(root=tmp_path, rules=[StagePlumb()], allowlist=[])
    keys = sorted({f.key for f in rep.violations})
    assert keys == ["cluster_pass", "game_rounds", "localize_stream",
                    "streaming_clustering", "transform_np",
                    "transform_scan"]
    plant(tmp_path, "src/repro_torch/core/partitioner.py", """\
        from .stages import TORCH_STAGES, run_clugp_body

        def strategy(src, dst, ctx):
            out = run_clugp_body(TORCH_STAGES, ctx)
            return {"game_rounds": out.rounds}
        """)
    rep = run_lint(root=tmp_path, rules=[StagePlumb()], allowlist=[])
    assert rep.ok and not rep.findings, rep.format()


def test_deprecated_api_scans_the_ports_files_only(tmp_path):
    bad = '''\
        """Docs may say comm_bytes_halo() and clugp_partition."""
        from repro_torch.core import clugp_partition

        def f(lay, sess):
            lay.comm_bytes_halo()
            getattr(lay, "comm_bytes_dense")()
            return sess.comm_bytes(programs=["pagerank"])
        '''
    for rel in ("src/repro_torch/user.py", "tests/test_torch_user.py",
                "examples/user_torch.py", "chip_smoke.py",
                "tests/test_user.py", "examples/user.py",
                "src/repro_torch/analysis/rules/x.py"):
        plant(tmp_path, rel, bad)
    rep = run_lint(root=tmp_path, rules=[DeprecatedApi()], allowlist=[])
    assert sorted((f.path, f.key) for f in rep.violations) == sorted(
        (p, k) for p in ("chip_smoke.py", "examples/user_torch.py",
                         "src/repro_torch/user.py",
                         "tests/test_torch_user.py")
        for k in ("clugp_partition", "comm_bytes_halo"))


@pytest.fixture
def one_violation_tree(tmp_path):
    plant(tmp_path, "src/repro_torch/launch/x.py", """\
        from repro_torch.graph import build_layout
        a = build_layout(1)
        b = build_layout(2)
        """)
    return tmp_path


@pytest.mark.parametrize("count,ok", [(2, True), (1, False), (3, False)])
def test_allowlist_counts_exactly(one_violation_tree, count, ok):
    """An entry demotes exactly its count of findings; a count off in
    either direction is an error naming the direction."""
    allow = [Allow("SESSION-BYPASS", "src/repro_torch/launch/x.py",
                   "build_layout", count, "planted")]
    rep = run_lint(root=one_violation_tree, rules=[SessionBypass()],
                   allowlist=allow)
    assert rep.ok == ok, rep.format()
    assert all(f.allowlisted for f in rep.findings)
    if not ok:
        word = "regressed" if count < 2 else "burned down"
        assert len(rep.errors) == 1 and word in rep.errors[0]


def test_allowlist_ignores_entries_of_rules_that_did_not_scan(
        one_violation_tree):
    allow = [Allow("SESSION-BYPASS", "src/repro_torch/launch/x.py",
                   "build_layout", 2, "planted"),
             Allow("DEPRECATED-API", "tests/test_torch_x.py",
                   "comm_bytes_halo", 1, "not scanned here")]
    rep = run_lint(root=one_violation_tree, rules=[SessionBypass()],
                   allowlist=allow)
    assert rep.ok, rep.format()


def test_shipped_tree_is_clean():
    rep = run_lint()
    assert rep.ok, rep.format()
    assert {r.id for r in DEFAULT_RULES} == {
        "RAW-COLLECTIVE", "STAGE-PLUMB", "SESSION-BYPASS", "DEPRECATED-API"}


def test_rules_scan_the_ports_files():
    """The shipped tree's files each rule reads: the port's modules, its
    launchers and twins, its tests and chip_smoke.py."""
    from repro_torch.analysis.lint import iter_python_files
    for rule in DEFAULT_RULES:
        files = [p.relative_to(REPO).as_posix()
                 for p in iter_python_files(REPO, rule.roots)]
        scanned = [f for f in files if rule.applies_to(f)]
        assert scanned, rule.id
        assert "src/repro_torch/dist/collectives.py" not in scanned \
            or rule.id != "RAW-COLLECTIVE"
    deprecated = [r for r in DEFAULT_RULES if r.id == "DEPRECATED-API"][0]
    assert deprecated.applies_to("chip_smoke.py")
    assert deprecated.applies_to("tests/test_torch_dryrun.py")
    assert not deprecated.applies_to("tests/test_session.py")
    bypass = [r for r in DEFAULT_RULES if r.id == "SESSION-BYPASS"][0]
    assert bypass.applies_to("examples/quickstart_torch.py")
    assert not bypass.applies_to("examples/quickstart.py")


def test_cli_check_exits_zero_on_the_repository(tmp_path):
    out = tmp_path / "analysis.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check", "--json",
         str(out)], env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    import json
    rows = json.loads(out.read_text())
    assert [r["rule"] for r in rows] == [r.id for r in DEFAULT_RULES] + [
        "TOTAL"]
    assert rows[-1]["violations"] == 0 and rows[-1]["errors"] == 0


def test_cli_exits_non_zero_on_a_finding(tmp_path):
    plant(tmp_path, "pyproject.toml", "")
    plant(tmp_path, "src/repro_torch/core/bad.py", """\
        import torch.distributed as dist
        dist.barrier()
        """)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check", "--root",
         str(tmp_path)], env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode == 1
    assert "RAW-COLLECTIVE" in proc.stdout
    assert (tmp_path / "results" / "ANALYSIS_torch.json").exists()
