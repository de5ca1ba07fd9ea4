"""The port's slice as a whole — GraphSession partition → layout →
PageRank — held against the JAX session, plus the layout and engine on
JAX-built layouts, the converters, the device default and the import
isolation of ``repro_torch``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import CLUGPConfig as JConfig  # noqa: E402
from repro.graph.engine import _local_rank_partial as jax_local  # noqa: E402
from repro.graph.engine import pagerank_program as jax_pagerank  # noqa: E402
from repro.graph.engine import simulate_gas as jax_simulate_gas  # noqa: E402
from repro.session import GraphSession as JSession  # noqa: E402
from repro.session import SessionConfig as JSessionConfig  # noqa: E402
from repro_torch.convert import (config_from_reference,  # noqa: E402
                                 layout_from_reference)
from repro_torch.core import CLUGPConfig, web_graph  # noqa: E402
from repro_torch.graph.engine import (_local_rank_partial,  # noqa: E402
                                      pagerank_program, reference_pagerank,
                                      simulate_gas, stack_dev)
from repro_torch.session import GraphSession, SessionConfig  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def greedy_pair():
    """The same stream through both sessions with the game off (the
    greedy CLUGP-G path: deterministic end to end)."""
    g = web_graph(scale=9, edge_factor=5, seed=1)
    jcfg = JConfig.optimized(8, game=False, restream=1,
                             split_degree_factor=4.0)
    js = JSession(JSessionConfig(clugp=jcfg, backend="jit"))
    js.partition(g.src, g.dst, g.num_vertices).layout()
    cfg = config_from_reference(js.to_json())
    ps = GraphSession(cfg, device="cpu")
    ps.partition(g.src, g.dst, g.num_vertices).layout()
    return g, js, ps


def test_session_greedy_matches_reference(greedy_pair):
    """Identical assignment, every build_layout table identical, PageRank
    within f32 summation-order tolerance."""
    g, js, ps = greedy_pair
    np.testing.assert_array_equal(ps.assign, js.assign)
    jl, pl = js.partition_layout, ps.partition_layout
    for name in pl.TABLES:
        a, b = getattr(jl, name), getattr(pl, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for name in ("k", "num_vertices", "num_edges", "e_max", "l_max",
                 "h_max", "mirrors_total"):
        assert getattr(pl, name) == getattr(jl, name), name
    np.testing.assert_allclose(ps.run("pagerank"), js.run("pagerank"),
                               rtol=1e-5, atol=1e-8)
    assert ps.stats["num_clusters"] == js.stats["num_clusters"]


def test_engine_on_reference_layout(greedy_pair):
    """The port's stacked halo engine on exactly the JAX-built layout
    against the JAX simulate_gas (30 iterations), and both against the
    float64 oracle."""
    g, js, _ = greedy_pair
    lay = layout_from_reference(js.partition_layout)
    want = jax_simulate_gas(jax_pagerank(g.num_vertices),
                            js.partition_layout, 30, exchange="halo")
    got = simulate_gas(pagerank_program(g.num_vertices), lay, 30,
                       exchange="halo", device="cpu")
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-8)
    ref = reference_pagerank(g.src, g.dst, g.num_vertices, 30)
    assert np.abs(got - ref).sum() < 1e-5


def test_row_split_gather_matches_reference_local(greedy_pair):
    """K3 PageRank gather (row-split ELL + row → slot sum) against the
    reference's segment_sum ``_local_rank_partial`` on the same layout."""
    g, js, _ = greedy_pair
    jl = js.partition_layout
    rank = np.random.default_rng(0).random((jl.k, jl.l_max)) \
        .astype(np.float32) / g.num_vertices
    jdev = jax.tree_util.tree_map(jnp.asarray, jl.device_arrays("halo"))
    want = jax.vmap(jax_local)(jnp.asarray(rank), jdev)
    dev = stack_dev(layout_from_reference(jl), "halo", "cpu")
    got = _local_rank_partial(torch.from_numpy(rank), dev)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-12)


def test_session_game_rf_within_ten_percent_of_host_game():
    """With the game on (batched Jacobi on K2's plain version here) the
    RF is within 10% of the JAX np backend's Gauss–Seidel game — the
    ``bench_partitioning --check`` gate."""
    g = web_graph(scale=10, edge_factor=6, seed=2)
    js = JSession(JSessionConfig(clugp=JConfig.optimized(8, restream=1),
                                 backend="np"))
    js.partition(g.src, g.dst, g.num_vertices)
    ps = GraphSession(CLUGPConfig.optimized(8, restream=1), device="cpu")
    ps.partition(g.src, g.dst, g.num_vertices)
    assert ps.stats["rf"] <= 1.10 * js.stats["rf"], \
        (ps.stats["rf"], js.stats["rf"])
    assert ps.stats["game_rounds"] >= 1
    assert max(ps.stats["sizes"]) <= 1.1 * g.num_edges / 8 + 1


def test_config_from_reference_maps_and_refuses():
    blob = JSession(JSessionConfig(
        clugp=JConfig.optimized(64, restream=1, kernel="pallas",
                                cluster_kernel="xla"),
        backend="jit", iters=12)).to_json()
    cfg = config_from_reference(blob)
    assert cfg.backend == "torch" and cfg.iters == 12
    assert cfg.clugp.kernel == "cuda" and cfg.clugp.cluster_kernel == "torch"
    assert cfg.clugp.k == 64 and cfg.clugp.tau == 1.1 and cfg.clugp.restream == 1
    assert SessionConfig.from_json(cfg.to_json()) == cfg
    for bad in (JSessionConfig(clugp=JConfig(k=4, kernel="scan")),
                JSessionConfig(clugp=JConfig(k=4), backend="jit", nodes=2),
                JSessionConfig(clugp=JConfig(k=4), backend="sharded",
                               nodes=2)):
        with pytest.raises(ValueError, match="ROADMAP"):
            config_from_reference(bad.to_json())


def test_session_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        GraphSession(SessionConfig(clugp=CLUGPConfig(k=4)))
    assert GraphSession(SessionConfig(clugp=CLUGPConfig(k=4)),
                        device="cpu").device.type == "cpu"


def test_port_imports_neither_jax_nor_reference():
    """A fresh interpreter imports every port module and finds neither
    jax nor the reference package loaded; an AST scan of the sources and
    chip_smoke.py finds no such import either."""
    code = ("import sys, pkgutil, importlib, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "'jax.') or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
    files = list((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (f, n)


def test_cap_retries_match_reference():
    """A tiny V_max (k = 512 on 512 vertices) overflows both first-guess
    caps: the port grows id_cap and m_cap and lands on the reference jit
    backend's assignment."""
    g = web_graph(scale=9, edge_factor=5, seed=1)
    want = JSession(JSessionConfig(clugp=JConfig(k=512, game=False),
                                   backend="jit"))
    want.partition(g.src, g.dst, g.num_vertices)
    got = GraphSession(CLUGPConfig(k=512, game=False), device="cpu")
    got.partition(g.src, g.dst, g.num_vertices)
    assert got.stats["cap_retries"] >= 1
    assert got.stats["num_clusters"] == want.stats["num_clusters"]
    np.testing.assert_array_equal(got.assign, want.assign)


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py prints no result and exits non-zero when no CUDA
    device is visible, and when it stands alone outside the repository."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((REPO / "chip_smoke.py").read_text())
    for script in (REPO / "chip_smoke.py", alone):
        proc = subprocess.run([sys.executable, str(script)], env=env,
                              capture_output=True, text=True, timeout=120,
                              cwd=script.parent)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
