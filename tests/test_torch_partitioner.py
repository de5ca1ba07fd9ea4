"""The rest of the CLUGP partitioner in the port, held against the JAX
package on the CPU: the host game, clustering and transform (numpy
copies, bit for bit), the ``np`` backend with its node combine, the
Gauss–Seidel scan game on G's plain version (bit for bit from the
reference's start assignment, round counts equal), the k-sweep, the
baselines, ``theory``, ``expert_placement`` and the partition launcher.

Tolerances: every comparison here is exact (``==`` on arrays and stats),
except the launcher's printed RF and balance, which are compared as the
three-decimal strings both launchers print.  The device games draw their
random start from a ``torch.Generator``, so where the game is on the
tests inject the reference's ``jax.random`` start assignment.
"""
import dataclasses
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import CLUGPConfig as JConfig  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import clustering as jclu  # noqa: E402
from repro.core import expert_placement as jexp  # noqa: E402
from repro.core import game as jgame  # noqa: E402
from repro.core import partition as jpartition  # noqa: E402
from repro.core import partition_sweep as jsweep  # noqa: E402
from repro.core import stages as jstages  # noqa: E402
from repro.core import theory as jtheory  # noqa: E402
from repro.core import transform as jtrans  # noqa: E402
from repro.session import GraphSession as JSession  # noqa: E402
from repro.session import SessionConfig as JSessionConfig  # noqa: E402
from repro_torch.core import CLUGPConfig, web_graph  # noqa: E402
from repro_torch.core import baselines, clustering, expert_placement  # noqa: E402
from repro_torch.core import game, stages, theory  # noqa: E402
from repro_torch.core.transform import (majority_vertex_map_np,  # noqa: E402
                                        transform_np)
from repro_torch.core.partitioner import partition, partition_sweep  # noqa: E402
from repro_torch.kernels.game_gs import game_gs, game_gs_plain  # noqa: E402
from repro_torch.session import GraphSession, SessionConfig  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_start(seed, m_cap, k):
    """The reference scan game's random start (``jax_game_rounds_gs``)."""
    return _t(jax.random.randint(jax.random.PRNGKey(seed), (m_cap,), 0, k,
                                 dtype=jnp.int32))


@pytest.fixture(scope="module")
def g10():
    return web_graph(scale=10, edge_factor=6, seed=2)


@pytest.fixture(scope="module")
def cgs(g10):
    """The reference's contraction of a host clustering at k = 8, and the
    port's of the same labels."""
    vmax = max(2.0, g10.num_edges / 8)
    cr = jclu.streaming_clustering_np(g10.src, g10.dst, g10.num_vertices,
                                      vmax, split_degree_factor=4.0)
    return (jgame.contract(g10.src, g10.dst, cr.clu),
            game.contract(g10.src, g10.dst, cr.clu))


def _same_cg(a, b):
    np.testing.assert_array_equal(a.sizes, b.sizes)
    np.testing.assert_array_equal(a.vertex_cluster, b.vertex_cluster)
    assert a.m == b.m and (a.adj != b.adj).nnz == 0
    assert a.total_cut_capacity == b.total_cut_capacity


# ---------------------------------------------------------- host game

def test_contract_and_lambdas_match_reference(cgs):
    j, p = cgs
    _same_cg(j, p)
    for k in (4, 8, 64):
        assert game.lambda_max(p, k) == jgame.lambda_max(j, k)
        for w in (0.2, 0.5, 0.9):
            assert game.lambda_from_weight(p, k, w) == \
                jgame.lambda_from_weight(j, k, w)


@pytest.mark.parametrize("batch_size,base", [(None, False), (64, False),
                                             (None, True), (64, True)])
def test_best_response_rounds_matches_reference(cgs, batch_size, base):
    """The host Gauss–Seidel game: assignment, rounds, moves and the
    potential trace equal (f64 on both sides, the same operations)."""
    j, p = cgs
    k = 8
    loads = (np.random.default_rng(1).integers(0, 50, k) if base else None)
    kw = dict(batch_size=batch_size, seed=5, track_potential=True,
              base_loads=loads)
    want = jgame.best_response_rounds(j, k, **kw)
    got = game.best_response_rounds(p, k, **kw)
    np.testing.assert_array_equal(got.assign, want.assign)
    assert (got.rounds, got.moves, got.potential_trace) == \
        (want.rounds, want.moves, want.potential_trace)
    lam = jgame.lambda_max(j, k)
    assert game.potential(p, got.assign, k, lam) == \
        jgame.potential(j, want.assign, k, lam)
    assert game.global_cost(p, got.assign, k, lam) == \
        jgame.global_cost(j, want.assign, k, lam)
    assert got.rounds > 1


@pytest.mark.parametrize("k", [4, 8, 64])
def test_greedy_assign_np_matches_reference(cgs, k):
    j, p = cgs
    np.testing.assert_array_equal(game.greedy_assign_np(p, k),
                                  jgame.greedy_assign(j, k))


# ----------------------------------------------- host clustering, transform

@pytest.mark.parametrize("sdf,k", [(0.0, 8), (4.0, 8), (0.0, 1024)])
def test_streaming_clustering_np_matches_reference(g10, sdf, k):
    """Split factors 0 and 4; at k = 1024 V_max is 2 and the raw id
    space overflows the vertex count (more ids than vertices)."""
    vmax = max(2.0, g10.num_edges / k)
    want = jclu.streaming_clustering_np(g10.src, g10.dst, g10.num_vertices,
                                        vmax, split_degree_factor=sdf)
    got = clustering.streaming_clustering_np(g10.src, g10.dst,
                                             g10.num_vertices, vmax,
                                             split_degree_factor=sdf)
    for name in ("clu", "deg", "divided", "replicas"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.num_clusters == want.num_clusters
    assert got.cluster_rf(g10.num_vertices) == \
        want.cluster_rf(g10.num_vertices)
    assert got.replicas.sum() > 0
    if k == 1024:      # ids allocated = vertices seen + splits > V
        seen = int((got.deg > 0).sum())
        assert seen + int(got.replicas.sum()) > g10.num_vertices


def test_compact_labels_matches_reference():
    raw = np.array([5, -1, 9, 5, 2, 2, -1, 40], np.int64)
    got, m = clustering._compact_labels(raw)
    want, wm = jclu._compact_labels(raw)
    np.testing.assert_array_equal(got, want)
    assert m == wm == 4


@pytest.mark.parametrize("seeded", [False, True])
def test_transform_np_and_majority_match_reference(g10, seeded):
    rng = np.random.default_rng(3)
    V, k = g10.num_vertices, 8
    vp = rng.integers(0, k, V).astype(np.int32)
    deg = np.bincount(np.concatenate([g10.src, g10.dst]), minlength=V)
    div = rng.random(V) < 0.1
    kw = dict(loads=rng.integers(0, 300, k), lmax=1.1 * g10.num_edges / k
              + 250) if seeded else {}
    want = jtrans.transform_np(g10.src, g10.dst, vp, deg, div, k, 1.1, **kw)
    got = transform_np(g10.src, g10.dst, vp, deg, div, k, 1.1, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        majority_vertex_map_np(g10.src, g10.dst, got, V, k),
        jtrans.majority_vertex_map_np(g10.src, g10.dst, want, V, k))


# ------------------------------------------------------------ np backend

@pytest.mark.parametrize("nodes", [1, 3])
@pytest.mark.parametrize("game_on", [False, True])
@pytest.mark.parametrize("restream", [0, 1])
def test_np_backend_matches_reference(g10, nodes, game_on, restream):
    """Assignment and every stat of the reference (``restream_rf_trace``
    and ``per_node`` included); the result objects as the reference
    fills them."""
    jcfg = JConfig.optimized(8, restream=restream, game=game_on)
    cfg = CLUGPConfig.optimized(8, restream=restream, game=game_on)
    want = jpartition(g10.src, g10.dst, g10.num_vertices, jcfg,
                      backend="np", nodes=nodes)
    got = partition(g10.src, g10.dst, g10.num_vertices, cfg, backend="np",
                    nodes=nodes)
    np.testing.assert_array_equal(got.assign, want.assign)
    for key, value in want.stats.items():
        assert got.stats[key] == value, key
    assert got.stats["backend"] == "np" and got.game_rounds == \
        want.game_rounds
    if nodes == 1:
        np.testing.assert_array_equal(got.cluster_assign, want.cluster_assign)
        _same_cg(got.cluster_graph, want.cluster_graph)
        np.testing.assert_array_equal(got.clustering.clu, want.clustering.clu)
        assert "stage_seconds" in got.stats
    else:
        assert got.clustering is got.cluster_graph is got.cluster_assign \
            is None
        assert len(got.stats["per_node"]) == nodes
    if restream:
        assert len(got.stats["restream_rf_trace"]) == 2


def test_torch_backend_refuses_nodes_and_np_is_no_fallback(g10):
    cfg = CLUGPConfig(k=4)
    with pytest.raises(ValueError, match="one device"):
        partition(g10.src, g10.dst, g10.num_vertices, cfg, nodes=2,
                  device="cpu")
    with pytest.raises(ValueError, match="one device"):
        SessionConfig(clugp=cfg, backend="torch", nodes=2)
    with pytest.raises(ValueError, match="nodes"):
        SessionConfig(clugp=cfg, backend="np", nodes=0)
    sc = SessionConfig(clugp=cfg, backend="np", nodes=3)
    assert SessionConfig.from_json(sc.to_json()) == sc
    res = partition(g10.src, g10.dst, g10.num_vertices, cfg, device="cpu")
    assert res.stats["backend"] == "torch"


# --------------------------------------------------------- the scan game

@pytest.fixture(scope="module")
def scan_inputs(g10):
    """Per k, the reference's cluster graph of the g10 stream at that k
    (V_max = E/k, effective sizes), λ, and its aggregated pairs (an
    nnz_cap that holds them all)."""
    out = {}
    for k in (1, 4, 8, 64):
        vmax = max(2.0, g10.num_edges / k)
        clu, *_ = jclu.streaming_clustering_jax(g10.src, g10.dst,
                                                g10.num_vertices, vmax)
        cap = g10.num_vertices + 2 * g10.num_edges + 2
        compact, m = jclu.compact_labels_jax(clu, cap)
        m_cap = -(-int(m) // 256) * 256
        jg = jstages.cluster_graph_arrays(jnp.asarray(g10.src),
                                          jnp.asarray(g10.dst), compact,
                                          m_cap, True)
        lam = jstages.lambda_jax(jg.sizes.sum(), jg.n_cross, k, None)
        pairs = jgame.jax_cluster_csr(jg.xs, jg.xd, m_cap,
                                      2 * int(jg.n_cross) + 8)
        assert not bool(pairs[3])
        out[k] = (m_cap, jg, lam, pairs)
    return out


@pytest.mark.parametrize("k", [8, 64])
def test_cluster_pairs_match_reference(scan_inputs, k):
    """The same (row, col, w) set in the same order: the reference's
    compacted lanes up to its pad rows."""
    m_cap, jg, _, (row, col, w, _) = scan_inputs[k]
    pr, pc, pw = game.cluster_pairs(_t(jg.xs), _t(jg.xd), m_cap)
    n = int((np.asarray(row) < m_cap).sum())
    assert pr.shape[0] == n > 0
    np.testing.assert_array_equal(pr.numpy(), np.asarray(row)[:n])
    np.testing.assert_array_equal(pc.numpy(), np.asarray(col)[:n])
    np.testing.assert_array_equal(pw.numpy(), np.asarray(w)[:n])


@pytest.mark.parametrize("k", [1, 4, 8, 64])
def test_game_rounds_gs_matches_reference(scan_inputs, k):
    """From the reference's start assignment: the returned assignment and
    the round count equal (G's plain version on the CPU)."""
    m_cap, jg, lam, (row, col, w, _) = scan_inputs[k]
    seed = 3
    want, want_rounds = jgame.jax_game_rounds_gs(
        row, col, w, jg.sizes, jg.row_tot, k, lam, max_rounds=64, seed=seed)
    pr, pc, pw = game.cluster_pairs(_t(jg.xs), _t(jg.xd), m_cap)
    got, rounds = game.game_rounds_gs(
        pr, pc, pw, _t(jg.sizes), _t(jg.row_tot), k,
        torch.tensor([float(lam)]), max_rounds=64, seed=seed,
        assign0=_jax_start(seed, m_cap, k))
    assert rounds == int(want_rounds)
    assert k == 1 or rounds > 2
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_game_rounds_gs_matches_reference_where_phi_rounds():
    """Scale 13 at k = 64: Σ loads² is past 2²⁴, so the reference's f32
    sum of Φ rounds (in XLA's order) where the port sums in f64 and
    rounds once; no near-tie flips and the game is still equal, rounds
    and all."""
    g = web_graph(scale=13, edge_factor=8, seed=0)
    k, seed = 64, 3
    vmax = max(2.0, g.num_edges / k)
    clu, *_ = jclu.streaming_clustering_jax(g.src, g.dst, g.num_vertices,
                                            vmax)
    compact, m = jclu.compact_labels_jax(
        clu, g.num_vertices + 2 * g.num_edges + 2)
    m_cap = -(-int(m) // 256) * 256
    jg = jstages.cluster_graph_arrays(jnp.asarray(g.src), jnp.asarray(g.dst),
                                      compact, m_cap, True)
    lam = jstages.lambda_jax(jg.sizes.sum(), jg.n_cross, k, None)
    row, col, w, _ = jgame.jax_cluster_csr(jg.xs, jg.xd, m_cap,
                                           2 * int(jg.n_cross) + 8)
    want, want_rounds = jgame.jax_game_rounds_gs(
        row, col, w, jg.sizes, jg.row_tot, k, lam, max_rounds=64, seed=seed)
    loads = np.bincount(np.asarray(want), weights=np.asarray(jg.sizes),
                        minlength=k)
    assert (loads ** 2).sum() > 2 ** 24
    pr, pc, pw = game.cluster_pairs(_t(jg.xs), _t(jg.xd), m_cap)
    got, rounds = game.game_rounds_gs(
        pr, pc, pw, _t(jg.sizes), _t(jg.row_tot), k,
        torch.tensor([float(lam)]), max_rounds=64, seed=seed,
        assign0=_jax_start(seed, m_cap, k))
    assert rounds == int(want_rounds) > 2
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sweep_skips_only_rows_that_cannot_move(scan_inputs):
    """G walks the rows up to the last live one: the same sweep over
    every row (the pad rows included) and over the live prefix gives the
    same assignment, loads and move count."""
    k = 8
    m_cap, jg, lam, _ = scan_inputs[k]
    pr, pc, pw = game.cluster_pairs(_t(jg.xs), _t(jg.xd), m_cap)
    sizes, row_tot = _t(jg.sizes), _t(jg.row_tot)
    assign = _jax_start(0, m_cap, k)
    aff = torch.zeros(m_cap, k).index_put_((pr, assign[pc].long()), pw,
                                           accumulate=True)
    loads = torch.zeros(k).index_add_(0, assign.long(), sizes)
    n = int(torch.nonzero((sizes != 0) | (row_tot != 0)).max()) + 1
    assert n < m_cap
    lam_t = torch.tensor([float(lam)])
    full = game_gs_plain(aff, sizes, row_tot, assign, loads, lam=lam_t, k=k)
    part = game_gs(aff, sizes, row_tot, assign, loads, lam=lam_t, k=k, n=n)
    for a, b in zip(full, part):
        assert torch.equal(a, b)
    assert int(full[2]) > 0


def test_resolve_game_mode_falls_back_as_the_reference():
    """``scan`` falls back above the pair-key limit (m_cap ≤ 46,340 keeps
    it), to the Jacobi CSR game where the reference takes ``xla``; the
    port's ``auto`` is the Jacobi CSR game, the reference's (off a TPU)
    the scan."""
    for m_cap in (256, 46336, 46340, 46341, 46592, 262144):
        want = jstages.resolve_game_mode("scan", m_cap)
        got = stages.resolve_game_mode("scan", m_cap)
        assert (got, want) in (("scan", "scan"), ("cuda", "xla")), m_cap
        assert stages.resolve_game_mode("auto", m_cap) == "cuda"
    assert stages.resolve_game_mode("scan", 46340) == "scan"
    assert stages.resolve_game_mode("scan", 46341) == "cuda"
    with pytest.raises(ValueError, match="kernel"):
        CLUGPConfig(k=4, cluster_kernel="scan")


@pytest.fixture
def jax_starts(monkeypatch):
    """The device games' default start drawn as the reference draws it."""
    monkeypatch.setattr(game, "start_assignment",
                        lambda m_cap, k, seed, device:
                        _jax_start(seed, m_cap, k))


def test_scan_session_matches_reference_jit_session(g10, jax_starts):
    """A ``kernel="scan"`` session, converted from the config blob of the
    reference's jit session with the scan game, gives its partition."""
    from repro_torch.convert import config_from_reference
    jcfg = JConfig.optimized(8, restream=1, kernel="scan", seed=2)
    js = JSession(JSessionConfig(clugp=jcfg, backend="jit"))
    js.partition(g10.src, g10.dst, g10.num_vertices)
    cfg = config_from_reference(js.to_json())
    assert cfg.backend == "torch" and cfg.clugp.kernel == "scan"
    ps = GraphSession(cfg, device="cpu")
    ps.partition(g10.src, g10.dst, g10.num_vertices)
    np.testing.assert_array_equal(ps.assign, js.assign)
    for key in ("rf", "balance", "sizes", "num_clusters", "game_rounds"):
        assert ps.stats[key] == js.stats[key], key
    assert ps.stats["game_rounds"] > 1


# ------------------------------------------------------------- the sweep

@pytest.mark.parametrize("game_on", [False, True])
def test_partition_sweep_matches_reference(g10, game_on, jax_starts):
    """ks = (4, 8, 16): the reference's stacked sweep (k_max-padded
    lanes, traced k) against the port's per-k bodies.  Game off, bit for
    bit; game on (the scan, as the reference plays it on the CPU), from
    the reference's start draws at the sweep's m_cap.  No near-tie of Φ's
    sum over the padded lanes flips here: the sums are exact at this
    size."""
    ks = (4, 8, 16)
    jcfg = JConfig.optimized(8, restream=1, game=game_on)
    cfg = CLUGPConfig.optimized(8, restream=1, game=game_on, kernel="scan")
    want = jsweep(g10.src, g10.dst, g10.num_vertices, jcfg, ks)
    got = partition_sweep(g10.src, g10.dst, g10.num_vertices, cfg, ks,
                          device="cpu")
    for k, w, p in zip(ks, want, got):
        np.testing.assert_array_equal(p.assign, w.assign, err_msg=str(k))
        for key, value in w.stats.items():
            if key != "backend":
                assert p.stats[key] == value, (k, key)
        assert p.stats["backend"] == "torch" and p.stats["sweep"]
        assert p.stats["k_max"] == 16
        assert (p.stats["game_rounds"] > 1) == game_on


def test_run_sweep_matches_reference_session(g10):
    """``run_sweep`` returns ``{k: result}`` equal to the reference
    session's (game off) and leaves the session on the last k, which
    ``layout()`` then builds; ``vmax`` is resolved per k."""
    ks = (16, 4, 8)
    jcfg = JConfig.optimized(8, game=False, split_degree_factor=4.0)
    js = JSession(JSessionConfig(clugp=jcfg, backend="jit"))
    want = js.run_sweep(g10.src, g10.dst, g10.num_vertices, ks)
    ps = GraphSession(CLUGPConfig.optimized(8, game=False,
                                            split_degree_factor=4.0),
                      device="cpu")
    got = ps.run_sweep(g10.src, g10.dst, g10.num_vertices, ks)
    assert list(got) == list(want) == list(ks)
    for k in ks:
        np.testing.assert_array_equal(got[k].assign, want[k].assign)
        assert got[k].stats["num_clusters"] == want[k].stats["num_clusters"]
        single = partition(g10.src, g10.dst, g10.num_vertices,
                           dataclasses.replace(ps.cfg.clugp, k=k),
                           device="cpu")
        np.testing.assert_array_equal(single.assign, got[k].assign)
    assert ps.k == js.k == 8
    np.testing.assert_array_equal(ps.assign, js.assign)
    assert ps.layout().partition_layout.k == 8


# ------------------------------------------------- baselines, theory, MoE

@pytest.mark.parametrize("name", sorted(baselines.ALL_BASELINES))
def test_baselines_match_reference(name):
    g = web_graph(scale=9, edge_factor=5, seed=4)
    for k in (8, 70):              # 70 lanes: two bitmask words
        got = baselines.ALL_BASELINES[name](g.src, g.dst, g.num_vertices, k)
        want = jbase.ALL_BASELINES[name](g.src, g.dst, g.num_vertices, k)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert set(baselines.ALL_BASELINES) == set(jbase.ALL_BASELINES)
    np.testing.assert_array_equal(
        baselines.hashing(g.src, g.dst, g.num_vertices, 8, seed=7),
        jbase.hashing(g.src, g.dst, g.num_vertices, 8, seed=7))


def test_theory_matches_reference(cgs):
    j, p = cgs
    rs = np.arange(2, 9)
    np.testing.assert_array_equal(theory.d_min_clugp(rs, 512.0, 40.0),
                                  jtheory.d_min_clugp(rs, 512.0, 40.0))
    np.testing.assert_array_equal(theory.d_min_holl(rs),
                                  jtheory.d_min_holl(rs))
    for fn in ("d_min_holl",):
        assert theory.rf_upper_bound(64, 3.0, 2.1, getattr(theory, fn)) == \
            jtheory.rf_upper_bound(64, 3.0, 2.1, getattr(jtheory, fn))
    assert theory.rf_upper_bound(64, 3.0, 2.1, theory.d_min_clugp,
                                 vmax=512.0, dmax=40.0) == \
        jtheory.rf_upper_bound(64, 3.0, 2.1, jtheory.d_min_clugp,
                               vmax=512.0, dmax=40.0)
    assert theory.game_round_bound(p) == jtheory.game_round_bound(j)
    assert (theory.poa_bound(8), theory.pos_bound()) == \
        (jtheory.poa_bound(8), jtheory.pos_bound())
    tiny = jgame.ClusterGraph(np.array([3, 1, 2, 5]), j.adj[:4, :4],
                              np.arange(4), 4)
    ptiny = game.ClusterGraph(tiny.sizes, tiny.adj, tiny.vertex_cluster, 4)
    assert theory.brute_force_optimum(ptiny, 3, 0.7) == \
        jtheory.brute_force_optimum(tiny, 3, 0.7)
    deg = np.bincount(np.asarray(j.vertex_cluster) % 97)
    assert theory.fit_power_law_alpha(deg) == \
        jtheory.fit_power_law_alpha(deg)


def test_expert_placement_matches_reference():
    rng = np.random.default_rng(0)
    n_experts, shards = 32, 4
    topic = rng.integers(0, 4, 600)
    top = np.stack([(topic * 8 + rng.integers(0, 10, 600)) % n_experts
                    for _ in range(3)], 1)
    top[:, 0] = 0            # a shared expert that co-fires with all
    _same_cg(expert_placement.coactivation_graph(top, n_experts),
             jexp.coactivation_graph(top, n_experts))
    perm = expert_placement.place_experts(top, n_experts, shards, seed=1)
    np.testing.assert_array_equal(
        perm, jexp.place_experts(top, n_experts, shards, seed=1))
    shard_of = perm // (n_experts // shards)
    assert expert_placement.a2a_volume(top, shard_of, shards) == \
        jexp.a2a_volume(top, shard_of, shards)
    assert sorted(perm.tolist()) == list(range(n_experts))


# -------------------------------------------------------------- launcher

def _rf_balance(out):
    line = [ln for ln in out.splitlines() if " rf=" in ln][-1]
    return line.split(": ", 1)[0], [w for w in line.split()
                                    if w.startswith(("rf=", "balance="))]


@pytest.mark.parametrize("algo,backend", [("clugp-opt", "np"),
                                          ("clugp-opt", "jit"),
                                          ("clugp-parallel", "np"),
                                          ("hdrf", "np")])
def test_launcher_prints_the_reference_rf_and_balance(algo, backend,
                                                      monkeypatch, capsys):
    """``--scale 9 --k 8`` through both launchers: the same label, RF and
    balance (exact, as the three-decimal strings both print).  ``--backend
    jit`` plays the reference's off-TPU game, the scan, from the
    reference's start draw."""
    from repro.launch import partition as jlaunch
    from repro_torch.launch import partition as plaunch
    argv = ["--scale", "9", "--k", "8", "--algo", algo, "--backend",
            backend]
    monkeypatch.setattr(sys, "argv", ["partition"] + argv)
    jlaunch.main()
    want = capsys.readouterr().out
    if backend == "jit":
        monkeypatch.setattr(game, "start_assignment",
                            lambda m_cap, k, seed, device:
                            _jax_start(seed, m_cap, k))
    assert plaunch.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _rf_balance(got) == _rf_balance(want)
    assert got.splitlines()[0] == want.splitlines()[0]      # graph: V= E=


def test_launcher_default_is_the_torch_backend_on_the_scan_game(
        monkeypatch, capsys):
    """With no ``--backend`` the launcher partitions on the torch backend
    (the device path, here on ``--device cpu``) with the scan game on G,
    and prints the reference launcher's ``--backend jit`` RF and balance
    exactly, from the reference's start draw.  The host oracle is never
    run."""
    from repro.launch import partition as jlaunch
    from repro_torch.core import partitioner
    from repro_torch.launch import partition as plaunch
    argv = ["--scale", "9", "--k", "8"]
    monkeypatch.setattr(sys, "argv", ["partition"] + argv + ["--backend",
                                                             "jit"])
    jlaunch.main()
    want = capsys.readouterr().out
    monkeypatch.setattr(game, "start_assignment",
                        lambda m_cap, k, seed, device:
                        _jax_start(seed, m_cap, k))
    sweeps = []
    monkeypatch.setattr(game, "game_gs",
                        lambda *a, **kw: sweeps.append(1) or game_gs(*a, **kw))

    def no_host(*a, **kw):
        raise AssertionError("the default ran the host oracle")
    monkeypatch.setattr(partitioner, "_run_np", no_host)
    args = plaunch.build_parser().parse_args(argv + ["--device", "cpu"])
    assert (args.backend, args.device) == ("jit", "cpu")
    assert plaunch.build_parser().parse_args([]).device == "cuda"
    assert plaunch.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert _rf_balance(got) == _rf_balance(want)
    assert _rf_balance(got)[0] == "clugp-opt[jit, restream=0]"
    assert sweeps


def test_launcher_pagerank_lines_and_refusals(capsys):
    from repro_torch.launch import partition as plaunch
    assert plaunch.main(["--scale", "8", "--k", "4", "--backend", "jit",
                         "--pagerank", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "interior/frontier: frac=" in out
    line = [ln for ln in out.splitlines() if ln.startswith("pagerank[halo]")]
    assert line and "comm/iter: ideal=" in line[0]
    err = float(line[0].split("max|err|=")[1].split()[0])
    assert err < 1e-6
    with pytest.raises(SystemExit, match="nodes"):
        plaunch.main(["--backend", "sharded", "--nodes", "0", "--device",
                      "cpu"])
