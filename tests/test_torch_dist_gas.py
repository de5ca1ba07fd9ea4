"""The port's per-rank GAS engine (``shard_map_gas``, ``shard_map_gas_many``,
``shard_map_pagerank``, ``shard_map_cc``) and the per-rank halves of the
five wires (``repro_torch.dist.halo``), one partition a rank with 8
ranks spawned on the CPU over gloo, on a scale-10 web graph at k = 8.

Tolerances:
- against the reference's own ``shard_map_pagerank``/``shard_map_cc`` on
  dense and halo (run in a subprocess on 8 XLA host devices): pagerank
  within 1e-6 max-abs, cc bit for bit;
- against the port's stacked halves (``simulate_*``) on all five wires,
  fused bundles, ``tol``, warm start and ``overlap``: bit for bit (the
  per-rank halves combine received lanes in rank order, the global
  scalars are added in rank order and a rank's K3 table takes the
  layout's row width);
- against the reference's ``simulate_*`` on quantized, ragged and
  ragged_quantized (the reference's shard_map fails on them with this
  jax): ``tests/test_torch_exchange.py``'s rules — integers bit for bit,
  ragged rtol 1e-5, quantized 1e-6 max-abs, ragged_quantized within 1%
  of JAX's own distance to the float64 oracle plus rtol 1e-5; its fused
  f32 bundle within 1.25× JAX's own max-abs distance to the oracle plus
  1e-7 (an ulp flips a top-Δ choice and moves single lanes by up to 2%
  where JAX's own centrality is 9e-3 from the oracle); the fused
  quantized wire 5e-4 of the oracle;
- ``tol``: iterations within ±1 of the reference's;
- bytes: the bytes every rank hands to the wire in one iteration equal
  ``layout.comm_bytes(exchange)`` on halo, quantized, ragged and
  ragged_quantized; on dense they are (k−1)/k of it (the model counts
  the block a rank gathers from itself, which never leaves it).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import web_graph  # noqa: E402
from repro_torch.dist import halo as phalo  # noqa: E402
from repro_torch.graph import engine as P  # noqa: E402
from repro_torch.graph.partition import build_layout  # noqa: E402
from repro_torch.dist.mesh import run_on_ranks  # noqa: E402
from repro_torch.launch.mesh import make_graph_mesh  # noqa: E402
from repro_torch.serve import GraphServer  # noqa: E402
from repro_torch.session import GraphSession, SessionConfig  # noqa: E402
from repro_torch.core import CLUGPConfig  # noqa: E402

# the spawned ranks import this module to find their job: the JAX
# package is imported by the fixtures only, so a rank starts without it
K, ITERS, TIMEOUT = 8, 12, 240
WIRES = phalo.EXCHANGE_NAMES
NEW = ("quantized", "ragged", "ragged_quantized")
F32_BUNDLE = ("pagerank", "ppr", "centrality")
I32_BUNDLE = ("cc", "labelprop", "sssp", "bfs")

REF_CODE = """
import numpy as np, jax
import repro.graph as J
d = np.load(%(path)r)
lay = J.build_layout(d["src"], d["dst"], d["assign"], int(d["n"]), %(k)d)
mesh = jax.make_mesh((%(k)d,), ("parts",))
out = {}
for ex in ("dense", "halo"):
    out[f"pagerank_{ex}"] = J.shard_map_pagerank(lay, mesh, %(iters)d,
                                                 exchange=ex)
    out[f"cc_{ex}"] = J.shard_map_cc(lay, mesh, %(iters)d, exchange=ex)
np.savez(%(out)r, **out)
print("REF_OK")
"""


@pytest.fixture(scope="module")
def J():
    """The reference's graph package (``repro.graph``)."""
    import repro.graph
    return repro.graph


@pytest.fixture(scope="module")
def case(J):
    from repro.core import CLUGPConfig as JConfig
    from repro.core import partition as j_partition
    g = web_graph(scale=10, edge_factor=6, seed=3)
    res = j_partition(g.src, g.dst, g.num_vertices, JConfig.optimized(K))
    n = g.num_vertices
    return dict(src=g.src, dst=g.dst, n=n, assign=res.assign,
                pl=build_layout(g.src, g.dst, res.assign, n, K),
                jl=J.build_layout(g.src, g.dst, res.assign, n, K))


def _programs(names, n):
    return [P.get_program(p, n) for p in names]


def _batch(mesh, pl):
    """Every per-rank run of this file in one spawn of k ranks (SPMD on
    the bound mesh; rank 0 holds the values)."""
    n = pl.num_vertices
    out = {}
    for ex in WIRES:
        for name in ("pagerank", "cc"):
            out[ex, name] = P.shard_map_gas(P.get_program(name, n), pl, mesh,
                                            ITERS, exchange=ex,
                                            return_wire=True)
        for tag, bundle in (("f32", F32_BUNDLE), ("i32", I32_BUNDLE)):
            out[ex, tag] = P.shard_map_gas_many(_programs(bundle, n), pl,
                                                mesh, ITERS, exchange=ex)
    out["pagerank_helper"] = P.shard_map_pagerank(pl, mesh, ITERS, "parts",
                                                  "halo")
    out["cc_helper"] = P.shard_map_cc(pl, mesh, ITERS, "parts", "ragged")
    pr = P.pagerank_program(n)
    out["tol"] = P.shard_map_gas(pr, pl, mesh, 200, exchange="halo",
                                 tol=1e-6, return_iters=True)
    # every rank seeds from the same vector: the stacked run's fixed point
    seed = P.simulate_gas(pr, pl, 200, "halo", tol=1e-6, device="cpu")
    out["warm"] = P.shard_map_gas(pr, pl, mesh, 200, exchange="halo",
                                  tol=1e-6, return_iters=True,
                                  init_values=seed)
    for ex in phalo.RAGGED_EXCHANGES:
        out["overlap", ex] = P.shard_map_gas(pr, pl, mesh, ITERS,
                                             exchange=ex, overlap=True)
        out["overlap_many", ex] = P.shard_map_gas_many(
            _programs(F32_BUNDLE, n), pl, mesh, ITERS, exchange=ex,
            overlap=True)
    return out


@pytest.fixture(scope="module")
def ranks(case):
    return run_on_ranks(_batch, make_graph_mesh(K, device="cpu"), case["pl"],
                        timeout=TIMEOUT)


@pytest.fixture(scope="module")
def ref(case, tmp_path_factory):
    from conftest import run_multidevice
    d = tmp_path_factory.mktemp("gasref")
    np.savez(d / "in.npz", src=case["src"], dst=case["dst"],
             assign=case["assign"], n=case["n"])
    out = run_multidevice(REF_CODE % {"path": str(d / "in.npz"),
                                      "out": str(d / "out.npz"), "k": K,
                                      "iters": ITERS},
                          n_devices=K, timeout=TIMEOUT)
    assert "REF_OK" in out
    return dict(np.load(d / "out.npz"))


def _stacked(case, name, ex, **kw):
    return P.simulate_gas(P.get_program(name, case["n"]), case["pl"],
                          kw.pop("iters", ITERS), ex, device="cpu", **kw)


@pytest.mark.multidevice
@pytest.mark.parametrize("exchange", ["dense", "halo"])
@pytest.mark.parametrize("name", ["pagerank", "cc"])
def test_shard_map_matches_reference_shard_map(multidevice, ref, ranks,
                                               exchange, name):
    got, _ = ranks[exchange, name]
    want = ref[f"{name}_{exchange}"]
    if name == "cc":
        np.testing.assert_array_equal(got.astype(np.int64), want)
    else:
        assert got.dtype == want.dtype
        assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("exchange", WIRES)
@pytest.mark.parametrize("name", ["pagerank", "cc"])
def test_shard_map_equals_stacked_halves(case, ranks, exchange, name):
    got, _ = ranks[exchange, name]
    np.testing.assert_array_equal(got, _stacked(case, name, exchange))


@pytest.mark.parametrize("exchange", NEW)
@pytest.mark.parametrize("name", ["pagerank", "cc"])
def test_shard_map_new_wires_match_reference_simulation(J, case, ranks,
                                                        exchange, name):
    got, _ = ranks[exchange, name]
    want = np.asarray(J.simulate_gas(J.get_program(name, case["n"]),
                                     case["jl"], ITERS, exchange=exchange))
    assert got.dtype == want.dtype
    if name == "cc":
        np.testing.assert_array_equal(got, want)
    elif exchange == "quantized":
        assert np.abs(got - want).max() <= 1e-6
    elif exchange == "ragged":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    else:
        oracle = P.reference_pagerank(case["src"], case["dst"], case["n"],
                                      ITERS)
        gap = float(np.abs(want - oracle).max())
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=0.01 * gap + 1e-9)


@pytest.mark.parametrize("exchange", WIRES)
@pytest.mark.parametrize("tag", ["f32", "i32"])
def test_fused_bundles_on_ranks(J, case, ranks, exchange, tag):
    bundle = F32_BUNDLE if tag == "f32" else I32_BUNDLE
    gots = ranks[exchange, tag]
    stacked = P.simulate_gas_many(_programs(bundle, case["n"]), case["pl"],
                                  ITERS, exchange=exchange, device="cpu")
    for name, got, want in zip(bundle, gots, stacked):
        np.testing.assert_array_equal(got, want, err_msg=name)
    if exchange == "quantized" and tag == "f32":
        for name, got in zip(bundle, gots):
            oracle = getattr(P, f"reference_{name}")(
                case["src"], case["dst"], case["n"], ITERS)
            assert np.abs(got - oracle).max() < 5e-4, name
    if exchange == "ragged_quantized":
        wants = J.simulate_gas_many([J.get_program(p, case["n"])
                                     for p in bundle], case["jl"], ITERS,
                                    exchange=exchange)
        for name, got, want in zip(bundle, gots, wants):
            want = np.asarray(want)
            if tag == "i32":
                np.testing.assert_array_equal(got, want)
                continue
            oracle = getattr(P, f"reference_{name}")(
                case["src"], case["dst"], case["n"], ITERS)
            gap = float(np.abs(want - oracle).max())
            assert np.abs(got - oracle).max() <= 1.25 * gap + 1e-7, name


def test_helpers_tol_and_warm_start_on_ranks(J, case, ranks):
    np.testing.assert_array_equal(ranks["pagerank_helper"],
                                  _stacked(case, "pagerank", "halo"))
    np.testing.assert_array_equal(ranks["cc_helper"],
                                  _stacked(case, "cc", "ragged")
                                  .astype(np.int64))
    (cold, it_cold), (warm, it_warm) = ranks["tol"], ranks["warm"]
    s_cold, s_it = _stacked(case, "pagerank", "halo", iters=200, tol=1e-6,
                            return_iters=True)
    np.testing.assert_array_equal(cold, s_cold)
    assert it_cold == s_it
    _, j_it = J.simulate_gas(J.pagerank_program(case["n"]), case["jl"], 200,
                             exchange="halo", tol=1e-6, return_iters=True)
    assert abs(it_cold - int(j_it)) <= 1
    assert it_warm < it_cold
    s_warm, s_wit = _stacked(case, "pagerank", "halo", iters=200, tol=1e-6,
                             init_values=s_cold, return_iters=True)
    np.testing.assert_array_equal(warm, s_warm)
    assert it_warm == s_wit


@pytest.mark.parametrize("exchange", phalo.RAGGED_EXCHANGES)
def test_overlap_on_ranks_is_bit_identical(case, ranks, exchange):
    plain, _ = ranks[exchange, "pagerank"]
    np.testing.assert_array_equal(ranks["overlap", exchange], plain)
    np.testing.assert_array_equal(
        ranks["overlap", exchange],
        _stacked(case, "pagerank", exchange, overlap=True))
    for got, want in zip(ranks["overlap_many", exchange],
                         ranks[exchange, "f32"]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("exchange", WIRES)
@pytest.mark.parametrize("name", ["pagerank", "cc"])
def test_counted_bytes_equal_the_comm_model(case, ranks, exchange, name):
    """Bytes every rank handed to the wire an iteration, against the
    model.  cc (min, int32) rides the exact halo / ragged wire on the
    quantized ones, as the model's ``lossy=False`` counts it."""
    _, wire = ranks[exchange, name]
    lossy = name == "pagerank"
    site = exchange if lossy else {"quantized": "halo",
                                   "ragged_quantized": "ragged"}.get(
        exchange, exchange)
    counted = sum(w["collectives"][f"{site}.{phase}"]["bytes"]
                  for w in wire for phase in ("reduce", "broadcast"))
    assert counted % ITERS == 0
    model = case["pl"].comm_bytes(exchange, lossy=lossy)
    if exchange == "dense":
        assert counted // ITERS * K == model * (K - 1)
    else:
        assert counted // ITERS == model
    # each rank called the wire twice an iteration (ragged: once a hop)
    calls = {w["collectives"][f"{site}.reduce"]["calls"] for w in wire}
    assert all(w["loop_seconds"] > 0 for w in wire)
    # K3 gathers pagerank once an iteration on every rank (the CPU
    # wrapper runs the plain version and counts nothing)
    assert all(w["launches"] == {} for w in wire)
    hops = sum(1 for h in case["pl"].halo_schedule() if h)
    per_phase = {"ragged": hops, "ragged_quantized": 3 * hops,
                 "quantized": 2}.get(site, 1)
    assert calls == {ITERS * per_phase}


def test_session_and_server_with_a_mesh_match_the_stacked_engine(case):
    mesh = make_graph_mesh(K, device="cpu")
    sess = GraphSession(SessionConfig(clugp=CLUGPConfig(k=K),
                                      exchange="ragged", iters=ITERS),
                        device="cpu")
    sess.with_partition(case["src"], case["dst"], case["n"], case["assign"])
    np.testing.assert_array_equal(sess.run("pagerank", mesh=mesh),
                                  sess.run("pagerank"))
    servers = [GraphServer(sess, mesh=m) for m in (mesh, None)]
    replies = []
    for srv in servers:
        tickets = [srv.submit("score", program="pagerank", vertices=[0, 5]),
                   srv.submit("score", program="ppr", vertices=[1]),
                   srv.submit("label", vertices=[3, 7])]
        srv.step()
        replies.append([srv.result(t) for t in tickets])
    for a, b in zip(*replies):
        assert a.error is None and b.error is None
        np.testing.assert_array_equal(np.asarray(a.value),
                                      np.asarray(b.value))


def test_get_exchange_with_an_axis_gives_per_rank_halves(case):
    mesh = make_graph_mesh(K, device="cpu")
    for name in WIRES:
        ex = phalo.get_exchange(name, case["pl"], axis=mesh)
        assert ex.axis is mesh
        for half in ("init_state_rank", "init_state_rank_multi",
                     "reduce_to_masters", "reduce_to_masters_multi",
                     "broadcast_from_masters",
                     "broadcast_from_masters_multi"):
            assert callable(getattr(ex, half)), (name, half)
    with pytest.raises(ValueError, match="k = 8"):
        P.shard_map_gas(P.CC_PROGRAM, case["pl"],
                        make_graph_mesh(4, device="cpu"))
