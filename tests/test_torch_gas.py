"""The port's GAS program library (``repro_torch.graph.engine``) and its
exchanges (``repro_torch.dist.halo``: dense and halo, sum and min
combines, the multi-program halves) held against the JAX package on
layouts both builders make from the same (src, dst, assign): every
program on both exchanges, fused bundles, early exit, warm start, the
min identity fill, and the session calls that reach them.

Integer programs (cc, labelprop, sssp, bfs, degree) must match bit for
bit; the f32 programs (pagerank, ppr, centrality) gather on K3's plain
version in another summation order and are held to rtol 1e-5."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.dist.halo as jhalo  # noqa: E402
import repro.graph as J  # noqa: E402
import repro_torch.dist.halo as phalo  # noqa: E402
import repro_torch.graph as P  # noqa: E402
from repro.session import GraphSession as JSession  # noqa: E402
from repro.session import SessionConfig as JSessionConfig  # noqa: E402
from repro.core import CLUGPConfig as JConfig  # noqa: E402
from repro_torch.convert import config_from_reference  # noqa: E402
from repro_torch.core import web_graph  # noqa: E402
from repro_torch.graph.engine import _residual  # noqa: E402
from repro_torch.launch.mesh import make_graph_mesh  # noqa: E402
from repro_torch.session import GraphSession  # noqa: E402

from conftest import random_graph_and_assign  # noqa: E402

EXCHANGES = ("dense", "halo")
INT_PROGRAMS = ("cc", "labelprop", "sssp", "bfs", "degree")
# tests/test_graph_programs.py's budgets: the int programs need the
# frontier to close
ITERS = {"pagerank": 30, "cc": 40, "labelprop": 40, "sssp": 40, "bfs": 40,
         "degree": 2, "centrality": 30, "ppr": 30}
F32_BUNDLE = ("pagerank", "ppr", "centrality")     # the f32 programs
I32_BUNDLE = ("cc", "labelprop", "sssp", "bfs")
SENT = P.CC_SENTINEL
# early exit for the f32 programs: a residual of 2e-6 lies clear of the
# last-bit noise of these cases (at 1e-7 centrality's residual hovers at
# its f32 floor and the exits of two summation orders drift apart), so the
# iteration counts are held within ±1 and the values within one exit's
# residual
F32_TOL = 2e-6


def _pair(src, dst, n, assign, k=8):
    return dict(src=src, dst=dst, n=n,
                jl=J.build_layout(src, dst, assign, n, k),
                pl=P.build_layout(src, dst, assign, n, k))


@pytest.fixture(scope="module")
def layouts():
    """tests/test_graph_programs.py's ``case`` (400-vertex Zipf digraph,
    random assignment, k = 8) and a scale-10 web graph under a seeded
    random assignment."""
    case = _pair(*random_graph_and_assign(0, 8, n=400))
    g = web_graph(scale=10, edge_factor=6, seed=3)
    assign = np.random.default_rng(3).integers(0, 8, g.num_edges) \
        .astype(np.int32)
    return {"case": case, "web10": _pair(g.src, g.dst, g.num_vertices,
                                         assign)}


@pytest.fixture(scope="module")
def case(layouts):
    return layouts["case"]


def _same(got, want, name):
    want = np.asarray(want)
    if name in INT_PROGRAMS:
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    else:
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def _oracle(c, name, iters=None):
    src, dst, n = c["src"], c["dst"], c["n"]
    it = ITERS[name] if iters is None else iters
    return {"pagerank": lambda m: m.reference_pagerank(src, dst, n, it),
            "cc": lambda m: m.reference_cc(src, dst, n),
            "labelprop": lambda m: m.reference_labelprop(src, dst, n, it),
            "sssp": lambda m: m.reference_sssp(src, dst, n, it),
            "bfs": lambda m: m.reference_bfs(src, dst, n, it),
            "degree": lambda m: m.reference_degree(src, dst, n),
            "centrality": lambda m: m.reference_centrality(src, dst, n, it),
            "ppr": lambda m: m.reference_ppr(src, dst, n, it)}[name]


# ------------------------------------------------- program × exchange matrix

@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("name", P.PROGRAM_NAMES)
@pytest.mark.parametrize("which", ("case", "web10"))
def test_program_matches_jax(layouts, which, name, exchange):
    c = layouts[which]
    want = J.simulate_gas(J.get_program(name, c["n"]), c["jl"], ITERS[name],
                          exchange=exchange)
    got = P.simulate_gas(P.get_program(name, c["n"]), c["pl"], ITERS[name],
                         exchange=exchange, device="cpu")
    _same(got, want, name)


@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("name", P.PROGRAM_NAMES)
def test_program_matches_port_oracle(case, name, exchange):
    got = P.simulate_gas(P.get_program(name, case["n"]), case["pl"],
                         ITERS[name], exchange=exchange, device="cpu")
    ref = _oracle(case, name)(P)
    if name in INT_PROGRAMS:
        np.testing.assert_array_equal(got.astype(np.int64), ref)
    else:
        assert np.abs(got - ref).max() < 1e-5


@pytest.mark.parametrize("name", P.PROGRAM_NAMES)
def test_port_oracle_matches_jax_oracle(case, name):
    """The port's numpy oracles (minimum.reduceat by destination,
    bincount sums) compute the reference's: the same integers, the f64
    sums in the same edge order."""
    got, want = _oracle(case, name)(P), _oracle(case, name)(J)
    if name in INT_PROGRAMS:
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_unreached_vertices_keep_the_sentinel(case):
    """sssp from vertex 0: whatever the oracle cannot reach stays at the
    int32 sentinel on both exchanges (the min identity is never replaced
    by a zero fill)."""
    ref = P.reference_sssp(case["src"], case["dst"], case["n"], 40)
    assert (ref == SENT).any()
    for ex in EXCHANGES:
        got = P.simulate_gas(P.sssp_program(), case["pl"], 40, exchange=ex,
                             device="cpu")
        assert (got[ref == SENT] == SENT).all() and got[0] == 0


# ------------------------------------------------------------ fused bundles

@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("bundle", (F32_BUNDLE, I32_BUNDLE),
                         ids=("f32", "i32"))
def test_fused_bundle_matches_jax(case, bundle, exchange):
    iters = 30 if bundle == F32_BUNDLE else 40
    want = J.simulate_gas_many([J.get_program(p, case["n"]) for p in bundle],
                               case["jl"], iters, exchange=exchange)
    got = P.simulate_gas_many([P.get_program(p, case["n"]) for p in bundle],
                              case["pl"], iters, exchange=exchange,
                              device="cpu")
    assert len(got) == len(bundle)
    for g, w, name in zip(got, want, bundle):
        _same(g, w, name)


@pytest.mark.parametrize("exchange", EXCHANGES)
def test_fused_bundles_match_single_runs(case, exchange):
    """The i32 bundle equals its programs run singly bit for bit; the f32
    bundle within rtol 1e-5 (the same sums, one fused exchange)."""
    n, pl = case["n"], case["pl"]
    for bundle, iters in ((I32_BUNDLE, 40), (F32_BUNDLE, 30)):
        fused = P.simulate_gas_many([P.get_program(p, n) for p in bundle],
                                    pl, iters, exchange=exchange,
                                    device="cpu")
        for name, got in zip(bundle, fused):
            single = P.simulate_gas(P.get_program(name, n), pl, iters,
                                    exchange=exchange, device="cpu")
            if name in INT_PROGRAMS:
                np.testing.assert_array_equal(got, single)
            else:
                np.testing.assert_allclose(got, single, rtol=1e-5, atol=0)


def test_fused_refuses_empty_and_mixed_bundles(case):
    n = case["n"]
    for mod in (P, J):
        with pytest.raises(ValueError, match="at least one program"):
            mod.fuse_programs([])
        with pytest.raises(ValueError, match=r"\(combine, dtype\)"):
            mod.fuse_programs([mod.get_program("pagerank", n),
                               mod.get_program("cc", n)])
        with pytest.raises(ValueError, match=r"\(combine, dtype\)"):
            mod.fuse_programs([mod.get_program("degree", n),
                               mod.get_program("cc", n)])
    fused = P.fuse_programs([P.get_program(p, n) for p in F32_BUNDLE])
    assert P.fuse_programs(fused) is fused
    assert fused.name == "pagerank+ppr+centrality"
    assert fused.combine == "sum" and fused.dtype == torch.float32


def test_iters_zero_returns_init_values(case):
    n = case["n"]
    for name in ("pagerank", "labelprop", "sssp"):
        for tol in (None, 0.0):
            out = P.simulate_gas(P.get_program(name, n), case["pl"], 0,
                                 tol=tol, return_iters=True, device="cpu")
            want = J.simulate_gas(J.get_program(name, n), case["jl"], 0,
                                  tol=tol, return_iters=True)
            _same(out[0], want[0], name)
            assert out[1] == want[1] == 0
    outs = P.simulate_gas_many([P.get_program(p, n) for p in I32_BUNDLE],
                               case["pl"], 0, device="cpu")
    wants = J.simulate_gas_many([J.get_program(p, n) for p in I32_BUNDLE],
                                case["jl"], 0)
    for o, w, name in zip(outs, wants, I32_BUNDLE):
        _same(o, w, name)


# ------------------------------------------------- early exit, warm start

@pytest.mark.parametrize("exchange", EXCHANGES)
@pytest.mark.parametrize("name", P.PROGRAM_NAMES)
def test_tol_early_exit_matches_jax(case, name, exchange):
    """Integer programs at tol = 0 run to their fixed point: values and
    iteration counts equal the reference's exactly.  The f32 programs at
    F32_TOL: the count within ±1, the values within rtol 1e-5 plus the
    exit residual."""
    n = case["n"]
    tol = 0.0 if name in INT_PROGRAMS else F32_TOL
    want, wit = J.simulate_gas(J.get_program(name, n), case["jl"], 200,
                               exchange=exchange, tol=tol, return_iters=True)
    got, git = P.simulate_gas(P.get_program(name, n), case["pl"], 200,
                              exchange=exchange, tol=tol, return_iters=True,
                              device="cpu")
    assert 0 < wit < 200
    if name in INT_PROGRAMS:
        assert git == wit
        _same(got, want, name)
    else:
        assert abs(git - wit) <= 1
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)


def test_tol_early_exit_fused_matches_jax(case):
    n = case["n"]
    for bundle, tol in ((I32_BUNDLE, 0.0), (F32_BUNDLE, F32_TOL)):
        want, wit = J.simulate_gas_many(
            [J.get_program(p, n) for p in bundle], case["jl"], 200,
            exchange="halo", tol=tol, return_iters=True)
        got, git = P.simulate_gas_many(
            [P.get_program(p, n) for p in bundle], case["pl"], 200,
            exchange="halo", tol=tol, return_iters=True, device="cpu")
        if bundle == I32_BUNDLE:
            assert git == wit
            for g, w, name in zip(got, want, bundle):
                _same(g, w, name)
        else:
            assert abs(git - wit) <= 1
            for g, w in zip(got, want):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=tol)


@pytest.mark.parametrize("variant", ("fixed_point", "longer", "empty"))
@pytest.mark.parametrize("name", ("labelprop", "cc", "sssp", "pagerank"))
def test_warm_start_matches_jax(case, name, variant):
    """``init_values``: restarting from the reference's own fixed point
    (an integer program then ends after one iteration), from a vector
    longer than V (the extra entries are ignored), and from an empty one
    (the cold run)."""
    n = case["n"]
    tol = 0.0 if name in INT_PROGRAMS else F32_TOL
    fixed = J.simulate_gas(J.get_program(name, n), case["jl"], 200, tol=tol)
    init = {"fixed_point": fixed,
            "longer": np.concatenate([fixed, np.full(10, 7, fixed.dtype)]),
            "empty": np.zeros(0, fixed.dtype)}[variant]
    want, wit = J.simulate_gas(J.get_program(name, n), case["jl"], 200,
                               exchange="halo", tol=tol, init_values=init,
                               return_iters=True)
    got, git = P.simulate_gas(P.get_program(name, n), case["pl"], 200,
                              exchange="halo", tol=tol, init_values=init,
                              return_iters=True, device="cpu")
    if name in INT_PROGRAMS:
        _same(got, want, name)
        assert git == wit
        if variant != "empty":
            assert git == 1
            np.testing.assert_array_equal(got, np.asarray(fixed))
    else:
        assert abs(git - wit) <= 1
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=tol)


def test_warm_start_fused_matches_jax(case):
    """Per-program warm vectors in a bundle, None for a cold program."""
    n = case["n"]
    lp = J.simulate_gas(J.get_program("labelprop", n), case["jl"], 200,
                        tol=0.0)
    init = [lp, None, np.zeros(0, np.int32), None]
    want, wit = J.simulate_gas_many(
        [J.get_program(p, n) for p in I32_BUNDLE], case["jl"], 200,
        exchange="dense", tol=0.0, init_values=init, return_iters=True)
    got, git = P.simulate_gas_many(
        [P.get_program(p, n) for p in I32_BUNDLE], case["pl"], 200,
        exchange="dense", tol=0.0, init_values=init, return_iters=True,
        device="cpu")
    assert git == wit
    for g, w, name in zip(got, want, I32_BUNDLE):
        _same(g, w, name)


# the engine drivers called without ``exchange``: (module, layout, V) →
# the driver's output
DEFAULT_DRIVERS = {
    "simulate_gas": lambda M, lay, n, **kw: M.simulate_gas(
        M.get_program("pagerank", n), lay, 30, **kw),
    "simulate_pagerank": lambda M, lay, n, **kw: M.simulate_pagerank(
        lay, 30, **kw),
    "simulate_cc": lambda M, lay, n, **kw: M.simulate_cc(lay, 40, **kw),
    "simulate_gas_many": lambda M, lay, n, **kw: M.simulate_gas_many(
        [M.get_program(p, n) for p in I32_BUNDLE], lay, 40, **kw)}


@pytest.mark.parametrize("driver", list(DEFAULT_DRIVERS))
def test_drivers_default_to_the_reference_exchange(case, driver,
                                                   monkeypatch):
    """Each driver called without ``exchange`` runs the reference's
    default wire ("dense") and matches the JAX driver called the same
    way."""
    calls = []
    real = phalo.get_exchange
    monkeypatch.setattr(P.engine, "get_exchange",
                        lambda name, *a, **kw: calls.append(name)
                        or real(name, *a, **kw))
    run = DEFAULT_DRIVERS[driver]
    want = run(J, case["jl"], case["n"])
    got = run(P, case["pl"], case["n"], device="cpu")
    assert calls and set(calls) == {"dense"}
    if driver == "simulate_gas_many":
        for g, w, name in zip(got, want, I32_BUNDLE):
            _same(g, w, name)
    elif driver == "simulate_cc":
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, np.asarray(want))
    else:
        _same(got, want, "pagerank")


def test_device_arrays_without_exchange_hold_every_table(case):
    """``device_arrays(None)`` holds the tables of every exchange the port
    has: the reference's set, less what only its unported wires read."""
    jl, pl = case["jl"], case["pl"]
    ported = set(pl.EXCHANGE_TABLES)
    only_unported = {t for ex, ts in jl.EXCHANGE_TABLES.items()
                     if ex not in ported for t in ts} - {
        t for ex in ported for t in jl.EXCHANGE_TABLES[ex]}
    got, want = pl.device_arrays(None), jl.device_arrays(None)
    assert set(got) == set(want) - only_unported
    assert set(got) == set(pl.device_arrays())
    for ex in ported:
        assert set(pl.device_arrays(ex)) == set(jl.device_arrays(ex))
    for name, arr in got.items():
        np.testing.assert_array_equal(arr, want[name], err_msg=name)


def test_residual_differences_integers_without_overflow():
    """max − min in int32: a sentinel against 0 reads 2³¹−1, not a
    wrapped negative; masked slots are ignored."""
    new = torch.tensor([[SENT, 5, 3]], dtype=torch.int32)
    old = torch.tensor([[0, 5, -100]], dtype=torch.int32)
    mask = torch.tensor([[True, True, False]])
    assert float(_residual(new, old, mask)) == float(np.float32(SENT))
    assert float(_residual(new, new, mask)) == 0.0


# ------------------------------------------------------ the exchange halves

def _tiny_layout():
    """k = 2, L_max = 4: vertex a is master at (0, 0) with a mirror at
    (1, 1); b is master at (0, 1) with no mirror, so no lane reaches it;
    c is master at (1, 0) with a mirror at (0, 2); the rest is pad."""
    L, pad = 4, 4
    send = np.full((2, 2, 2), pad, np.int32)
    recv = np.full((2, 2, 2), pad, np.int32)
    send[0, 1, 0], recv[1, 0, 0] = 2, 0       # c: (0, 2) → (1, 0)
    send[1, 0, 0], recv[0, 1, 0] = 1, 0       # a: (1, 1) → (0, 0)
    red = np.full((2, 2 * L), pad, np.int32)
    red[0, 0 * L + 0] = 0                     # a, own
    red[0, 1 * L + 1] = 0                     # a's mirror
    red[0, 0 * L + 1] = 1                     # b, own
    red[1, 1 * L + 0] = 0                     # c, own
    red[1, 0 * L + 2] = 0                     # c's mirror
    is_master = np.array([[1, 1, 0, 0], [1, 0, 0, 0]], bool)
    owner = np.array([[0, 0, 1, 0], [1, 0, 0, 0]], np.int32)
    own_slot = np.array([[0, 1, 0, 0], [0, 0, 0, 0]], np.int32)
    vert_gid = np.array([[0, 1, 2, 3], [2, 0, 3, 3]], np.int32)
    return dict(halo_send=send, halo_recv=recv, red_index=red,
                is_master=is_master, owner=owner, own_slot=own_slot,
                vert_gid=vert_gid)


@pytest.mark.parametrize("combine", ("min", "sum"))
@pytest.mark.parametrize("exchange", EXCHANGES)
def test_stacked_reduce_and_broadcast_match_jax(exchange, combine):
    """The stacked halves on a hand-built layout against the reference's.
    Under min, master b has no incoming lane: its total must stay its own
    partial 7 (halo) — a zero-initialised aggregate would make it 0."""
    tabs = _tiny_layout()
    partials = np.array([[5, 7, 3, SENT], [9, 2, SENT, SENT]], np.int32)
    jex = {"dense": jhalo.DenseExchange, "halo": jhalo.HaloExchange}[
        exchange]()
    jdev = {k: jnp.asarray(v) for k, v in tabs.items()}
    want, _ = jex.reduce_stacked(jnp.asarray(partials), jdev, combine)
    want_b, _ = jex.broadcast_stacked(jnp.asarray(partials), jdev, combine)
    dev = {k: torch.from_numpy(v) for k, v in tabs.items()}
    ex = phalo.get_exchange(exchange)
    dev.update(ex.routes(dev, 4))
    dev["routes"] = {}
    got, state = ex.reduce_stacked(torch.from_numpy(partials), dev, combine)
    got_b, _ = ex.broadcast_stacked(torch.from_numpy(partials), dev,
                                    combine, state)
    assert state == ()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_b.numpy(), np.asarray(want_b))
    if combine == "min" and exchange == "halo":
        assert got[0, 1] == 7 and got[0, 0] == 2 and got[1, 0] == 3
    # the multi halves carry two programs through one gather and scatter
    two = np.stack([partials, np.flip(partials, 1).copy()], axis=1)
    want2, _ = jex.reduce_stacked_multi(jnp.asarray(two), jdev, combine)
    got2, _ = ex.reduce_stacked_multi(torch.from_numpy(two), dev, combine)
    np.testing.assert_array_equal(got2.numpy(), np.asarray(want2))
    wantb2, _ = jex.broadcast_stacked_multi(jnp.asarray(two), jdev, combine)
    gotb2, _ = ex.broadcast_stacked_multi(torch.from_numpy(two), dev,
                                          combine)
    np.testing.assert_array_equal(gotb2.numpy(), np.asarray(wantb2))


@pytest.mark.parametrize("combine", ("sum", "min"))
@pytest.mark.parametrize("dtype", ("int32", "float32"))
def test_identity_and_lossy_rule_match_reference(combine, dtype):
    tdt = getattr(torch, dtype)
    ident = torch.tensor(phalo._pad_value(combine, tdt), dtype=tdt)
    assert ident.item() == \
        np.asarray(jhalo._pad_value(combine, jnp.dtype(dtype))).item()
    assert phalo.lossy_payload(combine, tdt) == \
        jhalo.lossy_payload(combine, jnp.dtype(dtype))


@pytest.mark.parametrize("name", ("quantized", "ragged", "ragged_quantized",
                                  "carrier_pigeon"))
def test_unported_exchanges_refuse(case, name):
    """An unknown wire format refuses in the registry and the drivers; the
    port's five give their per-rank halves for a mesh ``axis``, and the
    ragged ones refuse a call without the layout their schedule needs."""
    if name == "carrier_pigeon":
        with pytest.raises(ValueError, match="unknown exchange"):
            phalo.get_exchange(name)
        with pytest.raises(ValueError, match="unknown exchange"):
            P.simulate_gas(P.get_program("cc", case["n"]), case["pl"], 2,
                           exchange=name, device="cpu")
        return
    mesh = make_graph_mesh(case["pl"].k, device="cpu")
    assert phalo.get_exchange(name, case["pl"], axis=mesh).axis is mesh
    if name in phalo.RAGGED_EXCHANGES:
        with pytest.raises(ValueError, match="needs layout="):
            phalo.get_exchange(name)
    else:
        assert phalo.get_exchange(name).name == name


@pytest.mark.parametrize("name", ("quantized", "ragged", "ragged_quantized"))
def test_new_exchanges_run_through_the_drivers(case, name):
    """The exchanges that refused before this slice run cc through the
    driver, equal to the JAX package's run."""
    want = J.simulate_gas(J.CC_PROGRAM, case["jl"], 40, exchange=name)
    got = P.simulate_gas(P.CC_PROGRAM, case["pl"], 40, exchange=name,
                         device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_overlap_refuses(case):
    """overlap=True needs a ragged ring: the other wires refuse it with
    the reference's message."""
    for ex in ("dense", "halo", "quantized"):
        with pytest.raises(ValueError, match="needs a ragged ring exchange"):
            P.simulate_gas(P.CC_PROGRAM, case["pl"], 2, exchange=ex,
                           overlap=True, device="cpu")
        with pytest.raises(ValueError, match="needs a ragged ring exchange"):
            P.simulate_gas_many([P.CC_PROGRAM], case["pl"], 2, exchange=ex,
                                overlap=True, device="cpu")


def test_drivers_need_a_card_unless_told_otherwise(case, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.simulate_gas(P.CC_PROGRAM, case["pl"], 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.simulate_gas_many([P.CC_PROGRAM], case["pl"], 2)


# ----------------------------------------------------------------- session

@pytest.fixture(scope="module")
def sessions():
    """The JAX jit session (game off: deterministic end to end) and the
    port's session built from its config blob, on the CPU."""
    g = web_graph(scale=9, edge_factor=5, seed=1)
    jcfg = JConfig.optimized(8, game=False, restream=1,
                             split_degree_factor=4.0)
    js = JSession(JSessionConfig(clugp=jcfg, backend="jit",
                                 exchange="dense"))
    js.partition(g.src, g.dst, g.num_vertices).layout()
    ps = GraphSession(config_from_reference(js.to_json()), device="cpu")
    ps.partition(g.src, g.dst, g.num_vertices).layout()
    return js, ps


def test_session_runs_every_program_like_jax(sessions):
    js, ps = sessions
    assert ps.cfg.exchange == "dense"
    np.testing.assert_array_equal(ps.assign, js.assign)
    for name in P.PROGRAM_NAMES:
        for ex in EXCHANGES:
            got = ps.run(name, iters=ITERS[name], exchange=ex)
            want = js.run(name, iters=ITERS[name], exchange=ex)
            if name in INT_PROGRAMS:
                assert got.dtype == np.int64
                np.testing.assert_array_equal(got, want)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)


def test_session_tol_warm_start_and_run_many_like_jax(sessions):
    js, ps = sessions
    got, git = ps.run("cc", iters=100, tol=0, return_iters=True)
    want, wit = js.run("cc", iters=100, tol=0, return_iters=True)
    np.testing.assert_array_equal(got, want)
    assert git == wit and git < 100
    got2, it2 = ps.run("cc", iters=100, tol=0, init_values=got,
                       return_iters=True)
    np.testing.assert_array_equal(got2, got)
    assert it2 == 1
    outs = ps.run_many(I32_BUNDLE, iters=40, exchange="halo")
    wants = js.run_many(I32_BUNDLE, iters=40, exchange="halo")
    for o, w in zip(outs, wants):
        assert o.dtype == np.int64
        np.testing.assert_array_equal(o, w)
    outs, it = ps.run_many(F32_BUNDLE, iters=100, tol=F32_TOL,
                           return_iters=True)
    wants, wit = js.run_many(F32_BUNDLE, iters=100, tol=F32_TOL,
                             return_iters=True)
    assert abs(it - wit) <= 1
    for o, w in zip(outs, wants):
        np.testing.assert_allclose(o, w, rtol=1e-5, atol=F32_TOL)


def test_session_refuses_mesh_overlap_and_unknown_programs(sessions):
    _, ps = sessions
    with pytest.raises(ValueError, match="graph mesh"):
        ps.run("pagerank", mesh=object())
    with pytest.raises(ValueError, match="ragged"):
        ps.run("pagerank", overlap=True)
    with pytest.raises(ValueError, match="graph mesh"):
        ps.run_many(F32_BUNDLE, mesh=object())
    with pytest.raises(ValueError, match="ragged"):
        ps.run_many(F32_BUNDLE, overlap=True)
    with pytest.raises(ValueError, match="unknown program"):
        ps.run("triangle-count")
    with pytest.raises(ValueError, match="ragged"):
        ps.run("pagerank", exchange="quantized", overlap=True)


def test_config_from_reference_accepts_dense():
    """Every wire format of the reference maps to itself."""
    for ex in EXCHANGES:
        blob = JSession(JSessionConfig(clugp=JConfig.optimized(8),
                                       backend="jit", exchange=ex)).to_json()
        assert config_from_reference(blob).exchange == ex
    for ex in ("quantized", "ragged", "ragged_quantized"):
        blob = JSessionConfig(clugp=JConfig(k=4), exchange=ex).to_json()
        assert config_from_reference(blob).exchange == ex
