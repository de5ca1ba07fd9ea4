"""The port's quantized, ragged and ragged-quantized wire formats
(``repro_torch.dist.compress``, ``repro_torch.dist.halo``), the layout's
schedule, interior split and byte models (``repro_torch.graph.partition``),
the overlapped body (``repro_torch.graph.engine``) and the session's byte
calls, held against the JAX package on the same seeded numpy inputs.

Tolerances:
- the quantizers, nibble packing, encoders, top-Δ index choice, byte
  models, schedules and interior statistics: bit for bit (equal integers);
- each exchange's stacked halves (single and multi, sum and min, several
  steps threading the state): output and next state bit for bit; the
  port's lane state holds the reference's receiver-side arrays transposed
  (quantized), or rolled by −s on hop s and laid hop-major in one flat
  vector (ragged-quantized), which the comparison undoes;
- hopwise against deferred, and overlap against phase-ordered, in the
  port: bit for bit;
- whole programs through the drivers: integer programs bit for bit; f32
  programs (whose local gathers sum in K3's plain order, not JAX's) within
  rtol 1e-5 of JAX on ``ragged``, within 1e-6 max-abs of JAX's run on
  ``quantized``; on ``ragged_quantized``, whose top-Δ choice an ulp can
  flip, within 1% of JAX's own max-abs distance to the float64 oracle
  plus the ``ragged`` rule's rtol 1e-5; the fused int4 wire within its reference bound, 5e-4 max-abs
  of the oracle, on both sides;
- the reference's own bounds on the port: quantized pagerank within 1e-5
  of the oracle at 30 iterations, ragged-quantized error at 100 iterations
  below 1e-6 and below its error at 30;
- ``tol`` on quantized, cold and warm: iterations within ±1 of JAX at
  2e-6, values within 1e-5.
"""
import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.dist.compress as jcomp  # noqa: E402
import repro.dist.halo as jhalo  # noqa: E402
import repro.graph as J  # noqa: E402
from repro.core import CLUGPConfig as JConfig  # noqa: E402
from repro.core import partition as j_partition  # noqa: E402
from repro.core import web_graph  # noqa: E402
from repro.graph.engine import _stack_dev as j_stack_dev  # noqa: E402
from repro.serve import GraphServer as JServer  # noqa: E402
from repro.session import GraphSession as JSession  # noqa: E402
from repro.session import SessionConfig as JSessionConfig  # noqa: E402
import repro_torch.dist.compress as pcomp  # noqa: E402
import repro_torch.dist.halo as phalo  # noqa: E402
import repro_torch.graph as P  # noqa: E402
from repro_torch.convert import config_from_reference  # noqa: E402
from repro_torch.graph.engine import stack_dev  # noqa: E402
from repro_torch.serve import GraphServer  # noqa: E402
from repro_torch.session import GraphSession  # noqa: E402

from conftest import random_graph_and_assign  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
NEW = ("quantized", "ragged", "ragged_quantized")
INT_PROGRAMS = ("cc", "labelprop", "sssp", "bfs", "degree")
ITERS = {"pagerank": 30, "cc": 40, "labelprop": 40, "sssp": 40, "bfs": 40,
         "degree": 2, "centrality": 30, "ppr": 30}
F32_BUNDLE = ("pagerank", "ppr", "centrality")
I32_BUNDLE = ("cc", "labelprop", "sssp", "bfs")
F32_TOL = 2e-6


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(got, want, msg=""):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype, (msg, got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def _oracle(c, name, iters):
    return getattr(P, f"reference_{name}")(c["src"], c["dst"], c["n"], iters)


def _tracks(got, want, oracle):
    """The port's top-Δ transient within 1% of JAX's max-abs distance to
    the float64 oracle, plus rtol 1e-5."""
    gap = float(np.abs(want - oracle).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.01 * gap + 1e-9)


def _pair(src, dst, n, assign, k):
    return dict(src=src, dst=dst, n=n, k=k, assign=assign,
                jl=J.build_layout(src, dst, assign, n, k),
                pl=P.build_layout(src, dst, assign, n, k))


@pytest.fixture(scope="module")
def layouts():
    """Random Zipf digraphs under random assignments at k ∈ {2, 4, 7, 8}
    and the reference's CLUGP partition of a scale-10 web graph, k = 8."""
    out = {f"k{k}": _pair(*random_graph_and_assign(k, k, n=300), k)
           for k in (2, 4, 7, 8)}
    g = web_graph(scale=10, edge_factor=8, seed=0)
    res = j_partition(g.src, g.dst, g.num_vertices, JConfig.optimized(8))
    out["clugp10"] = _pair(g.src, g.dst, g.num_vertices, res.assign, 8)
    return out


@pytest.fixture(scope="module")
def case():
    """tests/test_graph_programs.py's case: 400 vertices, k = 8."""
    return _pair(*random_graph_and_assign(0, 8, n=400), 8)


# --------------------------------------------------------------- quantizers

@pytest.mark.parametrize("shape", [(5, 7), (3, 4, 64), (1, 1), (6, 0 + 33)])
def test_quantize_rows_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape)
         * rng.uniform(0, 10, shape[:-1] + (1,))).astype(np.float32)
    x[0] = 0.0                           # an all-zero row takes scale 1
    codes, scales = pcomp.quantize_rows(torch.from_numpy(x))
    jcodes, jscales = jcomp.quantize_rows(jnp.asarray(x))
    _eq(codes, jcodes)
    _eq(scales, jscales)
    _eq(pcomp.dequantize_rows(codes, scales),
        jcomp.dequantize_rows(jcodes, jscales))
    _eq(pcomp._scale_of(torch.from_numpy(x)), jcomp._scale_of(x))
    _eq(pcomp._quantize_dequantize(torch.from_numpy(x)),
        jcomp._quantize_dequantize(jnp.asarray(x)))


def test_error_feedback_compression_matches_reference():
    """Three steps of ``compress_with_error_feedback`` on a tree (dict,
    list, tuple leaves) carry the residual as the reference does; the
    stateless compressor, ``zero_residual`` and ``compressed_psum`` with
    one participant too."""
    rng = np.random.default_rng(0)

    def tree():
        return {"w": rng.standard_normal((4, 9)).astype(np.float32),
                "b": [rng.standard_normal(9).astype(np.float32),
                      (rng.standard_normal((2, 3)) * 1e-3).astype(
                          np.float32)]}

    def as_t(t):
        return {"w": torch.from_numpy(t["w"]),
                "b": [torch.from_numpy(t["b"][0]),
                      torch.from_numpy(t["b"][1])]}

    def as_j(t):
        return {"w": jnp.asarray(t["w"]),
                "b": [jnp.asarray(t["b"][0]), jnp.asarray(t["b"][1])]}

    def leaves(t):
        return [t["w"], t["b"][0], t["b"][1]]

    g0 = tree()
    pres, jres = pcomp.zero_residual(as_t(g0)), jcomp.zero_residual(as_j(g0))
    for a, b in zip(leaves(pres), leaves(jres)):
        _eq(a, b)
    for _ in range(3):
        g = tree()
        pc, pres = pcomp.compress_with_error_feedback(as_t(g), pres)
        jc, jres = jcomp.compress_with_error_feedback(as_j(g), jres)
        for a, b in zip(leaves(pc) + leaves(pres), leaves(jc) + leaves(jres)):
            _eq(a, b)
    g = tree()
    for a, b in zip(leaves(pcomp.make_grad_compressor()(as_t(g))),
                    leaves(jcomp.make_grad_compressor()(as_j(g)))):
        _eq(a, b)
    # with no mesh (one participant) compressed_psum is the stateless
    # quantize-dequantize; over ranks it is held in test_torch_dist_partition
    x = rng.standard_normal(33).astype(np.float32)
    _eq(pcomp.compressed_psum(torch.from_numpy(x), None),
        jcomp._quantize_dequantize(jnp.asarray(x)))


@pytest.mark.parametrize("h", [1, 3, 7, 8, 9, 20, 61, 64])
def test_quantize_groups_matches_reference(h):
    """The int4 group quantizer, rows not a multiple of 8 included (as
    ``test_quantize_groups_pads_non_multiple_of_8_rows``): codes and fp16
    scales bit for bit, pad lanes code 0, the real lanes within half a
    grid step."""
    rng = np.random.default_rng(h)
    err = rng.standard_normal((5, 2, h)).astype(np.float32)
    err[0, 0] = 0.0
    err[1, 1, :1] = 1e-9                 # a scale that rounds to fp16 zero
    codes, scales = phalo._quantize_groups(torch.from_numpy(err))
    jcodes, jscales = jhalo._quantize_groups(jnp.asarray(err))
    _eq(codes, jcodes)
    _eq(scales, jscales)
    assert codes.shape[-1] % phalo._NUM_SCALE_GROUPS == 0
    assert not codes[..., h:].any()
    deq = phalo._dequantize_groups(codes, scales)
    _eq(deq, jhalo._dequantize_groups(jcodes, jscales))
    tol = float(scales.float().max()) / 2 + 1e-6
    assert (deq[..., :h] - torch.from_numpy(err)).abs().max() <= tol


def test_nibble_pack_every_code_pair():
    """All 15 × 15 pairs of int4 codes pack to the reference's bytes and
    unpack back, sign included."""
    lo, hi = np.meshgrid(np.arange(-7, 8), np.arange(-7, 8))
    codes = np.stack([lo.ravel(), hi.ravel()], -1).reshape(1, -1) \
        .astype(np.int8)
    packed = phalo._nibble_pack(torch.from_numpy(codes))
    _eq(packed, jhalo._nibble_pack(jnp.asarray(codes)))
    _eq(phalo._nibble_unpack(packed), codes)
    _eq(phalo._nibble_unpack(packed),
        jhalo._nibble_unpack(jnp.asarray(_np(packed))))


@pytest.mark.parametrize("fused", [False, True])
def test_error_feedback_encoders_match_reference(fused):
    rng = np.random.default_rng(int(fused))
    shape = (3, 4, 2, 21) if fused else (3, 4, 21)
    lanes, sref, sres = (rng.standard_normal(shape).astype(np.float32)
                         for _ in range(3))
    t = [torch.from_numpy(a) for a in (lanes, sref, sres)]
    j = [jnp.asarray(a) for a in (lanes, sref, sres)]
    enc = "_ef_encode_fused" if fused else "_ef_encode"
    got, want = getattr(phalo, enc)(*t), getattr(jhalo, enc)(*j)
    for a, b in zip(got, want):
        _eq(a, b)
    if fused:
        _eq(phalo._ef_decode_fused(got[2], got[3], 21),
            jhalo._ef_decode_fused(want[2], want[3], 21))


def _one_hop_segments(ex, h, n):
    """The port's segment tables of a one-hop ring (k = 2) carrying n
    programs: 2·n rows of h lanes."""
    zeros = torch.zeros(2 * h, dtype=torch.int64)
    return ex._segments({"rq_mirror": zeros, "rq_master": zeros,
                         "routes": {}}, n, 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_top_delta_encoder_picks_the_reference_lanes(seed):
    """Rows with planted ties in |Δ| across the T_s boundary: the port's
    one sort over every row sends the reference's ``top_k`` lanes (lower
    index first on ties), in its order, with its codes, scales and
    advanced reference, and decodes them as it does."""
    rng = np.random.default_rng(seed)
    h = 8 + 4 * seed
    lanes = rng.choice([0.5, -0.5, 0.25, -0.25, 0.0, 0.125], (6, h)) \
        .astype(np.float32)
    sref = np.zeros_like(lanes)
    sref[1] = rng.choice([0.0, 0.25], h).astype(np.float32)
    jex = jhalo.RaggedQuantizedHaloExchange(schedule=(h,))
    pex = phalo.RaggedQuantizedHaloExchange(schedule=(h,))
    jst, jwire = jex._encode(jnp.asarray(lanes),
                             {"sref": jnp.asarray(sref),
                              "rref": jnp.zeros_like(jnp.asarray(sref))}, h)
    seg = _one_hop_segments(pex, h, 3)
    pst, pwire = pex._encode(torch.from_numpy(lanes).reshape(-1),
                             {"sref": torch.from_numpy(sref).reshape(-1),
                              "rref": torch.zeros(6 * h)}, seg)
    for a, b in zip(pwire, jwire):
        _eq(a, np.asarray(b).reshape(a.shape))
    _eq(pst["sref"], np.asarray(jst["sref"]).reshape(-1))
    _eq(pex._decode(*pwire, seg, 6 * h),
        np.asarray(jex._decode(*jwire, h)).reshape(-1))
    # the tie case of the two libraries' top-k: jax [0 2 4 1]
    half = phalo.RaggedQuantizedHaloExchange(schedule=(8,), top_delta=0.5)
    x = torch.tensor([.5, .25, .5, .25, .5, 0, 0, .25] * 2)
    _, (idx, _, _) = half._encode(x, {"sref": torch.zeros(16),
                                      "rref": torch.zeros(16)},
                                  _one_hop_segments(half, 8, 1))
    assert idx.tolist() == [0, 2, 4, 1] * 2


def test_hop_helpers_match_reference():
    rng = np.random.default_rng(5)
    idx = np.stack([rng.permutation(9)[:4] for _ in range(6)]) \
        .reshape(2, 3, 4).astype(np.int32)
    vals = rng.standard_normal((2, 3, 4)).astype(np.float32)
    _eq(phalo._scatter_last(torch.from_numpy(idx), torch.from_numpy(vals),
                            9),
        jhalo._scatter_last(jnp.asarray(idx), jnp.asarray(vals), 9))
    for combine in ("sum", "min"):
        for dtype in ("int32", "float32"):
            acc = phalo._acc_init((7,), getattr(torch, dtype), combine)
            want = jhalo._acc_init((7,), jnp.dtype(dtype), combine)
            _eq(acc, want)
            slots = np.array([0, 3, 3, 6, 1], np.int64)
            recv = rng.integers(-50, 50, 5).astype(dtype)
            _eq(phalo._hop_accumulate(acc.clone(), torch.from_numpy(slots),
                                      torch.from_numpy(recv), combine),
                jhalo._hop_accumulate(want, jnp.asarray(slots),
                                      jnp.asarray(recv), combine))
    assert phalo.DEFAULT_TOP_DELTA == jhalo.DEFAULT_TOP_DELTA
    assert (phalo._Q4MAX, phalo._NUM_SCALE_GROUPS) == \
        (jhalo._Q4MAX, jhalo._NUM_SCALE_GROUPS)
    assert pcomp._QMAX == jcomp._QMAX


# ------------------------------------------------- schedule and byte models

@pytest.mark.parametrize("which", ["k2", "k4", "k7", "k8", "clugp10"])
def test_schedule_interior_and_byte_models_match_reference(layouts, which):
    c = layouts[which]
    jl, pl = c["jl"], c["pl"]
    assert pl.halo_schedule() == jl.halo_schedule()
    assert pl.interior_frontier_stats() == jl.interior_frontier_stats()
    assert pl.COMM_MODELS == jl.COMM_MODELS
    assert pl.comm_bytes() == jl.comm_bytes()
    for model in pl.COMM_MODELS:
        for kw in ({}, {"lossy": False}, {"value_bytes": 2},
                   {"programs": 3}, {"programs": 3, "fused": True},
                   {"programs": 2, "fused": True, "lossy": False},
                   {"top_delta": 0.1}):
            assert pl.comm_bytes(model, **kw) == jl.comm_bytes(model, **kw), \
                (model, kw)
    with pytest.raises(ValueError, match="explicit exchange"):
        pl.comm_bytes(programs=2)
    with pytest.raises(ValueError, match="unknown exchange"):
        pl.comm_bytes("carrier_pigeon")
    for ex in NEW:
        assert set(pl.device_arrays(ex)) == set(jl.device_arrays(ex))
        pex, jex = phalo.get_exchange(ex, pl), jhalo.get_exchange(ex, jl)
        assert pex.bytes_per_iter(pl) == jex.bytes_per_iter(jl)
    for ex in ("dense", "halo"):
        assert phalo.get_exchange(ex).bytes_per_iter(pl) == \
            jhalo.get_exchange(ex).bytes_per_iter(jl)


def test_deprecated_byte_shims_warn_and_match(case):
    pl, jl = case["pl"], case["jl"]
    calls = [("comm_bytes_mirror_sync", ()), ("comm_bytes_halo", ()),
             ("comm_bytes_ragged", ()), ("comm_bytes_ragged_quantized", ()),
             ("comm_bytes_halo_quantized", ()),
             ("comm_bytes_fused_quantized", (3,)),
             ("comm_bytes_exchange", ("quantized",)),
             ("comm_bytes_fused", (3, "quantized")),
             ("comm_bytes_ideal", ()), ("comm_bytes_dense", ())]
    for name, args in calls:
        with pytest.warns(DeprecationWarning, match=name):
            got = getattr(pl, name)(*args)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            assert got == getattr(jl, name)(*args), name


def test_comm_model_quantized_below_halo_below_dense(layouts):
    """The reference's ordering gate on the scale-10 CLUGP layout, and the
    ragged ring never above halo."""
    lay, k = layouts["clugp10"]["pl"], 8
    assert lay.comm_bytes("quantized") < lay.comm_bytes("halo") \
        < lay.comm_bytes("dense")
    assert lay.comm_bytes("ragged") <= lay.comm_bytes("halo")
    assert lay.comm_bytes("quantized") == 2 * k * (k - 1) * (lay.h_max + 4)


def test_session_byte_calls_match_reference(case):
    args = (case["src"], case["dst"], case["n"], case["assign"])
    js = JSession(JSessionConfig(clugp=JConfig(k=8), exchange="quantized"))
    js.with_partition(*args)
    ps = GraphSession(config_from_reference(js.to_json()), device="cpu")
    ps.with_partition(*args)
    assert ps.comm_bytes() == js.comm_bytes()
    assert ps.comm_bytes(exchange="ragged") == js.comm_bytes(
        exchange="ragged")
    assert ps.comm_bytes(programs=P.PROGRAM_NAMES) == \
        js.comm_bytes(programs=J.PROGRAM_NAMES)
    assert ps.comm_bytes(programs=["pagerank", "cc"], exchange="halo") == \
        js.comm_bytes(programs=["pagerank", "cc"], exchange="halo")
    for bundle in (F32_BUNDLE, I32_BUNDLE):
        assert ps.comm_bytes(programs=bundle, fused=True) == \
            js.comm_bytes(programs=bundle, fused=True)
    with pytest.raises(ValueError, match="needs programs"):
        ps.comm_bytes(fused=True)
    for name, args in (("comm_bytes_programs", ()),
                       ("comm_bytes_fused", (F32_BUNDLE,))):
        with pytest.warns(DeprecationWarning, match=name):
            got = getattr(ps, name)(*args)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            assert got == getattr(js, name)(*args)


# ------------------------------------------------------- stacked halves

def _port_state(name, jstate, schedule, multi):
    """The reference's lane state in the port's pair-indexed layout."""
    if not jstate:
        return ()
    if name == "quantized":
        flip = {"reduce": ("rref",), "bcast": ("sref", "sres")}
        return {ph: {key: torch.from_numpy(np.array(
            np.swapaxes(_np(arr), 0, 1) if key in flip[ph] else _np(arr)))
            for key, arr in st.items()} for ph, st in jstate.items()}
    # ragged_quantized: flat hop-major vectors (hop, row, program, lane)
    hops = [s for s, h in enumerate(schedule, 1) if h > 0]
    flip = {"reduce": "rref", "bcast": "sref"}
    progs = jstate if multi else (jstate,)
    return {ph: {key: torch.from_numpy(np.concatenate([
        np.stack([np.roll(_np(p[ph][i][key]), -s if key == flip[ph] else 0,
                          0) for p in progs], axis=1).reshape(-1)
        for i, s in enumerate(hops)])) for key in ("sref", "rref")}
        for ph in ("reduce", "bcast")}


def _check_state(name, got, jstate, schedule, multi):
    want = _port_state(name, jstate, schedule, multi)
    assert type(got) is type(want)
    if not want:
        return
    for ph in want:
        assert set(got[ph]) == set(want[ph])
        for key in want[ph]:
            _eq(got[ph][key], want[ph][key], f"{ph}/{key}")


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("cell", [("sum", "float32"), ("min", "int32"),
                                  ("sum", "int32")])
@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("which", ["k2", "k7", "k8"])
def test_stacked_halves_match_reference(layouts, which, name, cell, multi):
    """Three steps of reduce then broadcast threading the lane state, on
    seeded random values: outputs and the next state bit for bit (the
    reduce also with ``hopwise=True`` on the ragged wires)."""
    combine, dtype = cell
    c = layouts[which]
    jl, pl = c["jl"], c["pl"]
    jex, pex = jhalo.get_exchange(name, jl), phalo.get_exchange(name, pl)
    jdev, pdev = j_stack_dev(jl, name), stack_dev(pl, name, "cpu")
    k, L, n = jl.k, jl.l_max, 3
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    if multi:
        jst = jex.init_state_multi(jdev, jdt, combine, n)
        pst = pex.init_state_multi(pdev, tdt, combine, n)
    else:
        jst, pst = jex.init_state(jdev, jdt, combine), \
            pex.init_state(pdev, tdt, combine)
    sched = getattr(jex, "schedule", ())
    _check_state(name, pst, jst, sched, multi)
    rng = np.random.default_rng(k)
    red, bc = ("reduce_stacked_multi", "broadcast_stacked_multi") if multi \
        else ("reduce_stacked", "broadcast_stacked")
    for step in range(3):
        shape = (k, n, L) if multi else (k, L)
        vals = (rng.standard_normal(shape) * 10.0 ** -step).astype(dtype) \
            if dtype == "float32" else rng.integers(0, 1000, shape) \
            .astype(dtype)
        kw = {"hopwise": True} if name != "quantized" and step == 1 else {}
        want, jst = getattr(jex, red)(jnp.asarray(vals), jdev, combine, jst,
                                      **kw)
        got, pst = getattr(pex, red)(torch.from_numpy(vals), pdev, combine,
                                     pst, **kw)
        _eq(got, want, f"reduce step {step}")
        _check_state(name, pst, jst, sched, multi)
        want, jst = getattr(jex, bc)(want, jdev, combine, jst)
        got, pst = getattr(pex, bc)(got, pdev, combine, pst)
        _eq(got, want, f"broadcast step {step}")
        _check_state(name, pst, jst, sched, multi)


@pytest.mark.parametrize("name", phalo.RAGGED_EXCHANGES)
@pytest.mark.parametrize("cell", [("sum", "float32"), ("min", "int32")])
def test_hopwise_equals_deferred(layouts, name, cell):
    combine, dtype = cell
    pl = layouts["clugp10"]["pl"]
    ex, dev = phalo.get_exchange(name, pl), stack_dev(pl, name, "cpu")
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(3)
    vals = torch.from_numpy(rng.standard_normal((pl.k, 2, pl.l_max))
                            .astype(np.float32)).to(tdt)
    st = ex.init_state_multi(dev, tdt, combine, 2)
    a, sa = ex.reduce_stacked_multi(vals, dev, combine, st)
    b, sb = ex.reduce_stacked_multi(vals, dev, combine, st, hopwise=True)
    _eq(a, b)
    if st:
        _eq(sa["reduce"]["rref"], sb["reduce"]["rref"])


def test_registry_signature_and_names(case):
    assert phalo.EXCHANGE_NAMES == jhalo.EXCHANGE_NAMES
    assert phalo.RAGGED_EXCHANGES == jhalo.RAGGED_EXCHANGES
    pl, jl = case["pl"], case["jl"]
    ex = phalo.get_exchange("ragged_quantized", pl, top_delta=0.5)
    assert ex.top_delta == 0.5 and ex.schedule == jhalo.get_exchange(
        "ragged_quantized", jl).schedule
    assert phalo.get_exchange("ragged", pl).k == pl.k
    with pytest.raises(ValueError, match="unknown exchange"):
        phalo.get_exchange("carrier_pigeon", pl)


# ------------------------------------------------------------ the drivers

@pytest.mark.parametrize("exchange", NEW)
@pytest.mark.parametrize("name", P.PROGRAM_NAMES)
def test_program_matches_jax(case, name, exchange):
    want = np.asarray(J.simulate_gas(J.get_program(name, case["n"]),
                                     case["jl"], ITERS[name],
                                     exchange=exchange))
    got = P.simulate_gas(P.get_program(name, case["n"]), case["pl"],
                         ITERS[name], exchange=exchange, device="cpu")
    assert got.dtype == want.dtype
    if name in INT_PROGRAMS:
        np.testing.assert_array_equal(got, want)
    elif exchange == "quantized":
        assert np.abs(got - want).max() <= 1e-6
    elif exchange == "ragged":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    else:
        _tracks(got, want, _oracle(case, name, ITERS[name]))


@pytest.mark.parametrize("exchange", NEW)
@pytest.mark.parametrize("bundle", [F32_BUNDLE, I32_BUNDLE])
def test_fused_bundles_match_jax(case, exchange, bundle):
    n = case["n"]
    wants = J.simulate_gas_many([J.get_program(p, n) for p in bundle],
                                case["jl"], 30, exchange=exchange)
    gots = P.simulate_gas_many([P.get_program(p, n) for p in bundle],
                               case["pl"], 30, exchange=exchange,
                               device="cpu")
    for name, got, want in zip(bundle, gots, wants):
        want = np.asarray(want)
        if name in INT_PROGRAMS:
            np.testing.assert_array_equal(got, want)
        elif exchange == "quantized":
            for v in (got, want):
                assert np.abs(v - _oracle(case, name, 30)).max() < 5e-4, name
        elif exchange == "ragged":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
        else:
            _tracks(got, want, _oracle(case, name, 30))


@pytest.mark.parametrize("exchange", phalo.RAGGED_EXCHANGES)
@pytest.mark.parametrize("name", ["pagerank", "cc", "sssp"])
def test_overlap_bit_identical_to_phase_ordered(exchange, name):
    src, dst, n, assign = random_graph_and_assign(3, 4, n=250)
    pl = P.build_layout(src, dst, assign, n, 4)
    prog = P.get_program(name, n)
    base = P.simulate_gas(prog, pl, 8, exchange=exchange, device="cpu")
    over = P.simulate_gas(prog, pl, 8, exchange=exchange, overlap=True,
                          device="cpu")
    np.testing.assert_array_equal(over, base)


@pytest.mark.parametrize("exchange", phalo.RAGGED_EXCHANGES)
def test_overlap_fused_bundle_bit_identical(exchange):
    src, dst, n, assign = random_graph_and_assign(5, 4, n=250)
    pl = P.build_layout(src, dst, assign, n, 4)
    bundle = [P.get_program(p, n) for p in F32_BUNDLE]
    base = P.simulate_gas_many(bundle, pl, 6, exchange=exchange,
                               device="cpu")
    over = P.simulate_gas_many(bundle, pl, 6, exchange=exchange,
                               overlap=True, device="cpu")
    for b, o in zip(base, over):
        np.testing.assert_array_equal(o, b)


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_bounds_hold_on_the_port(seed):
    """tests/test_graph_quantized.py's bounds: quantized pagerank within
    1e-5 of the float64 oracle (and of halo) at 30 iterations; the
    ragged-quantized error shrinks from 30 to 100 iterations, below 1e-3
    and 1e-6."""
    src, dst, n, assign = random_graph_and_assign(seed, 8, n=400)
    pl = P.build_layout(src, dst, assign, n, 8)
    ref = P.reference_pagerank(src, dst, n, 30)
    pr_q = P.simulate_pagerank(pl, 30, exchange="quantized", device="cpu")
    pr_h = P.simulate_pagerank(pl, 30, exchange="halo", device="cpu")
    assert np.abs(pr_q - ref).max() < 1e-5
    assert np.abs(pr_q - pr_h).max() < 1e-5
    errs = {}
    for iters in (30, 100):
        ref = P.reference_pagerank(src, dst, n, iters)
        pr = P.simulate_pagerank(pl, iters, exchange="ragged_quantized",
                                 device="cpu")
        errs[iters] = np.abs(pr - ref).max()
    assert errs[30] < 1e-3 and errs[100] < 1e-6 and errs[100] < errs[30], \
        errs


def test_tol_and_warm_start_on_quantized(case):
    """Early exit on the quantized wire within ±1 iteration of JAX at
    2e-6, each at its own fixed-iteration value; the same for a warm
    restart from the fixed point (which saves nothing on this wire, in
    either package: the lane references restart from zero); cc exact to
    its fixed point."""
    n = case["n"]
    prog_j, prog_p = J.get_program("pagerank", n), P.get_program("pagerank",
                                                                  n)
    want, wit = J.simulate_gas(prog_j, case["jl"], 200, "quantized",
                               tol=F32_TOL, return_iters=True)
    got, git = P.simulate_gas(prog_p, case["pl"], 200, "quantized",
                              tol=F32_TOL, return_iters=True, device="cpu")
    assert abs(git - wit) <= 1 and git < 200
    np.testing.assert_array_equal(
        got, P.simulate_gas(prog_p, case["pl"], git, "quantized",
                            device="cpu"))
    assert np.abs(got - np.asarray(want)).max() <= 1e-5
    wwant, wwit = J.simulate_gas(prog_j, case["jl"], 200, "quantized",
                                 tol=F32_TOL, init_values=np.asarray(want),
                                 return_iters=True)
    wgot, wgit = P.simulate_gas(prog_p, case["pl"], 200, "quantized",
                                tol=F32_TOL, init_values=got,
                                return_iters=True, device="cpu")
    assert abs(wgit - wwit) <= 1
    assert np.abs(wgot - np.asarray(wwant)).max() <= 1e-5
    cc_w, cc_wit = J.simulate_gas(J.CC_PROGRAM, case["jl"], 100, "quantized",
                                  tol=0.0, return_iters=True)
    cc_g, cc_git = P.simulate_gas(P.CC_PROGRAM, case["pl"], 100, "quantized",
                                  tol=0.0, return_iters=True, device="cpu")
    assert cc_git == cc_wit
    np.testing.assert_array_equal(cc_g, np.asarray(cc_w))


# ------------------------------------------------------------ serving

@pytest.mark.parametrize("exchange", ["ragged", "quantized"])
def test_server_replies_match_reference(exchange):
    """``GraphServer`` on the new wires answers a fused microbatch as the
    reference server does (f32 replies within rtol 1e-5, integer ones
    exact), and ``run_many`` with ``overlap`` on the ragged one."""
    g = web_graph(scale=10, seed=0)
    assign = j_partition(g.src, g.dst, g.num_vertices,
                         JConfig.optimized(4, restream=1)).assign
    jcfg = JSessionConfig(clugp=JConfig.optimized(4), iters=8,
                          exchange=exchange)
    js = JSession(jcfg).with_partition(g.src, g.dst, g.num_vertices, assign)
    ps = GraphSession(config_from_reference(js.to_json()), device="cpu")
    ps.with_partition(g.src, g.dst, g.num_vertices, assign)
    jsrv, psrv = JServer(js.layout(), max_batch=8), \
        GraphServer(ps.layout(), max_batch=8)
    verts = np.random.default_rng(1).integers(0, g.num_vertices, 16)
    replies = []
    for srv in (jsrv, psrv):
        tickets = [srv.submit("score", program=p, vertices=verts)
                   for p in ("pagerank", "degree", "cc")]
        tickets.append(srv.submit("label"))
        assert srv.serve_pending() == 4
        replies.append([np.asarray(srv.result(t).value) for t in tickets])
    for want, got in zip(*replies):
        assert got.dtype == want.dtype and got.shape == want.shape
        if np.issubdtype(got.dtype, np.integer):
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=0.0)
    assert psrv.stats == jsrv.stats
    if exchange == "ragged":
        outs = ps.run_many(I32_BUNDLE, iters=40, overlap=True)
        wants = js.run_many(I32_BUNDLE, iters=40, overlap=True)
        for o, w in zip(outs, wants):
            np.testing.assert_array_equal(o, w)


def test_launcher_smoke_on_ragged_quantized(tmp_path):
    """``launch.serve_graph --exchange ragged_quantized --smoke`` on the
    CPU: its reply checks and restream gate pass."""
    out = tmp_path / "bench.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_graph",
         "--device", "cpu", "--scale", "10", "--k", "4", "--window", "256",
         "--exchange", "ragged_quantized", "--smoke", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rows = json.loads(out.read_text())
    assert rows[0]["exchange"] == "ragged_quantized"
