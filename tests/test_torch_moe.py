"""The port's MoE family held against the JAX package on the same weights:
``models.moe`` (the grouped sort dispatch with capacity and drops, the
no-capacity oracle, top-k ties), the MoE groups of ``models.lm`` (prefill
on K4's plain version, decode with the cache keyed by group), the weight
converter for both group layouts, and the serving launcher.

Inputs are made from numpy seeds; the reference's weights cross as numpy
arrays (``lm_params_from_reference`` for a whole model); everything runs
in f32 on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.train import make_decode_fn as jmake_decode_fn  # noqa: E402
from repro.train import make_prefill_step as jmake_prefill_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch.serve import generate, main  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.train import make_decode_fn, make_prefill_step  # noqa: E402

LLAMA4 = "llama4_scout_17b_a16e"
# the three routings of the assigned archs, at their reduced sizes: top-1
# with a shared expert (llama4), top-2 softmax (jamba), top-2
# softmax-after-top-k with a shared expert and an aux-loss-free selection
# bias (deepseek's routing, without MLA)
ROUTINGS = {"llama4": LLAMA4, "jamba": "jamba_1_5_large_398b",
            "deepseek": "deepseek_v3_671b"}


def _t(a):
    return torch.from_numpy(np.array(a))


def _tt(tree):
    """A numpy tree → the same tree of CPU tensors."""
    if isinstance(tree, dict):
        return {k: _tt(v) for k, v in tree.items()}
    return _t(tree)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _moe_case(routing, seed):
    """(moe kwargs, reference weights as numpy, x, router bias or None)."""
    mo = jconfigs.get_config(ROUTINGS[routing]).reduced().moe
    d = 128
    p = _np_tree(JM.moe_init(jax.random.key(seed), d, mo.d_expert,
                             mo.n_experts, mo.n_shared))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 24, d)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(mo.n_experts).astype(np.float32)
            if routing == "deepseek" else None)
    kw = dict(n_experts=mo.n_experts, top_k=mo.top_k,
              router_softmax_after_topk=mo.softmax_after_topk)
    return kw, p, x, bias


# ------------------------------------------------------------------ layer

@pytest.mark.parametrize("capacity_factor", [8.0, 0.25])
@pytest.mark.parametrize("routing", sorted(ROUTINGS))
def test_moe_apply_matches_reference(routing, capacity_factor):
    """The grouped dispatch against the reference's, f32, 1e-5: without
    drops (8.0) and with them (0.25, where the tables must show drops)."""
    kw, p, x, bias = _moe_case(routing, 1)
    jb, tb = (None, None) if bias is None else (jnp.asarray(bias), _t(bias))
    want = JM.moe_apply(_jtree(p), jnp.asarray(x),
                        capacity_factor=capacity_factor, router_bias=jb, **kw)
    got = M.moe_apply(_tt(p), _t(x), capacity_factor=capacity_factor,
                      router_bias=tb, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    top_idx, gates = M.route(_tt(p), _t(x), top_k=kw["top_k"],
                             router_softmax_after_topk=kw[
                                 "router_softmax_after_topk"],
                             router_bias=tb)
    cap = M.expert_capacity(x.shape[1], kw["top_k"], kw["n_experts"],
                            capacity_factor)
    tok, _gat = M.dispatch_tables(top_idx, gates, n_experts=kw["n_experts"],
                                  capacity=cap)
    kept = int((tok < x.shape[1]).sum())
    routed = top_idx.numel()
    assert (kept < routed) == (capacity_factor < 1), (kept, routed)


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
def test_moe_reference_matches_reference(routing):
    kw, p, x, bias = _moe_case(routing, 2)
    want = JM.moe_reference(p, x, router_bias=bias, **kw)
    got = M.moe_reference(_tt(p), _t(x),
                          router_bias=None if bias is None else _t(bias),
                          **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("routing", sorted(ROUTINGS))
def test_moe_apply_uncapped_matches_the_oracle(routing):
    """The port's dispatch at a capacity that drops nothing (E / k) against
    the port's own oracle, at the JAX package's tolerance for the same
    comparison (tests/test_substrates.py)."""
    kw, p, x, bias = _moe_case(routing, 3)
    rb = None if bias is None else _t(bias)
    got = M.moe_apply(_tt(p), _t(x), router_bias=rb,
                      capacity_factor=kw["n_experts"] / kw["top_k"], **kw)
    want = M.moe_reference(_tt(p), _t(x), router_bias=rb, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_top_k_ties_pick_the_lower_expert(top_k):
    """Router scores drawn from four values over 16 experts tie often;
    the port ranks them as ``jax.lax.top_k`` does (the lower expert
    first), ids and order."""
    sel = np.random.default_rng(top_k).integers(0, 4, (64, 16)).astype(
        np.float32)
    _, want = jax.lax.top_k(jnp.asarray(sel), top_k)
    got = M.top_k_experts(_t(sel), top_k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("routing", ["llama4", "jamba"])
def test_moe_apply_with_every_logit_tied_matches_reference(routing):
    """A zero router ties every expert for every token: all go to the
    lowest experts, which overflow their capacity; the layer equals the
    reference's, drops included."""
    kw, p, x, _ = _moe_case(routing, 4)
    p["router"]["w"] = np.zeros_like(p["router"]["w"])
    want = JM.moe_apply(_jtree(p), jnp.asarray(x), capacity_factor=1.25, **kw)
    got = M.moe_apply(_tt(p), _t(x), capacity_factor=1.25, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    top_idx, _ = M.route(_tt(p), _t(x), top_k=kw["top_k"])
    assert (top_idx == torch.arange(kw["top_k"])).all()


# deepseek-v3's published routing (top-8 of 256, softmax after top-k, a
# shared expert, the selection bias) at small widths: the reduced config
# caps routing at top-2 of 8, so this is the only CPU case of it

def _published_case(seed):
    mo = jconfigs.get_config("deepseek_v3_671b").moe
    d, d_expert = 128, 64
    p = _np_tree(JM.moe_init(jax.random.key(seed), d, d_expert,
                             mo.n_experts, mo.n_shared))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 24, d)).astype(np.float32)
    bias = (0.5 * rng.standard_normal(mo.n_experts)).astype(np.float32)
    kw = dict(n_experts=mo.n_experts, top_k=mo.top_k,
              router_softmax_after_topk=mo.softmax_after_topk)
    assert (mo.n_experts, mo.top_k, mo.softmax_after_topk) == (256, 8, True)
    return kw, p, x, bias


@pytest.mark.parametrize("capacity_factor", [32.0, 0.25])
def test_moe_apply_at_deepseek_published_routing_matches_reference(
        capacity_factor):
    """Top-8 of 256 experts against the reference, f32, 1e-5: at E / k
    (32.0: a slot for every token, no drops) and at 0.25 (one slot an
    expert, where the tables must show drops)."""
    kw, p, x, bias = _published_case(7)
    want = JM.moe_apply(_jtree(p), jnp.asarray(x),
                        capacity_factor=capacity_factor,
                        router_bias=jnp.asarray(bias), **kw)
    got = M.moe_apply(_tt(p), _t(x), capacity_factor=capacity_factor,
                      router_bias=_t(bias), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    top_idx, gates = M.route(_tt(p), _t(x), top_k=kw["top_k"],
                             router_softmax_after_topk=True,
                             router_bias=_t(bias))
    cap = M.expert_capacity(x.shape[1], kw["top_k"], kw["n_experts"],
                            capacity_factor)
    tok, _ = M.dispatch_tables(top_idx, gates, n_experts=kw["n_experts"],
                               capacity=cap)
    kept = int((tok < x.shape[1]).sum())
    assert (kept < top_idx.numel()) == (capacity_factor < 1)


def test_top8_of_256_ties_pick_the_lower_expert():
    """Scores from four values over 256 experts tie in nearly every row;
    the top 8 come out as ``jax.lax.top_k`` ranks them, ids and order."""
    sel = np.random.default_rng(8).integers(0, 4, (64, 256)).astype(
        np.float32)
    _, want = jax.lax.top_k(jnp.asarray(sel), 8)
    got = M.top_k_experts(_t(sel), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_moe_apply_at_published_routing_with_every_logit_tied():
    """A zero router ties all 256 experts for every token: each goes to
    experts 0-7 with gates 1/8, they overflow their one slot, and the
    layer equals the reference's, drops included."""
    kw, p, x, _ = _published_case(9)
    p["router"]["w"] = np.zeros_like(p["router"]["w"])
    want = JM.moe_apply(_jtree(p), jnp.asarray(x), capacity_factor=1.25,
                        **kw)
    got = M.moe_apply(_tt(p), _t(x), capacity_factor=1.25, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    top_idx, gates = M.route(_tt(p), _t(x), top_k=8,
                             router_softmax_after_topk=True)
    assert (top_idx == torch.arange(8)).all()
    torch.testing.assert_close(gates, torch.full_like(gates, 0.125))


@pytest.mark.parametrize("tokens,top_k,n_experts,factor,want", [
    (2048, 1, 16, 1.25, 160), (1, 1, 16, 1.25, 1), (24, 2, 8, 0.25, 1),
    (100, 1, 16, 16.0, 100), (7, 8, 256, 1.25, 1), (4096, 8, 256, 1.25, 160)])
def test_expert_capacity_is_the_reference_formula(tokens, top_k, n_experts,
                                                  factor, want):
    assert want == max(1, int(factor * tokens * top_k / n_experts))
    assert M.expert_capacity(tokens, top_k, n_experts, factor) == want


# ------------------------------------------------------------------ model

def _cfgs(layout, capacity_factor=None):
    """(reference cfg, port cfg): reduced llama4-scout (one ``moe`` group),
    or deepseek-v3's reduced routing with GQA in place of MLA (a ``dense``
    group of first_k_dense = 1, then ``moe``)."""
    arch = LLAMA4 if layout == "moe" else "deepseek_v3_671b"
    out = []
    for c in (jconfigs.get_config(arch).reduced(),
              configs.get_config(arch).reduced()):
        if layout == "dense+moe":
            c = dataclasses.replace(c, mla=None)
        if capacity_factor is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=capacity_factor))
        out.append(c)
    return out


def _pair(layout, seed, capacity_factor=None):
    cfg, tcfg = _cfgs(layout, capacity_factor)
    tree = _np_tree(JLM.init_params(cfg, jax.random.key(seed)))
    return cfg, tcfg, tree, lm_params_from_reference(tree, tcfg)


LAYOUTS = ["moe", "dense+moe"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_moe_prefill_matches_reference(layout):
    """``forward`` and the prefill step at the config's own capacity
    (1.25: tokens dropped) against the reference, f32, 1e-4."""
    cfg, tcfg, tree, params = _pair(layout, 1)
    assert [g for g, _ in lm.layer_groups(tcfg)] == layout.split("+")
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 24))
    jt = _jtree(tree)
    want_logits = jmake_prefill_step(cfg, dtype=jnp.float32)(
        jt, {"tokens": jnp.asarray(toks, jnp.int32)})
    want_x = JLM.forward(jt, {"tokens": jnp.asarray(toks, jnp.int32)}, cfg,
                         dtype=jnp.float32, remat=False)
    got_logits = make_prefill_step(tcfg, dtype=torch.float32)(
        params, {"tokens": _t(toks)})
    got_x = lm.forward(params, {"tokens": _t(toks)}, tcfg,
                       dtype=torch.float32)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_moe_decode_steps_match_reference(layout):
    """Three decode steps: logits and every group's cache against the
    reference, f32, 1e-4."""
    cfg, tcfg, tree, params = _pair(layout, 2)
    B, S = 2, 3
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, S))
    jt = _jtree(tree)
    jstep = jax.jit(jmake_decode_fn(cfg, dtype=jnp.float32))
    jcache = JLM.init_cache(cfg, B, S, dtype=jnp.float32)
    step = make_decode_fn(tcfg, dtype=torch.float32)
    cache = lm.init_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
    assert set(cache) == set(jcache) == set(layout.split("+"))
    for t in range(S):
        jl, jcache = jstep(jt, jcache, jnp.asarray(toks[:, t:t + 1],
                                                   jnp.int32), jnp.int32(t))
        tl, cache = step(params, cache, _t(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    for group in cache:
        for name in ("k", "v"):
            np.testing.assert_allclose(cache[group][name].numpy(),
                                       np.asarray(jcache[group][name]),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_moe_decode_matches_prefill(layout):
    """The port's decode loop against its prefill at every position,
    drop-free (capacity factor 8.0: a 10-token prefill and 1-token decode
    steps drop differently otherwise, as in the reference's own test),
    at the reference's tolerance for this comparison."""
    _, cfg = _cfgs(layout, capacity_factor=8.0)
    params = lm.init_params(cfg, torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 10)))
    x = lm.forward(params, {"tokens": toks}, cfg, dtype=torch.float32)
    full = L.linear(params["lm_head"], x)
    cache = lm.init_cache(cfg, 2, 10, dtype=torch.float32, device="cpu")
    for t in range(10):
        logits, cache = lm.decode_step(params, cache, toks[:, t:t + 1], t,
                                       cfg, dtype=torch.float32)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_moe_serve_greedy_tokens_match_reference():
    """``launch.serve.generate`` on reduced llama4-scout against the
    reference launcher's loop on the same weights: the same greedy
    tokens."""
    cfg, tcfg, tree, params = _pair("moe", 4)
    B, P, N = 2, 5, 6
    prompt = np.random.default_rng(4).integers(0, cfg.vocab, (B, P))
    jt = _jtree(tree)
    fn = jax.jit(jmake_decode_fn(cfg, dtype=jnp.float32))
    cache = JLM.init_cache(cfg, B, P + N, dtype=jnp.float32)
    jp = jnp.asarray(prompt, jnp.int32)
    for t in range(P):
        logits, cache = fn(jt, cache, jp[:, t:t + 1], jnp.int32(t))
    want = []
    for t in range(N):
        nxt = jnp.argmax(logits[:, -1, :cfg.vocab], -1)[:, None].astype(
            jnp.int32)
        want.append(np.asarray(nxt))
        logits, cache = fn(jt, cache, nxt, jnp.int32(P + t))
    got = generate(params, tcfg, _t(prompt), N)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.concatenate(want, 1))
    assert got.finite


def test_generate_reports_non_finite_logits():
    """``generate`` tests every step's logits on the device: an infinite
    LM-head weight makes them non-finite, and the result says so."""
    cfg = configs.get_config(LLAMA4).reduced()
    params = lm.init_params(cfg, torch.Generator().manual_seed(6))
    prompt = torch.zeros((1, 3), dtype=torch.int64)
    assert generate(params, cfg, prompt, 2).finite
    params["lm_head"]["w"][:, 7] = float("inf")
    assert not generate(params, cfg, prompt, 2).finite


# ------------------------------------------------------------ weights etc.

@pytest.mark.parametrize("layout", LAYOUTS)
def test_convert_round_trips_moe_trees(layout):
    """The converter splits each group of the reference's tree into
    per-layer dicts with the shapes and dtypes of the port's own
    ``init_params``; both count what the reference's ``param_count``
    counts (also at full width, from the config); a tree that does not
    fit raises."""
    cfg, tcfg, tree, params = _pair(layout, 5)
    own = lm.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype),
                                    params)
    assert shapes == jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), t.dtype), own)
    assert sum(t.numel() for t in lm.tree_leaves(own)) == \
        lm.param_count(tcfg) == JLM.param_count(cfg)
    full, tfull = (dataclasses.replace(c, mla=None) for c in (
        jconfigs.get_config(LLAMA4 if layout == "moe" else
                            "deepseek_v3_671b"),
        configs.get_config(LLAMA4 if layout == "moe" else
                           "deepseek_v3_671b")))
    assert lm.param_count(tfull) == JLM.param_count(full)
    last = len(params["g_moe"]) - 1
    np.testing.assert_array_equal(
        params["g_moe"][last]["ffn"]["experts"]["down"].numpy(),
        tree["g_moe"]["ffn"]["experts"]["down"][last])
    bad = {k: v for k, v in tree.items() if k != "g_moe"}
    with pytest.raises(ValueError, match="not an LM tree"):
        lm_params_from_reference(bad, tcfg)
    cut = dict(tree, g_moe=jax.tree_util.tree_map(lambda a: a[:0],
                                                  tree["g_moe"]))
    with pytest.raises(ValueError, match="does not fit"):
        lm_params_from_reference(cut, tcfg)


def test_llama4_published_param_count():
    """llama4-scout at published width: the layer and the embedding/head
    counts this slice's card phase reports (12 of 48 layers)."""
    cfg = configs.get_config(LLAMA4)
    layer = (lm.param_count(dataclasses.replace(cfg, n_layers=2))
             - lm.param_count(dataclasses.replace(cfg, n_layers=1)))
    assert layer == 2_202_101_760
    assert lm.param_count(cfg) - 48 * layer == 2_070_937_600 + cfg.d_model
    assert lm.param_count(cfg) == JLM.param_count(jconfigs.get_config(LLAMA4))


def test_moe_entry_points_need_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config(LLAMA4).reduced()
    for call in (lambda: lm.init_cache(cfg, 1, 4),
                 lambda: main(["--arch", "llama4-scout-17b-a16e",
                               "--tokens", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    cache = lm.init_cache(cfg, 1, 4, device="cpu")
    assert set(cache) == {"moe"} and cache["moe"]["k"].device.type == "cpu"


def test_serve_launcher_runs_llama4_reduced_on_cpu(capsys):
    main(["--arch", "llama4-scout-17b-a16e", "--device", "cpu", "--batch",
          "2", "--prompt-len", "4", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=llama4-scout-17b-a16e" in out and "on cpu" in out
