"""The port's MLA (deepseek-v3's Multi-head Latent Attention) held against
the JAX package on the same weights: ``mla_attention`` in its decompressed
form (K4's plain version on the CPU at the (nope + rope, v) head dims),
the latent decode attention and cache update, the absorbed decode of one
layer, ``prefill`` and a run of decode steps of the reduced deepseek-v3
(a ``dense`` group, then ``moe``; and the dense-only cut the card's f32
check runs), the port's own decode against its prefill, the published
parameter count, the converter, and the serving launcher.

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
from repro.dist import decode as JD  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.train import make_decode_fn as jmake_decode_fn  # noqa: E402
from repro.train import make_prefill_step as jmake_prefill_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.dist import decode as DEC  # noqa: E402
from repro_torch.launch.serve import generate, main  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import make_decode_fn, make_prefill_step  # noqa: E402

ARCH = "deepseek_v3_671b"


def _t(a):
    return torch.from_numpy(np.array(a))


def _tt(tree):
    if isinstance(tree, dict):
        return {k: _tt(v) for k, v in tree.items()}
    return _t(tree)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _cfgs(layout="dense+moe", capacity_factor=None):
    """(reference cfg, port cfg): the reduced deepseek-v3 (``dense`` group
    of first_k_dense = 1, then ``moe``), or cut to its dense layers
    (``moe=None``: one ``dense`` group of 2), as the card's f32 check
    cuts the published one."""
    out = []
    for c in (jconfigs.get_config(ARCH).reduced(),
              configs.get_config(ARCH).reduced()):
        if layout == "dense":
            c = dataclasses.replace(c, moe=None)
        elif capacity_factor is not None:
            c = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=capacity_factor))
        out.append(c)
    return out


def _pair(layout, seed, capacity_factor=None):
    cfg, tcfg = _cfgs(layout, capacity_factor)
    tree = _np_tree(JLM.init_params(cfg, jax.random.key(seed)))
    return cfg, tcfg, tree, lm_params_from_reference(tree, tcfg)


def _mla_kw(cfg):
    m = cfg.mla
    return dict(n_heads=cfg.n_heads, q_lora=m.q_lora, kv_lora=m.kv_lora,
                nope_dim=m.nope_dim, rope_dim=m.rope_dim, v_dim=m.v_dim)


# ------------------------------------------------------------------ layer

@pytest.mark.parametrize("causal", [True, False])
def test_mla_attention_matches_reference(causal):
    """The decompressed MLA layer against the reference's, f32, 1e-5:
    projections, RoPE on both rope parts at the default θ, the shared
    rope head broadcast into k, attention at (nope + rope, v) head dims
    with scale 1/sqrt(nope + rope), the output projection."""
    cfg, _ = _cfgs()
    kw = _mla_kw(cfg)
    p = _np_tree(JA.mla_init(jax.random.key(1), cfg.d_model, pad_heads_to=1,
                             **kw))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)[None]
    want = JA.mla_attention(_jtree(p), jnp.asarray(x), pad_heads_to=1,
                            positions=jnp.asarray(pos), causal=causal,
                            block_kv=16, **kw)
    got = A.mla_attention(_tt(p), _t(x), positions=_t(pos), causal=causal,
                          **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_mla_init_has_the_reference_tree():
    cfg, tcfg = _cfgs()
    kw = _mla_kw(cfg)
    want = JA.mla_init(jax.random.key(0), cfg.d_model, pad_heads_to=1, **kw)
    got = A.mla_init(torch.Generator().manual_seed(0), tcfg.d_model, **kw)
    assert jax.tree_util.tree_map(lambda a: tuple(a.shape), got) == \
        jax.tree_util.tree_map(lambda a: tuple(a.shape), want)


@pytest.mark.parametrize("index", [0, 6, 11])
def test_latent_decode_attention_matches_reference(index):
    """The attention over the latent cache (whole max_len, masked by
    ``arange(S) <= index``) and the in-place cache update against the
    reference's, f32, 1e-5."""
    rng = np.random.default_rng(index)
    B, H, C, R, S = 2, 4, 32, 8, 12
    q_lat = rng.standard_normal((B, H, C)).astype(np.float32)
    q_rope = rng.standard_normal((B, H, R)).astype(np.float32)
    lat = rng.standard_normal((B, S, C)).astype(np.float32)
    rope = rng.standard_normal((B, S, R)).astype(np.float32)
    row_lat = rng.standard_normal((B, 1, C)).astype(np.float32)
    row_rope = rng.standard_normal((B, 1, R)).astype(np.float32)
    jlat = JD.sp_latent_cache_update(jnp.asarray(lat), row_lat, index)
    jrope = JD.sp_latent_cache_update(jnp.asarray(rope), row_rope, index)
    tlat, trope = _t(lat), _t(rope)
    assert DEC.sp_latent_cache_update(tlat, _t(row_lat), index) is tlat
    DEC.sp_latent_cache_update(trope, _t(row_rope), index)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(trope.numpy(), np.asarray(jrope), rtol=1e-5,
                               atol=1e-5)
    want = JD.sp_decode_attention_latent(q_lat, q_rope, jlat, jrope, index,
                                         nope_dim=16, rope_dim=R)
    got = DEC.sp_decode_attention_latent(_t(q_lat), _t(q_rope), tlat, trope,
                                         index, nope_dim=16, rope_dim=R)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_mla_decode_one_step_matches_reference():
    """One absorbed decode step of layer 0 (W_uk and W_uv split out of
    kv_b, both einsums in f32) over a cache whose earlier rows hold
    numbers: the output and both written caches, f32, 1e-5."""
    cfg, tcfg, tree, params = _pair("dense+moe", 2)
    lp = jax.tree_util.tree_map(lambda a: a[0], tree["g_dense"]["attn"])
    rng = np.random.default_rng(2)
    B, S, index = 2, 9, 5
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    lat = rng.standard_normal((B, S, cfg.mla.kv_lora)).astype(np.float32)
    rope = rng.standard_normal((B, S, cfg.mla.rope_dim)).astype(np.float32)
    want, jc = JLM._mla_decode(_jtree(lp), jnp.asarray(x),
                               {"lat": jnp.asarray(lat),
                                "rope": jnp.asarray(rope)}, cfg, 1, index)
    tlat, trope = _t(lat), _t(rope)
    got = lm._mla_decode(params["g_dense"][0]["attn"], _t(x), tlat, trope,
                         tcfg, index)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for name, t in (("lat", tlat), ("rope", trope)):
        np.testing.assert_allclose(t.numpy(), np.asarray(jc[name]),
                                   rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ model

LAYOUTS = ["dense+moe", "dense"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mla_prefill_matches_reference(layout):
    """``forward`` and the prefill step at the config's own capacity
    against the reference, f32, 1e-4."""
    cfg, tcfg, tree, params = _pair(layout, 1)
    assert [g for g, _ in lm.layer_groups(tcfg)] == layout.split("+")
    assert lm.layer_groups(tcfg) == JLM.layer_groups(cfg)
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
def test_mla_decode_steps_match_reference(layout):
    """Six decode steps: logits and every group's latent cache against the
    reference, f32, 1e-4.  The port writes its cache in place."""
    cfg, tcfg, tree, params = _pair(layout, 2)
    B, S = 2, 6
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
        assert set(cache[group]) == set(jcache[group]) == {"lat", "rope"}
        for name in ("lat", "rope"):
            np.testing.assert_allclose(cache[group][name].numpy(),
                                       np.asarray(jcache[group][name]),
                                       rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_mla_decode_matches_prefill(layout):
    """The port's absorbed decode loop against its decompressed prefill at
    every position, drop-free (capacity factor 8.0, as the reference's
    own test), at the reference's tolerance for this comparison
    (tests/test_arch_smoke.py's MLA decode-vs-forward test)."""
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


def test_mla_serve_greedy_tokens_match_reference():
    """``launch.serve.generate`` on the reduced deepseek-v3 against the
    reference launcher's loop on the same weights: the same greedy
    tokens."""
    cfg, tcfg, tree, params = _pair("dense+moe", 4)
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


# ------------------------------------------------------------ weights etc.

def test_deepseek_published_param_count():
    """deepseek-v3 at published width: the whole model is the published
    671 B, as the reference counts it; a dense and an MoE layer, the
    embedding and head, and the 3 dense + 2 MoE layers the card serves."""
    cfg = configs.get_config(ARCH)
    total = lm.param_count(cfg)
    assert total == 671_026_279_424 == JLM.param_count(
        jconfigs.get_config(ARCH))

    def count(n, **kw):
        return lm.param_count(dataclasses.replace(cfg, n_layers=n, **kw))
    # below first_k_dense = 3 layers the moe group's count goes negative:
    # a dense layer is counted with the MoE left out
    dense = count(2, moe=None) - count(1, moe=None)
    moe = count(5) - count(4)
    assert dense == 583_481_344 and moe == 11_507_283_968
    head = count(3) - 3 * dense
    assert head == 2 * cfg.padded_vocab * cfg.d_model + cfg.d_model
    assert total == head + 3 * dense + 58 * moe
    assert count(5) == 26_618_377_216


def test_convert_round_trips_mla_tree():
    """The converter splits each group of the reference's MLA tree into
    per-layer dicts with the shapes and dtypes of the port's own
    ``init_params``; both count what the reference's ``param_count``
    counts; a tree that does not fit raises."""
    cfg, tcfg, tree, params = _pair("dense+moe", 5)
    own = lm.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype),
                                    params)
    assert shapes == jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), t.dtype), own)
    assert sum(t.numel() for t in lm.tree_leaves(own)) == \
        lm.param_count(tcfg) == JLM.param_count(cfg)
    np.testing.assert_array_equal(
        params["g_moe"][0]["attn"]["kv_b"]["w"].numpy(),
        tree["g_moe"]["attn"]["kv_b"]["w"][0])
    bad = dict(tree, g_dense=dict(tree["g_dense"], attn={
        k: v for k, v in tree["g_dense"]["attn"].items() if k != "q_a"}))
    with pytest.raises(ValueError, match="does not fit"):
        lm_params_from_reference(bad, tcfg)


def test_mla_entry_points_need_a_card_unless_told_otherwise(monkeypatch):
    """The latent cache and the launcher run on ``cuda`` unless the caller
    names the CPU; without a card they raise instead of moving there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs()
    for call in (lambda: lm.init_cache(cfg, 1, 4),
                 lambda: main(["--arch", ARCH, "--tokens", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    cache = lm.init_cache(cfg, 1, 4, device="cpu")
    assert set(cache) == {"dense", "moe"}
    assert cache["moe"]["lat"].shape == (1, 1, 4, cfg.mla.kv_lora)
    assert cache["moe"]["rope"].device.type == "cpu"


def test_serve_launcher_runs_deepseek_reduced_on_cpu(capsys):
    main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
          "--prompt-len", "4", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "arch=deepseek-v3-671b" in out and "on cpu" in out
