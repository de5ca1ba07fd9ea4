"""The port's LM stack (dense family) held against the JAX package on the
same weights: the layers, ``forward``/``prefill`` (whose attention is K4's
plain version on the CPU), ``decode_step`` with its cache, the serving
launcher's greedy loop, the configs and the weight converter.

Weights come from the reference's ``init_params``, with random biases
planted so the QKV-bias path carries numbers, and cross as numpy arrays
through ``lm_params_from_reference``; everything runs in f32.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.train import make_decode_fn as jmake_decode_fn  # noqa: E402
from repro.train import make_prefill_step as jmake_prefill_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import make_decode_fn, make_prefill_step  # noqa: E402

DENSE = ["qwen2_7b", "stablelm_1_6b", "command_r_35b"]
# the families outside the dense one, each with the cache tensors its
# decode writes (keyed by layer group)
OTHER_FAMILIES = {"mamba2_130m": {"ssd": {"state"}},
                  "jamba_1_5_large_398b": {"hyb": {"k", "v", "state"}},
                  "seamless_m4t_large_v2": {"dec": {"k", "v"}},
                  "pixtral_12b": {"dense": {"k", "v"}}}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _plant_biases(tree, seed):
    """Random values in every bias leaf (the reference initializes them to
    zero), so the bias path is compared on numbers."""
    rng = np.random.default_rng(seed)

    def walk(x, key=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if key in ("b", "bias"):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return walk(tree)


def _pair(arch, seed):
    """(cfg, reference tree with planted biases, the port's params)."""
    cfg = jconfigs.get_config(arch).reduced()
    tree = _plant_biases(_np_tree(JLM.init_params(cfg, jax.random.key(seed))),
                         seed)
    return cfg, tree, lm_params_from_reference(tree, configs.get_config(
        arch).reduced())


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ------------------------------------------------------------------ layers

def _layer_case(name, rng):
    d, dff = 48, 80
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    if name == "rmsnorm":
        p = {"scale": rng.standard_normal(d).astype(np.float32)}
        return JL.rmsnorm(p, x), L.rmsnorm({"scale": _t(p["scale"])}, _t(x))
    if name == "layernorm":
        p = {"scale": rng.standard_normal(d).astype(np.float32),
             "bias": rng.standard_normal(d).astype(np.float32)}
        return JL.layernorm(p, x), L.layernorm(
            {k: _t(v) for k, v in p.items()}, _t(x))
    if name == "rope":
        xh = rng.standard_normal((2, 6, 3, 32)).astype(np.float32)
        pos = rng.integers(0, 64, (2, 6)).astype(np.int32)
        return (JL.apply_rope(xh, pos, 1e6),
                L.apply_rope(_t(xh), _t(pos), 1e6))
    gated = name == "ffn_swiglu"
    names = ("gate", "up", "down") if gated else ("up", "down")
    p = {n: {"w": (rng.standard_normal((dff, d) if n == "down" else (d, dff))
                   / 8).astype(np.float32)} for n in names}
    tp = {n: {"w": _t(v["w"])} for n, v in p.items()}
    return JL.ffn(p, x), L.ffn(tp, _t(x))


@pytest.mark.parametrize("name", ["rmsnorm", "layernorm", "rope",
                                  "ffn_swiglu", "ffn_gelu"])
def test_layer_matches_reference(name):
    want, got = _layer_case(name, np.random.default_rng(7))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_gqa_project_with_bias_matches_reference():
    """The projection prefill and decode run (``lm.gqa_project``, one
    device: every weight whole) against the reference's."""
    rng = np.random.default_rng(8)
    d, hq, hkv, hd = 64, 6, 2, 16
    p = {}
    for n, width in (("q", hq * hd), ("k", hkv * hd), ("v", hkv * hd)):
        p[n] = {"w": (rng.standard_normal((d, width)) / 8).astype(np.float32),
                "b": rng.standard_normal(width).astype(np.float32)}
    x = rng.standard_normal((2, 7, d)).astype(np.float32)
    pos = np.arange(3, 10, dtype=np.int32)[None].repeat(2, 0)
    kw = dict(n_heads=hq, n_kv=hkv, head_dim=hd, rope_theta=1e6)
    want = JA.gqa_project(p, x, pad_heads_to=1, positions=pos, **kw)
    whole = lm.TensorParallel(hq, hkv, hd, heads=(0, hq), kv=(0, hkv))
    tp = {n: {k: _t(a) for k, a in v.items()} for n, v in p.items()}
    for every_head in (False, True):
        got = lm.gqa_project(tp, _t(x), whole, _t(pos), 1e6,
                             every_head=every_head)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_forms_match_reference(causal):
    """The port's plain chunked form and einsum oracle against the
    reference's, on group-expanded k/v with a ragged last block."""
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 40, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 16)).astype(np.float32)
    kx, vx = JA.expand_kv(k, 6), JA.expand_kv(v, 6)
    np.testing.assert_array_equal(A.expand_kv(_t(k), 6).numpy(),
                                  np.asarray(kx))
    want = JA.chunked_attention(q, kx, vx, causal=causal, block_kv=16)
    got = A.chunked_attention(_t(q), _t(np.asarray(kx)), _t(np.asarray(vx)),
                              causal=causal, block_kv=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    oracle = A.full_attention(_t(q), _t(np.asarray(kx)), _t(np.asarray(vx)),
                              causal=causal)
    np.testing.assert_allclose(
        oracle.numpy(), np.asarray(JA.full_attention(q, kx, vx,
                                                     causal=causal)),
        rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_reference(arch):
    """``forward`` and the prefill step against the reference in f32 (the
    port's attention is K4's plain version; the reference's is
    ``chunked_attention`` on expanded k/v)."""
    cfg, tree, params = _pair(arch, 1)
    tcfg = configs.get_config(arch).reduced()
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, (2, 24))
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


def test_decode_steps_match_reference():
    """Eight decode steps: logits and both caches against the reference,
    f32, 1e-4.  The port writes its cache in place."""
    cfg, tree, params = _pair("qwen2_7b", 2)
    tcfg = configs.get_config("qwen2_7b").reduced()
    B, S = 2, 8
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (B, S))
    jt = _jtree(tree)
    jstep = jax.jit(jmake_decode_fn(cfg, dtype=jnp.float32))
    jcache = JLM.init_cache(cfg, B, S, dtype=jnp.float32)
    step = make_decode_fn(tcfg, dtype=torch.float32)
    cache = lm.init_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
    for t in range(S):
        jl, jcache = jstep(jt, jcache, jnp.asarray(toks[:, t:t + 1],
                                                   jnp.int32), jnp.int32(t))
        tl, cache = step(params, cache, _t(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache["dense"][name].numpy(),
                                   np.asarray(jcache["dense"][name]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen2_7b", "stablelm_1_6b"])
def test_decode_matches_prefill(arch):
    """The port's own decode loop against its prefill (K4's plain
    version) at every position, at the reference's own tolerance for this
    comparison (tests/test_arch_smoke.py's decode-vs-forward test)."""
    cfg = configs.get_config(arch).reduced()
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


def test_serve_greedy_tokens_match_reference():
    """``launch.serve.generate`` against the reference launcher's loop
    (copied here: its ``main`` draws its own weights) on the same weights
    and prompt: the same greedy tokens."""
    cfg, tree, params = _pair("qwen2_7b", 4)
    tcfg = configs.get_config("qwen2_7b").reduced()
    B, P, N = 2, 6, 10
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
    assert got.steps == P + N and got.prompt_logits.shape == (
        B, cfg.padded_vocab)


def test_lm_entry_points_need_a_card_unless_told_otherwise(monkeypatch):
    """The cache and the launcher run on ``cuda`` unless the caller names
    the CPU; without a card they raise instead of moving to the CPU."""
    from repro_torch.launch.serve import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config("qwen2_7b").reduced()
    for call in (lambda: lm.init_cache(cfg, 1, 4),
                 lambda: main(["--tokens", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    cache = lm.init_cache(cfg, 1, 4, device="cpu")
    assert cache["dense"]["k"].device.type == "cpu"


def test_serve_launcher_runs_reduced_on_cpu(capsys):
    from repro_torch.launch.serve import main
    main(["--device", "cpu", "--batch", "2", "--prompt-len", "4",
          "--tokens", "3"])
    out = capsys.readouterr().out
    assert "ms/token-step) on cpu" in out and "sample:" in out


# ------------------------------------------------------------ configs etc.

@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_reference(arch):
    for c in (lambda a: a, lambda a: a.reduced()):
        want = dataclasses.asdict(c(jconfigs.get_config(arch)))
        got = dataclasses.asdict(c(configs.get_config(arch)))
        assert got == want
    assert lm.layer_groups(configs.get_config(arch)) == \
        JLM.layer_groups(jconfigs.get_config(arch))
    assert configs.ARCHS == jconfigs.ARCHS
    assert configs.get_config(arch.replace("_", "-")).name == \
        jconfigs.get_config(arch).name


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_and_converted_shapes(arch):
    """The converter's per-layer dicts have the shapes and dtypes of the
    port's own ``init_params``, and both count what the reference's
    ``param_count`` counts (also at full width, from the config)."""
    cfg, tree, params = _pair(arch, 5)
    tcfg = configs.get_config(arch).reduced()
    own = lm.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype),
                                    params)
    assert shapes == jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), t.dtype), own)
    assert sum(t.numel() for t in jax.tree_util.tree_leaves(own)) == \
        lm.param_count(tcfg) == JLM.param_count(cfg)
    assert lm.param_count(configs.get_config(arch)) == \
        JLM.param_count(jconfigs.get_config(arch))
    np.testing.assert_array_equal(
        params["g_dense"][1]["attn"]["k"]["w"].numpy(),
        tree["g_dense"]["attn"]["k"]["w"][1])
    bad = dict(tree, embed={"table": tree["embed"]["table"][:-1]})
    with pytest.raises(ValueError, match="does not fit"):
        lm_params_from_reference(bad, tcfg)


@pytest.mark.parametrize("arch", sorted(OTHER_FAMILIES))
def test_model_builds_for_families_beyond_dense(arch):
    """The SSM, hybrid, encdec and vlm families build, count and cache
    (the encoder keeps no cache); a family the port does not know
    raises."""
    cfg = configs.get_config(arch).reduced()
    params = lm.init_params(cfg, torch.Generator())
    cache = lm.init_cache(cfg, 1, 4, device="cpu")
    assert sum(t.numel() for t in lm.tree_leaves(params)) == \
        lm.param_count(cfg)
    assert {g: set(c) for g, c in cache.items()} == OTHER_FAMILIES[arch]
    with pytest.raises(ValueError, match="unknown family"):
        lm.param_count(dataclasses.replace(cfg, family="audio"))
