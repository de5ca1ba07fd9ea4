"""The port's SSM and hybrid families held against the JAX package on the
same weights: ``models.mamba`` (the chunked SSD scan, its sequential
oracle, the full block and the one-token decode step) and the ``ssd`` and
``hyb`` groups of ``models.lm`` (forward, prefill, decode with the state
cache), the weight converter for the hybrid's list of sublayers, the
parameter counts and the serving launcher.

Inputs are made from numpy seeds; the reference's weights cross as numpy
arrays (``lm_params_from_reference`` for a whole model); everything runs
in f32 on the CPU.

Tolerances.  A layer is held to 1e-5 of its output's largest magnitude:
the scan sums up to ``chunk`` terms of that magnitude in another order
than XLA's CPU dot, so the elementwise gap reaches 3.6e-5 at |y| ≈ 32
(chunk 32), and each package's own gap to a float64 oracle is of the same
size.  Models are held to 1e-4 elementwise, except the reduced jamba's
whole stack: its 16 sublayers of random weights amplify f32 rounding (a
one-ulp change of the reference's own embedding moves its hidden states by
2.3e-4 to 1.2e-3 over seeds 0-2), so the stack is held to 5e-3 and every
sublayer on the reference's own input to 1e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.train import make_decode_fn as jmake_decode_fn  # noqa: E402
from repro.train import make_prefill_step as jmake_prefill_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch.serve import generate, main  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.train import make_decode_fn, make_prefill_step  # noqa: E402

MAMBA, JAMBA = "mamba2_130m", "jamba_1_5_large_398b"
LAYER_TOL = 1e-5
MODEL_TOL = {MAMBA: 1e-4, JAMBA: 5e-3}


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_layer_close(got, want, tol=LAYER_TOL):
    """max |got − want| ≤ tol · max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    gap, scale = np.abs(got - want).max(), np.abs(want).max()
    assert gap <= tol * scale, f"gap {gap} above {tol} × {scale}"


def _scan_inputs(seed, b=2, S=64, H=4, dh=16, N=16):
    """x, Δ (post-softplus), A (the reference's −1..−16), B, C, D."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, S, H, dh)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, S, H)) - 1.0)).astype(
        np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    B = rng.standard_normal((b, S, N)).astype(np.float32)
    C = rng.standard_normal((b, S, N)).astype(np.float32)
    D = (1.0 + 0.1 * rng.standard_normal(H)).astype(np.float32)
    return x, dt, A, B, C, D


# ------------------------------------------------------------------ layer

@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_chunked_matches_reference(chunk):
    args = _scan_inputs(chunk)
    want = JM.ssd_chunked(*map(jnp.asarray, args), chunk=chunk)
    got = M.ssd_chunked(*map(_t, args), chunk=chunk)
    _assert_layer_close(got.numpy(), want)


def test_ssd_reference_matches_reference():
    args = _scan_inputs(1)
    want = JM.ssd_reference(*map(jnp.asarray, args))
    got = M.ssd_reference(*map(_t, args))
    _assert_layer_close(got.numpy(), want)


@pytest.mark.parametrize("chunk", [16, 32])
def test_ssd_chunked_matches_sequential_oracle(chunk):
    """The port's chunked scan against its own O(S) oracle, and both
    against a float64 oracle: the f32 gap is the scan's rounding."""
    args = _scan_inputs(chunk + 1)
    got = M.ssd_chunked(*map(_t, args), chunk=chunk)
    seq = M.ssd_reference(*map(_t, args))
    f64 = M.ssd_reference(*(_t(a).double() for a in args))
    _assert_layer_close(got.numpy(), seq.numpy())
    _assert_layer_close(got.numpy(), f64.numpy())
    _assert_layer_close(seq.numpy(), f64.numpy())


def test_ssd_chunked_raises_when_the_sequence_is_not_whole_chunks():
    args = _scan_inputs(2, S=40)
    with pytest.raises(AssertionError, match="divisible by chunk"):
        JM.ssd_chunked(*map(jnp.asarray, args), chunk=16)
    with pytest.raises(ValueError, match="divisible by chunk"):
        M.ssd_chunked(*map(_t, args), chunk=16)


def _block_case(seed, d=64, d_inner=128, d_state=16, head_dim=16):
    """(reference block weights as numpy with planted A_log, D, dt_bias
    and norm, the same as tensors, dims)."""
    p = _np_tree(JM.ssd_init(jax.random.key(seed), d, d_inner, d_state,
                             head_dim))
    rng = np.random.default_rng(seed)
    for name in ("A_log", "D", "dt_bias"):
        p[name] = (p[name] + 0.3 * rng.standard_normal(p[name].shape)
                   ).astype(np.float32)
    p["norm"]["scale"] = (1 + 0.1 * rng.standard_normal(d_inner)).astype(
        np.float32)
    tp = jax.tree_util.tree_map(_t, p)
    return p, tp, dict(d_inner=d_inner, d_state=d_state, head_dim=head_dim)


def test_ssd_apply_matches_reference():
    p, tp, dims = _block_case(3)
    x = np.random.default_rng(3).standard_normal((2, 32, 64)).astype(
        np.float32)
    want = JM.ssd_apply(_jtree(p), jnp.asarray(x), **dims, chunk=16)
    got = M.ssd_apply(tp, _t(x), **dims, chunk=16)
    _assert_layer_close(got.numpy(), want)


def test_ssd_decode_step_matches_reference():
    """One step from a random state: output and new state; the port's
    state tensor is the one written."""
    p, tp, dims = _block_case(4)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, 64)).astype(np.float32)
    st = rng.standard_normal((2, 8, 16, 16)).astype(np.float32)
    want_y, want_st = JM.ssd_decode_step(_jtree(p), jnp.asarray(x),
                                         jnp.asarray(st), **dims)
    state = _t(st)
    got_y, got_st = M.ssd_decode_step(tp, _t(x), state, **dims)
    assert got_st is state
    _assert_layer_close(got_y.numpy(), want_y)
    _assert_layer_close(got_st.numpy(), want_st)


def test_ssd_decode_steps_match_ssd_apply():
    """Decode stepped over S tokens from a zero state against the chunked
    block on the whole sequence."""
    _, tp, dims = _block_case(5)
    x = _t(np.random.default_rng(5).standard_normal((2, 32, 64)).astype(
        np.float32))
    full = M.ssd_apply(tp, x, **dims, chunk=16)
    state = torch.zeros(2, 8, 16, 16)
    steps = [M.ssd_decode_step(tp, x[:, t:t + 1], state, **dims)[0]
             for t in range(32)]
    _assert_layer_close(torch.cat(steps, 1).numpy(), full.numpy())


# ------------------------------------------------------------------ model

def _pair(arch, seed):
    cfg = jconfigs.get_config(arch).reduced()
    tcfg = configs.get_config(arch).reduced()
    tree = _np_tree(JLM.init_params(cfg, jax.random.key(seed)))
    return cfg, tcfg, tree, lm_params_from_reference(tree, tcfg)


def _assert_model_close(arch, got, want):
    tol = MODEL_TOL[arch]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_ssm_prefill_matches_reference(arch):
    """``forward`` and the prefill step of reduced mamba2-130m (2 ``ssd``
    layers) and reduced jamba (2 ``hyb`` periods of 8: attention at
    sublayer 3 on K4's plain version, MoE 8 experts top-2 at the odd
    sublayers) against the reference, f32."""
    cfg, tcfg, tree, params = _pair(arch, 0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    jt, jtoks = _jtree(tree), {"tokens": jnp.asarray(toks, jnp.int32)}
    want_x = JLM.forward(jt, jtoks, cfg, dtype=jnp.float32, remat=False)
    want_logits = jmake_prefill_step(cfg, dtype=jnp.float32)(jt, jtoks)
    got_x = lm.forward(params, {"tokens": _t(toks)}, tcfg,
                       dtype=torch.float32)
    got_logits = make_prefill_step(tcfg, dtype=torch.float32)(
        params, {"tokens": _t(toks)})
    _assert_model_close(arch, got_x.numpy(), want_x)
    _assert_model_close(arch, got_logits.numpy(), want_logits)


def test_jamba_sublayers_match_reference_on_its_inputs():
    """Every sublayer of both reduced jamba periods (mixer, then FFN or
    MoE) fed the reference's own residual stream: the port's output
    within 1e-4, so the stack's larger gap is amplified rounding."""
    cfg, tcfg, tree, params = _pair(JAMBA, 0)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 32))
    jt = _jtree(tree)
    x = np.asarray(jt["embed"]["table"][toks])
    pos, tpos = jnp.arange(32)[None], torch.arange(32)[None]
    s = cfg.ssm
    dims = dict(d_inner=s.expand * cfg.d_model, d_state=s.d_state,
                head_dim=s.head_dim)
    for layer in range(2):
        for i in range(cfg.attn_period):
            sub = jax.tree_util.tree_map(lambda a: a[layer],
                                         jt["g_hyb"]["sub"][i])
            tsub = params["g_hyb"][layer]["sub"][i]
            h = JLM._norm(cfg, sub["ln1"], jnp.asarray(x))
            th = lm._norm(tcfg, tsub["ln1"], _t(x))
            if i == cfg.attn_index:
                want = JLM._self_attention(sub["attn"], h, cfg, 1, pos)
                got = lm._self_attention(tsub["attn"], th, tcfg,
                                         lm.tensor_parallel(tcfg), tpos)
            else:
                want = JM.ssd_apply(sub["ssd"], h, **dims, chunk=s.chunk)
                got = M.ssd_apply(tsub["ssd"], th, **dims, chunk=s.chunk)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
            x = x + np.asarray(want)
            kind = "moe" if i % cfg.moe.every == 1 else "ffn"
            want = JLM._ffn_apply(sub["ffn"], JLM._norm(
                cfg, sub["ln2"], jnp.asarray(x)), cfg, kind)
            got = lm._ffn_apply(tsub["ffn"], lm._norm(tcfg, tsub["ln2"],
                                                      _t(x)), tcfg,
                                lm.tensor_parallel(tcfg), kind)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4)
            x = x + np.asarray(want)


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_ssm_decode_steps_match_reference(arch):
    """Eight decode steps: logits and every cache tensor (the SSM states;
    jamba's attention KV) against the reference, f32."""
    cfg, tcfg, tree, params = _pair(arch, 1)
    B, S = 2, 8
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, S))
    jt = _jtree(tree)
    jstep = jax.jit(jmake_decode_fn(cfg, dtype=jnp.float32))
    jcache = JLM.init_cache(cfg, B, S, dtype=jnp.float32)
    step = make_decode_fn(tcfg, dtype=torch.float32)
    cache = lm.init_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
    assert {g: {n: tuple(t.shape) for n, t in c.items()}
            for g, c in cache.items()} == \
        {g: {n: tuple(t.shape) for n, t in c.items()}
         for g, c in jcache.items()}
    for t in range(S):
        jl, jcache = jstep(jt, jcache, jnp.asarray(toks[:, t:t + 1],
                                                   jnp.int32), jnp.int32(t))
        tl, cache = step(params, cache, _t(toks[:, t:t + 1]), t)
        _assert_model_close(arch, tl.numpy(), jl)
    for group in cache:
        for name in cache[group]:
            _assert_model_close(arch, cache[group][name].numpy(),
                                jcache[group][name])


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_ssm_decode_matches_prefill(arch):
    """The port's decode loop against its prefill at every position, at
    the reference's tolerance for this comparison (the MoE at a capacity
    that drops nothing: a prefill group and a one-token step drop
    differently otherwise)."""
    cfg = configs.get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    params = lm.init_params(cfg, torch.Generator().manual_seed(3))
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 16)))
    x = lm.forward(params, {"tokens": toks}, cfg, dtype=torch.float32)
    full = x @ params["lm_head"]["w"]
    cache = lm.init_cache(cfg, 2, 16, dtype=torch.float32, device="cpu")
    for t in range(16):
        logits, cache = lm.decode_step(params, cache, toks[:, t:t + 1], t,
                                       cfg, dtype=torch.float32)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_mamba_serve_greedy_tokens_match_reference():
    """``launch.serve.generate`` on reduced mamba2-130m against the
    reference launcher's loop on the same weights: the same greedy
    tokens."""
    cfg, tcfg, tree, params = _pair(MAMBA, 4)
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

@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_convert_round_trips_ssm_trees(arch):
    """The converter splits ``g_ssd``, and ``g_hyb``'s list of stacked
    sublayers, into per-layer dicts with the shapes and dtypes of the
    port's own ``init_params``; both count what the reference counts; a
    tree that does not fit raises."""
    cfg, tcfg, tree, params = _pair(arch, 5)
    own = lm.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype),
                                    params)
    assert shapes == jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), t.dtype), own)
    assert sum(t.numel() for t in lm.tree_leaves(own)) == \
        lm.param_count(tcfg) == JLM.param_count(cfg)
    group = "g_ssd" if arch == MAMBA else "g_hyb"
    last = len(params[group]) - 1
    if arch == MAMBA:
        got = params[group][last]["ssd"]["bc_proj"]["w"]
        want = tree[group]["ssd"]["bc_proj"]["w"][last]
    else:
        got = params[group][last]["sub"][6]["ssd"]["bc_proj"]["w"]
        want = tree[group]["sub"][6]["ssd"]["bc_proj"]["w"][last]
    np.testing.assert_array_equal(got.numpy(), want)
    cut = dict(tree, **{group: jax.tree_util.tree_map(lambda a: a[:1],
                                                      tree[group])})
    with pytest.raises(ValueError, match="does not fit"):
        lm_params_from_reference(cut, tcfg)


@pytest.mark.parametrize("arch,layers,want", [
    (MAMBA, None, 167_616_960),
    (JAMBA, None, 397_706_697_984),
    (JAMBA, 8, 45_144_077_568)])
def test_ssm_published_param_count(arch, layers, want):
    """Full width: mamba2-130m, jamba's 72 layers and one 8-layer period,
    against the reference's ``param_count``; the card's jamba period
    (8 of its 16 experts) is counted too."""
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
        jcfg = dataclasses.replace(jcfg, n_layers=layers)
    assert lm.param_count(cfg) == JLM.param_count(jcfg) == want
    if layers is not None:
        cut = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=8))
        assert lm.param_count(cut) == 25_816_462_592


def test_ssm_cache_needs_a_card_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_config(JAMBA).reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(cfg, 1, 4)
    cache = lm.init_cache(cfg, 1, 4, device="cpu")
    assert set(cache["hyb"]) == {"k", "v", "state"}
    assert cache["hyb"]["state"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b"])
def test_serve_launcher_runs_ssm_reduced_on_cpu(arch, capsys):
    main(["--arch", arch, "--device", "cpu", "--batch", "2",
          "--prompt-len", "4", "--tokens", "3"])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "on cpu" in out
