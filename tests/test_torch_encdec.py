"""The port's encoder–decoder and VLM families held against the JAX package
on the same weights: seamless-m4t-large-v2 (``enc`` and ``dec`` groups:
non-causal encoder self-attention, decoder self-attention, then
cross-attention over the encoder's output) and pixtral-12b (dense layers
behind the stub frontend's ``prefix_embeds``, and a reduced pixtral at its
published head dim, 160) — the blocks, ``forward``/``prefill``,
``decode_step`` with the encoder's memory, prefill against decode, the
published parameter counts, the weight converter and the serving
launcher's greedy tokens — and K4's plain version at head dim 160 and at
the decode's one-row cross-attention against the reference kernel.

The reduced configurations have 2 + 2 layers (seamless) or 2 (pixtral),
d_model 128 and 4 query heads over 2 KV heads, so the cross-attention
runs at group 2.  Inputs come from numpy seeds; the reference's weights
cross as numpy arrays (``lm_params_from_reference``); everything runs in
f32 on the CPU, where the port's attention is K4's plain version.  Blocks
and models are held to 1e-5 of their output's largest magnitude.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.train import make_decode_fn as jmake_decode_fn  # noqa: E402
from repro.train import make_prefill_step as jmake_prefill_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import make_decode_fn, make_prefill_step  # noqa: E402

SEAMLESS, PIXTRAL = "seamless_m4t_large_v2", "pixtral_12b"
# (arch, head dim): the reduced configs, and pixtral at its own head dim
CASES = [(SEAMLESS, None), (PIXTRAL, None), (PIXTRAL, 160)]
CASE_IDS = ["seamless", "pixtral", "pixtral-hd160"]
REL_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _cfgs(arch, head_dim=None):
    """The reduced (reference, port) configs, at ``head_dim`` if given."""
    jcfg, tcfg = (c.get_config(arch).reduced()
                  for c in (jconfigs, configs))
    if head_dim is not None:
        jcfg = dataclasses.replace(jcfg, head_dim=head_dim)
        tcfg = dataclasses.replace(tcfg, head_dim=head_dim)
    return jcfg, tcfg


def _pair(arch, head_dim, seed):
    jcfg, tcfg = _cfgs(arch, head_dim)
    tree = jax.tree_util.tree_map(
        np.array, JLM.init_params(jcfg, jax.random.key(seed)))
    return jcfg, tcfg, tree, lm_params_from_reference(tree, tcfg)


def _assert_rel_close(got, want, tol=REL_TOL):
    """Within ``tol`` of the reference's largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _batch(cfg, seed, B=2, S=24, Sm=40, prefix=True):
    """Numpy inputs: tokens; seamless's ``src_embeds`` (Sm ≠ S frames) or
    pixtral's ``prefix_embeds`` (its reduced 8 positions)."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal(
            (B, Sm, cfg.d_model)).astype(np.float32)
    elif prefix:
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _layer_slice(tree, group, i):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a[i]),
                                  tree[f"g_{group}"])


# ------------------------------------------------------------------ blocks

@pytest.mark.parametrize("S", [24, 1])
def test_enc_block_matches_reference(S):
    """One encoder layer (non-causal self-attention with RoPE, then the
    ungated FFN under layernorm) on the reference's inputs."""
    jcfg, tcfg, tree, params = _pair(SEAMLESS, None, 0)
    x = np.random.default_rng(0).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    for i in range(jcfg.n_encoder_layers):
        want = JLM._make_block(jcfg, "enc", 1, 1024)(
            jnp.asarray(x), _layer_slice(tree, "enc", i))
        got = lm._layer(_t(x), params["g_enc"][i], tcfg,
                        lm.tensor_parallel(tcfg), torch.arange(S)[None],
                        "enc")
        _assert_rel_close(got.numpy(), want)


@pytest.mark.parametrize("S,Sm", [(24, 40), (40, 7), (1, 40)])
def test_dec_block_matches_reference(S, Sm):
    """One decoder layer (causal self-attention, cross-attention over a
    memory of Sm ≠ S rows at group 2, then ln3 and the FFN) against the
    reference's ``_make_block`` with the same memory."""
    jcfg, tcfg, tree, params = _pair(SEAMLESS, None, 1)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, S, jcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, Sm, jcfg.d_model)).astype(np.float32)
    assert jcfg.n_heads // jcfg.n_kv_heads == 2
    for i in range(jcfg.n_layers):
        want = JLM._make_block(jcfg, "dec", 1, 1024, memory=jnp.asarray(mem))(
            jnp.asarray(x), _layer_slice(tree, "dec", i))
        got = lm._layer(_t(x), params["g_dec"][i], tcfg,
                        lm.tensor_parallel(tcfg), torch.arange(S)[None],
                        "dec", _t(mem))
        _assert_rel_close(got.numpy(), want)


# ------------------------------------------------------------------ models

@pytest.mark.parametrize("arch,head_dim", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("prefix", [True, False])
def test_forward_matches_reference(arch, head_dim, prefix):
    """``forward`` and the prefill step against the reference in f32:
    seamless on 24 tokens over 40 source frames (Sm ≠ S), pixtral with its
    prefix embeddings ahead of 24 tokens (positions over all 32) and
    without them (``prefix`` only matters there)."""
    jcfg, tcfg, tree, params = _pair(arch, head_dim, 2)
    batch = _batch(jcfg, 2, prefix=prefix)
    jt, jb = _jtree(tree), {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: _t(v) for k, v in batch.items()}
    want_x = JLM.forward(jt, jb, jcfg, dtype=jnp.float32, remat=False)
    want_logits = jmake_prefill_step(jcfg, dtype=jnp.float32)(jt, jb)
    got_x = lm.forward(params, tb, tcfg, dtype=torch.float32)
    got_logits = make_prefill_step(tcfg, dtype=torch.float32)(params, tb)
    S = 24 + (jcfg.prefix_tokens if "prefix_embeds" in batch else 0)
    assert got_x.shape == (2, S, tcfg.d_model)
    _assert_rel_close(got_x.numpy(), want_x)
    _assert_rel_close(got_logits.numpy(), want_logits)


def test_encode_is_the_forward_pass_memory():
    """``encode`` is the encoder pass ``forward`` runs: the reference's
    encoder group scanned over the source frames."""
    jcfg, tcfg, tree, params = _pair(SEAMLESS, None, 3)
    src = _batch(jcfg, 3)["src_embeds"]
    want = JLM._scan_group(jnp.asarray(src), _jtree(tree)["g_enc"],
                           JLM._make_block(jcfg, "enc", 1, 1024),
                           remat=False)
    got = lm.encode(params, _t(src), tcfg, dtype=torch.float32)
    _assert_rel_close(got.numpy(), want)


@pytest.mark.parametrize("arch,head_dim", CASES, ids=CASE_IDS)
def test_decode_steps_match_reference(arch, head_dim):
    """Eight decode steps, the encoder-decoder's against a memory of 13
    rows: logits and the decoder's KV cache against the reference, f32."""
    jcfg, tcfg, tree, params = _pair(arch, head_dim, 4)
    B, S = 2, 8
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    mem = (rng.standard_normal((B, 13, jcfg.d_model)).astype(np.float32)
           if jcfg.family == "encdec" else None)
    jt = _jtree(tree)
    jstep = jax.jit(jmake_decode_fn(jcfg, dtype=jnp.float32))
    jcache = JLM.init_cache(jcfg, B, S, dtype=jnp.float32)
    step = make_decode_fn(tcfg, dtype=torch.float32)
    cache = lm.init_cache(tcfg, B, S, dtype=torch.float32, device="cpu")
    assert {g: {n: tuple(t.shape) for n, t in c.items()}
            for g, c in cache.items()} == \
        {g: {n: tuple(t.shape) for n, t in c.items()}
         for g, c in jcache.items()}
    for t in range(S):
        jl, jcache = jstep(jt, jcache, jnp.asarray(toks[:, t:t + 1]),
                           jnp.int32(t),
                           None if mem is None else jnp.asarray(mem))
        tl, cache = step(params, cache, _t(toks[:, t:t + 1]), t,
                         None if mem is None else _t(mem))
        _assert_rel_close(tl.numpy(), jl)
    for group in cache:
        for name in cache[group]:
            _assert_rel_close(cache[group][name].numpy(),
                              jcache[group][name])


@pytest.mark.parametrize("arch,head_dim", CASES, ids=CASE_IDS)
def test_decode_matches_prefill(arch, head_dim):
    """The port's decode loop (seamless attending ``encode`` of 19
    frames) against its prefill's logits at every position, at the
    reference's tolerance for this comparison (2e-3); a vlm's decode
    embeds tokens only, so its prefill runs without the prefix."""
    _, cfg = _cfgs(arch, head_dim)
    params = lm.init_params(cfg, torch.Generator().manual_seed(5))
    batch = {k: _t(v) for k, v in _batch(cfg, 5, S=12, Sm=19,
                                         prefix=False).items()}
    toks = batch["tokens"]
    full = lm.forward(params, batch, cfg, dtype=torch.float32) \
        @ params["lm_head"]["w"]
    last, _ = lm.prefill(params, batch, cfg, dtype=torch.float32)
    torch.testing.assert_close(last[:, 0], full[:, -1])
    memory = (lm.encode(params, batch["src_embeds"], cfg,
                        dtype=torch.float32)
              if cfg.family == "encdec" else None)
    cache = lm.init_cache(cfg, 2, 12, dtype=torch.float32, device="cpu")
    for t in range(12):
        logits, cache = lm.decode_step(params, cache, toks[:, t:t + 1], t,
                                       cfg, dtype=torch.float32,
                                       memory=memory)
        np.testing.assert_allclose(logits[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-3, atol=2e-3)


def test_encdec_decode_needs_memory():
    _, cfg = _cfgs(SEAMLESS)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0))
    cache = lm.init_cache(cfg, 1, 2, dtype=torch.float32, device="cpu")
    assert set(cache) == {"dec"}
    with pytest.raises(ValueError, match="needs memory"):
        lm.decode_step(params, cache, torch.zeros(1, 1, dtype=torch.long), 0,
                       cfg, dtype=torch.float32)


def _reference_greedy(jcfg, tree, prompt, new_tokens, memory):
    """The reference launcher's loop (``repro.launch.serve.main``, which
    draws its own weights) on the given weights."""
    fn = jax.jit(jmake_decode_fn(jcfg, dtype=jnp.float32))
    B, P = prompt.shape
    cache = JLM.init_cache(jcfg, B, P + new_tokens, dtype=jnp.float32)
    jt, jp = _jtree(tree), jnp.asarray(prompt, jnp.int32)
    for t in range(P):
        logits, cache = fn(jt, cache, jp[:, t:t + 1], jnp.int32(t), memory)
    out = []
    for t in range(new_tokens):
        nxt = jnp.argmax(logits[:, -1, :jcfg.vocab], -1)[:, None].astype(
            jnp.int32)
        out.append(np.asarray(nxt))
        logits, cache = fn(jt, cache, nxt, jnp.int32(P + t), memory)
    return np.concatenate(out, 1)


@pytest.mark.parametrize("arch", [SEAMLESS, PIXTRAL])
def test_serve_launcher_greedy_tokens_match_reference(arch, capsys,
                                                      monkeypatch):
    """``python -m repro_torch.launch.serve --arch <arch> --device cpu``
    (reduced) on the reference's weights — the launcher's ``init_params``
    swapped for the converted tree — prints the greedy tokens of the
    reference launcher's loop with the same stub memory (zeros of (B, 8,
    d_model) for the encoder-decoder)."""
    jcfg, tcfg, tree, params = _pair(arch, None, 6)
    monkeypatch.setattr(serve, "init_params", lambda cfg, gen: params)
    B, P, N = 2, 5, 6
    serve.main(["--arch", arch, "--device", "cpu", "--batch", str(B),
                "--prompt-len", str(P), "--tokens", str(N), "--seed", "6"])
    out = capsys.readouterr().out
    assert f"arch={tcfg.name}" in out and "on cpu" in out
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab, (B, P))
    memory = (jnp.zeros((B, 8, jcfg.d_model), jnp.float32)
              if jcfg.family == "encdec" else None)
    want = _reference_greedy(jcfg, tree, prompt, N, memory)
    assert f"sample: {want[0][:16].tolist()}" in out
    got = serve.generate(params, tcfg, _t(prompt), N,
                         memory=None if memory is None
                         else torch.zeros(B, 8, tcfg.d_model))
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    assert got.finite


# ------------------------------------------------------------ weights etc.

@pytest.mark.parametrize("arch,head_dim", CASES, ids=CASE_IDS)
def test_convert_round_trips_trees(arch, head_dim):
    """The converter splits ``g_enc`` and ``g_dec`` (with ``ln3`` and
    ``xattn``), or pixtral's ``g_dense``, into per-layer dicts with the
    shapes and dtypes of the port's own ``init_params``; both count what
    the reference counts; a tree that does not fit raises."""
    jcfg, tcfg, tree, params = _pair(arch, head_dim, 7)
    own = lm.init_params(tcfg, torch.Generator().manual_seed(0))
    shapes = jax.tree_util.tree_map(lambda t: (tuple(t.shape), t.dtype),
                                    params)
    assert shapes == jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), t.dtype), own)
    assert sum(t.numel() for t in lm.tree_leaves(own)) == \
        lm.param_count(tcfg) == JLM.param_count(jcfg)
    group = "g_dec" if jcfg.family == "encdec" else "g_dense"
    np.testing.assert_array_equal(
        params[group][1]["attn"]["q"]["w"].numpy(),
        tree[group]["attn"]["q"]["w"][1])
    if jcfg.family == "encdec":
        np.testing.assert_array_equal(
            params[group][1]["xattn"]["v"]["w"].numpy(),
            tree[group]["xattn"]["v"]["w"][1])
    cut = dict(tree, **{group: jax.tree_util.tree_map(lambda a: a[:1],
                                                      tree[group])})
    with pytest.raises(ValueError, match="does not fit"):
        lm_params_from_reference(cut, tcfg)


@pytest.mark.parametrize("arch,want", [(SEAMLESS, 1_632_356_352),
                                       (PIXTRAL, 12_772_070_400)])
def test_published_param_count(arch, want):
    """The full configurations against the reference's ``param_count``."""
    assert lm.param_count(configs.get_config(arch)) == \
        JLM.param_count(jconfigs.get_config(arch)) == want


# ------------------------------------------------------------------ K4

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_hd160_matches_reference(causal, dtype):
    """K4's plain version at pixtral's head dim (160, group 4) against the
    Pallas kernel in interpret mode, at ``tests/test_kernels.py``'s
    tolerances."""
    rng = np.random.default_rng(8)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((1, 8, 128, 160), (1, 2, 128, 160), (1, 2, 128, 160))]
    jd, td = (jnp.float32, torch.float32) if dtype == "float32" \
        else (jnp.bfloat16, torch.bfloat16)
    want = jops.flash_attention(*(jnp.asarray(a, jd) for a in arrs),
                                causal=causal, block_q=64, block_kv=64,
                                interpret=True)
    got = ops.flash_attention(*(_t(a).to(td) for a in arrs), causal=causal)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def test_flash_attention_one_query_row_matches_reference():
    """The decode's cross-attention: one query row over 300 memory rows,
    not causal, seamless's reduced head split (group 2), against the
    reference's einsum oracle."""
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((2, 4, 1, 64), (2, 2, 300, 64), (2, 2, 300, 64)))
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                    causal=False)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
