"""The port's training slice held against the JAX package on the CPU: the
chunked loss, ``forward_train``'s loss and every gradient leaf (dense
family; the other families in ``test_torch_train_families.py``), K4's
backward against ``jax.grad`` of ``chunked_attention``, the optimizers and the schedule, the train step
(micro-batches, gradient compression), the data pipeline, ``ft.run`` with
checkpoint-restart and the training launcher.

Weights come from the reference's ``init_params`` and cross as numpy
arrays through ``lm_params_from_reference`` (a gradient tree has the
parameters' shape and converts the same way); inputs are made with numpy
from a seed; everything runs in f32.  Tolerances are stated per test.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.ckpt import checkpoint as jckpt  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.dist import compress as jcompress  # noqa: E402
from repro.dist import ft as jft  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import ckpt, configs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.dist import compress, ft  # noqa: E402
from repro_torch.kernels import flash_attention as K4  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

# a gradient or a parameter after a step, against the reference's: within
# this share of the reference leaf's largest magnitude (f32 sums taken in
# another order through two layers and the chunked loss)
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-5          # a loss (a mean over the batch's labels)
OPT_TOL = 1e-6            # an optimizer step on the same f32 inputs


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _plant_biases(tree, seed):
    """Random values in every bias leaf (the reference initializes them to
    zero), so the bias path carries numbers and gradients."""
    rng = np.random.default_rng(seed)

    def walk(x, key=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if key in ("b", "bias"):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return walk(tree)


def _cfgs(arch, **changes):
    return tuple(dataclasses.replace(c.reduced(), **changes)
                 for c in (jconfigs.get_config(arch),
                           configs.get_config(arch)))


def _pair(arch, seed, **changes):
    """(reference cfg, port cfg, reference tree, the port's params)."""
    jcfg, tcfg = _cfgs(arch, **changes)
    tree = _plant_biases(_np_tree(JLM.init_params(jcfg, jax.random.key(seed))),
                         seed)
    return jcfg, tcfg, tree, lm_params_from_reference(tree, tcfg)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _batch(cfg, seed, B=2, S=24, Sm=20):
    """Numpy inputs from ``batch_at``'s stream: tokens and labels (the
    last label −1); seamless's ``src_embeds``; pixtral's ``prefix_embeds``
    with the prefix positions' labels −1."""
    b = jdata.batch_at(jdata.DataConfig(cfg.vocab, S, B, seed=seed), 0)
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        b["src_embeds"] = rng.standard_normal(
            (B, Sm, cfg.d_model)).astype(np.float32)
    elif cfg.prefix_tokens:
        P = cfg.prefix_tokens
        b["prefix_embeds"] = rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32)
        b["labels"] = np.concatenate(
            [np.full((B, P), -1, np.int32), b["labels"]], 1)
    return b


def _leaf_close(got, want, tol=GRAD_TOL, what=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"{what}: max |d| {err:.3e} vs {tol} × {scale:.3e}"


def _trees_close(got, want, tol=GRAD_TOL):
    """Every leaf of the port's tree against the converted reference's."""
    g, w = lm.tree_leaves(got), lm.tree_leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == tuple(b.shape), i
        _leaf_close(a.detach().numpy(), b.numpy(), tol, f"leaf {i}")


# the parameters after AdamW steps, against the reference's: the L2 of the
# difference within this share of the L2 of the reference's update, per
# leaf.  AdamW's normalised update is sign-like where a gradient element
# is near zero, so a rounding-level difference in that element can move it
# by up to 2·lr; the losses of the later steps are the well-conditioned
# check of the same run.
UPDATE_TOL = 5e-2


def _updates_close(got, want, start, tol=UPDATE_TOL):
    for i, (a, b, c) in enumerate(zip(lm.tree_leaves(got),
                                      lm.tree_leaves(want),
                                      lm.tree_leaves(start))):
        err = float((a.detach() - b).norm())
        assert err <= tol * float((b - c).norm()), f"leaf {i}: {err:.3e}"


def _with_grad(params):
    leaves = [p.clone().requires_grad_() for p in lm.tree_leaves(params)]
    return leaves, opt.tree_unflatten(params, leaves)


# ------------------------------------------------------------------ loss

@pytest.mark.parametrize("S,chunk", [(37, 16), (32, 16), (20, 512)])
def test_lm_loss_and_its_gradient_match_reference(S, chunk):
    """The chunked CE, its pad chunk and −1 labels, and its gradient with
    respect to x and the LM head, against ``jax.value_and_grad`` of the
    reference's ``lm_loss``: loss rtol 1e-5, gradients GRAD_TOL."""
    jcfg, tcfg = _cfgs("stablelm_1_6b")
    rng = np.random.default_rng(S)
    x = rng.standard_normal((3, S, jcfg.d_model)).astype(np.float32)
    w = (0.1 * rng.standard_normal((jcfg.d_model, jcfg.padded_vocab))
         ).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab, (3, S)).astype(np.int32)
    labels[rng.random((3, S)) < 0.3] = -1
    labels[:, -1] = -1

    def jloss(x, w):
        return JLM.lm_loss({"lm_head": {"w": w}}, x, jnp.asarray(labels),
                           jcfg, chunk=chunk)
    want, (jgx, jgw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    got = lm.lm_loss({"lm_head": {"w": tw}}, tx, _t(labels), tcfg,
                     chunk=chunk)
    gx, gw = torch.autograd.grad(got, (tx, tw))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    _leaf_close(gx.numpy(), jgx, what="dx")
    _leaf_close(gw.numpy(), jgw, what="dw")


def test_lm_loss_with_every_label_masked_is_zero():
    """cnt = 0: the mean divides by max(cnt, 1), as the reference's."""
    _, tcfg = _cfgs("stablelm_1_6b")
    x = torch.randn(2, 10, tcfg.d_model)
    w = torch.randn(tcfg.d_model, tcfg.padded_vocab)
    loss = lm.lm_loss({"lm_head": {"w": w}}, x,
                      torch.full((2, 10), -1, dtype=torch.int32), tcfg, 4)
    assert float(loss) == 0.0


@pytest.mark.parametrize("arch", ["stablelm_1_6b", "qwen2_7b"])
def test_forward_train_loss_and_every_gradient_match_reference(arch):
    """stablelm (LayerNorm, ungated FFN) and qwen2 (RMSNorm, SwiGLU, QKV
    bias, GQA): the loss (rtol 1e-5) and every gradient leaf (GRAD_TOL of
    its largest magnitude) against ``jax.value_and_grad`` of the
    reference's ``forward_train``, the gradient tree converted as the
    parameters are.  The embedding gradient included: in f32 gathering
    first (the port) and casting first (the reference) are one function.
    Each layer runs under its checkpoint (recomputing K4's plain version
    on the CPU in the backward)."""
    jcfg, tcfg, tree, params = _pair(arch, 3)
    b = _batch(jcfg, 4, S=40)
    want, jgrads = jax.value_and_grad(JLM.forward_train)(
        _jtree(tree), {k: jnp.asarray(v) for k, v in b.items()}, jcfg,
        dtype=jnp.float32, block_kv=16, loss_chunk=16)
    leaves, live = _with_grad(params)
    got = lm.forward_train(live, {k: _t(v) for k, v in b.items()}, tcfg,
                           dtype=torch.float32, loss_chunk=16)
    grads = torch.autograd.grad(got, leaves)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    _trees_close(opt.tree_unflatten(params, grads),
                 lm_params_from_reference(_np_tree(jgrads), tcfg))


OTHER_FAMILIES = ["llama4_scout_17b_a16e", "deepseek_v3_671b", "mamba2_130m",
                  "jamba_1_5_large_398b", "seamless_m4t_large_v2",
                  "pixtral_12b"]


# ------------------------------------------------------------------ K4

def _k4_cases():
    for d, dv in K4.HEAD_DIMS:
        for causal in (True, False):
            for group, hkv in ((1, 2), (4, 1), (7, 1)):
                yield d, dv, causal, group, hkv


@pytest.mark.parametrize("D,Dv,causal,group,Hkv", list(_k4_cases()))
def test_flash_attention_backward_matches_jax_grad(D, Dv, causal, group,
                                                   Hkv, monkeypatch):
    """``flash_attention``'s gradient on the CPU (``FlashAttention``: the
    plain forward with its log-sum-exp, then ``flash_attention_backward``)
    against ``jax.vjp`` of the reference's ``chunked_attention`` over the
    group-expanded k/v, for every head-dim pair, causal and not, Sq ≠ Skv
    both ways, groups 1, 4 and 7: dq, dk, dv within 1e-5 of each one's
    largest magnitude (f32).  The backward takes KV blocks of 16 rows, so
    it walks several blocks and, causal, skips the q rows before each."""
    monkeypatch.setattr(K4, "BACKWARD_BLOCK_KV", 16)
    rng = np.random.default_rng(D + Dv + group + causal)
    B, Hq = 2, group * Hkv
    Sq, Skv = (40, 24) if group == 4 else (19, 45)
    q = rng.standard_normal((B, Sq, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, Dv)).astype(np.float32)
    do = rng.standard_normal((B, Sq, Hq, Dv)).astype(np.float32)
    scale = 1.0 / np.sqrt(D)

    def jattn(q, k, v):
        return JA.chunked_attention(q, JA.expand_kv(k, Hq),
                                    JA.expand_kv(v, Hq), causal=causal,
                                    block_kv=16, sm_scale=scale)
    _, vjp = jax.vjp(jattn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = K4.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                             tv.transpose(1, 2), causal=causal,
                             sm_scale=scale).transpose(1, 2)
    got = torch.autograd.grad(out, (tq, tk, tv), _t(do))
    for name, g, w in zip("qkv", got, want):
        _leaf_close(g.numpy(), w, 1e-5, f"d{name}")


def _bf16_exact(rng, shape):
    """Seeded normals rounded to bf16 values, held in f32."""
    a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return a.to(torch.bfloat16).to(torch.float32).numpy()


@pytest.mark.parametrize("D,Dv", [pytest.param(64, 64, id="64"),
                                  pytest.param(128, 128, id="128"),
                                  (160, 160), (192, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 7])
def test_rounding_backward_twin_matches_jax_grad(D, Dv, causal, group):
    """The plain backward with ``round_dtype=torch.bfloat16`` (P and dS
    rounded to bf16 before their products, as the bf16 backward kernel
    rounds them) on bf16-exact inputs, from the plain forward's f32 output
    and log-sum-exp, against ``jax.vjp`` of the reference's
    ``chunked_attention`` (f32), at every head-dim pair the kernel takes:
    dq, dk, dv within 2e-2 of each one's largest magnitude (K4's bf16
    tolerance; the rounding of P and dS is all that separates the two)."""
    rng = np.random.default_rng(D + group + 10 * causal)
    B, Hkv, Sq, Skv = 2, 1, 37, 53
    Hq = group * Hkv
    q = _bf16_exact(rng, (B, Sq, Hq, D))
    do = _bf16_exact(rng, (B, Sq, Hq, Dv))
    k = _bf16_exact(rng, (B, Skv, Hkv, D))
    v = _bf16_exact(rng, (B, Skv, Hkv, Dv))
    scale = 1.0 / np.sqrt(D)

    def jattn(q, k, v):
        return JA.chunked_attention(q, JA.expand_kv(k, Hq),
                                    JA.expand_kv(v, Hq), causal=causal,
                                    block_kv=16, sm_scale=scale)
    _, vjp = jax.vjp(jattn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (_t(a).transpose(1, 2) for a in (q, k, v, do))
    o, lse = K4.flash_attention_plain(tq, tk, tv, causal=causal,
                                      sm_scale=scale, return_lse=True)
    got = K4.flash_attention_backward_plain(tq, tk, tv, o, lse, tdo, causal,
                                            scale, round_dtype=torch.bfloat16)
    for name, g, w in zip("qkv", got, want):
        _leaf_close(g.transpose(1, 2).numpy(), w, 2e-2, f"d{name}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_backward_on_cpu_is_the_plain_version(dtype, causal):
    """``flash_attention_backward`` on CPU tensors (f32 and bf16) returns
    ``flash_attention_backward_plain``'s gradients bit for bit."""
    g = torch.Generator().manual_seed(5)
    q, do = (torch.randn(2, 4, 21, 32, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(2, 2, 34, 32, generator=g).to(dtype)
            for _ in range(2))
    o, lse = K4.flash_attention_plain(q, k, v, causal=causal,
                                      return_lse=True)
    got = K4.flash_attention_backward(q, k, v, o, lse, do, causal)
    want = K4.flash_attention_backward_plain(q, k, v, o, lse, do, causal)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


def _parent_backward(q, k, v, o, lse, do, causal=True, sm_scale=None):
    """``flash_attention_backward`` as it stood before the rounding option
    and the kernel dispatch: the f32 tensor code, kept here verbatim so
    that ``round_dtype=None`` is held to it bit for bit."""
    import math
    B, Hq, Sq, D = q.shape
    Hkv, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    g = Hq // Hkv
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(D)
    f32, dev = torch.float32, q.device
    qf = (q.to(f32) * scale).reshape(B, Hkv, g, Sq, D)
    dof = do.to(f32).reshape(B, Hkv, g, Sq, Dv)
    delta = (dof * o.to(f32).reshape(B, Hkv, g, Sq, Dv)).sum(-1)
    lse = lse.reshape(B, Hkv, g, Sq)
    qpos = torch.arange(Sq, device=dev)
    dq = torch.zeros((B, Hkv, g, Sq, D), dtype=f32, device=dev)
    dk = torch.zeros((B, Hkv, Skv, D), dtype=f32, device=dev)
    dv = torch.zeros((B, Hkv, Skv, Dv), dtype=f32, device=dev)
    for start in range(0, Skv, K4.BACKWARD_BLOCK_KV):
        end = min(start + K4.BACKWARD_BLOCK_KV, Skv)
        q0 = min(start, Sq) if causal else 0
        n = Sq - q0
        if n == 0:
            continue

        def rows(t):
            return t[:, :, :, q0:].reshape(B, Hkv, g * n, *t.shape[4:])

        kb = k[:, :, start:end].to(f32)
        vb = v[:, :, start:end].to(f32)
        qs, dos = rows(qf), rows(dof)
        s = qs @ kb.transpose(-1, -2)
        if causal:
            kpos = torch.arange(start, end, device=dev)
            s.view(B, Hkv, g, n, end - start).masked_fill_(
                kpos[None, :] > qpos[q0:, None], K4.NEG_INF)
        p = s.sub_(rows(lse[..., None])).exp_()
        dv[:, :, start:end] = p.transpose(-1, -2) @ dos
        ds = (dos @ vb.transpose(-1, -2)).sub_(rows(delta[..., None])).mul_(p)
        del p, s
        dq[:, :, :, q0:] += (ds @ kb).view(B, Hkv, g, n, D)
        dk[:, :, start:end] = ds.transpose(-1, -2) @ qs
    return ((dq * scale).reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group,D,Dv", [(1, 64, 64), (4, 192, 128)])
def test_backward_without_rounding_is_the_parents_bit_for_bit(
        causal, group, D, Dv, monkeypatch):
    """``flash_attention_backward_plain(..., round_dtype=None)`` equals the
    f32 tensor code it replaced (``_parent_backward``) bit for bit, over
    several KV blocks of 16 rows."""
    monkeypatch.setattr(K4, "BACKWARD_BLOCK_KV", 16)
    g = torch.Generator().manual_seed(group + D)
    q, do = torch.randn(1, 2 * group, 45, D, generator=g), \
        torch.randn(1, 2 * group, 45, Dv, generator=g)
    k = torch.randn(1, 2, 40, D, generator=g)
    v = torch.randn(1, 2, 40, Dv, generator=g)
    o, lse = K4.flash_attention_plain(q, k, v, causal=causal,
                                      return_lse=True)
    got = K4.flash_attention_backward_plain(q, k, v, o, lse, do, causal)
    want = _parent_backward(q, k, v, o, lse, do, causal)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_lse_is_the_rows_log_sum_exp(causal):
    """``return_lse``: log Σ exp(s·scale) over each row's unmasked columns
    (1e-5), the same by KV blocks of 16 as in one block."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 6, 30, 32, generator=g)
    k, v = (torch.randn(2, 3, 50, 32, generator=g) for _ in range(2))
    _, lse = K4.flash_attention_plain(q, k, v, causal=causal,
                                      return_lse=True, block_kv=16)
    s = q.reshape(2, 3, 2, 30, 32) @ k[:, :, None].transpose(-1, -2) \
        / np.sqrt(32)
    if causal:
        s = s.masked_fill(torch.ones(30, 50, dtype=torch.bool).triu(1),
                          float("-inf"))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).reshape(2, 6, 30),
                               rtol=1e-5, atol=1e-5)


def test_serving_takes_no_gradient_path():
    """Without a gradient, ``flash_attention`` returns the plain version's
    output with no graph; with one it runs ``FlashAttention``."""
    q, k, v = (torch.randn(1, 2, 8, 32) for _ in range(3))
    assert K4.flash_attention(q, k, v).grad_fn is None
    q.requires_grad_()
    assert type(K4.flash_attention(q, k, v).grad_fn).__name__ \
        == "FlashAttentionBackward"
    with torch.no_grad():
        assert K4.flash_attention(q, k, v).grad_fn is None


# ------------------------------------------------------------------ optimizers

def _opt_tree(rng):
    """Leaves factored (both trailing dims ≥ 128) and not, in dicts and
    a list of per-layer dicts, as the port's trees are."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return {"a": a(200, 150), "b": a(7),
            "layers": [{"w": a(130, 129), "s": a(130)}, {"w": a(5, 300),
                                                         "s": a(130)}]}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return _t(tree)


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree)]


def test_cosine_schedule_matches_reference():
    """lr at every step of warmup, decay and past the end (f32, 1e-6)."""
    want = jopt.cosine_schedule(3e-3, warmup=3, total=10)
    got = opt.cosine_schedule(3e-3, warmup=3, total=10)
    for step in range(13):
        np.testing.assert_allclose(float(got(step)), float(want(step)),
                                   rtol=OPT_TOL, atol=0)
        assert got(step).dtype == torch.float32


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}),
    ("adamw", {"weight_decay": 0.0, "b2": 0.999}),
    ("adafactor", {}),
    ("adafactor", {"weight_decay": 0.1, "min_factor_dim": 8}),
])
def test_optimizer_matches_reference_over_three_steps(name, kw):
    """AdamW and Adafactor (factored and unfactored leaves), under the
    cosine schedule, over 3 steps of seeded gradients: parameters and
    state after each step within 1e-6 of each leaf's largest magnitude."""
    rng = np.random.default_rng(len(kw))
    params = _opt_tree(rng)
    j = jopt.get_optimizer(name, schedule=jopt.cosine_schedule(1e-2, 1, 3),
                           **kw)
    t = opt.get_optimizer(name, schedule=opt.cosine_schedule(1e-2, 1, 3),
                          **kw)
    jp, tp = _jtree(params), _to_torch(params)
    js, ts = j.init(jp), t.init(tp)
    for step in range(3):
        grads = _opt_tree(rng)
        jp, js = j.update(_jtree(grads), js, jp, jnp.int32(step))
        tp, ts = t.update(_to_torch(grads), ts, tp, step)
        for got, want in zip(_flat((tp, ts)), _flat((jp, js))):
            assert got.shape == want.shape
            _leaf_close(got, want, OPT_TOL)


# ------------------------------------------------------------------ step

@pytest.mark.parametrize("micro,compress_grads,n_layers", [
    (1, False, 2), (2, False, 2), (1, True, 1), (2, True, 1)])
def test_make_train_step_matches_reference(micro, compress_grads, n_layers):
    """Three AdamW steps of ``make_train_step`` (f32) against the
    reference's, with 1 and 2 micro-batches and with
    ``make_grad_compressor``: the losses (rtol 1e-5) and every parameter
    after the steps (UPDATE_TOL).
    The compressor's scale is one max-abs a leaf: the reference's stacked
    leaf spans a group's layers, the port's one layer, so that case runs
    one layer a group, where the two are one function."""
    jcfg, tcfg, tree, params = _pair("qwen2_7b", 7, n_layers=n_layers)
    sched = (jopt.cosine_schedule(3e-3, 1, 4), opt.cosine_schedule(3e-3, 1, 4))
    jo = jopt.adamw(schedule=sched[0])
    to = opt.adamw(schedule=sched[1])
    jfn = jax.jit(jstep.make_train_step(
        jcfg, jo, dtype=jnp.float32, micro_batches=micro, block_kv=16,
        loss_chunk=16, compress_grads=jcompress.make_grad_compressor()
        if compress_grads else None))
    tfn = tstep.make_train_step(
        tcfg, to, dtype=torch.float32, micro_batches=micro, loss_chunk=16,
        compress_grads=compress.make_grad_compressor() if compress_grads
        else None)
    jp, js = _jtree(tree), jo.init(_jtree(tree))
    tp, ts = params, to.init(params)
    for step in range(3):
        b = _batch(jcfg, 10 + step, B=4, S=24)
        jp, js, jl = jfn(jp, js, {k: jnp.asarray(v) for k, v in b.items()},
                         jnp.int32(step))
        tp, ts, tl = tfn(tp, ts, {k: _t(v) for k, v in b.items()}, step)
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    _updates_close(tp, lm_params_from_reference(_np_tree(jp), tcfg), params)


def test_train_step_leaves_its_inputs_and_casts_all_but_the_table():
    """The step returns new trees (the caller's are unchanged), and the
    compute copy is in the compute dtype for every f32 leaf of a layer
    (1-D norm scales too, as the reference's stacked (L, d) leaves are)
    and every top-level matrix but the embedding table, which stays f32
    (gathered, then cast); ``ln_f`` stays f32."""
    _, tcfg, _, params = _pair("stablelm_1_6b", 1)
    before = [p.clone() for p in lm.tree_leaves(params)]
    o = opt.adamw(lr=1e-2)
    fn = tstep.make_train_step(tcfg, o, dtype=torch.float32, loss_chunk=8)
    b = {k: _t(v) for k, v in _batch(tcfg, 2).items()}
    new, _, loss = fn(params, o.init(params), b, 1)
    assert all(torch.equal(a, p) for a, p in zip(before,
                                                 lm.tree_leaves(params)))
    assert not torch.equal(new["lm_head"]["w"], params["lm_head"]["w"])
    assert loss.dtype == torch.float32 and loss.dim() == 0
    c = tstep._compute_copy(params, torch.bfloat16)
    assert c["embed"]["table"].dtype == torch.float32
    assert c["lm_head"]["w"].dtype == torch.bfloat16
    assert c["g_dense"][0]["attn"]["q"]["w"].dtype == torch.bfloat16
    assert c["g_dense"][0]["ln1"]["scale"].dtype == torch.bfloat16
    assert c["ln_f"]["scale"].dtype == torch.float32


ALL_FAMILIES = ["stablelm_1_6b", "qwen2_7b"] + OTHER_FAMILIES


@pytest.mark.parametrize("arch", ALL_FAMILIES)
def test_compute_copy_casts_the_leaves_the_reference_casts(arch):
    """Which leaves the train step's compute copy casts to bf16, against
    the reference's ``make_train_step`` rule (f32 leaves of ≥ 2 dims) on
    its stacked tree: a marker tree (1 where the reference casts, 0 where
    not) converted as the parameters are, then each of the port's leaves
    in bf16 exactly where its markers are 1, the embedding table (cast by
    the reference, gathered first by the port; ROADMAP, Queue 3) apart."""
    jcfg, tcfg, tree, params = _pair(arch, 2)
    marks = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, float(a.ndim >= 2 and
                                         a.dtype == np.float32), np.float32),
        tree)
    want = lm.tree_leaves(lm_params_from_reference(marks, tcfg))
    got = lm.tree_leaves(tstep._compute_copy(params, torch.bfloat16))
    table = params["embed"]["table"]
    assert len(got) == len(want)
    for i, (g, m) in enumerate(zip(got, want)):
        if g is table:
            continue
        assert bool((m == m.flatten()[0]).all()), f"leaf {i} mixes rules"
        cast = bool(m.flatten()[0] == 1)
        assert g.dtype == (torch.bfloat16 if cast else torch.float32), i


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("n_hosts,host_id,step", [(1, 0, 0), (1, 0, 7),
                                                  (4, 2, 3)])
def test_batch_at_is_the_reference_bit_for_bit(n_hosts, host_id, step):
    cfg = dict(vocab=1000, seq_len=33, global_batch=8, seed=5,
               n_hosts=n_hosts, host_id=host_id)
    want = jdata.batch_at(jdata.DataConfig(**cfg), step)
    got = data.batch_at(data.DataConfig(**cfg), step)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_graph_edge_shards_are_the_reference_bit_for_bit():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 100, 1001), rng.integers(0, 100, 1001)
    for n in (1, 3, 8):
        for (a, b), (c, d) in zip(data.graph_edge_shards(src, dst, n),
                                  jdata.graph_edge_shards(src, dst, n)):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


# ------------------------------------------------------------------ ft

def _ft_setup(arch="stablelm_1_6b", seed=11, **changes):
    jcfg, tcfg, tree, params = _pair(arch, seed, **changes)
    dcfg = dict(vocab=jcfg.vocab, seq_len=16, global_batch=4, seed=seed)
    return jcfg, tcfg, tree, params, dcfg


def _port_run(tcfg, params, dcfg, ckpt_dir, steps=6, **ftkw):
    o = opt.adamw(schedule=opt.cosine_schedule(3e-3, steps // 10, steps))
    fn = tstep.make_train_step(tcfg, o, dtype=torch.float32, loss_chunk=8)
    d = data.DataConfig(**dcfg)

    def data_fn(i):
        return {k: torch.from_numpy(v) for k, v in data.batch_at(d, i).items()}
    cfg = ft.FTConfig(ckpt_dir=str(ckpt_dir), ckpt_every=2, **ftkw)
    return ft.run(fn, params, o.init(params), data_fn, steps, cfg,
                  log_every=0)


def test_ft_run_losses_match_reference(tmp_path):
    """``ft.run`` on both packages from the same weights and data (AdamW,
    cosine schedule, f32, checkpoints every 2 steps): losses rtol 1e-5 at
    every step, the final parameters UPDATE_TOL."""
    jcfg, tcfg, tree, params, dcfg = _ft_setup()
    o = jopt.adamw(schedule=jopt.cosine_schedule(3e-3, 0, 6))
    jfn = jax.jit(jstep.make_train_step(jcfg, o, dtype=jnp.float32,
                                        block_kv=16, loss_chunk=8))
    d = jdata.DataConfig(**dcfg)
    jp, _, jlosses, _ = jft.run(
        jfn, _jtree(tree), o.init(_jtree(tree)),
        lambda i: {k: jnp.asarray(v) for k, v in jdata.batch_at(d, i).items()},
        6, jft.FTConfig(ckpt_dir=str(tmp_path / "j"), ckpt_every=2),
        log_every=0)
    tp, _, tlosses, state = _port_run(tcfg, params, dcfg, tmp_path / "t")
    assert state.step == 6 and state.restarts == 0
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_RTOL)
    _updates_close(tp, lm_params_from_reference(_np_tree(jp), tcfg), params)
    assert jckpt.list_steps(tmp_path / "j") == ckpt.list_steps(
        tmp_path / "t") == [2, 4, 5]


def test_ft_kill_and_resume_equals_an_uninterrupted_run(tmp_path):
    """A run killed at step 4 (``fail_at_step``) and resumed from its step-2
    checkpoint gives the uninterrupted run's losses and parameters bit for
    bit on the CPU; the checkpoint is the port's tree with its AdamW
    state.  (At 4 × 16 tokens the embedding's gradient, 8,192 elements, is
    summed serially; from 32,768 elements PyTorch's CPU sums it on several
    threads by float atomics, and two runs may differ in the last bit.)"""
    _, tcfg, _, params, dcfg = _ft_setup()
    _, _, full, _ = _port_run(tcfg, params, dcfg, tmp_path / "a")
    with pytest.raises(RuntimeError, match="injected failure at step 4"):
        _port_run(tcfg, params, dcfg, tmp_path / "b", fail_at_step=4)
    assert ckpt.list_steps(tmp_path / "b") == [2]
    p2, s2, tail, state = _port_run(tcfg, params, dcfg, tmp_path / "b")
    assert state.restarts == 1 and state.step == 6
    assert tail == full[3:]
    p1, s1, _, _ = _port_run(tcfg, params, dcfg, tmp_path / "a")
    assert all(torch.equal(a, b) for a, b in zip(
        lm.tree_leaves(p1), lm.tree_leaves(p2)))


def test_restore_rejects_a_mismatched_tree(tmp_path):
    """A checkpoint of another width: ``restore`` fails its shape assert
    and ``ft.run`` raises the reference's RuntimeError; ``resume="none"``
    starts over."""
    _, tcfg, _, params, dcfg = _ft_setup()
    _port_run(tcfg, params, dcfg, tmp_path, steps=2)
    _, wide, _, wparams, _ = _ft_setup(d_model=64, n_heads=2)
    with pytest.raises(AssertionError):
        ckpt.restore(tmp_path, 1, ft._tree(wparams,
                                           opt.adamw().init(wparams)))
    with pytest.raises(RuntimeError, match="does not match the current model"):
        _port_run(wide, wparams, dcfg, tmp_path, steps=2)
    _, _, losses, state = _port_run(wide, wparams, dcfg, tmp_path, steps=2,
                                    resume="none")
    assert len(losses) == 2 and state.restarts == 0


def test_restore_brings_bf16_leaves_back(tmp_path):
    tree = {"a": torch.randn(3, 4).to(torch.bfloat16), "b": [torch.arange(5)]}
    ckpt.save(tmp_path, 3, tree)
    got, step = ckpt.restore_latest(tmp_path, tree)
    assert step == 3 and got["a"].dtype == torch.bfloat16
    assert torch.equal(got["a"], tree["a"]) and torch.equal(got["b"][0],
                                                            tree["b"][0])
    (tmp_path / "step_00000009.tmp").mkdir()           # a torn write
    assert ckpt.restore_latest(tmp_path, tree)[1] == 3


# ------------------------------------------------------------------ launcher

def test_train_launcher_runs_on_cpu_and_resumes(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --reduced --steps
    20``: exit 0, the loss falls (the launcher asserts it); run again on
    the same checkpoint directory it finds the run complete."""
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--device",
           "cpu", "--reduced", "--steps", "20", "--ckpt-dir",
           str(tmp_path), "--ckpt-every", "5"]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "done: 20 steps" in out.stdout
    again = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=300)
    assert again.returncode == 0, again.stderr
    assert "restored step 19" in again.stdout and "already complete" in \
        again.stdout


def test_train_launcher_needs_a_card_unless_told_otherwise(monkeypatch,
                                                           tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--reduced", "--steps", "1", "--ckpt-dir",
                           str(tmp_path)])
