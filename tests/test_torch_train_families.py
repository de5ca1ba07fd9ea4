"""Training every LM family the port runs beside the dense one — MoE
(llama4-scout), MLA + MoE (deepseek-v3), SSM (mamba2), the hybrid
(jamba), the encoder–decoder (seamless) and the VLM (pixtral) — held
against the JAX package on the CPU: ``forward_train``'s loss and every
gradient leaf against ``jax.value_and_grad`` of the reference's, and one
``make_train_step`` against the reference's with the optimizer its
dry-run picks for the full configuration.

Each model runs at its reduced config in f32, from the reference's
``init_params`` (biases planted) through ``lm_params_from_reference``;
inputs come from ``batch_at``'s stream and seeded numpy.  A leaf is held
within ``GRAD_TOL`` of its largest magnitude.  The reduced jamba's
16-sublayer random stack amplifies f32 rounding (ROADMAP Queue 3), so it
is held by the rule the mesh decode of mamba2 is held by: no farther from
the reference's float64 gradient than ``F64_NOISE`` times the
reference's own f32 gradient is, with each of its sublayers held within
``GRAD_TOL`` through ``jax.vjp`` on the reference's own input and
cotangent.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.launch import dryrun as jdryrun  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import step as jstep  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import mamba as M  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

FAMILIES = ["llama4_scout_17b_a16e", "deepseek_v3_671b", "mamba2_130m",
            "jamba_1_5_large_398b", "seamless_m4t_large_v2", "pixtral_12b"]
JAMBA = "jamba_1_5_large_398b"
# a gradient leaf against the reference's: within this share of the
# reference leaf's largest magnitude (f32 sums in another order)
GRAD_TOL = 1e-4
# a loss (a mean over the batch's labels) against the reference's,
# relative: jamba's stack amplifies f32 rounding
LOSS_RTOL = 1e-4
# the parameters after a step: the L2 of the difference within this share
# of the L2 of the reference's update, per leaf (test_torch_train.py's
# rule: an optimizer's normalised update is sign-like where a gradient
# element is near zero)
UPDATE_TOL = 5e-2
# jamba: the port's distance to the reference's float64 result over the
# reference's own f32 distance to it
F64_NOISE = 1.2
# the reduced configs' batch: 2 rows of 32 tokens (whole SSD chunks of 16)
B, S = 2, 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


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


def _pair(arch, seed, one_a_group=False):
    """(reference cfg, port cfg, reference tree, the port's params) at the
    reduced config, or with ``one_a_group`` cut to one layer a layer
    group (``cfg_with_counts``)."""
    jcfg = jconfigs.get_config(arch).reduced()
    tcfg = configs.get_config(arch).reduced()
    if one_a_group:
        counts = {g: 1 for g, _ in lm.layer_groups(tcfg)}
        jcfg = jdryrun.cfg_with_counts(jcfg, counts)
        tcfg = dryrun.cfg_with_counts(tcfg, counts)
    tree = _plant_biases(_np_tree(JLM.init_params(jcfg, jax.random.key(seed))),
                         seed)
    return jcfg, tcfg, tree, lm_params_from_reference(tree, tcfg)


def _batch(cfg, seed, Sm=20):
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


def _named(tree, prefix=""):
    """(path, leaf) of the port's tree, in ``lm.tree_leaves`` order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _leaf_dist(got, want):
    """max |got − want| over the largest magnitude of ``want``."""
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) / scale


def _dists(got, want) -> dict:
    """Each leaf's ``_leaf_dist`` by path, the two trees in the port's
    layout."""
    g, w = list(_named(got)), lm.tree_leaves(want)
    assert len(g) == len(w)
    out = {}
    for (name, a), b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape), name
        out[name] = _leaf_dist(a.detach().numpy(), b.numpy())
    return out


def _worst(dists: dict) -> tuple:
    name = max(dists, key=dists.get)
    return dists[name], name


@contextlib.contextmanager
def _x64():
    """The reference in float64 for the span of the block."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", was)


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a, np.float64))
        if np.asarray(a).dtype == np.float32 else jnp.asarray(a), tree)


def _reference_grad(jcfg, tree, b, dtype):
    """``jax.value_and_grad`` of the reference's ``forward_train``."""
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    if dtype == jnp.float64:
        jb = {k: (v.astype(jnp.float64) if v.dtype == jnp.float32 else v)
              for k, v in jb.items()}
    return jax.value_and_grad(JLM.forward_train)(
        tree, jb, jcfg, dtype=dtype, block_kv=16, loss_chunk=16)


def _port_grad(tcfg, params, b):
    """The port's ``forward_train`` loss and its gradient tree, every leaf
    reached (``allow_unused=False``)."""
    leaves = [p.clone().requires_grad_() for p in lm.tree_leaves(params)]
    live = opt.tree_unflatten(params, leaves)
    loss = lm.forward_train(live, {k: _t(v) for k, v in b.items()}, tcfg,
                            dtype=torch.float32, loss_chunk=16)
    grads = torch.autograd.grad(loss, leaves)
    return loss, opt.tree_unflatten(params, list(grads))


# ------------------------------------------------------------------ gradient

@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_train_loss_of_every_other_family_matches_reference(arch):
    """MoE, MLA + MoE, SSM, hybrid, encoder–decoder and VLM (its prefix
    positions labelled −1): the loss within 1e-4 relative and every
    gradient leaf — none left without one — against
    ``jax.value_and_grad`` of the reference's ``forward_train``, within
    ``GRAD_TOL`` of the leaf's largest magnitude; jamba by the f64 rule
    (module docstring; its sublayers in
    ``test_jamba_sublayer_gradients_match_reference_on_its_inputs``)."""
    jcfg, tcfg, tree, params = _pair(arch, 5)
    b = _batch(jcfg, 6)
    want, jgrads = _reference_grad(jcfg, _jtree(tree), b, jnp.float32)
    got, grads = _port_grad(tcfg, params, b)
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    port = _dists(grads, lm_params_from_reference(_np_tree(jgrads), tcfg))
    if arch != JAMBA:
        worst, name = _worst(port)
        assert worst <= GRAD_TOL, f"{name}: {worst:.3e} above {GRAD_TOL}"
        return
    with _x64():
        _, g64 = _reference_grad(jcfg, _f64(tree), b, jnp.float64)
        g64 = lm_params_from_reference(_np_tree(g64), tcfg)
    port64, _ = _worst(_dists(grads, g64))
    ref64, _ = _worst(_dists(lm_params_from_reference(_np_tree(jgrads),
                                                      tcfg), g64))
    assert port64 <= F64_NOISE * ref64, (
        f"jamba's gradient {port64:.3e} from the reference's f64 one, above "
        f"{F64_NOISE} × the reference f32's {ref64:.3e}")


def _at(tree, path):
    """The leaf of a tree of dicts at a ``_named`` path of dict keys."""
    for key in path.strip("/").split("/"):
        tree = tree[key]
    return tree


def _sub_dict(tree, keys):
    return {k: tree[k] for k in keys}


def _jamba_halves(cfg, tcfg, i):
    """The two halves of hybrid sublayer ``i`` as (keys, reference fn,
    port fn), each fn(params, x) → the residual's increment: the mixer
    (attention at ``attn_index``, else SSD) after ``ln1``, then the FFN
    or MoE after ``ln2``."""
    s = cfg.ssm
    dims = dict(d_inner=s.expand * cfg.d_model, d_state=s.d_state,
                head_dim=s.head_dim, chunk=s.chunk)
    tp = lm.tensor_parallel(tcfg)
    kind = "moe" if i % cfg.moe.every == 1 else "ffn"
    if i == cfg.attn_index:
        mixer = "attn"

        def jmix(p, h):
            return JLM._self_attention(p, h, cfg, 1,
                                       jnp.arange(h.shape[1])[None],
                                       block_kv=16)

        def tmix(p, h):
            return lm._self_attention(p, h, tcfg, tp,
                                      torch.arange(h.shape[1])[None])
    else:
        mixer = "ssd"

        def jmix(p, h):
            return JM.ssd_apply(p, h, **dims)

        def tmix(p, h):
            return M.ssd_apply(p, h, **dims)
    return ((("ln1", mixer),
             lambda p, x: jmix(p[mixer], JLM._norm(cfg, p["ln1"], x)),
             lambda p, x: tmix(p[mixer], lm._norm(tcfg, p["ln1"], x))),
            (("ln2", "ffn"),
             lambda p, x: JLM._ffn_apply(p["ffn"], JLM._norm(
                 cfg, p["ln2"], x), cfg, kind),
             lambda p, x: lm._ffn_apply(p["ffn"], lm._norm(
                 tcfg, p["ln2"], x), tcfg, tp, kind)))


def test_jamba_sublayer_gradients_match_reference_on_its_inputs():
    """Every half-sublayer of both reduced jamba periods (the mixer after
    ``ln1``, then the FFN or MoE after ``ln2``), fed the reference's own
    residual stream and a seeded cotangent: the gradient of every
    parameter leaf and of the input through the port against ``jax.vjp``
    of the reference's, within ``GRAD_TOL`` of each one's largest
    magnitude — so the whole stack's larger distance is amplified
    rounding, not a wrong gradient."""
    jcfg, tcfg, tree, params = _pair(JAMBA, 5)
    rng = np.random.default_rng(7)
    toks = _batch(jcfg, 6)["tokens"]
    x = np.asarray(tree["embed"]["table"][toks])
    for layer in range(jcfg.n_layers // jcfg.attn_period):
        for i in range(jcfg.attn_period):
            jsub = jax.tree_util.tree_map(lambda a: jnp.asarray(a[layer]),
                                          tree["g_hyb"]["sub"][i])
            tsub = params["g_hyb"][layer]["sub"][i]
            for keys, jfn, tfn in _jamba_halves(jcfg, tcfg, i):
                jp, tp = _sub_dict(jsub, keys), _sub_dict(tsub, keys)
                y, vjp = jax.vjp(jfn, jp, jnp.asarray(x))
                ct = rng.standard_normal(y.shape).astype(np.float32)
                jgp, jgx = vjp(jnp.asarray(ct))
                leaves = [p.clone().requires_grad_()
                          for p in lm.tree_leaves(tp)]
                tx = _t(x).requires_grad_()
                out = tfn(opt.tree_unflatten(tp, leaves), tx)
                grads = torch.autograd.grad(out, leaves + [tx], _t(ct))
                got = _named(opt.tree_unflatten(tp, list(grads[:-1])))
                for name, g in list(got) + [("x", grads[-1])]:
                    w = jgx if name == "x" else _at(jgp, name)
                    assert tuple(g.shape) == tuple(np.shape(w)), name
                    d = _leaf_dist(g.numpy(), w)
                    assert d <= GRAD_TOL, (f"period {layer} sublayer {i} "
                                           f"{keys}: {name} {d:.3e}")
                x = x + np.asarray(y)


# ------------------------------------------------------------------ step

def _optimizers(arch):
    """The optimizer the dry-run picks for ``arch``'s full config (the
    port's rule against the reference's), built in both packages at its
    default learning rate."""
    name = dryrun.optimizer_default(configs.get_config(arch))
    assert name == jdryrun.optimizer_default(jconfigs.get_config(arch))
    return name, jopt.get_optimizer(name), opt.get_optimizer(name)


def _update_dists(got, want, start) -> dict:
    """Each leaf's ‖got − want‖ over the reference update's ‖want −
    start‖, by path."""
    out = {}
    for (name, a), b, c in zip(_named(got), lm.tree_leaves(want),
                               lm.tree_leaves(start)):
        out[name] = float((a.detach().double() - b.double()).norm()) / max(
            float((b.double() - c.double()).norm()), 1e-30)
    return out


def _reference_step(jcfg, jo, tree, b, dtype):
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    if dtype == jnp.float64:
        jb = {k: (v.astype(jnp.float64) if v.dtype == jnp.float32 else v)
              for k, v in jb.items()}
    fn = jstep.make_train_step(jcfg, jo, dtype=dtype, block_kv=16,
                               loss_chunk=16)
    return fn(tree, jo.init(tree), jb, jnp.int32(0))


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_of_every_other_family_matches_reference(arch):
    """One ``make_train_step`` (f32, the optimizer ``optimizer_default``
    picks for the full config: Adafactor for llama4-scout, deepseek-v3
    and jamba, AdamW for the rest) against the reference's
    ``make_train_step`` on the same weights and batch.  Adafactor's
    update clip takes the RMS of a reference leaf that stacks a layer
    group, and of one layer's leaf in the port (ROADMAP Queue 3), so its
    models run one layer a group (jamba one period of 8 sublayers), where
    the two are one function.  The loss within
    1e-4 relative, every parameter after the step within ``UPDATE_TOL``
    of the reference's update; jamba's parameters by the f64 rule (no
    farther from the reference's float64 step than ``F64_NOISE`` times
    the reference's f32 step is)."""
    name, jo, to = _optimizers(arch)
    jcfg, tcfg, tree, params = _pair(arch, 8, name == "adafactor")
    b = _batch(jcfg, 9)
    jp, _, jl = _reference_step(jcfg, jo, _jtree(tree), b, jnp.float32)
    fn = tstep.make_train_step(tcfg, to, dtype=torch.float32, loss_chunk=16)
    tp, _, tl = fn(params, to.init(params), {k: _t(v) for k, v in b.items()},
                   0)
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL)
    ref32 = lm_params_from_reference(_np_tree(jp), tcfg)
    port = _update_dists(tp, ref32, params)
    if arch != JAMBA:
        worst, leaf = _worst(port)
        assert worst <= UPDATE_TOL, f"{name} step, {leaf}: {worst:.3e}"
        return
    with _x64():
        j64, _, _ = _reference_step(jcfg, jo, _f64(tree), b, jnp.float64)
        ref64 = lm_params_from_reference(_np_tree(j64), tcfg)
    port64, leaf = _worst(_update_dists(tp, ref64, params))
    base, _ = _worst(_update_dists(ref32, ref64, params))
    assert port64 <= F64_NOISE * base, (
        f"jamba's {name} step, {leaf}: {port64:.3e} from the reference's "
        f"f64 step, above {F64_NOISE} × the reference f32's {base:.3e}")
