"""Training over the (data, model) mesh held against the JAX package on the
CPU: qwen2 reduced under ``SINGLE_POD_RULES`` on ``make_test_mesh(2, 4)``
(8 gloo ranks), its parameters placed ZeRO-3 (``place_params(mesh,
zero=True)``), trained by ``make_train_step(mp=4)`` — the case of the
reference's ``test_sharded_train_step_runs_and_improves``, whose own
8-device run does not run here.

The ranks are held against the reference's one-device functions on the
same converted weights: the step-0 loss (``LOSS_RTOL``) and every
gradient leaf gathered whole (within ``GRAD_TOL`` of its largest
magnitude) against ``jax.value_and_grad``; three AdamW steps' losses and
the parameters after them (``UPDATE_TOL``) and two micro-batched steps
against the reference's ``make_train_step``; eight steps with the last
loss below the first (the reference test's assertion).  Adafactor and the
gradient compressor run on the same config cut to one layer, where the
reference's stacked layer leaves and the port's per-layer leaves are one
function (Adafactor's clip and the int8 scale take a whole leaf), against
the reference's ``make_train_step(mp=4)``; the compressor's codes on
blocks equal one device's bit for bit.  The vocab-parallel ``lm_loss`` and its gradients
are held against the reference's ``lm_loss``, the differentiable
collectives against their definitions.

Every rank job runs in one spawn (a module-scoped fixture).  A spawned
rank imports this module to find its job, so the JAX package is imported
in fixtures and tests only.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.data import pipeline as data  # noqa: E402
from repro_torch.dist import collectives as coll  # noqa: E402
from repro_torch.dist import compress  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.dist.mesh import as_axis, run_on_ranks  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import shardings as TS  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402

TIMEOUT = 400
MP = 4
LR = 1e-2
SEQ, BATCH = 64, 4                 # the reference test's DataConfig
BLOCK_KV = LOSS_CHUNK = 32
STEPS, COMPARED = 8, 3             # steps run; steps held step by step
VARIANT_STEPS = 2
# a gradient leaf within this share of its largest magnitude (one device
# against the reference is held at 1e-4 in test_torch_train.py); a loss and
# the parameters after steps at test_torch_train.py's tolerances
GRAD_TOL = 1e-5
LOSS_RTOL = 1e-5
UPDATE_TOL = 5e-2
# the vocab-parallel loss: rows, positions (a pad chunk), chunk
LOSS_B, LOSS_S, LOSS_CH = 4, 37, 16


def _cfg(get=configs.get_config, n_layers=None):
    """qwen2 reduced (``get``: the port's or the reference's configs), cut
    to ``n_layers``."""
    cfg = get("qwen2_7b").reduced()
    return cfg if n_layers is None else dataclasses.replace(
        cfg, n_layers=n_layers)


def _plant_biases(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(x, key=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if key in ("b", "bias"):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return walk(tree)


def _batches(n):
    d = data.DataConfig(_cfg().vocab, SEQ, BATCH)
    return [data.batch_at(d, i) for i in range(n)]


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _place(params, mesh, zero=True):
    """``params`` (whole) cut part by part as ``init_params(place=...)``
    cuts them; (blocks, sanitized specs)."""
    place = TS.place_params(mesh, zero=zero)
    local = {k: ([place(f"['{k}'][{i}]", lp) for i, lp in enumerate(v)]
                 if isinstance(v, list) else place(f"['{k}']", v))
             for k, v in params.items()}
    return local, TS.placed_specs(place)


def _gathered(tree, specs, mesh, site="test"):
    return TS.gather_tree(tree, specs, mesh, site=site)


# ------------------------------------------------------------ rank jobs

def _run(mesh, params, specs, optimizer, n_steps, batches, keep=(),
         cfg=None, **kw):
    """``n_steps`` of the mesh's step from ``params`` (the rank's blocks of
    ``cfg``, by default ``_cfg()``): the losses, and the whole parameters
    after each step in ``keep``."""
    step = tstep.make_train_step(cfg or _cfg(), optimizer, mp=MP,
                                 dtype=torch.float32, loss_chunk=LOSS_CHUNK,
                                 specs=specs, **kw)
    _mesh, axes = tstep.mesh_axes(specs)
    state = optimizer.init(params, axes=axes)
    losses, kept = [], {}
    for i in range(n_steps):
        params, state, loss = step(params, state, _torch_batch(batches[i]),
                                   i)
        losses.append(float(loss))
        if i + 1 in keep:
            kept[i + 1] = _gathered(params, specs, mesh)
    return losses, kept


def _cotangent(g, y):
    return g.reshape(-1)[:y.numel()].reshape(y.shape)


def _collectives_job(mesh, x, g):
    """The autograd collectives on the model axis, forward and backward."""
    model = as_axis(mesh, "model")
    r = model.rank
    out = {}
    xr = x[r].clone()
    out["reduce_scatter"] = coll.reduce_scatter(xr, model, 1, site="t")
    out["psum"] = coll.psum(xr, model, site="t")
    xb = xr.to(torch.bfloat16)
    out["reduce_scatter_bf16"] = coll.reduce_scatter(xb, model, 1, site="t")
    out["psum_bf16"] = coll.psum(xb, model, site="t")
    leaf = xr.clone().requires_grad_()
    cases = {
        "psum_grad": lambda t: coll.psum_grad(t, model, site="t"),
        "copy_grad": lambda t: coll.copy_grad(t, model, site="t"),
        "gather": lambda t: coll.all_gather_grad(t, model, 1, site="t"),
        "gather_alike": lambda t: coll.all_gather_grad(t, model, 1,
                                                       site="t", alike=True),
        "reduce_scatter_grad": lambda t: coll.reduce_scatter_grad(
            t, model, 1, site="t"),
        "slice": lambda t: coll.slice_grad(t, model, 1, site="t"),
    }
    for name, fn in cases.items():
        y = fn(leaf)
        (dx,) = torch.autograd.grad(y, leaf, _cotangent(g[r], y))
        out[name] = (y.detach(), dx)
    return coll.gather_objects(out, mesh)


def _train_job(mesh, params, params1, batches, grad_tree, loss_case):
    """Every training case of the module on one rank of (2, 4);
    ``params1``: the one-layer tree of Adafactor and the compressor."""
    cfg = _cfg()
    out = {}
    with S.use_rules(S.SINGLE_POD_RULES, mesh):
        local, specs = _place(params, mesh)
        out["gathered"] = _gathered(local, specs, mesh)
        out["specs"] = specs
        out["shapes"] = [tuple(t.shape) for t in lm.tree_leaves(local)]
        # the loss and every gradient leaf of step 0
        grad_fn = tstep.make_grad_fn(cfg, mp=MP, dtype=torch.float32,
                                     loss_chunk=LOSS_CHUNK, specs=specs)
        coll.reset_counts()
        loss, grads = grad_fn(local, _torch_batch(batches[0]))
        out["grad_counts"] = coll.counts()
        out["loss0"] = float(loss)
        out["losses_alike"] = coll.gather_objects(float(loss), mesh)
        out["grads"] = _gathered(opt.tree_unflatten(local, grads), specs,
                                 mesh)
        # AdamW over STEPS, the parameters after COMPARED of them
        out["adamw"] = _run(mesh, local, specs, opt.adamw(lr=LR), STEPS,
                            batches, keep=(COMPARED,))
        out["micro"] = _run(mesh, local, specs, opt.adamw(lr=LR),
                            VARIANT_STEPS, batches, keep=(VARIANT_STEPS,),
                            micro_batches=2)
        local1, specs1 = _place(params1, mesh)
        out["adafactor"] = _run(mesh, local1, specs1, opt.adafactor(lr=LR),
                                VARIANT_STEPS, batches,
                                keep=(VARIANT_STEPS,), cfg=_cfg(n_layers=1))
        out["compressed"] = _run(
            mesh, local1, specs1, opt.adamw(lr=LR), VARIANT_STEPS, batches,
            keep=(VARIANT_STEPS,), cfg=_cfg(n_layers=1),
            compress_grads=compress.make_grad_compressor())
        # the compressor alone on blocks of a fixed tree
        g_local, g_specs = _place(grad_tree, mesh)
        _m, axes = tstep.mesh_axes(g_specs)
        coll.reset_counts()
        out["codes"] = _gathered(compress.make_grad_compressor()(
            g_local, axes=axes), g_specs, mesh)
        out["codes_counts"] = coll.counts()
        # the vocab-parallel loss: rows on "data", columns on "model"
        x, w, labels = (torch.from_numpy(a) for a in loss_case)
        xs = S.shard(x, "batch", None, None).clone().requires_grad_()
        wspec = (None, "model")
        ws = S.block(w, wspec, mesh).clone().requires_grad_()
        data_axis = as_axis(mesh, "data")
        loss = lm.lm_loss({"lm_head": {"w": ws}}, xs,
                          S.shard(labels, "batch", None), cfg, LOSS_CH,
                          rows=(data_axis,))
        gx, gw = torch.autograd.grad(loss, (xs, ws))
        out["vp_loss"] = float(loss)
        out["vp_dx"] = S.unshard(gx, ("data", None, None), mesh)
        out["vp_dw"] = S.unshard(coll.psum(gw, data_axis, site="test"),
                                 wspec, mesh)
    return out


# ------------------------------------------------------------- fixtures

def _reference():
    """The reference's one-device answers on the converted weights."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.dist import compress as jcompress
    from repro.models import lm as JLM
    from repro.train import optimizer as jopt
    from repro.train import step as jstep
    jcfg, jcfg1 = (_cfg(jconfigs.get_config, n) for n in (None, 1))

    def draw(cfg):
        return _plant_biases(jax.tree_util.tree_map(
            np.asarray, JLM.init_params(cfg, jax.random.key(0), mp=MP)), 0)
    tree, tree1 = draw(jcfg), draw(jcfg1)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    batches = _batches(STEPS)

    def jb(b):
        return {k: jnp.asarray(v) for k, v in b.items()}

    def loss_fn(p, b):           # the reference step's own loss
        pc = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32)
                                    if a.ndim >= 2 else a, p)
        return JLM.forward_train(pc, b, jcfg, mp=MP, dtype=jnp.float32,
                                 block_kv=BLOCK_KV, loss_chunk=LOSS_CHUNK)
    loss0, grads = jax.value_and_grad(loss_fn)(jtree, jb(batches[0]))
    ref = {"tree": tree, "loss0": float(loss0),
           "grads": jax.tree_util.tree_map(np.asarray, grads)}

    def run(n, cfg=jcfg, start=tree, o=None, **kw):
        o = o or jopt.adamw(lr=LR)
        fn = jax.jit(jstep.make_train_step(
            cfg, o, mp=MP, dtype=jnp.float32, block_kv=BLOCK_KV,
            loss_chunk=LOSS_CHUNK, **kw))
        p = jax.tree_util.tree_map(jnp.asarray, start)
        s, losses = o.init(p), []
        for i in range(n):
            p, s, loss = fn(p, s, jb(batches[i]), jnp.int32(i))
            losses.append(float(loss))
        return losses, jax.tree_util.tree_map(np.asarray, p)
    ref["adamw"] = run(COMPARED)
    ref["micro"] = run(VARIANT_STEPS, micro_batches=2)
    ref["tree1"] = tree1
    ref["adafactor"] = run(VARIANT_STEPS, jcfg1, tree1,
                           jopt.adafactor(lr=LR))
    ref["compressed"] = run(VARIANT_STEPS, jcfg1, tree1,
                            compress_grads=jcompress.make_grad_compressor())

    rng = np.random.default_rng(3)
    x = rng.standard_normal((LOSS_B, LOSS_S, jcfg.d_model)).astype(
        np.float32)
    w = (0.1 * rng.standard_normal((jcfg.d_model, jcfg.padded_vocab))
         ).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab, (LOSS_B, LOSS_S)).astype(np.int32)
    labels[rng.random(labels.shape) < 0.3] = -1
    labels[:, -1] = -1

    def jloss(x, w):
        return JLM.lm_loss({"lm_head": {"w": w}}, x, jnp.asarray(labels),
                           jcfg, chunk=LOSS_CH)
    vl, (vx, vw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    ref["vp"] = (float(vl), np.asarray(vx), np.asarray(vw))
    return ref, batches, (x, w, labels)


@pytest.fixture(scope="module")
def trained():
    ref, batches, loss_case = _reference()
    params = lm_params_from_reference(ref["tree"], _cfg(), MP)
    rng = np.random.default_rng(9)
    grad_tree = opt.tree_map(lambda t: torch.from_numpy(
        rng.standard_normal(tuple(t.shape)).astype(np.float32)
        * rng.choice([1e-3, 1.0, 30.0])), params)
    params1 = lm_params_from_reference(ref["tree1"], _cfg(n_layers=1), MP)
    ranks = run_on_ranks(_train_job, make_test_mesh(2, MP, device="cpu"),
                         params, params1, batches, grad_tree, loss_case,
                         timeout=TIMEOUT)
    return ref, params, grad_tree, ranks, params1


def _leaf_close(got, want, tol, what=""):
    want = np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= tol * scale, f"{what}: max |d| {err:.3e} vs {tol} × " \
        f"{scale:.3e}"


def _updates_close(got, want, start, tol=UPDATE_TOL):
    for i, (a, b, c) in enumerate(zip(lm.tree_leaves(got),
                                      lm.tree_leaves(want),
                                      lm.tree_leaves(start))):
        err = float((a - b).norm())
        assert err <= tol * float((b - c).norm()), f"leaf {i}: {err:.3e}"


# ---------------------------------------------------------------- tests

def test_zero_placement_cuts_each_weight_over_both_axes(trained):
    """The blocks are the reference's ``param_specs(zero=True)`` cuts,
    sanitized (its stacked layer dim dropped): each matrix's TP dim on
    "model" and its other dim on "data", 1-D leaves whole; they gather
    back to the tree bit for bit."""
    import jax
    from repro.train import shardings as JS
    ref, params, _g, ranks, _p1 = trained
    jspecs = JS.sanitize_specs(
        JS.param_specs(ref["tree"], zero=True, multi_pod=False), ref["tree"],
        types.SimpleNamespace(shape={"data": 2, "model": MP}))
    want = {jax.tree_util.keystr(path): tuple(spec) for path, spec in
            jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]}
    flat = {}
    TS.map_with_path(lambda p, s: flat.__setitem__(p, s), ranks["specs"])
    assert len(flat) == len(lm.tree_leaves(params))
    for path, spec in flat.items():
        toks = TS._path_tokens(path)
        if toks[0].startswith("g_"):       # the reference's stacked dim
            jpath = "".join(f"['{t}']" for t in toks[:1] + toks[2:])
            assert spec == want[jpath][1:], path
        else:
            assert spec == want[path], path
    assert flat["['g_dense'][0]['attn']['q']['w']"] == ("data", "model")
    assert flat["['g_dense'][0]['attn']['o']['w']"] == ("model", "data")
    assert flat["['embed']['table']"] == ("model", "data")
    assert flat["['g_dense'][1]['attn']['q']['b']"] == (None,)
    for a, b in zip(lm.tree_leaves(ranks["gathered"]),
                    lm.tree_leaves(params)):
        assert torch.equal(a, b)
    for shape, leaf in zip(ranks["shapes"], lm.tree_leaves(params)):
        assert int(np.prod(shape)) * (8 if leaf.dim() == 2 else 1) \
            == leaf.numel()


def test_mesh_loss_and_every_gradient_leaf_match_reference(trained):
    """Step 0's loss (LOSS_RTOL) and every gradient leaf gathered whole
    (GRAD_TOL of its largest magnitude) against ``jax.value_and_grad`` of
    the reference step's loss: a factor of the axis size or a bias's
    missing columns would show here.  Every rank returns the same
    loss."""
    ref, _p, _g, ranks, _p1 = trained
    np.testing.assert_allclose(ranks["loss0"], ref["loss0"], rtol=LOSS_RTOL)
    assert len(set(ranks["losses_alike"])) == 1
    want = lm_params_from_reference(ref["grads"], _cfg(), MP)
    got = lm.tree_leaves(ranks["grads"])
    assert len(got) == len(lm.tree_leaves(want))
    for i, (a, b) in enumerate(zip(got, lm.tree_leaves(want))):
        assert a.shape == b.shape, i
        _leaf_close(a.numpy(), b.numpy(), GRAD_TOL, f"leaf {i}")


def test_mesh_step_moves_zero_gathers_and_reduce_scatters(trained):
    """What the step hands to other ranks, by site: each layer's blocks
    gathered over "data" in the forward and again in the recompute, the
    gradient reduce-scattered once (the table and the head once a step);
    the row-parallel sums, the input-gradient sums, the loss's sums and
    one sum of the leaves whole on "data"."""
    _r, _p, _g, ranks, _p1 = trained
    c = ranks["grad_counts"]
    cfg = _cfg()
    per_layer = sum("data" in s for s in lm.tree_leaves(
        ranks["specs"]["g_dense"][0]))
    assert per_layer == 7              # q, k, v, o, gate, up, down
    assert c["zero.gather"]["calls"] == 2 * per_layer * cfg.n_layers + 2
    assert c["zero.gather.grad"]["calls"] == per_layer * cfg.n_layers + 2
    assert c["grad.data"]["calls"] == 1
    # the recompute stops after the last tensor the backward needs (the
    # down product's inputs), so ffn.down's sum runs once a layer
    assert c["attn.o"]["calls"] == 2 * cfg.n_layers
    assert c["ffn.down"]["calls"] == cfg.n_layers
    for site in ("attn.in.grad", "ffn.in.grad", "attn.qkv.grad"):
        assert c[site]["calls"] == cfg.n_layers
    assert c["loss.rows"]["calls"] == 1
    assert c["loss.in.grad"]["calls"] == 1


def test_mesh_adamw_steps_match_reference(trained):
    """Three AdamW steps (lr 1e-2) against the reference's
    ``make_train_step(mp=4)``: every loss at LOSS_RTOL, every parameter
    after them at UPDATE_TOL."""
    ref, params, _g, ranks, _p1 = trained
    (losses, kept), (jlosses, jp) = ranks["adamw"], ref["adamw"]
    np.testing.assert_allclose(losses[:COMPARED], jlosses, rtol=LOSS_RTOL)
    _updates_close(kept[COMPARED], lm_params_from_reference(jp, _cfg(), MP),
                   params)


def test_mesh_training_improves(trained):
    """The reference test's own assertion over its eight steps: every
    loss finite, the last below the first."""
    _r, _p, _g, ranks, _p1 = trained
    losses = ranks["adamw"][0]
    assert len(losses) == STEPS and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


@pytest.mark.parametrize("case", ["micro", "adafactor", "compressed"])
def test_mesh_step_variants_match(trained, case):
    """Two steps against the reference's ``make_train_step(mp=4)``: with
    2 micro-batches; and at one layer, where its stacked leaves are the
    port's per-layer leaves, Adafactor (its means summed over the axes
    that cut each leaf, factored by the whole shape) and AdamW after the
    int8 compressor (each scale a ``pmax`` over the leaf's axes).  The
    losses at LOSS_RTOL, the parameters after them at UPDATE_TOL."""
    ref, params, _g, ranks, params1 = trained
    losses, kept = ranks[case]
    jlosses, jp = ref[case]
    cfg, start = (_cfg(), params) if case == "micro" else \
        (_cfg(n_layers=1), params1)
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    _updates_close(kept[VARIANT_STEPS],
                   lm_params_from_reference(jp, cfg, MP), start)


def test_mesh_compressor_codes_equal_one_device(trained):
    """Each block scaled by its whole leaf's max (a ``pmax`` over the
    leaf's axes, one call an axis for every leaf cut by the same axes):
    gathered, the codes are one
    device's bit for bit."""
    _r, _p, grad_tree, ranks, _p1 = trained
    want = compress.make_grad_compressor()(grad_tree)
    for a, b in zip(lm.tree_leaves(ranks["codes"]), lm.tree_leaves(want)):
        assert torch.equal(a, b)
    assert ranks["codes_counts"]["compress.scale"]["calls"] == 2


def test_vocab_parallel_lm_loss_matches_reference(trained):
    """``lm_loss`` with the head's columns on "model" and the rows on
    "data" (a pad chunk, −1 labels): the loss at LOSS_RTOL and dx, dw
    (gathered) within GRAD_TOL of the reference's ``lm_loss``
    gradients."""
    ref, _p, _g, ranks, _p1 = trained
    loss, dx, dw = ref["vp"]
    np.testing.assert_allclose(ranks["vp_loss"], loss, rtol=LOSS_RTOL)
    _leaf_close(ranks["vp_dx"].numpy(), dx, GRAD_TOL, "dx")
    _leaf_close(ranks["vp_dw"].numpy(), dw, GRAD_TOL, "dw")


@pytest.fixture(scope="module")
def collectives():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((MP, 3, 8, 2)).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((MP, 3, 32, 2)).astype(
        np.float32))
    return x, g, run_on_ranks(_collectives_job,
                              make_test_mesh(1, MP, device="cpu"), x, g,
                              timeout=TIMEOUT)


def test_reduce_scatter_is_psums_slice_bit_for_bit(collectives):
    """Rank r's reduce-scatter along dim 1 is its quarter of ``psum``,
    bit for bit, in f32 and in bf16 (added in f32, rounded once)."""
    _x, _g, ranks = collectives
    for r, out in enumerate(ranks):
        for sfx in ("", "_bf16"):
            want = out["psum" + sfx][:, 2 * r:2 * (r + 1)]
            assert torch.equal(out["reduce_scatter" + sfx], want)


@pytest.mark.parametrize("name", ["psum_grad", "copy_grad", "gather",
                                  "gather_alike", "reduce_scatter_grad",
                                  "slice"])
def test_autograd_collectives_follow_their_rule(collectives, name):
    """Each collective's forward and its backward's rule: a sum passes its
    gradient through; an identity's gradient is summed; a gather's is
    reduce-scattered (or cut to the rank's slice, ``alike``); a
    reduce-scatter's is gathered; a slice's is gathered whole."""
    x, g, ranks = collectives
    n = MP
    whole = x.sum(0)
    for r, out in enumerate(ranks):
        y, dx = out[name]
        gr = [_cotangent(g[q], y) for q in range(n)]
        if name == "psum_grad":
            torch.testing.assert_close(y, whole)
            assert torch.equal(dx, gr[r])
        elif name == "copy_grad":
            assert torch.equal(y, x[r])
            torch.testing.assert_close(dx, sum(gr))
        elif name.startswith("gather"):
            assert torch.equal(y, torch.cat(list(x), 1))
            want = gr[r] if name == "gather_alike" else sum(gr)
            torch.testing.assert_close(dx, want[:, 8 * r:8 * (r + 1)])
        elif name == "reduce_scatter_grad":
            torch.testing.assert_close(y, whole[:, 2 * r:2 * (r + 1)])
            torch.testing.assert_close(dx, torch.cat(gr, 1))
        else:
            assert torch.equal(y, x[r][:, 2 * r:2 * (r + 1)])
            assert torch.equal(dx, torch.cat(gr, 1))
