"""Every LM family served over the (data, model) mesh, held against the
JAX package on the CPU: MLA (deepseek-v3 reduced at mp 4, and at mp 8
with its heads padded to 8, two a model rank), SSD (mamba2-130m reduced,
and with 2 SSD heads of 128, which do not divide 4 ranks, so its prefill
gathers x's and z's columns as decode does),
the hybrid (jamba reduced: SSD sublayers, the GQA sublayer and MoE
sublayers with their experts on "model") and the encoder–decoder
(seamless-m4t reduced: 2 KV heads at mp 4, so k/v columns are gathered,
and the cross-attention over a memory whole on every model rank), each
on ``make_test_mesh(2, 4)`` as 8 gloo ranks in one spawn.

The reference's own mesh paths do not run here, so the ranks are held
against its single-device functions at the same ``mp``, the oracle its
multidevice tests compare with: ``make_prefill_step`` and ``prefill``'s
hidden states, and its launcher's decode loop (every step's logits, the
greedy tokens, the SSM state at the end), in f32, within 1e-5 of the
largest magnitude (jamba's 16-sublayer random stack 5e-3, as on one
device: ROADMAP Queue 3); the placement round trip bit for bit.  The
reduced mamba2's decode steps are 1.2e-5 of the largest logit from the
reference's on one device already (f32 rounding at a few ill-conditioned
steps, where the reference itself is 8e-6 from its f64 run: ROADMAP
Queue 3), so each model's decode is held to the reference within the
larger of its tolerance and ``NOISE`` times the one-device port's own
distance, and to the one-device port within the same 1e-5 (jamba
5e-3).  Each
model's weights come from the reference's ``init_params(cfg, key, mp)``
through ``lm_params_from_reference`` (the layer norms' biases planted).

A spawned rank imports this module to find its job, so the JAX package is
imported in fixtures and tests only.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.dist import collectives as coll  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.dist.mesh import line_mesh, run_on_ranks  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import shardings as TS  # noqa: E402
from repro_torch.train import make_decode_fn, make_prefill_step  # noqa: E402
from repro_torch.train.step import batch_rows, gather_rows  # noqa: E402

TIMEOUT = 240
# prompt, new tokens, prefill length (a multiple of the reduced SSD chunk,
# 16), the encoder's memory rows
PROMPT, NEW, PREFILL, SM = 6, 6, 16, 8
# (name, arch, mp, SSD head dim or None): mamba2_gathered's 2 heads of 128
# do not divide 4 ranks while d_inner does, so its prefill gathers x's and
# z's columns and runs every head on every rank, as decode does
MODELS = (("deepseek_mp4", "deepseek_v3_671b", 4, None),
          ("deepseek_mp8", "deepseek_v3_671b", 8, None),
          ("mamba2", "mamba2_130m", 4, None),
          ("mamba2_gathered", "mamba2_130m", 4, 128),
          ("jamba", "jamba_1_5_large_398b", 4, None),
          ("seamless", "seamless_m4t_large_v2", 4, None))
NAMES = [m[0] for m in MODELS]
TOL = {"jamba": 5e-3}
# the mesh's distance to the reference over the one device's (the bound
# where the one device's own distance exceeds the tolerance)
NOISE = 1.2
# the collective sites each family's prefill and decode must call
SITES = {
    "deepseek": ({"attn.o", "ffn.down", "moe.combine", "embed", "logits"},
                 {"decode.qkv", "decode.merge", "attn.o", "moe.combine"}),
    "mamba2": ({"ssd.norm", "ssd.out", "embed", "logits"},
               {"decode.ssd", "ssd.out"}),
    "mamba2_gathered": ({"ssd.xz", "ssd.out"}, {"decode.ssd", "ssd.out"}),
    "jamba": ({"ssd.norm", "ssd.out", "attn.qkv", "attn.o", "ffn.down",
               "moe.combine"},
              {"decode.ssd", "ssd.out", "decode.qkv", "decode.merge",
               "attn.o", "ffn.down", "moe.combine"}),
    "seamless": ({"attn.qkv", "attn.o", "xattn.o", "ffn.down"},
                 {"decode.qkv", "decode.merge", "attn.qkv", "xattn.o",
                  "ffn.down"}),
}


def _t(a):
    return torch.from_numpy(np.array(a))


def _family(name):
    return name if name in SITES else name.split("_")[0]


def _reduced(get_config, arch, head_dim):
    """The reduced config of ``arch`` (``get_config``: the port's or the
    reference's), with SSD heads of ``head_dim`` where given."""
    cfg = get_config(arch).reduced()
    if head_dim is None:
        return cfg
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, head_dim=head_dim))


def _requiring_grad(params):
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda t: t.detach().clone().requires_grad_(), params)


def _state_report(cache, cfg, tp, spec, mesh):
    """Whether this rank's SSM state equals every model rank's, bit for
    bit (gathered to rank 0 by global rank), and the whole batch's state."""
    st = cache[lm.layer_groups(cfg)[0][0]]["state"]
    parts = coll.all_gather(st, tp.model, site="test")
    same = coll.gather_objects(all(torch.equal(p, st) for p in parts), mesh)
    lead = (None,) * (st.dim() - 4)
    return same, S.unshard(st, lead + (spec[0], None, None, None), mesh)


def _family_job(mesh, cases):
    """For each model on this rank: the placement round trip, its plan,
    the prefill step's logits and the hidden states, ``generate``, and
    the decode loop's logits of every step on the reference's tokens,
    each gathered whole, the sites each called, the SSM state, and a
    gradient under the mesh (refused).  First the broadcasts over "data"
    (each data line's model rank m takes line 0's rank m's tensor and
    object)."""
    data, model = S.as_axis(mesh, "data"), S.as_axis(mesh, "model")
    x = torch.full((3, 2), float(mesh.rank))
    coll.broadcast(x, data, site="test")
    out = {"broadcast": coll.gather_objects(x.tolist(), mesh),
           "broadcast_objects": coll.gather_objects(coll.broadcast_objects(
               {"from": mesh.rank} if data.rank == 0 else None, data),
               mesh)}
    # columns of two products with different leading dims in one gather
    a = torch.full((2, 3, 2), float(model.rank))
    b = torch.full((2, 5, 1), -float(model.rank))
    out["gather_cols"] = lm.L.gather_cols([a, b], model, site="test")
    # the first data line as a (1, 4) mesh of its own
    line, seen = line_mesh(mesh, "model", 0), None
    if line is not None:
        seen = (line.shape, line.coords, line.ranks,
                coll.psum(torch.tensor([float(mesh.rank)]), line,
                          site="test").item(),
                coll.psum(torch.ones(1), S.as_axis(line, "data"),
                          site="test").item())
    out["line_mesh"] = coll.gather_objects(seen, mesh)
    for name, cfg, params, mp, batch, prompt, ref_tokens in cases:
        specs = TS.param_specs(params, zero=False, multi_pod=False)
        memory = batch.get("src_embeds")
        with S.use_rules(S.SINGLE_POD_RULES, mesh):
            local = TS.local_tree(params, specs, mesh)
            out[name, "gathered"] = TS.gather_tree(
                local, TS.sanitize_specs(specs, params, mesh.shape), mesh)
            tp = lm.tensor_parallel(cfg, mp)     # its group stays here
            out[name, "tp"] = dataclasses.replace(
                tp, model=(tp.model.size, tp.model.ranks))
            coll.reset_counts()
            out[name, "logits"] = make_prefill_step(
                cfg, dtype=torch.float32, mp=mp)(local, batch)
            out[name, "prefill_sites"] = set(coll.counts())
            rows, spec = batch_rows(batch)
            _logits, hidden = lm.prefill(local, rows, cfg,
                                         dtype=torch.float32, mp=mp)
            out[name, "hidden"] = gather_rows(hidden, spec)
            out[name, "generate"] = generate(local, cfg, prompt, NEW, mp=mp,
                                             memory=memory)
            B, P = prompt.shape
            feed = S.shard(torch.cat([prompt, ref_tokens], 1), "batch", None)
            mem = None if memory is None else S.shard(memory, "batch", None,
                                                      None)
            cache = lm.init_cache(cfg, B, P + NEW, dtype=torch.float32,
                                  device="cpu")
            step = make_decode_fn(cfg, dtype=torch.float32, mp=mp,
                                  max_len=P + NEW)
            coll.reset_counts()
            steps = []
            for t in range(P + NEW):
                logits, cache = step(local, cache, feed[:, t:t + 1], t, mem)
                (logits,) = lm.L.gather_cols([logits], tp.axis(tp.vocab),
                                             site="test")
                steps.append(gather_rows(logits, spec))
            out[name, "decode_sites"] = set(coll.counts())
            out[name, "steps"] = torch.cat(steps, 1)
            if cfg.ssm is not None:
                out[name, "state_equal"], out[name, "state"] = \
                    _state_report(cache, cfg, tp, spec, mesh)
            try:
                lm.forward_train(_requiring_grad(local), {
                    "tokens": feed[:, :PREFILL // 2].long(),
                    "labels": feed[:, :PREFILL // 2].long(),
                    **({} if mem is None else {"src_embeds": mem})},
                    cfg, dtype=torch.float32, mp=mp)
                out[name, "grad_refused"] = None
            except ValueError as e:
                out[name, "grad_refused"] = str(e)
    return out


def _plant_biases(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(x, key=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if key in ("b", "bias"):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return walk(tree)


def _one_device_steps(cfg, params, mp, feed, memory):
    """The port's decode loop on one device: every step's logits on
    ``feed``'s tokens."""
    B, n = feed.shape
    cache = lm.init_cache(cfg, B, n, dtype=torch.float32, device="cpu")
    step = make_decode_fn(cfg, dtype=torch.float32, mp=mp)
    steps = []
    for t in range(n):
        logits, cache = step(params, cache, feed[:, t:t + 1], t, memory)
        steps.append(logits)
    return torch.cat(steps, 1).numpy()


def _reference_serve(jcfg, tree, prompt, mp, memory):
    """The reference launcher's loop (its ``main`` draws its own weights):
    greedy tokens, every step's logits and the cache at the end."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as JLM
    from repro.train import make_decode_fn as jmake_decode_fn
    fn = jax.jit(jmake_decode_fn(jcfg, mp=mp, dtype=jnp.float32))
    B, P = prompt.shape
    cache = JLM.init_cache(jcfg, B, P + NEW, mp, dtype=jnp.float32)
    jp = jnp.asarray(prompt, jnp.int32)
    mem = None if memory is None else jnp.asarray(memory)
    steps = []
    for t in range(P):
        logits, cache = fn(tree, cache, jp[:, t:t + 1], jnp.int32(t), mem)
        steps.append(np.asarray(logits))
    toks = []
    for t in range(NEW):
        nxt = jnp.argmax(logits[:, -1, :jcfg.vocab], -1)[:, None].astype(
            jnp.int32)
        toks.append(np.asarray(nxt))
        logits, cache = fn(tree, cache, nxt, jnp.int32(P + t), mem)
        steps.append(np.asarray(logits))
    return np.concatenate(toks, 1), np.concatenate(steps, 1), cache


@pytest.fixture(scope="module")
def served():
    """The models converted from the reference's ``init_params(cfg, key,
    mp)``, its prefill and launcher outputs, and the 8 ranks' results in
    one spawn."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import lm as JLM
    from repro.train import make_prefill_step as jmake_prefill_step
    cases, refs = [], {}
    rng = np.random.default_rng(9)
    for i, (name, arch, mp, head_dim) in enumerate(MODELS):
        jcfg = _reduced(jconfigs.get_config, arch, head_dim)
        cfg = _reduced(configs.get_config, arch, head_dim)
        tree = _plant_biases(jax.tree_util.tree_map(
            np.asarray, JLM.init_params(jcfg, jax.random.key(i), mp)), i)
        params = lm_params_from_reference(tree, cfg, mp)
        batch = {"tokens": rng.integers(0, jcfg.vocab, (4, PREFILL))
                 .astype(np.int32)}
        if cfg.family == "encdec":
            batch["src_embeds"] = rng.standard_normal(
                (4, SM, cfg.d_model)).astype(np.float32)
        prompt = batch["tokens"][:, :PROMPT]
        jtree = jax.tree_util.tree_map(jnp.asarray, tree)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        ref_logits = np.asarray(jmake_prefill_step(
            jcfg, mp=mp, dtype=jnp.float32)(jtree, jb))
        _l, ref_x = JLM.prefill(jtree, jb, jcfg, mp, dtype=jnp.float32)
        ref_tokens, ref_steps, ref_cache = _reference_serve(
            jcfg, jtree, prompt, mp, batch.get("src_embeds"))
        state = (np.asarray(ref_cache[lm.layer_groups(cfg)[0][0]]["state"])
                 if cfg.ssm is not None else None)
        tb = {k: _t(v) for k, v in batch.items()}
        tb["tokens"] = tb["tokens"].long()
        one = _one_device_steps(cfg, params, mp, torch.cat(
            [_t(prompt), _t(ref_tokens)], 1).long(), tb.get("src_embeds"))
        refs[name] = dict(params=params, logits=ref_logits,
                          hidden=np.asarray(ref_x), tokens=ref_tokens,
                          steps=ref_steps, state=state, one_steps=one)
        cases.append((name, cfg, params, mp, tb, _t(prompt).long(),
                      _t(ref_tokens).long()))
    ranks = run_on_ranks(_family_job, make_test_mesh(2, 4, device="cpu"),
                         cases, timeout=TIMEOUT)
    return refs, ranks


def _dist(got, want) -> float:
    """max |got − want| over the largest |want|."""
    return float(np.abs(np.asarray(got) - want).max() / np.abs(want).max())


def _close(got, want, rel):
    assert _dist(got, want) <= rel, (_dist(got, want), rel)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_plan_of_each_family(served, name):
    """What rank 0 does at the shard points: MLA's padded heads split
    (one, or two at mp 8, a model rank), SSD's d_inner split (by heads or
    gathered: the sites tell, ``SITES``), KV columns gathered where 2 KV
    heads do not divide 4 ranks, the experts split."""
    _refs, ranks = served
    tp = ranks[name, "tp"]
    assert tp.model == (4, (0, 1, 2, 3)) and tp.vocab
    want = {"deepseek_mp4": dict(hp=4, heads=(0, 1), rows=True,
                                 experts=True, ssd=False),
            "deepseek_mp8": dict(hp=8, heads=(0, 2), rows=True,
                                 experts=True, ssd=False),
            "mamba2": dict(ssd=True),
            "mamba2_gathered": dict(ssd=True),
            "jamba": dict(hp=4, heads=(0, 1), kv_gather=True, ssd=True,
                          experts=True),
            "seamless": dict(hp=4, heads=(0, 1), kv=(0, 2), kv_gather=True,
                             rows=True, ffn=True, ssd=False)}[name]
    assert {k: getattr(tp, k) for k in want} == want


@pytest.mark.parametrize("name", NAMES)
def test_placement_round_trip_is_exact(served, name):
    refs, ranks = served
    got, want = ranks[name, "gathered"], refs[name]["params"]
    assert [tuple(t.shape) for t in lm.tree_leaves(got)] == \
        [tuple(t.shape) for t in lm.tree_leaves(want)]
    for a, b in zip(lm.tree_leaves(got), lm.tree_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", NAMES)
def test_mesh_prefill_matches_reference(served, name):
    """The prefill step's logits and the hidden states against the
    reference's ``make_prefill_step`` and ``prefill`` at the same mp, on
    one device; each family's prefill called its collective sites."""
    refs, ranks = served
    tol = TOL.get(name, 1e-5)
    _close(ranks[name, "logits"].numpy(), refs[name]["logits"], tol)
    _close(ranks[name, "hidden"].numpy(), refs[name]["hidden"], tol)
    want = SITES[_family(name)][0]
    assert want <= ranks[name, "prefill_sites"], \
        want - ranks[name, "prefill_sites"]


@pytest.mark.parametrize("name", NAMES)
def test_mesh_decode_matches_the_reference_launcher(served, name):
    """Greedy tokens equal the reference launcher's; every decode step's
    logits on its tokens within the tolerance, or ``NOISE`` times the
    one-device port's distance where that is larger (mamba2: module
    docstring); each family's decode called its collective sites."""
    refs, ranks = served
    tol = max(TOL.get(name, 1e-5), NOISE * _dist(refs[name]["one_steps"],
                                                 refs[name]["steps"]))
    g = ranks[name, "generate"]
    np.testing.assert_array_equal(g.tokens.numpy(), refs[name]["tokens"])
    assert g.finite and g.steps == PROMPT + NEW
    _close(g.prompt_logits.numpy(), refs[name]["steps"][:, PROMPT - 1], tol)
    _close(ranks[name, "steps"].numpy(), refs[name]["steps"], tol)
    want = SITES[_family(name)][1]
    assert want <= ranks[name, "decode_sites"], \
        want - ranks[name, "decode_sites"]


@pytest.mark.parametrize("name", NAMES)
def test_mesh_decode_matches_one_device(served, name):
    """Every decode step's logits on the ranks against the port's own
    decode loop on one device, on the same tokens: within 1e-5 of the
    largest, jamba's stack 5e-3 (the rank-order sums of the row-parallel
    products, the split norm and the merged attention reorder f32 adds)."""
    refs, ranks = served
    _close(ranks[name, "steps"].numpy(), refs[name]["one_steps"],
           TOL.get(name, 1e-5))


@pytest.mark.parametrize("name", ["mamba2", "mamba2_gathered", "jamba"])
def test_ssm_state_after_decode_is_whole_and_alike(served, name):
    """The SSM state a rank holds is every head of its batch rows
    (``cache_specs``), the same bits on every model rank, and within the
    tolerance of the reference launcher's state at the end."""
    refs, ranks = served
    assert ranks[name, "state_equal"] == [True] * 8
    _close(ranks[name, "state"].numpy(), refs[name]["state"],
           TOL.get(name, 1e-5))


@pytest.mark.parametrize("name", NAMES)
def test_gradient_under_the_mesh_is_refused(served, name):
    """Training these families over the mesh is not ported: a gradient
    through the model raises on every rank, naming its ROADMAP item."""
    _refs, ranks = served
    msg = ranks[name, "grad_refused"]
    assert msg is not None and "not ported" in msg and "Queue 1 item" in msg


def test_broadcast_over_data_takes_the_first_lines_values(served):
    """``collectives.broadcast`` writes data line 0's tensor into each
    other line's rank at the same model coordinate (in place), and
    ``broadcast_objects`` hands its object over the same way."""
    _refs, ranks = served
    want = [m % 4 for m in range(8)]
    assert ranks["broadcast"] == [[[float(w)] * 2] * 3 for w in want]
    assert ranks["broadcast_objects"] == [{"from": w} for w in want]


def test_gather_cols_joins_products_of_different_leading_dims(served):
    """One all-gather brings back each product whole, its ranks' columns
    joined in rank order, whatever its leading dims (a cross-attention's
    q over S rows and k/v over Sm)."""
    _refs, ranks = served
    a, b = ranks["gather_cols"]
    assert a.shape == (2, 3, 8) and b.shape == (2, 5, 4)
    assert torch.equal(a[0, 0], torch.tensor([0., 0, 1, 1, 2, 2, 3, 3]))
    assert torch.equal(b[1, 4], -torch.arange(4.))


def test_line_mesh_is_a_mesh_of_the_first_data_line(served):
    """``line_mesh(mesh, "model", 0)`` is, on data line 0's ranks, a (1, 4)
    mesh whose whole-mesh sums run over that line alone and whose "data"
    axis is the rank itself; None on the other line's ranks."""
    _refs, ranks = served
    seen = ranks["line_mesh"]
    assert seen[4:] == [None] * 4
    for m, (shape, coords, members, total, data) in enumerate(seen[:4]):
        assert shape == {"data": 1, "model": 4}
        assert coords == {"data": 0, "model": m}
        assert tuple(members) == (0, 1, 2, 3)
        assert total == 6.0 and data == 1.0
