"""The LM half of the mesh held against the JAX package on the CPU: the
rule tables and spec functions (``dist.sharding``, ``train.shardings``),
the meshes, the placement of a parameter tree, sequence-parallel decode
(``dist.decode``) and ``pipeline_apply`` on 4 gloo ranks, and qwen2
reduced served tensor- and sequence-parallel on ``make_test_mesh(2, 4)``
(8 gloo ranks), with llama4-scout reduced beside it, its experts split
over "model" (expert parallelism) or left whole where they do not
divide the axis.

The reference's own mesh paths do not run here (its multidevice LM tests
fail in this environment), so the ranks are held against its
single-device functions, the oracle its multidevice tests compare with:
``sp_decode_attention`` and ``reference_apply`` within its 2e-5, the
model's ``prefill(..., mp=...)`` and launcher loop outside any mesh
within 1e-5 of the largest magnitude, greedy tokens equal, a cache
update exactly.  The spec functions are pure and are compared bit for
bit, as tuples against the reference's ``PartitionSpec``s (the
reference's stacked layer dim dropped).

Every rank job of a mesh shape runs in one spawn (a module-scoped
fixture).  A spawned rank imports this module to find its job, so the
JAX package is imported in fixtures and tests only.
"""
import dataclasses
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.dist import collectives as coll  # noqa: E402
from repro_torch.dist import decode as DEC  # noqa: E402
from repro_torch.dist import pipeline_parallel as PP  # noqa: E402
from repro_torch.dist import sharding as S  # noqa: E402
from repro_torch.dist.mesh import make_mesh, run_on_ranks  # noqa: E402
from repro_torch.launch.mesh import (make_production_mesh,  # noqa: E402
                                     make_test_mesh)
from repro_torch.launch.serve import generate  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.attention import kv_index  # noqa: E402
from repro_torch.train import shardings as TS  # noqa: E402
from repro_torch.train import make_decode_fn, make_prefill_step  # noqa: E402

TIMEOUT = 240
ALL_ARCHS = configs.ARCHS
# the reference's multidevice SP decode shapes
SP_B, SP_S, SP_HQ, SP_HKV, SP_D, SP_INDEX = 4, 64, 8, 2, 32, 37
LAT_H, LAT_C, LAT_R = 4, 24, 8
# the reference's pipeline test: tanh blocks, M microbatches of (mb, d)
PP_M, PP_MB, PP_D = 6, 4, 16
# the served model: prompt, new tokens, prefill length
PROMPT, NEW, PREFILL = 6, 6, 12
# (name, n_kv_heads, mp): KV heads replicated and their columns gathered;
# KV heads dividing the axis; q heads padded (4 heads at mp 8)
MODELS = (("gathered_kv", 2, 4), ("divisible_kv", 4, 4),
          ("padded_heads", 2, 8))
# llama4-scout reduced (8 experts top-1 and a shared expert) at mp 4:
# (name, experts, capacity factor): every token kept (E / k), the
# default capacity (tokens dropped), 6 experts (whole on every rank)
MOE_MODELS = (("moe_no_drop", 8, 8.0), ("moe_default", 8, None),
              ("moe_whole", 6, None))
MOE_MP = 4
# the families whose serving paths run on a bound mesh since MLA, SSD, the
# hybrid and the encoder–decoder joined (their runs are
# test_torch_dist_families.py's)
FAMILY_ARCHS = ("deepseek_v3_671b", "mamba2_130m", "jamba_1_5_large_398b",
                "seamless_m4t_large_v2")


def _t(a):
    return torch.from_numpy(np.array(a))


def _tup(spec):
    return tuple(spec)


# ------------------------------------------------------ rule tables, specs

def test_rule_tables_equal_the_reference():
    from repro.dist import sharding as J
    for name in ("SINGLE_POD_RULES", "MULTI_POD_RULES", "PARTITIONER_RULES",
                 "CP_SERVE_RULES"):
        assert getattr(S, name) == getattr(J, name), name
    from repro_torch import dist
    assert dist.SINGLE_POD_RULES is S.SINGLE_POD_RULES
    assert dist.shard is S.shard and dist.use_rules is S.use_rules


REF_CASES = [   # tests/test_dist_sharding.py's cases: shape, tags, rules, axes
    ((8, 64, 8, 32), ("batch", "seq", "heads", None), "SINGLE", "single"),
    ((8, 64, 512), ("batch", None, "vocab"), "SINGLE", "single"),
    ((8, 64, 2, 32), ("batch", "sp_seq", None, None), "SINGLE", "single"),
    ((8, 64, 8, 32), ("batch", "seq", "heads", None), "MULTI", "multi"),
    ((8, 64, 8, 32), ("batch", "seq", "heads", None), "MULTI", "single"),
    ((8, 64, 8, 32), ("batch", "seq", "heads", None), "CP", "single"),
    ((8, 64, 2, 32), ("batch", None, "kv_heads_sharded", None), "CP",
     "single"),
    ((8, 63, 8, 32), ("batch", "sp_seq", "heads", None), "SINGLE", "single"),
    ((8, 64, 2, 32), ("batch", None, "heads", None), "SINGLE", "single"),
    ((64, 512), ("heads", "vocab"), "SINGLE", "single"),
]
AXES = {"single": {"data": 2, "model": 4},
        "multi": {"pod": 2, "data": 2, "model": 4}}


@pytest.mark.parametrize("case", range(len(REF_CASES)))
def test_resolve_spec_on_the_reference_cases(case):
    from repro.dist import sharding as J
    shape, tags, rules, axes = REF_CASES[case]
    name = f"{rules}_POD_RULES" if rules != "CP" else "CP_SERVE_RULES"
    want = J.resolve_spec(shape, tags, getattr(J, name), AXES[axes])
    got = S.resolve_spec(shape, tags, getattr(S, name), AXES[axes])
    assert got == _tup(want)


@pytest.mark.parametrize("seed", range(4))
def test_resolve_spec_on_random_shapes(seed):
    """Random dims (some dividing, some not), tags, rule tables and meshes
    (absent axes included), 100 draws a seed."""
    from repro.dist import sharding as J
    rng = np.random.default_rng(seed)
    tags = list(S.SINGLE_POD_RULES) + ["stream", "vertex", None]
    tables = ("SINGLE_POD_RULES", "MULTI_POD_RULES", "CP_SERVE_RULES",
              "PARTITIONER_RULES")
    for _ in range(100):
        nd = int(rng.integers(1, 5))
        shape = tuple(int(x) for x in rng.choice([1, 2, 3, 4, 6, 8, 12, 16,
                                                   63, 64], nd))
        tg = tuple(tags[i] for i in rng.integers(0, len(tags), nd))
        sizes = {a: int(rng.choice([1, 2, 4, 8]))
                 for a in ("pod", "data", "model", "stream")
                 if rng.random() < 0.75}
        table = tables[int(rng.integers(0, len(tables)))]
        want = J.resolve_spec(shape, tg, getattr(J, table), sizes)
        assert S.resolve_spec(shape, tg, getattr(S, table), sizes) == \
            _tup(want), (shape, tg, table, sizes)


def test_shard_is_the_identity_outside_rules_and_nests():
    x = torch.ones(4, 8)
    assert S.active_rules() is None
    assert S.shard(x, "batch", None) is x
    spec = make_test_mesh(1, 1, device="cpu")
    with S.use_rules(S.SINGLE_POD_RULES, spec):
        assert S.active_rules() == (S.SINGLE_POD_RULES, spec)
        with S.use_rules(S.CP_SERVE_RULES, spec):
            assert S.active_rules()[0] is S.CP_SERVE_RULES
        assert S.active_rules()[0] is S.SINGLE_POD_RULES
        assert S.shard(x, "batch", "vocab") is x     # 1 × 1: nothing splits
    assert S.active_rules() is None


def _ref_tree(arch, mp=1, seed=0):
    import jax
    from repro import configs as jconfigs
    from repro.models import lm as JLM
    cfg = jconfigs.get_config(arch).reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, JLM.init_params(cfg, jax.random.key(seed), mp))
    return cfg, tree


def _drop_layer_dim(specs, ref_tree, cfg):
    """The reference's spec tree (stacked groups) laid out as the port's
    per-layer tree, each group leaf's leading layer entry dropped."""
    def walk(node, drop, index=None):
        if isinstance(node, dict):
            return {k: walk(v, drop, index) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, drop, index) for v in node]
        return _tup(node)[1:] if drop else _tup(node)

    out = {}
    for key in ref_tree:
        if key.startswith("g_"):
            count = dict(lm.layer_groups(cfg))[key[2:]]
            out[key] = [walk(specs[key], True) for _ in range(count)]
        else:
            out[key] = walk(specs[key], False)
    return out


def _is_spec(x):
    from jax.sharding import PartitionSpec
    return isinstance(x, PartitionSpec)


def _as_specs(tree):
    """A reference spec tree with PartitionSpec leaves → nested dicts and
    lists of tuples (a PartitionSpec is a tuple, which jax would walk)."""
    if _is_spec(tree):
        return tree
    if isinstance(tree, dict):
        return {k: _as_specs(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_as_specs(v) for v in tree]
    return tree


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_sanitize_batch_and_cache_specs_match_reference(arch):
    """``param_specs`` (zero on and off, single and multi pod) and
    ``sanitize_specs`` on the converted reduced tree, ``batch_specs`` and
    ``cache_specs`` on the caches, each equal to the reference's."""
    from repro.models import lm as JLM
    from repro.train import shardings as JS
    cfg, tree = _ref_tree(arch)
    params = lm_params_from_reference(tree, configs.get_config(arch)
                                      .reduced())
    for zero, multi in itertools.product((False, True), repeat=2):
        want = _as_specs(JS.param_specs(tree, zero=zero, multi_pod=multi))
        got = TS.param_specs(params, zero=zero, multi_pod=multi)
        assert got == _drop_layer_dim(want, tree, cfg), (zero, multi)
        axes = AXES["multi" if multi else "single"]
        mesh = types.SimpleNamespace(shape=axes)
        jsds = {k: v for k, v in tree.items()}
        swant = _as_specs(JS.sanitize_specs(
            JS.param_specs(tree, zero=zero, multi_pod=multi), jsds, mesh))
        assert TS.sanitize_specs(got, params, axes) == \
            _drop_layer_dim(swant, tree, cfg), (zero, multi)
    B, Smax = 4, 16
    jcache = JLM.init_cache(cfg, B, Smax)
    cache = lm.init_cache(configs.get_config(arch).reduced(), B, Smax,
                          device="cpu")
    for multi in (False, True):
        want = _as_specs(JS.cache_specs(jcache, multi_pod=multi))
        assert TS.cache_specs(cache, multi_pod=multi) == \
            {g: {k: _tup(v) for k, v in c.items()} for g, c in want.items()}
        batch = {"tokens": np.zeros((B, Smax), np.int32),
                 "labels": np.zeros((B, Smax), np.int32),
                 "step": np.zeros((), np.int32)}
        want = _as_specs(JS.batch_specs(batch, multi_pod=multi))
        got = TS.batch_specs({k: _t(v) for k, v in batch.items()},
                             multi_pod=multi)
        assert got == {k: _tup(v) for k, v in want.items()}


def test_param_specs_of_adamw_state_match_reference():
    """The optimizer-state paths (``['m']…``, ``['v']…``) parse as the
    parameter they mirror, never as the attention's value projection."""
    import jax
    from repro.train import optimizer as JO
    from repro.train import shardings as JS
    from repro_torch.train.optimizer import adamw
    cfg, tree = _ref_tree("qwen2_7b")
    params = lm_params_from_reference(tree, configs.get_config(
        "qwen2_7b").reduced())
    jstate = jax.tree_util.tree_map(np.asarray, JO.adamw().init(tree))
    want = _as_specs(JS.param_specs(jstate, zero=True, multi_pod=False))
    got = TS.param_specs(adamw().init(params), zero=True, multi_pod=False)
    for k in ("m", "v"):
        assert got[k] == _drop_layer_dim(want[k], tree, cfg)
    assert got["v"]["g_dense"][0]["attn"]["v"]["w"] == ("data", "model")


def test_meshes_match_the_reference_constants(monkeypatch):
    """``make_test_mesh`` and ``make_production_mesh``: the reference's
    shapes and axis names in its order (its ``jax.make_mesh`` calls are
    recorded, not run: this process has one device); without a card and
    without ``device="cpu"`` a mesh raises."""
    from repro.launch import mesh as JM
    monkeypatch.setattr(JM.jax, "make_mesh", lambda shape, axes: (
        tuple(shape), tuple(axes)))
    pairs = [(JM.make_test_mesh(), make_test_mesh(device="cpu")),
             (JM.make_test_mesh(1, 4), make_test_mesh(1, 4, device="cpu")),
             (JM.make_production_mesh(), make_production_mesh(
                 device="cpu")),
             (JM.make_production_mesh(multi_pod=True),
              make_production_mesh(multi_pod=True, device="cpu"))]
    for (shape, axes), m in pairs:
        assert (tuple(m.shape.values()), tuple(m.shape)) == (shape, axes)
        assert m.axes == axes and m.size == int(np.prod(shape))
        assert not m.bound and m.transport == "gloo"
    assert make_production_mesh(device="cpu").describe() == {
        "axis": ("data", "model"), "ranks": 256, "device": "cpu",
        "transport": "gloo", "shape": {"data": 16, "model": 16}}
    from repro_torch.dist.mesh import as_axis, axis_lines
    spec = make_test_mesh(2, 4, device="cpu")
    assert axis_lines(spec.shape, "model") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert axis_lines(spec.shape, "data") == [[0, 4], [1, 5], [2, 6],
                                              [3, 7]]
    assert as_axis(spec, "model").shape == {"model": 4}
    with pytest.raises(ValueError, match="no axis"):
        as_axis(spec, "stage")
    # ranks run on the card unless the CPU is named: no card, no mesh
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_test_mesh()


@pytest.mark.parametrize("arch", [a for a in ALL_ARCHS])
def test_param_count_with_padded_heads_matches_reference(arch):
    """``param_count(cfg, mp)`` counts the reference's padded tree, MLA's
    padded heads included (``q_b``, ``kv_b`` and ``o`` at Hp heads)."""
    from repro import configs as jconfigs
    from repro.models import lm as JLM
    cfg = configs.get_config(arch)
    for mp in (1, 8, 16):
        assert lm.param_count(cfg, mp) == JLM.param_count(
            jconfigs.get_config(arch), mp)


@pytest.mark.parametrize("arch", ["qwen2_7b", "pixtral_12b",
                                  "seamless_m4t_large_v2",
                                  "jamba_1_5_large_398b"])
def test_padded_heads_prefill_matches_reference(arch):
    """On one device with q heads padded (mp 8 on 4 heads, KV heads read
    by ``expand_kv``'s map): ``forward`` and the prefill step against the
    reference's at the same ``mp``, f32; jamba's 16-sublayer stack at
    ``test_torch_ssm.py``'s 5e-3 (a random deep stack amplifies f32
    rounding, ROADMAP Queue 3)."""
    import jax.numpy as jnp
    from repro.train import make_prefill_step as jmake_prefill_step
    from repro.models import lm as JLM
    mp = 8
    jcfg, tree = _ref_tree(arch, mp, seed=3)
    cfg = configs.get_config(arch).reduced()
    params = lm_params_from_reference(tree, cfg, mp)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["src_embeds"] = rng.standard_normal(
            (2, 8, cfg.d_model)).astype(np.float32)
    if cfg.prefix_tokens:
        batch["prefix_embeds"] = rng.standard_normal(
            (2, cfg.prefix_tokens, cfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(jmake_prefill_step(jcfg, mp=mp, dtype=jnp.float32)(
        tree, jb))
    want_x = np.asarray(JLM.forward(tree, jb, jcfg, mp, dtype=jnp.float32,
                                    remat=False))
    tb = {k: _t(v) for k, v in batch.items()}
    got = make_prefill_step(cfg, dtype=torch.float32, mp=mp)(params, tb)
    got_x = lm.forward(params, tb, cfg, dtype=torch.float32, mp=mp)
    tol = 5e-3 if cfg.family == "hybrid" else 1e-4
    np.testing.assert_allclose(got_x.numpy(), want_x, rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_kv_index_is_the_reference_expand_kv_map():
    """Every q-head block of a rank reads the KV heads ``expand_kv`` gives
    it: a slice where that is K4's map, a list where it is not."""
    import jax.numpy as jnp
    from repro.models.attention import expand_kv
    for hp, hkv, n in ((28, 4, 4), (4, 2, 4), (8, 2, 4), (4, 4, 4),
                       (8, 3, 4), (12, 4, 3), (8, 8, 8)):
        k = jnp.arange(hkv)[None, None, :, None]
        want = np.asarray(expand_kv(k, hp))[0, 0, :, 0]
        hl = hp // n
        for r in range(n):
            idx = kv_index(r * hl, hl, hp, hkv)
            got = np.arange(hkv)[idx]
            if isinstance(idx, slice):
                g = hl // len(got)
                got = np.repeat(got, g)
            np.testing.assert_array_equal(got, want[r * hl:(r + 1) * hl])
    assert kv_index(0, 7, 28, 4) == slice(0, 1)
    assert kv_index(0, 4, 8, 3) == [0, 0, 0, 1]
    with pytest.raises(ValueError, match="held"):
        kv_index(4, 2, 8, 2, kv0=0, held=1)


def test_pipeline_reference_apply_matches_reference():
    import jax.numpy as jnp
    from repro.dist.pipeline_parallel import reference_apply as jref
    w, xs = _pipeline_inputs(4)
    want = jref(jnp.asarray(w), jnp.asarray(xs),
                lambda x, wi: jnp.tanh(x @ wi))
    got = PP.reference_apply([_t(wi) for wi in w], _t(xs), _tanh_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_the_mesh_refuses_what_is_not_ported(sp):
    """Under a mesh with a model axis every family runs — dense, MoE, MLA,
    SSD, hybrid and encoder–decoder: on the bound make_test_mesh(1, 4)
    the four families MLA, SSD, the hybrid and the encoder–decoder
    joined make their plans (rank 0's heads, MLA's and the
    encoder–decoder's o row-parallel, SSD's heads split; their serving
    runs are ``test_torch_dist_families.py``'s), and on a spec mesh,
    which is no rank's, each family asks for a bound one; MLA's heads
    that do not divide the axis raise first.  Context-parallel rules and
    a gradient through an MoE layer, or through the layers of MLA, SSD,
    hybrid and encoder–decoder models, still raise, naming their ROADMAP
    items."""
    plans = sp[2]["plans"]
    assert plans == {"deepseek_v3_671b": ((0, 1), True, False),
                     "mamba2_130m": ((0, 1), True, True),
                     "jamba_1_5_large_398b": ((0, 1), True, True),
                     "seamless_m4t_large_v2": ((0, 1), True, False)}
    spec = make_test_mesh(2, 4, device="cpu")
    with S.use_rules(S.SINGLE_POD_RULES, spec):
        for arch in ("deepseek_v3_671b", "mamba2_130m",
                     "jamba_1_5_large_398b", "seamless_m4t_large_v2",
                     "qwen2_7b", "llama4_scout_17b_a16e"):
            with pytest.raises(ValueError, match="bound mesh"):
                lm.tensor_parallel(configs.get_config(arch).reduced())
    mla = configs.get_config("deepseek_v3_671b").reduced()
    with S.use_rules(S.SINGLE_POD_RULES, make_test_mesh(1, 8, device="cpu")):
        with pytest.raises(ValueError, match="do not divide"):
            lm.tensor_parallel(mla)                 # 4 heads on 8 ranks
        with pytest.raises(ValueError, match="bound mesh"):
            lm.tensor_parallel(mla, 8)              # padded to 8
    cfg = configs.get_config("llama4_scout_17b_a16e").reduced()
    ffn = lm.init_params(cfg, torch.Generator().manual_seed(0))[
        "g_moe"][0]["ffn"]
    x = torch.zeros(1, 4, cfg.d_model, requires_grad=True)
    tp = lm.tensor_parallel(cfg)
    with S.use_rules(S.SINGLE_POD_RULES, spec):
        with pytest.raises(ValueError, match="MoE under a mesh is not "
                           "ported .*item 1.1"):
            lm._ffn_apply(ffn, x, cfg, tp, "moe")
        with torch.no_grad():
            assert lm._ffn_apply(ffn, x, cfg, tp, "moe").shape == x.shape
    pos = torch.arange(4)[None, :]
    for arch in ("deepseek_v3_671b", "mamba2_130m", "jamba_1_5_large_398b",
                 "seamless_m4t_large_v2"):
        cfg = configs.get_config(arch).reduced()
        tp = lm.tensor_parallel(cfg)
        group = lm.layer_groups(cfg)[0][0]
        layer = lm.init_layer(cfg, group, torch.Generator().manual_seed(0))
        memory = torch.zeros(1, 4, cfg.d_model)
        with S.use_rules(S.SINGLE_POD_RULES, spec):
            with pytest.raises(ValueError, match="Queue 1 item 2"):
                lm._run_layer(x, layer, cfg, pos, group, tp, memory)
    with S.use_rules(S.CP_SERVE_RULES, spec):
        with pytest.raises(ValueError, match="context-parallel.*item 1.5"):
            lm.tensor_parallel(configs.get_config("qwen2_7b").reduced())
    assert lm.tensor_parallel(configs.get_config("qwen2_7b")).model is None


# ------------------------------------------------- SP decode and pipeline

def _tanh_block(x, w):
    return torch.tanh(x @ w)


def _pipeline_inputs(n):
    rng = np.random.default_rng(11)
    w = (rng.standard_normal((n, PP_D, PP_D)) / np.sqrt(PP_D)).astype(
        np.float32)
    xs = rng.standard_normal((PP_M, PP_MB, PP_D)).astype(np.float32)
    return w, xs


def _sp_inputs():
    rng = np.random.default_rng(7)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return dict(q=f(SP_B, 1, SP_HQ, SP_D), k=f(SP_B, SP_S, SP_HKV, SP_D),
                v=f(SP_B, SP_S, SP_HKV, SP_D), new=f(SP_B, 1, SP_HKV, SP_D),
                k63=f(SP_B, 63, SP_HKV, SP_D), v63=f(SP_B, 63, SP_HKV, SP_D),
                q_lat=f(SP_B, LAT_H, LAT_C), q_rope=f(SP_B, LAT_H, LAT_R),
                lat=f(SP_B, SP_S, LAT_C), rope=f(SP_B, SP_S, LAT_R),
                lat_new=f(SP_B, 1, LAT_C))


def _sp_job(mesh, d, w):
    """Every SP decode case and the pipeline in one spawn of 4 ranks:
    SP on make_test_mesh(1, 4), the pipeline on a {"stage": 4} mesh."""
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    out = {}
    with S.use_rules(S.SINGLE_POD_RULES, mesh):
        def blk(x):
            return S.shard(x, "batch", "sp_seq", *([None] * (x.dim() - 2)))
        kb, vb = blk(t["k"]), blk(t["v"])
        out["rows"] = kb.shape[1]
        for index in (0, SP_INDEX, SP_S - 1):
            out["attn", index] = DEC.sp_decode_attention(
                t["q"], kb, vb, index, max_len=SP_S)
        spec = S.active_spec(t["k"].shape, "batch", "sp_seq", None, None)
        before = kb.clone()
        DEC.sp_cache_update(kb, t["new"], SP_INDEX, max_len=SP_S)
        out["wrote"] = coll.gather_objects(
            not torch.equal(kb, before), S.as_axis(mesh, "model"))
        out["update"] = S.unshard(kb, spec, mesh)
        # 63 rows do not split over 4: the whole cache on every rank
        k63, v63 = blk(t["k63"]), blk(t["v63"])
        out["rows63"] = k63.shape[1]
        out["attn63"] = DEC.sp_decode_attention(t["q"], k63, v63, SP_INDEX,
                                                max_len=63)
        DEC.sp_cache_update(k63, t["new"], SP_INDEX, max_len=63)
        out["update63"] = k63
        lat, rope = blk(t["lat"]), blk(t["rope"])
        out["latent"] = DEC.sp_decode_attention_latent(
            t["q_lat"], t["q_rope"], lat, rope, SP_INDEX, nope_dim=16,
            rope_dim=LAT_R, max_len=SP_S)
        DEC.sp_latent_cache_update(lat, t["lat_new"], SP_INDEX,
                                   max_len=SP_S)
        out["latent_update"] = S.unshard(
            lat, S.active_spec(t["lat"].shape, "batch", "sp_seq", None),
            mesh)
    with S.use_rules(S.SINGLE_POD_RULES, mesh):
        out["plans"] = {}
        for arch in FAMILY_ARCHS:
            tp = lm.tensor_parallel(configs.get_config(arch).reduced())
            out["plans"][arch] = (tp.heads, tp.rows, tp.ssd)
    stage = make_mesh({"stage": mesh.size}, device="cpu")
    ws = [torch.from_numpy(x) if r == stage.rank else None
          for r, x in enumerate(w[0])]
    coll.reset_counts()
    out["pipeline"] = PP.pipeline_apply(stage, "stage", ws,
                                        torch.from_numpy(w[1]), _tanh_block)
    out["pipeline_counts"] = coll.counts()
    return out


@pytest.fixture(scope="module")
def sp():
    d = _sp_inputs()
    w = _pipeline_inputs(4)
    ranks = run_on_ranks(_sp_job, make_test_mesh(1, 4, device="cpu"), d, w,
                         timeout=TIMEOUT)
    return d, w, ranks


@pytest.mark.parametrize("hq,hkv", [(8, 2), (6, 4)])
def test_sp_decode_attention_on_one_device_matches_reference(hq, hkv):
    """Outside any mesh, with whole groups (folded) and with padded heads
    past them (6 q heads over 4 KV heads read by ``expand_kv``'s map)."""
    import jax.numpy as jnp
    from repro.dist.decode import sp_decode_attention as jattn
    rng = np.random.default_rng(hq)
    q = rng.standard_normal((2, 1, hq, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 24, hkv, 16)).astype(np.float32)
            for _ in range(2))
    want = jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                 jnp.int32(11))
    got = DEC.sp_decode_attention(_t(q), _t(k), _t(v), 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_sp_decode_attention_on_ranks_matches_reference(sp):
    """4 ranks of 16 rows each: at index 0 three ranks' rows lie wholly
    past it, at 37 one, at 63 none."""
    import jax.numpy as jnp
    from repro.dist.decode import sp_decode_attention as jattn
    d, _w, ranks = sp
    assert ranks["rows"] == SP_S // 4
    for index in (0, SP_INDEX, SP_S - 1):
        want = jattn(jnp.asarray(d["q"]), jnp.asarray(d["k"]),
                     jnp.asarray(d["v"]), jnp.int32(index))
        np.testing.assert_allclose(ranks["attn", index].numpy(),
                                   np.asarray(want), rtol=2e-5, atol=2e-5)


def test_sp_cache_update_writes_only_the_owner(sp):
    import jax.numpy as jnp
    from repro.dist.decode import sp_cache_update as jupd
    d, _w, ranks = sp
    want = np.asarray(jupd(jnp.asarray(d["k"]), jnp.asarray(d["new"]),
                           jnp.int32(SP_INDEX)))
    np.testing.assert_array_equal(ranks["update"].numpy(), want)
    assert ranks["wrote"] == [r == SP_INDEX // 16 for r in range(4)]


@pytest.mark.parametrize("index", [-1, 8])
def test_sp_cache_update_refuses_a_position_outside_the_cache(index):
    """No rank would own it (the reference clamps it to the last row)."""
    cache = torch.zeros(2, 8, 1, 4)
    with pytest.raises(IndexError, match="outside its 8 rows"):
        DEC.sp_cache_update(cache, torch.ones(2, 1, 1, 4), index)
    assert not cache.any()


def test_sp_latent_forms_on_ranks_match_reference(sp):
    import jax.numpy as jnp
    from repro.dist import decode as JD
    d, _w, ranks = sp
    want = JD.sp_decode_attention_latent(
        jnp.asarray(d["q_lat"]), jnp.asarray(d["q_rope"]),
        jnp.asarray(d["lat"]), jnp.asarray(d["rope"]), jnp.int32(SP_INDEX),
        nope_dim=16, rope_dim=LAT_R)
    np.testing.assert_allclose(ranks["latent"].numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(
        ranks["latent_update"].numpy(),
        np.asarray(JD.sp_latent_cache_update(
            jnp.asarray(d["lat"]), jnp.asarray(d["lat_new"]),
            jnp.int32(SP_INDEX))))


def test_sp_decode_falls_back_to_replication_where_the_rows_do_not_divide(
        sp):
    import jax.numpy as jnp
    from repro.dist import decode as JD
    d, _w, ranks = sp
    assert ranks["rows63"] == 63
    want = JD.sp_decode_attention(jnp.asarray(d["q"]), jnp.asarray(d["k63"]),
                                  jnp.asarray(d["v63"]), jnp.int32(SP_INDEX))
    np.testing.assert_allclose(ranks["attn63"].numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(
        ranks["update63"].numpy(),
        np.asarray(JD.sp_cache_update(jnp.asarray(d["k63"]),
                                      jnp.asarray(d["new"]),
                                      jnp.int32(SP_INDEX))))


def test_pipeline_apply_on_ranks_matches_reference(sp):
    """4 stages, 6 microbatches: M + S − 1 = 9 ring hops, then the sum of
    zeros and the last stage's outputs."""
    import jax.numpy as jnp
    from repro.dist.pipeline_parallel import reference_apply as jref
    _d, (w, xs), ranks = sp
    want = jref(jnp.asarray(w), jnp.asarray(xs),
                lambda x, wi: jnp.tanh(x @ wi))
    np.testing.assert_allclose(ranks["pipeline"].numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    counts = ranks["pipeline_counts"]
    assert counts["pipeline.hop"]["calls"] == PP_M + 4 - 1
    assert counts["pipeline.out"]["calls"] == 1


# --------------------------------------------------- the model on (2, 4)

def _model_cfg(n_kv):
    return dataclasses.replace(configs.get_config("qwen2_7b").reduced(),
                               n_kv_heads=n_kv)


def _moe_cfg(get_config, n_experts, capacity):
    """llama4-scout reduced from ``get_config`` (the port's or the
    reference's) with ``n_experts`` experts and, if given, the capacity
    factor."""
    cfg = get_config("llama4_scout_17b_a16e").reduced()
    moe = dataclasses.replace(cfg.moe, n_experts=n_experts)
    if capacity is not None:
        moe = dataclasses.replace(moe, capacity_factor=capacity)
    return dataclasses.replace(cfg, moe=moe)


def _plant_biases(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(x, key=None):
        if isinstance(x, dict):
            return {k: walk(v, k) for k, v in x.items()}
        if key in ("b", "bias"):
            return (0.1 * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return walk(tree)


def _moe_job(mesh, cfg, params, local, out, name, x):
    """An MoE model's extra cases: its first layer's routed experts on the
    ranks (no shared expert) against one device's, bit for bit, and a
    gradient through the model (the rank's blocks, ``local``) under the
    mesh."""
    from repro_torch.models import moe as M
    tp = lm.tensor_parallel(cfg, MOE_MP)
    out[name, "experts_split"] = tp.experts
    whole = {k: v for k, v in params["g_moe"][0]["ffn"].items()
             if k != "shared"}
    mine = dict(whole)
    if tp.experts:
        mine["experts"] = {k: S.block(v, ("model", None, None), mesh)
                           for k, v in whole["experts"].items()}
    mo = cfg.moe
    kw = dict(n_experts=mo.n_experts, top_k=mo.top_k,
              capacity_factor=mo.capacity_factor)
    coll.reset_counts()
    got = M.moe_apply(mine, x, axis=tp.axis(tp.experts), **kw)
    out[name, "combine_calls"] = coll.counts().get(
        "moe.combine", {"calls": 0})["calls"]
    out[name, "routed_equal"] = coll.gather_objects(
        bool(torch.equal(got, M.moe_apply(whole, x, **kw))), mesh)
    live = _requiring_grad(local)
    try:
        lm.forward_train(live, {"tokens": x.new_zeros(2, 4).long(),
                                "labels": x.new_zeros(2, 4).long()}, cfg,
                         dtype=torch.float32, mp=MOE_MP)
        out[name, "grad_refused"] = None
    except ValueError as e:
        out[name, "grad_refused"] = str(e)


def _requiring_grad(params):
    """A copy of ``params`` whose leaves take a gradient."""
    from repro_torch.train.optimizer import tree_map
    return tree_map(lambda t: t.detach().clone().requires_grad_(), params)


def _model_job(mesh, cases):
    """For each model: the placement round trip, the prefill step's
    logits and the hidden states, ``generate``, and the decode loop's
    logits of every step on the reference's tokens, each gathered whole;
    an MoE model's extra cases (``_moe_job``)."""
    out = {}
    for name, cfg, params, mp, toks, prompt, ref_tokens, x in cases:
        specs = TS.param_specs(params, zero=False, multi_pod=False)
        with S.use_rules(S.SINGLE_POD_RULES, mesh):
            local = TS.local_tree(params, specs, mesh)
            out[name, "gathered"] = TS.gather_tree(
                local, TS.sanitize_specs(specs, params, mesh.shape), mesh)
            tp = lm.tensor_parallel(cfg, mp)     # its group stays here
            out[name, "tp"] = dataclasses.replace(
                tp, model=(tp.model.size, tp.model.ranks))
            out[name, "logits"] = make_prefill_step(
                cfg, dtype=torch.float32, mp=mp)(local, {"tokens": toks})
            rows = S.shard(toks, "batch", None)
            _logits, hidden = lm.prefill(local, {"tokens": rows}, cfg,
                                         dtype=torch.float32, mp=mp)
            spec = S.active_spec(toks.shape, "batch", None)
            out[name, "hidden"] = S.unshard(hidden, spec + (None,), mesh)
            out[name, "generate"] = generate(local, cfg, prompt, NEW, mp=mp)
            B, P = prompt.shape
            feed = torch.cat([prompt, ref_tokens], 1)
            mine = S.shard(feed, "batch", None)
            cache = lm.init_cache(cfg, B, P + NEW, dtype=torch.float32,
                                  device="cpu")
            step = make_decode_fn(cfg, dtype=torch.float32, mp=mp,
                                  max_len=P + NEW)
            steps = []
            for t in range(P + NEW):
                logits, cache = step(local, cache, mine[:, t:t + 1], t)
                (logits,) = lm.L.gather_cols([logits], tp.axis(tp.vocab),
                                             site="test")
                steps.append(S.unshard(logits, spec + (None,), mesh))
            out[name, "steps"] = torch.cat(steps, 1)
            out[name, "cache_shape"] = tuple(cache[lm.layer_groups(cfg)[0][0]]
                                             ["k"].shape)
            if cfg.moe is not None:
                _moe_job(mesh, cfg, params, local, out, name, x)
    return out


def _reference_serve(jcfg, tree, prompt, mp):
    """The reference launcher's loop (its ``main`` draws its own weights):
    greedy tokens and every step's logits."""
    import jax
    import jax.numpy as jnp
    from repro.models import lm as JLM
    from repro.train import make_decode_fn as jmake_decode_fn
    fn = jax.jit(jmake_decode_fn(jcfg, mp=mp, dtype=jnp.float32))
    B, P = prompt.shape
    cache = JLM.init_cache(jcfg, B, P + NEW, mp, dtype=jnp.float32)
    jp = jnp.asarray(prompt, jnp.int32)
    steps = []
    for t in range(P):
        logits, cache = fn(tree, cache, jp[:, t:t + 1], jnp.int32(t))
        steps.append(np.asarray(logits))
    toks = []
    for t in range(NEW):
        nxt = jnp.argmax(logits[:, -1, :jcfg.vocab], -1)[:, None].astype(
            jnp.int32)
        toks.append(np.asarray(nxt))
        logits, cache = fn(tree, cache, nxt, jnp.int32(P + t))
        steps.append(np.asarray(logits))
    return np.concatenate(toks, 1), np.concatenate(steps, 1)


@pytest.fixture(scope="module")
def served():
    """The models converted from the reference's ``init_params(cfg, key,
    mp)`` (biases planted), its prefill and launcher outputs, and the 8
    ranks' results in one spawn."""
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.models import lm as JLM
    from repro.train import make_prefill_step as jmake_prefill_step
    cases, refs = [], {}
    rng = np.random.default_rng(5)
    models = [(name, mp, dataclasses.replace(
        jconfigs.get_config("qwen2_7b").reduced(), n_kv_heads=n_kv),
        _model_cfg(n_kv)) for name, n_kv, mp in MODELS]
    models += [(name, MOE_MP, _moe_cfg(jconfigs.get_config, e, c),
                _moe_cfg(configs.get_config, e, c))
               for name, e, c in MOE_MODELS]
    for i, (name, mp, jcfg, cfg) in enumerate(models):
        tree = _plant_biases(jax.tree_util.tree_map(
            np.asarray, JLM.init_params(jcfg, jax.random.key(i), mp)), i)
        params = lm_params_from_reference(tree, cfg, mp)
        toks = rng.integers(0, jcfg.vocab, (4, PREFILL)).astype(np.int32)
        prompt = toks[:, :PROMPT]
        jtree = jax.tree_util.tree_map(jnp.asarray, tree)
        jb = {"tokens": jnp.asarray(toks)}
        ref_logits = np.asarray(jmake_prefill_step(
            jcfg, mp=mp, dtype=jnp.float32)(jtree, jb))
        _l, ref_x = JLM.prefill(jtree, jb, jcfg, mp, dtype=jnp.float32)
        ref_tokens, ref_steps = _reference_serve(jcfg, jtree, prompt, mp)
        refs[name] = dict(params=params, logits=ref_logits,
                          hidden=np.asarray(ref_x), tokens=ref_tokens,
                          steps=ref_steps)
        x = _t(rng.standard_normal((4, PREFILL, cfg.d_model)).astype(
            np.float32))
        cases.append((name, cfg, params, mp, _t(toks).long(),
                      _t(prompt).long(), _t(ref_tokens).long(), x))
    ranks = run_on_ranks(_model_job, make_test_mesh(2, 4, device="cpu"),
                         cases, timeout=TIMEOUT)
    return refs, ranks


def _close(got, want, rel=1e-5):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("name", [m[0] for m in MODELS])
def test_mesh_plan_of_each_model(served, name):
    """What each model's rank 0 does at the shard points: q heads and KV
    heads split or gathered, padded heads two a rank."""
    _refs, ranks = served
    tp = ranks[name, "tp"]
    want = {"gathered_kv": ((0, 1), (0, 2), True),
            "divisible_kv": ((0, 1), (0, 1), False),
            "padded_heads": ((0, 2), (0, 2), True)}[name]
    assert (tp.heads, tp.kv, tp.kv_gather) == want
    assert tp.rows and tp.ffn and tp.vocab and not tp.q_gather
    assert tp.model == (4, (0, 1, 2, 3))      # rank 0's model line


@pytest.mark.parametrize("name", [m[0] for m in MODELS])
def test_placement_round_trip_is_exact(served, name):
    refs, ranks = served
    got, want = ranks[name, "gathered"], refs[name]["params"]
    assert [tuple(t.shape) for t in lm.tree_leaves(got)] == \
        [tuple(t.shape) for t in lm.tree_leaves(want)]
    for a, b in zip(lm.tree_leaves(got), lm.tree_leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", [m[0] for m in MODELS])
def test_mesh_prefill_matches_reference(served, name):
    refs, ranks = served
    _close(ranks[name, "logits"].numpy(), refs[name]["logits"])
    _close(ranks[name, "hidden"].numpy(), refs[name]["hidden"])


@pytest.mark.parametrize("name", [m[0] for m in MODELS])
def test_mesh_generate_matches_the_reference_launcher(served, name):
    """Greedy tokens equal; every decode step's logits (on the reference's
    tokens) within 1e-5 of the largest; the SP cache a rank holds is its
    2 batch rows and 3 of the 12 positions."""
    refs, ranks = served
    g = ranks[name, "generate"]
    np.testing.assert_array_equal(g.tokens.numpy(), refs[name]["tokens"])
    assert g.finite and g.steps == PROMPT + NEW
    _close(g.prompt_logits.numpy(), refs[name]["steps"][:, PROMPT - 1])
    _close(ranks[name, "steps"].numpy(), refs[name]["steps"])
    assert ranks[name, "cache_shape"][1:3] == (2, (PROMPT + NEW) // 4)


# ------------------------------------------- llama4-scout, experts on model

MOE_NAMES = [m[0] for m in MOE_MODELS]


@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_mesh_prefill_matches_reference(served, name):
    """The prefill step's logits and the hidden states against the
    reference's ``prefill(..., mp=4)`` on one device, within 1e-5 of the
    largest magnitude (the row-parallel sums of o, the shared expert's
    down and the combine reorder f32 adds)."""
    refs, ranks = served
    _close(ranks[name, "logits"].numpy(), refs[name]["logits"])
    _close(ranks[name, "hidden"].numpy(), refs[name]["hidden"])


@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_mesh_generate_matches_the_reference_launcher(served, name):
    """Greedy tokens equal the reference launcher's; every decode step's
    logits on its tokens within 1e-5 of the largest."""
    refs, ranks = served
    g = ranks[name, "generate"]
    np.testing.assert_array_equal(g.tokens.numpy(), refs[name]["tokens"])
    assert g.finite and g.steps == PROMPT + NEW
    _close(g.prompt_logits.numpy(), refs[name]["steps"][:, PROMPT - 1])
    _close(ranks[name, "steps"].numpy(), refs[name]["steps"])


@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_combine_on_ranks_is_one_devices_bit_for_bit(served, name):
    """A layer's routed experts on the ranks (each its two experts, the
    combine summed over "model" in rank order) against ``moe_apply`` on
    one device, f32, top-1: equal bit for bit on every rank, at a
    capacity that drops nothing and at the default one; with 6 experts
    the banks stay whole and nothing is summed."""
    _refs, ranks = served
    split = name != "moe_whole"
    assert ranks[name, "experts_split"] is split
    assert ranks[name, "combine_calls"] == (1 if split else 0)
    assert ranks[name, "routed_equal"] == [True] * 8


@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_gradient_under_the_mesh_is_refused(served, name):
    """Training MoE over the mesh is not ported: a gradient through the
    model raises at its first MoE layer, on every rank alike."""
    _refs, ranks = served
    assert "not ported" in ranks[name, "grad_refused"]
