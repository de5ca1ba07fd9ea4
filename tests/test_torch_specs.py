"""The dry-run's inputs and a rank's parameter bytes held against the JAX
package on the CPU, nothing compiled and no device made.

- ``launch/specs.py``: the shapes letter for letter; for every arch ×
  shape the skip reason and every leaf of ``input_specs(cfg, shape,
  mp=16)`` at the reference's shape and dtype (its cache through
  ``jax.eval_shape``).
- A rank of the (16, 16) production mesh: for every arch, serving in
  bf16 and training in f32 with its optimizer, the port's
  ``memory.arguments`` (the bytes ``build_cell`` placed on the meta
  device) equal, to the byte, the sum over the reference's leaves
  (``abstract_params``, the optimizer's ``init`` through
  ``jax.eval_shape``) of each leaf's bytes over the product of the axis
  sizes in its ``param_specs`` after ``sanitize_specs`` (which reads only
  ``mesh.shape``).  The ZeRO and optimizer choices are the reference
  ``build_cell``'s, written out here from ``src/repro/launch/dryrun.py``
  (importing that module would set its 512-device ``XLA_FLAGS`` in this
  process): training ZeRO-shards ≥ 8e9 parameters and takes Adafactor
  from 3e10; serving shards over "data" only where the bf16 weights over
  "model" pass 8 GiB.
"""
import math
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.dist import collectives as coll  # noqa: E402
from repro_torch.dist.sharding import SINGLE_POD_RULES, use_rules  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402

CELLS = [(a, s) for a in configs.ARCHS for s in S.SHAPES]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "int32": torch.int32}


@pytest.fixture(scope="module")
def ref():
    import jax
    from repro import configs as jconfigs
    from repro.launch import specs as JS
    from repro.models import lm as JLM
    from repro.train import optimizer as JO
    from repro.train import shardings as JT
    return types.SimpleNamespace(jax=jax, configs=jconfigs, specs=JS,
                                 lm=JLM, opt=JO, shardings=JT)


def _leaves(tree, path=""):
    """(path, leaf) of a tree of dicts, in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                         f"{path}/{k}")]
    return [(path, tree)]


def test_shapes_are_the_references(ref):
    assert S.SHAPES == ref.specs.SHAPES


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_leaf_for_leaf(ref, arch, shape):
    """The skip reason, then every leaf's path, shape and dtype."""
    cfg, jcfg = configs.get_config(arch), ref.configs.get_config(arch)
    assert S.cell_is_skipped(cfg, shape) == ref.specs.cell_is_skipped(
        jcfg, shape)
    got = _leaves(S.input_specs(cfg, shape, mp=16))
    want = _leaves(ref.specs.input_specs(jcfg, shape, mp=16))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, t), (_, sds) in zip(got, want):
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(sds.shape), path
        assert t.dtype == DTYPES[np.dtype(sds.dtype).name], path


def _reference_rank_bytes(ref, tree, zero: bool, mesh_shape: dict) -> int:
    """Σ over the leaves of ``tree`` (ShapeDtypeStructs) of their bytes
    over the product of the axis sizes of their sanitized specs."""
    P = ref.jax.sharding.PartitionSpec
    specs = ref.shardings.sanitize_specs(
        ref.shardings.param_specs(tree, zero=zero, multi_pod=False), tree,
        types.SimpleNamespace(shape=mesh_shape))
    leaves = ref.jax.tree_util.tree_leaves(tree)
    parts = ref.jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, P))
    total = 0
    for leaf, spec in zip(leaves, parts):
        n = math.prod(mesh_shape[a] for e in spec if e is not None
                      for a in (e if isinstance(e, tuple) else (e,)))
        size = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
        assert size % n == 0
        total += size // n
    return total


@pytest.mark.parametrize("kind", ["serve", "train"])
@pytest.mark.parametrize("arch", configs.ARCHS)
def test_rank_parameter_bytes_equal_the_references(ref, arch, kind):
    """Rank 0 of (16, 16): the parameters' (and the optimizer state's)
    bytes the port places, against the reference's specs."""
    import jax.numpy as jnp
    cfg, jcfg = configs.get_config(arch), ref.configs.get_config(arch)
    mesh = D.make_production_mesh(device="meta")
    shape = dict(mesh.shape)
    n = ref.lm.param_count(jcfg, mp=16)
    train = kind == "train"
    zero = n >= 8e9 if train else 2 * n / shape["model"] > 8 * 2**30
    opt_name = "adafactor" if n >= 3e10 else "adamw"
    assert (D.zero_default(cfg) if train
            else D.serve_zero(cfg, 16, mesh)) == zero
    assert D.optimizer_default(cfg) == opt_name
    with coll.dry(mesh, 0) as rank, use_rules(SINGLE_POD_RULES, rank):
        _fn, _args, held = D.build_cell(
            cfg, "train_4k" if train else "decode_32k", rank,
            SINGLE_POD_RULES, mp=16, multi_pod=False)
    tree = ref.lm.abstract_params(jcfg, 16,
                                  dtype=None if train else jnp.bfloat16)
    assert held["params"] == _reference_rank_bytes(ref, tree, zero, shape)
    if train:
        opt = ref.opt.get_optimizer(opt_name)
        state = ref.jax.eval_shape(opt.init, tree)
        assert held["opt_state"] == _reference_rank_bytes(ref, state, zero,
                                                          shape)
