"""How far a random SSD stack's bf16 prefill parts from its f32 twin, by
depth, in the JAX package and in the port on the same weights: a
witness for the bf16 gates of ``chip_smoke.py``'s ``[family-mesh]``.

mamba2-130m at its published width, its first 1, 2, 4 and 24 layers,
drawn by the reference's ``init_params``; the matrices cast to bf16 and
the per-layer vectors (norm scales, ``A_log``, ``D``, ``dt_bias``) kept in
f32, as the port's ``init_params(..., dtype=torch.bfloat16)`` keeps them;
the twin is those bf16 weights back in f32, run in f32.  Random SSD
stacks amplify bf16 rounding from layer to layer, in the reference as in
the port: at one layer both stay within the 2e-2 that ``[family-mesh]``
holds a mesh to the one card, at 4 layers within the 0.1 it holds the
mesh's and the one card's first 4 layers to their f32 twin, and at 24
layers both are far past 2e-2 (so no flat bf16 tolerance can hold a
whole random mamba2 stack to another run of it).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import lm as JLM  # noqa: E402
from repro.train import make_prefill_step as jmake_prefill_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_reference  # noqa: E402
from repro_torch.train import make_prefill_step  # noqa: E402

ARCH = "mamba2_130m"
DEPTHS = (1, 2, 4, 24)
B, S = 2, 128           # one SSD chunk of 128 positions a row
# (largest distance allowed, or None; smallest required, or None), of
# max |bf16 - twin| over the twin's largest |logit|
BANDS = {1: (2e-2, None), 2: (5e-2, None), 4: (0.1, None), 24: (None, 0.3)}


def _bf16_matrices_jax(tree):
    """The reference's tree with every matrix in bf16: a leaf of a layer
    group (``g_*``, stacked on a leading layer axis) is a matrix where a
    layer's slice has two dims or more."""
    def cast(path, x):
        stacked = str(getattr(path[0], "key", "")).startswith("g_")
        return x.astype(jnp.bfloat16) if x.ndim - stacked >= 2 else x
    return jax.tree_util.tree_map_with_path(cast, tree)


def _bf16_matrices_torch(tree):
    if isinstance(tree, dict):
        return {k: _bf16_matrices_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16_matrices_torch(v) for v in tree]
    return tree.to(torch.bfloat16) if tree.dim() >= 2 else tree


def _rel(got, twin):
    got, twin = np.asarray(got, np.float64), np.asarray(twin, np.float64)
    return float(np.abs(got - twin).max() / np.abs(twin).max())


@pytest.fixture(scope="module")
def distances():
    """depth → (the reference's distance, the port's)."""
    full = jconfigs.get_config(ARCH)
    tokens = np.random.default_rng(13).integers(0, full.vocab, (B, S))
    out = {}
    for n in DEPTHS:
        cfg = dataclasses.replace(full, n_layers=n)
        tree = JLM.init_params(cfg, jax.random.key(1))
        bf = _bf16_matrices_jax(tree)
        twin = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), bf)
        batch = {"tokens": jnp.asarray(tokens)}
        ref = _rel(jmake_prefill_step(cfg, dtype=jnp.bfloat16)(bf, batch)
                   .astype(jnp.float32),
                   jmake_prefill_step(cfg, dtype=jnp.float32)(twin, batch))
        tcfg = dataclasses.replace(configs.get_config(ARCH), n_layers=n)
        p32 = lm_params_from_reference(
            jax.tree_util.tree_map(np.array, twin), tcfg)
        tb = {"tokens": torch.from_numpy(tokens)}
        with torch.no_grad():
            port = _rel(make_prefill_step(tcfg, dtype=torch.bfloat16)(
                _bf16_matrices_torch(p32), tb).float(),
                make_prefill_step(tcfg, dtype=torch.float32)(p32, tb))
        out[n] = (ref, port)
    return out


@pytest.mark.parametrize("depth", DEPTHS)
def test_bf16_distance_from_f32_twin_by_depth(distances, depth):
    """Each depth's distance in the reference and in the port lies in its
    band, and both grow with depth."""
    most, least = BANDS[depth]
    ref, port = distances[depth]
    for who, d in (("reference", ref), ("port", port)):
        assert np.isfinite(d), (who, depth)
        assert most is None or d <= most, (who, depth, d)
        assert least is None or d >= least, (who, depth, d)
    shallower = [n for n in DEPTHS if n < depth]
    if shallower:
        below = distances[shallower[-1]]
        assert ref > below[0] and port > below[1], (distances, depth)
