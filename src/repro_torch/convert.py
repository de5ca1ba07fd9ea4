"""Carry state across from the JAX package.

What a graph run of the reference carries is its config blob
(``repro.session.SessionConfig.to_json()``), its edge → partition
assignment (a plain array both packages share) and its layout tables; an
LM carries its parameter tree.  Every converter takes plain JSON / numpy
input, so this module imports nothing of the reference.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .core.pipeline import CLUGPConfig
from .graph.partition import PartitionLayout
from .models.config import ModelConfig
from .models.lm import param_count, require_dense, tree_leaves
from .session import SessionConfig

_BACKENDS = {"jit": "torch", "np": "torch", "torch": "torch"}
_KERNELS = {"auto": "auto", "pallas": "cuda", "xla": "torch",
            "cuda": "cuda", "torch": "torch"}
# lowering-only knobs of the reference with no counterpart in the port
_DROPPED = ("unroll",)


def _not_ported(what: str, item: str) -> ValueError:
    return ValueError(f"{what} is not ported yet (ROADMAP, Queue 1: {item})")


def config_from_reference(json_text: str) -> SessionConfig:
    """A reference ``SessionConfig.to_json()`` blob → the port's config:
    backend ``jit``/``np`` → ``torch``, game/cluster kernel ``pallas`` →
    ``cuda`` and ``xla`` → ``torch``.  Raises on what the port does not
    have yet (the scan game, the sharded backend).

    Two mappings change the game: ``backend="np"`` (the reference
    session's default, which plays the host ``best_response_rounds``)
    and an off-TPU ``kernel="auto"`` (which the reference resolves to
    the Gauss–Seidel scan) both map to the port's Jacobi CSR game.  With
    the game on the partitions therefore differ; with it off they are
    bit-identical."""
    d = json.loads(json_text)
    backend = d.get("backend", "np")
    if backend not in _BACKENDS:
        raise _not_ported(f"backend {backend!r}",
                          "the sharded partitioner and multi-GPU engine")
    exchange = d.get("exchange", "halo")
    if int(d.get("nodes", 1)) != 1:
        raise _not_ported("nodes > 1",
                          "the sharded partitioner and multi-GPU engine")
    clugp = dict(d["clugp"])
    for key in _DROPPED:
        clugp.pop(key, None)
    for key in ("kernel", "cluster_kernel"):
        value = clugp.get(key, "auto")
        if value == "scan":
            raise _not_ported("the scan game", "the Gauss–Seidel game")
        if value not in _KERNELS:
            raise ValueError(f"unknown {key} {value!r}")
        clugp[key] = _KERNELS[value]
    return SessionConfig(clugp=CLUGPConfig(**clugp), backend="torch",
                         exchange=exchange,
                         iters=int(d.get("iters", 30)),
                         pad_multiple=int(d.get("pad_multiple", 8)))


def layout_from_reference(obj) -> PartitionLayout:
    """Any object or dict carrying a ``PartitionLayout``'s fields (the
    reference's layout object, or a dict of its numpy tables) → the
    port's layout, tables copied as numpy arrays."""
    def get(name):
        return obj[name] if isinstance(obj, dict) else getattr(obj, name)

    fields = {}
    for f in dataclasses.fields(PartitionLayout):
        if f.name == "cache":
            continue
        value = get(f.name)
        fields[f.name] = (np.array(value) if f.name in PartitionLayout.TABLES
                          else int(value))
    return PartitionLayout(**fields)


def lm_params_from_reference(tree, cfg: ModelConfig) -> dict:
    """The reference's LM parameter tree as numpy arrays (``{"embed",
    "lm_head", "ln_f", "g_dense": {leaves stacked on a leading layer
    axis}}``, weights (d_in, d_out) as in ``repro.models.layers``) → the
    port's parameters: CPU tensors in the tree's dtypes, ``g_dense`` split
    into one dict per layer.  Raises for a configuration the port cannot
    run and for a tree that does not fit ``cfg``."""
    require_dense(cfg)
    if set(tree) != {"embed", "lm_head", "ln_f", "g_dense"}:
        raise ValueError(f"not a dense LM tree: keys {sorted(tree)}")

    def walk(x, pick):
        if isinstance(x, dict):
            return {k: walk(v, pick) for k, v in x.items()}
        return torch.from_numpy(np.array(pick(np.asarray(x))))

    out = {k: walk(tree[k], lambda a: a)
           for k in ("embed", "lm_head", "ln_f")}
    out["g_dense"] = [walk(tree["g_dense"], lambda a, i=i: a[i])
                      for i in range(cfg.n_layers)]
    want = {"embed": (cfg.padded_vocab, cfg.d_model),
            "lm_head": (cfg.d_model, cfg.padded_vocab)}
    got = {"embed": tuple(out["embed"]["table"].shape),
           "lm_head": tuple(out["lm_head"]["w"].shape)}
    layers = {np.asarray(a).shape[0]
              for a in tree_leaves(tree["g_dense"])}
    total = sum(t.numel() for t in tree_leaves(out))
    if got != want or layers != {cfg.n_layers} or total != param_count(cfg):
        raise ValueError(f"tree does not fit {cfg.name}: {got} vs {want}, "
                         f"layer axis {layers} vs {cfg.n_layers}, "
                         f"{total} vs {param_count(cfg)} parameters")
    return out

