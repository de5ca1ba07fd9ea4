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
from .models.lm import (layer_groups, param_count, require_ported,
                        tree_leaves)
from .session import SessionConfig

_BACKENDS = {"jit": "torch", "np": "np", "torch": "torch",
             "sharded": "sharded"}
# the game kernel: the reference resolves "auto" off a TPU to the scan
# (repro.core.stages.resolve_game_mode); the clustering kernel's "auto"
# means the kernels on both sides
_GAME_KERNELS = {"auto": "scan", "scan": "scan", "pallas": "cuda",
                 "xla": "torch", "cuda": "cuda", "torch": "torch"}
_CLUSTER_KERNELS = {"auto": "auto", "pallas": "cuda", "xla": "torch",
                    "cuda": "cuda", "torch": "torch"}
# lowering-only knobs of the reference with no counterpart in the port
_DROPPED = ("unroll",)


def config_from_reference(json_text: str) -> SessionConfig:
    """A reference ``SessionConfig.to_json()`` blob → the port's config,
    resolved as the reference resolves it off a TPU:

    - backend ``np`` → ``np`` (the host oracle; ``nodes > 1`` → its host
      combine), ``jit`` → ``torch`` (whose ``nodes`` the reference
      ignores, so it becomes 1) and ``sharded`` → ``sharded``;
    - game kernel ``scan`` and ``auto`` → ``scan`` (the Gauss–Seidel game,
      falling back to the Jacobi CSR game above the pair-key limit as the
      reference falls back to ``xla``), ``pallas`` → ``cuda``, ``xla`` →
      ``torch``; cluster kernel ``pallas`` → ``cuda``, ``xla`` →
      ``torch``.

    So a converted config gives the reference's partition with the game
    on too: bit for bit on the CPU, given the reference's draws (the
    device games take the reference's start assignment injected).
    Raises on a backend neither package has."""
    d = json.loads(json_text)
    backend = d.get("backend", "np")
    if backend not in _BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    nodes = int(d.get("nodes", 1)) if backend != "jit" else 1
    clugp = dict(d["clugp"])
    for key in _DROPPED:
        clugp.pop(key, None)
    for key, table in (("kernel", _GAME_KERNELS),
                       ("cluster_kernel", _CLUSTER_KERNELS)):
        value = clugp.get(key, "auto")
        if value not in table:
            raise ValueError(f"unknown {key} {value!r}")
        clugp[key] = table[value]
    return SessionConfig(clugp=CLUGPConfig(**clugp),
                         backend=_BACKENDS[backend], nodes=nodes,
                         exchange=d.get("exchange", "halo"),
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


def lm_params_from_reference(tree, cfg: ModelConfig, mp: int = 1) -> dict:
    """The reference's LM parameter tree as numpy arrays (``{"embed",
    "lm_head", "ln_f"}`` and one ``g_<group>`` per layer group of ``cfg``
    — ``g_dense``; ``g_moe``, after ``g_dense`` when ``first_k_dense >
    0``; ``g_ssd``; ``g_hyb``, ``{"sub": [one dict a sublayer]}``;
    ``g_enc`` and ``g_dec``, the latter with ``ln3`` and the
    cross-attention's ``xattn`` — each with its leaves stacked on a
    leading layer axis; weights (d_in, d_out) as in
    ``repro.models.layers``; q heads padded to a multiple of ``mp``, as
    the reference's ``init_params(cfg, key, mp)`` pads them) → the port's
    parameters: CPU tensors in the tree's dtypes, each group split into
    one dict per layer.  Raises for a family the port does not know and
    for a tree that does not fit ``cfg`` at ``mp``."""
    require_ported(cfg)
    groups = layer_groups(cfg)
    keys = {"embed", "lm_head", "ln_f"} | {f"g_{g}" for g, _ in groups}
    if set(tree) != keys:
        raise ValueError(f"not an LM tree of {cfg.name}: keys {sorted(tree)}"
                         f", want {sorted(keys)}")

    def walk(x, pick):
        if isinstance(x, dict):
            return {k: walk(v, pick) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v, pick) for v in x]
        return torch.from_numpy(np.array(pick(np.asarray(x))))

    out = {k: walk(tree[k], lambda a: a)
           for k in ("embed", "lm_head", "ln_f")}
    want = {"embed": (cfg.padded_vocab, cfg.d_model),
            "lm_head": (cfg.d_model, cfg.padded_vocab)}
    got = {"embed": tuple(out["embed"]["table"].shape),
           "lm_head": tuple(out["lm_head"]["w"].shape)}
    layers = {g: {np.asarray(a).shape[0] for a in tree_leaves(tree[f"g_{g}"])}
              for g, _ in groups}
    if got != want or layers != {g: {n} for g, n in groups}:
        raise ValueError(f"tree does not fit {cfg.name}: {got} vs {want}, "
                         f"layer axes {layers} vs {dict(groups)}")
    for g, count in groups:
        out[f"g_{g}"] = [walk(tree[f"g_{g}"], lambda a, i=i: a[i])
                         for i in range(count)]
    total = sum(t.numel() for t in tree_leaves(out))
    if total != param_count(cfg, mp):
        raise ValueError(f"tree does not fit {cfg.name}: {total} vs "
                         f"{param_count(cfg, mp)} parameters")
    return out
