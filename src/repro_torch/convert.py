"""Carry state across from the JAX package.

This system has no model weights.  What a run of the reference carries
is its config blob (``repro.session.SessionConfig.to_json()``), its
edge → partition assignment (a plain array both packages share) and its
layout tables.  Both converters take plain JSON / numpy input, so this
module imports nothing of the reference.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from .core.pipeline import CLUGPConfig
from .graph.partition import PartitionLayout
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
    have yet (the scan game, the sharded backend, other exchanges)."""
    d = json.loads(json_text)
    backend = d.get("backend", "np")
    if backend not in _BACKENDS:
        raise _not_ported(f"backend {backend!r}",
                          "the sharded partitioner and multi-GPU engine")
    exchange = d.get("exchange", "halo")
    if exchange != "halo":
        raise _not_ported(f"exchange {exchange!r}",
                          "dense, quantized and ragged exchanges")
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
                         exchange="halo",
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
