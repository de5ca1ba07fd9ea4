"""Checkpoints with atomic writes (port of ``repro.ckpt.checkpoint``).

Layout, the reference's own, so either package reads the other's:

    <dir>/step_<N>/   (N zero-padded to 8 digits)
        manifest.json   — {"step", "keys", "dtypes", "extra"}
        arrays.npz      — the flattened leaves, keyed by tree path

A write goes to ``step_<N>.tmp`` and is moved into place with
``os.replace``, so a reader never sees a torn checkpoint, and
``list_steps`` skips what a killed writer left behind.  Keys are the
paths ``jax.tree_util.keystr`` writes: ``['src']`` for a dict entry,
``[0]`` for a sequence item, concatenated for nested trees; this module
builds them itself, with numpy, and imports nothing of JAX.

``restore`` and ``restore_latest`` bring a training run's checkpoint
back onto a template tree (the port's: nested dicts, and lists of
per-layer dicts), checking every leaf's shape and restoring bf16 leaves
from the manifest's dtypes; they take a ``device`` where the reference
takes ``shardings`` (one card has no mesh to re-shard onto).
``restore_raw`` is the shape-blind restore a service uses, whose arrays
grow between snapshots.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch


def _leaves(tree, prefix=""):
    """(keystr path, leaf) pairs in ``jax.tree_util``'s order: dict keys
    sorted, sequences in order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], f"{prefix}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves(item, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _flatten(tree):
    out, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            dtypes[key] = str(leaf.dtype).removeprefix("torch.")
            if leaf.dtype == torch.bfloat16:
                leaf = leaf.float()       # lossless bf16 → f32
            arr = leaf.detach().cpu().numpy()
        else:
            arr = np.asarray(leaf)
            dtypes[key] = str(arr.dtype)
        out[key] = arr
    return out, dtypes


def save(path: str | Path, step: int, tree, extra: dict | None = None):
    """Write ``tree`` (nested dicts and sequences of arrays or tensors) and
    a JSON-serializable ``extra`` as step ``step``; returns its
    directory."""
    path = Path(path)
    final = path / f"step_{step:08d}"
    tmp = Path(str(final) + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat, dtypes = _flatten(tree)
    np.savez(tmp / "arrays.npz", **flat)
    manifest = {"step": step, "keys": sorted(flat), "dtypes": dtypes,
                "extra": extra or {}}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def list_steps(path: str | Path) -> list[int]:
    """The steps under ``path`` with an intact manifest, ascending."""
    path = Path(path)
    if not path.exists():
        return []
    out = []
    for d in path.iterdir():
        if d.is_dir() and d.name.startswith("step_") \
                and not d.name.endswith(".tmp") \
                and (d / "manifest.json").exists():
            try:
                json.loads((d / "manifest.json").read_text())
                out.append(int(d.name[5:]))
            except (ValueError, json.JSONDecodeError):
                continue   # torn write: skip
    return sorted(out)


def _rebuild(tree, fn, prefix=""):
    """``tree``'s structure with each leaf replaced by ``fn(keystr path,
    leaf)``, walked as ``_leaves`` walks it."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{prefix}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def restore(path: str | Path, step: int, target_tree, device=None):
    """Step ``step`` onto ``target_tree``'s structure: each leaf the stored
    array of its path, whose shape must equal the template leaf's
    (AssertionError otherwise; a missing path raises KeyError), as a
    tensor in the manifest's dtype (bf16 brought back from its lossless
    f32 copy) on ``device`` (default: the template leaf's)."""
    path = Path(path) / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    dtypes = manifest.get("dtypes", {})
    with np.load(path / "arrays.npz") as data:
        def load(key, leaf):
            arr = data[key]
            assert arr.shape == tuple(leaf.shape), (key, arr.shape,
                                                    tuple(leaf.shape))
            t = torch.from_numpy(np.array(arr))
            if "bfloat16" in dtypes.get(key, str(arr.dtype)):
                t = t.to(torch.bfloat16)
            dev = device if device is not None else getattr(leaf, "device",
                                                             "cpu")
            return t.to(dev)
        return _rebuild(target_tree, load)


def restore_latest(path: str | Path, target_tree, device=None):
    """(tree, step) of the newest intact checkpoint under ``path``
    (``restore``), or (None, -1) when there is none."""
    steps = list_steps(path)
    if not steps:
        return None, -1
    return restore(path, steps[-1], target_tree, device), steps[-1]


def restore_raw(path: str | Path, step: int):
    """Shape-blind restore: the stored flat ``{keystr: np.ndarray}`` map
    and the manifest, with no template tree and no shape checks."""
    path = Path(path) / f"step_{step:08d}"
    with np.load(path / "arrays.npz") as data:
        flat = {k: data[k] for k in data.files}
    manifest = json.loads((path / "manifest.json").read_text())
    return flat, manifest
