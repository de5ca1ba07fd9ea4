"""Parameter, batch and cache placement over a mesh of ranks (port of
``repro.train.shardings``): DP/TP/EP specs, with ZeRO-3 over the data
axis as an option.

The spec functions are pure and return, for every leaf of the port's
trees (nested dicts, and lists of per-layer dicts for the layer groups),
a plain tuple spec, one entry a dim (None, an axis name or a tuple of
names), as ``dist.sharding.resolve_spec`` does.  Paths are parsed into
key components (never substring-matched — optimizer moment keys like
``['v']`` must not collide with the attention value projection), in the
reference's key-path notation: ``['g_dense'][3]['attn']['q']['w']``.
The reference stacks a layer group's leaves on a leading layer dim (its
``extra`` dim, spec None); the port's leaves are one layer each, so its
specs are the reference's without that entry.

``zero=True`` also shards each weight's non-TP dim over the data axis
(FSDP / ZeRO-3: ``models.lm`` gathers each block over "data" right
before its layer uses it, and the gradient comes back reduce-scattered).
``sanitize_specs`` drops any axis that does not divide its dim — the
fallback is replication, never a failure.  ``local_tree`` is the
placement the reference's ``named_shardings`` makes: each leaf of a
whole tree cut to this rank's block under its sanitized spec;
``place_params`` makes that cut part by part while ``init_params`` draws
and keeps the sanitized specs it cut by (``placed_specs``);
``gather_tree`` is its inverse, the whole tree on rank 0 (the tests, a
checkpoint).  ``leaf_axes`` turns a spec tree into the bound axes that
cut each dim of each leaf, and ``gather_plan`` keeps of them the ones a
block is gathered over before use (every axis but "model", whose cuts
the model code runs tensor-parallel).
"""
from __future__ import annotations

import math
import re
from dataclasses import replace

import torch

from ..dist import collectives as coll
from ..dist.mesh import as_axis
from ..dist.sharding import NotPorted, block, entry_axes

_KEY_RE = re.compile(r"\['([^']+)'\]|\[(\d+)\]")
PARAM_LEAF = {"w", "b", "table", "scale", "bias", "A_log", "D", "dt_bias",
              "gate", "up", "down"}
COLUMN_MODS = {"q", "k", "v", "gate", "up", "q_b", "kv_b", "x_proj",
               "z_proj"}
ROW_MODS = {"o", "down", "out_proj"}
SMALL_MODS = {"q_a", "kv_a", "bc_proj", "dt_proj", "router"}


def _path_tokens(pstr: str) -> list[str]:
    return [a or b for a, b in _KEY_RE.findall(pstr)]


def _mod_leaf_state(pstr: str):
    toks = _path_tokens(pstr)
    state = None
    if toks and (toks[-1] in ("vr", "vc")
                 or (toks[-1] in ("v", "m")
                     and len(toks) >= 2 and toks[-2] in PARAM_LEAF)):
        state = toks[-1]
        toks = toks[:-1]
    leaf = toks[-1] if toks else ""
    mod = toks[-2] if len(toks) >= 2 else ""
    return mod, leaf, state, toks


def _base_spec(mod: str, leaf: str, ndim: int, zero: bool,
               data_axes) -> list:
    za = data_axes if zero else None
    if ndim <= 1:
        return [None] * ndim
    if leaf == "table":                               # embed (V, D)
        return ["model", za]
    if mod == "lm_head":                              # (D, V)
        return [za, "model"]
    if mod == "experts":                              # (E, D, F)/(E, F, D)
        return ["model", za, None]
    if mod in COLUMN_MODS and leaf in ("w", "b"):
        return [za, "model"] if leaf == "w" else ["model"]
    if mod in ROW_MODS and leaf in ("w", "b"):
        return ["model", za] if leaf == "w" else [None]
    if mod in SMALL_MODS and leaf in ("w", "b"):
        return [za, None] if leaf == "w" else [None]
    return [None] * ndim


def map_with_path(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over a tree of nested dicts and lists, the path
    in the reference's key notation (``['a'][0]['b']``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}['{k}']")
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{path}[{i}]")
                for i, v in enumerate(tree)]
    return fn(path, tree)


def _map2(fn, a, b):
    """``fn`` over two trees of one structure, leaf by leaf (a spec tuple
    in ``a`` is a leaf)."""
    if isinstance(a, dict):
        return {k: _map2(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, list):
        return [_map2(fn, v, w) for v, w in zip(a, b)]
    return fn(a, b)


def _param_spec(pstr: str, leaf, zero: bool, multi_pod: bool) -> tuple:
    data_axes = ("pod", "data") if multi_pod else "data"
    nd = leaf.dim()
    mod, name, state, _toks = _mod_leaf_state(pstr)
    core = nd + (1 if state in ("vr", "vc") else 0)
    s = _base_spec(mod, name, core, zero, data_axes)
    s = (s + [None] * core)[:core]
    if state == "vr":
        s = s[:-1]
    elif state == "vc":
        del s[-2]
    return tuple(s[:nd])


def param_specs(params_tree, *, zero: bool, multi_pod: bool):
    """Spec tree for a parameter tree or an optimizer-state tree (AdamW's
    ``m``/``v`` mirror the parameters; Adafactor's ``vr`` drops the last
    dim, ``vc`` the one before it)."""
    return map_with_path(
        lambda pstr, leaf: _param_spec(pstr, leaf, zero, multi_pod),
        params_tree)


def sanitize_specs(specs_tree, shapes_tree, mesh_shape: dict):
    """Drop the axes that don't divide their dim (replicate instead).
    ``shapes_tree`` holds tensors or shapes; ``mesh_shape`` is
    ``{axis: size}`` (a mesh's ``shape``)."""
    def fix(spec, sds):
        shape = tuple(sds.shape) if isinstance(sds, torch.Tensor) \
            else tuple(sds)
        ent = list(spec) + [None] * (len(shape) - len(spec))
        out = []
        for dim, ax in zip(shape, ent):
            axes = entry_axes(ax)
            size = math.prod(mesh_shape[a] for a in axes)
            out.append(ax if axes and dim % size == 0 else None)
        return tuple(out)

    return _map2(fix, specs_tree, shapes_tree)


def batch_specs(batch_tree, *, multi_pod: bool):
    data_axes = ("pod", "data") if multi_pod else "data"

    def spec(_path, leaf):
        return () if leaf.dim() == 0 else \
            (data_axes,) + (None,) * (leaf.dim() - 1)

    return map_with_path(spec, batch_tree)


def cache_specs(cache_tree, *, multi_pod: bool):
    """Decode caches: KV and latent (L, B, S, …) — batch on data, sequence
    on model (SP flash-decoding); SSM states (…, B, H, N, dh) — batch
    only."""
    data_axes = ("pod", "data") if multi_pod else "data"

    def spec(pstr, leaf):
        nd = leaf.dim()
        if "state" in pstr:                 # (..., B, H, N, dh)
            core = [data_axes, None, None, None]
        elif "lat" in pstr or "rope" in pstr:   # (..., B, S, C)
            core = [data_axes, "model", None]
        else:                               # k/v: (..., B, S, Hkv, Dh)
            core = [data_axes, "model", None, None]
        lead = nd - len(core)
        if lead < 0:
            raise ValueError(f"cache leaf {pstr} of shape "
                             f"{tuple(leaf.shape)} has too few dims")
        return tuple([None] * lead + core)

    return map_with_path(spec, cache_tree)


def local_tree(tree, specs_tree, mesh):
    """Each leaf of ``tree`` (whole) cut to this rank's block on the bound
    ``mesh`` under its spec, sanitized against the leaf's shape first.
    The blocks are copies, so the whole leaf can be freed."""
    specs = sanitize_specs(specs_tree, tree, mesh.shape)
    return _map2(lambda x, s: block(x, s, mesh).clone(), tree, specs)


def place_params(mesh, zero: bool = False):
    """``models.init_params``'s ``place`` on the bound ``mesh``: each part
    as it is drawn (the embedding, the head, the final norm, one layer;
    whole, at its path in the tree) cut to this rank's blocks under its
    ``param_specs`` (tensor-parallel, and with ``zero`` each weight's
    other dim over "data" too; the multi-pod axes are not ported),
    sanitized, so one part is whole at a time.  The sanitized specs of
    every part it cut are kept on it (``placed_specs``).  A mesh with a
    "pod" axis raises: ``MULTI_POD_RULES``' placement is not ported."""
    if "pod" in mesh.axes:
        raise NotPorted("the multi-pod placement (weights over ('pod', "
                        "'data')) is not ported (ROADMAP Queue 1 item "
                        "1.6)", "1.6")
    cut: dict = {}

    def place(path, sub):
        specs = sanitize_specs(map_with_path(
            lambda pstr, leaf: _param_spec(pstr, leaf, zero, False),
            sub, path), sub, mesh.shape)
        cut[path] = specs
        return _map2(lambda x, s: block(x, s, mesh).clone(), sub, specs)
    place.specs = cut
    return place


def placed_specs(place) -> dict:
    """The sanitized spec tree of the tree ``place`` (a ``place_params``)
    cut, in the parameters' structure (top-level keys, and a list of
    per-layer specs for each layer group)."""
    tree: dict = {}
    for path, specs in place.specs.items():
        key, *index = _path_tokens(path)
        if index:
            group = tree.setdefault(key, [])
            i = int(index[0])
            group.extend([None] * (i + 1 - len(group)))
            group[i] = specs
        else:
            tree[key] = specs
    return tree


def leaf_axes(specs_tree, mesh):
    """Per leaf of a sanitized spec tree, one tuple a dim of the bound
    one-axis meshes (``as_axis``) that cut it, innermost last; () where
    the dim is whole (an axis of one rank cuts nothing)."""
    def axes(spec):
        return tuple(tuple(as_axis(mesh, a) for a in entry_axes(e)
                           if mesh.shape[a] > 1) for e in spec)
    return _map2(lambda s, _: axes(s), specs_tree, specs_tree)


def gather_plan(axes_tree):
    """Per leaf of a ``leaf_axes`` tree, the (dim, axis) pairs its block is
    gathered over before use, in the order ``dist.sharding.unshard``
    takes them: every cut but the "model" axis's."""
    def plan(axes):
        return tuple((d, a) for d, dim_axes in enumerate(axes)
                     for a in reversed(dim_axes) if a.axis != "model")
    return _map2(lambda a, _: plan(a), axes_tree, axes_tree)


def gather_tree(tree, specs_tree, mesh, *, site: str = "gather_tree"):
    """Inverse of ``local_tree``: every rank's blocks (``tree``, this
    rank's) → the whole tree on rank 0, None on the others.  Each leaf's
    blocks go to rank 0 over the whole mesh and are put back at their
    ranks' coordinates (``specs_tree`` must be the sanitized specs the
    blocks were cut by)."""
    coords = [replace(mesh, rank=r).coords for r in range(mesh.size)]

    def put(x, spec):
        parts = coll.gather_to_root(x, mesh, site=site)
        if parts is None:
            return None
        full = [d * math.prod(mesh.shape[a] for a in entry_axes(e))
                for d, e in zip(x.shape, spec)]
        out = torch.empty(full, dtype=x.dtype, device=x.device)
        for r in range(mesh.size):
            idx = []
            for d, e in zip(x.shape, spec):
                i = 0
                for a in entry_axes(e):
                    i = i * mesh.shape[a] + coords[r][a]
                idx.append(slice(i * d, (i + 1) * d))
            out[tuple(idx)] = parts[r]
        return out

    return _map2(put, tree, specs_tree)
