"""Step builders (port of ``repro.train.step``): the training step the
training launcher and ``chip_smoke.py`` run (``make_train_step``: f32
masters cast to the compute dtype inside the loss, the gradient of
``models.forward_train`` by ``torch.autograd.grad``, micro-batches summed
in f32, an optional gradient compressor, then the optimizer), and the
serving steps, for every family ``models.lm`` runs (dense and MoE, with
GQA or MLA attention; SSM and hybrid; the encoder–decoder, whose decode
step takes the encoder's output as ``memory``; the VLM, whose prefill
batch may carry ``prefix_embeds``).  PyTorch runs eagerly, so there is
nothing to jit; ``mp`` pads the q heads as the reference's does, and its
``block_kv`` and ``unroll`` are lowering knobs with no counterpart.

Every step runs under an active ``dist.sharding.use_rules`` context too
(``models.lm``'s module docstring): the parameters are the rank's blocks
(``train.shardings.place_params``), the batch is whole on every rank and
split here over its rows ("batch", as ``batch_specs`` places it), and the
prefill's logits are gathered back whole on every rank.  The training
step (the dense GQA families) takes the sanitized specs its blocks were
cut by (``specs``, from ``train.shardings.placed_specs``): with ZeRO-3
each block is gathered over "data" inside its layer and its gradient
comes back reduce-scattered; the gradient of a leaf whole on "data" (1-D
leaves, dims that do not divide) is summed over "data" here, all such
leaves in one call; a leaf whole on "model" and used alike on every
model rank (norm scales, row-parallel biases) already holds its whole
gradient.  Every sum is in rank order, and the loss is the whole batch's
on every rank.  The optimizer and the compressor take the leaves' axes
(``leaf_axes``), so Adafactor's means and the int8 scale span the whole
leaf."""
from __future__ import annotations

import torch

from ..dist import collectives as coll
from ..dist.mesh import as_axis
from ..dist.sharding import (active_rules, active_spec, entry_axes, shard,
                             unshard)
from ..models import decode_step as _decode_step
from ..models import forward_train, tree_leaves
from ..models import prefill as _prefill
from ..models.config import ModelConfig
from .optimizer import Optimizer, tree_map, tree_unflatten
from .shardings import gather_plan, leaf_axes


def _compute_copy(params, dtype):
    """The parameters as the loss reads them (a differentiable cast, so the
    gradient lands on the f32 master).  The reference casts every f32 leaf
    of ≥ 2 dims; its layer groups are stacked, so that is every f32 leaf
    of a layer (norm scales and biases included, (L, d) there) and the
    top-level matrices, while ``ln_f`` stays f32.  The port's layers are
    lists of per-layer leaves, so every f32 leaf under a ``g_*`` group is
    cast whatever its dims.  The embedding table is not cast:
    ``layers.embed`` gathers its rows and casts them, the same forward
    values as the reference's cast-then-gather, with the gradient summed
    into the f32 rows (the reference sums it in ``dtype``; ROADMAP, Queue
    3) and no copy of the table."""
    def cast(p):
        return p.to(dtype) if p.dtype == torch.float32 else p

    out = {}
    for key, sub in params.items():
        if key.startswith("g_"):
            out[key] = tree_map(cast, sub)
        elif key == "embed":
            out[key] = sub
        else:
            out[key] = tree_map(lambda p: cast(p) if p.dim() >= 2 else p,
                                sub)
    return out


def mesh_axes(specs):
    """(mesh, ``leaf_axes`` of ``specs``) under an active ``use_rules``
    context on a mesh of several ranks; (None, None) outside one."""
    ctx = active_rules()
    if ctx is None or ctx[1].size == 1:
        return None, None
    mesh = ctx[1]
    if specs is None:
        raise ValueError("a training step under a mesh needs the specs its "
                         "blocks were cut by (train.shardings.placed_specs)")
    return mesh, leaf_axes(specs, mesh)


def _data_axes(mesh) -> list:
    """The axes of ``mesh`` a batch's rows are split over: every axis of
    more than one rank but "model"."""
    return [a for a in mesh.axes if a != "model" and mesh.shape[a] > 1]


def _sum_whole_leaves(grads: list, axes: list, mesh) -> list:
    """Each gradient summed over the data axes that do not cut its leaf
    (its rows' shares on other ranks), in rank order; the leaves needing
    the same axes go in one f32 call."""
    data = _data_axes(mesh)
    need = []
    for ax in axes:
        cut = {a.axis for dim in ax for a in dim}
        need.append([as_axis(mesh, a) for a in data if a not in cut])
    summed = coll.over_axes([g.to(torch.float32) for g in grads], need,
                            coll.psum, site="grad.data")
    return [s.to(g.dtype) for s, g in zip(summed, grads)]


def make_grad_fn(cfg: ModelConfig, *, mp: int = 1, dtype=torch.bfloat16,
                 micro_batches: int = 1, loss_chunk: int = 512, specs=None):
    """Returns grad_fn(params, batch) → (loss, gradient leaves in
    ``models.tree_leaves`` order): the loss of ``forward_train`` on the
    f32 masters cast to ``dtype`` and its gradient, micro-batches summed
    in f32 and divided by their number (the batch's tensors split into
    ``micro_batches`` contiguous slices along the batch dim).  Under a
    mesh (module docstring) each micro-batch is split over the data axes
    by its rows, ``specs`` give the blocks' cuts, and every gradient is
    this rank's block of the whole batch's."""

    def one(params, batch, plan, rows):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        tree = _compute_copy(tree_unflatten(params, live), dtype)
        loss = forward_train(tree, batch, cfg, dtype=dtype,
                             loss_chunk=loss_chunk, mp=mp, gather=plan,
                             rows=rows)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(live, grads)]

    def grad_fn(params, batch):
        mesh, axes = mesh_axes(specs)
        plan = None if axes is None else gather_plan(axes)
        parts = [batch] if micro_batches == 1 else [
            dict(zip(batch, vs)) for vs in zip(*(torch.chunk(
                v, micro_batches) for v in batch.values()))]
        loss, grads = None, None
        for part in parts:
            rows = ()
            if mesh is not None:
                n_rows = part["tokens"].shape[0]
                part, spec = batch_rows(part)
                rows = tuple(as_axis(mesh, a) for a in entry_axes(spec[0])
                             if mesh.shape[a] > 1)
                if {a.axis for a in rows} != set(_data_axes(mesh)):
                    raise ValueError(f"{n_rows} rows a micro-batch do not "
                                     f"split over {mesh.shape}'s data axes")
            li, gi = one(params, part, plan, rows)
            if micro_batches == 1:
                loss, grads = li, gi
                continue
            gi = [g.to(torch.float32) for g in gi]
            loss = li if loss is None else loss + li
            grads = gi if grads is None else [a + b for a, b in
                                              zip(grads, gi)]
        if micro_batches > 1:
            n = torch.full((), float(micro_batches), dtype=torch.float32,
                           device=loss.device)
            loss = loss / n
            grads = [g / n for g in grads]
        if axes is not None:
            grads = _sum_whole_leaves(grads, tree_leaves(axes), mesh)
        return loss, grads

    return grad_fn


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *, mp: int = 1,
                    dtype=torch.bfloat16, micro_batches: int = 1,
                    loss_chunk: int = 512, compress_grads=None, specs=None):
    """Returns train_step(params, opt_state, batch, step) → (params,
    opt_state, loss); ``loss`` is an f32 0-d tensor on the parameters'
    device (reading it waits for the step).  With ``micro_batches`` > 1
    the batch's tensors are split into that many contiguous slices along
    the batch dim, the f32 gradients and losses summed over them, then
    divided by their number (``make_grad_fn``).  ``compress_grads``
    (e.g. ``dist.compress.make_grad_compressor()``) maps the gradient
    tree before the optimizer.  Under a mesh ``params`` and ``opt_state``
    are the rank's blocks (``specs``: their sanitized specs), the batch
    is whole, and the loss is the whole batch's on every rank; the
    compressor and the optimizer get the leaves' axes (``axes=``)."""
    grad_fn = make_grad_fn(cfg, mp=mp, dtype=dtype,
                           micro_batches=micro_batches,
                           loss_chunk=loss_chunk, specs=specs)

    def train_step(params, opt_state, batch, step):
        loss, grads = grad_fn(params, batch)
        grads = tree_unflatten(params, grads)
        _mesh, axes = mesh_axes(specs)
        kw = {} if axes is None else {"axes": axes}
        if compress_grads is not None:
            grads = compress_grads(grads, **kw)
        params, opt_state = optimizer.update(grads, opt_state, params, step,
                                             **kw)
        return params, opt_state, loss

    return train_step


def batch_rows(batch: dict) -> tuple[dict, tuple]:
    """A whole batch → (this rank's rows of each tensor, the spec of the
    batch dim) under the active rules ("batch"); as it is outside any."""
    spec = active_spec(tuple(batch["tokens"].shape[:1]), "batch")
    return {k: shard(v, "batch", *([None] * (v.dim() - 1)))
            for k, v in batch.items()}, spec


def gather_rows(x, spec: tuple, *, site: str = "batch.gather"):
    """The inverse of ``batch_rows`` for one output: the whole batch's
    rows on every rank."""
    if spec[0] is None:
        return x
    return unshard(x, spec + (None,) * (x.dim() - 1), active_rules()[1],
                   site=site)


def make_prefill_step(cfg: ModelConfig, *, dtype=torch.bfloat16,
                      mp: int = 1):
    """Returns prefill_step(params, batch) → last-position logits
    (B, 1, V).  ``batch`` passes through whole: "tokens", and an
    encdec's "src_embeds" or a vlm's "prefix_embeds".  Its attention is
    K4, once an attention layer (none in an SSM model, once a period in a
    hybrid one, three times an encoder–decoder layer pair: encoder,
    decoder and cross-attention).  Under a mesh each rank runs its rows
    of the batch and the logits come back whole."""
    def prefill_step(params, batch):
        rows, spec = batch_rows(batch)
        logits, _hidden = _prefill(params, rows, cfg, dtype=dtype, mp=mp)
        return gather_rows(logits, spec)

    return prefill_step


def make_decode_fn(cfg: ModelConfig, *, dtype=torch.bfloat16, mp: int = 1,
                   max_len: int | None = None):
    """Returns serve_step(params, cache, tokens, index, memory=None) →
    (logits, cache); the cache (KV rows, SSM states) is written in place;
    an encdec step attends ``memory``, the encoder's output.  Under a mesh
    the cache and tokens are the rank's (``models.lm.decode_step``) and
    ``max_len`` is the whole cache's rows."""
    def serve_step(params, cache, tokens, index, memory=None):
        return _decode_step(params, cache, tokens, index, cfg, dtype=dtype,
                            memory=memory, mp=mp, max_len=max_len)

    return serve_step
