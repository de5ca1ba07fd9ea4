"""Step builders (port of ``repro.train.step``): the training step the
training launcher and ``chip_smoke.py`` run (``make_train_step``: f32
masters cast to the compute dtype inside the loss, the gradient of
``models.forward_train`` by ``torch.autograd.grad``, micro-batches summed
in f32, an optional gradient compressor, then the optimizer), and the
serving steps, for every family ``models.lm`` runs (dense and MoE, with
GQA or MLA attention; SSM and hybrid; the encoder–decoder, whose decode
step takes the encoder's output as ``memory``; the VLM, whose prefill
batch may carry ``prefix_embeds``).  PyTorch runs eagerly, so there is
nothing to jit; ``mp`` pads the q heads as the reference's does (the
serving steps; training under a mesh is not ported), and its
``block_kv`` and ``unroll`` are lowering knobs with no counterpart.

The serving steps run under an active ``dist.sharding.use_rules`` context
too (the dense GQA families; ``models.lm``'s module docstring): the
parameters are the rank's blocks (``train.shardings.place_params``), the
batch is whole on every rank and split here over its rows ("batch", as
``batch_specs`` places it), and the prefill's logits are gathered back
whole on every rank."""
from __future__ import annotations

import torch

from ..dist.sharding import active_rules, active_spec, shard, unshard
from ..models import decode_step as _decode_step
from ..models import forward_train, tree_leaves
from ..models import prefill as _prefill
from ..models.config import ModelConfig
from .optimizer import Optimizer, tree_map, tree_unflatten


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


def make_train_step(cfg: ModelConfig, optimizer: Optimizer, *,
                    dtype=torch.bfloat16, micro_batches: int = 1,
                    loss_chunk: int = 512, compress_grads=None):
    """Returns train_step(params, opt_state, batch, step) → (params,
    opt_state, loss); ``loss`` is an f32 0-d tensor on the parameters'
    device (reading it waits for the step).  With ``micro_batches`` > 1
    the batch's tensors are split into that many contiguous slices along
    the batch dim, the f32 gradients and losses summed over them, then
    divided by their number.  ``compress_grads`` (e.g.
    ``dist.compress.make_grad_compressor()``) maps the gradient tree
    before the optimizer."""

    def grad_fn(params, batch):
        live = [p.detach().requires_grad_() for p in tree_leaves(params)]
        tree = _compute_copy(tree_unflatten(params, live), dtype)
        loss = forward_train(tree, batch, cfg, dtype=dtype,
                             loss_chunk=loss_chunk)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        return loss.detach(), [torch.zeros_like(p) if g is None else g
                               for p, g in zip(live, grads)]

    def train_step(params, opt_state, batch, step):
        if micro_batches == 1:
            loss, grads = grad_fn(params, batch)
        else:
            parts = {k: torch.chunk(v, micro_batches) for k, v in batch.items()}
            loss, grads = None, None
            for i in range(micro_batches):
                li, gi = grad_fn(params, {k: v[i] for k, v in parts.items()})
                gi = [g.to(torch.float32) for g in gi]
                loss = li if loss is None else loss + li
                grads = gi if grads is None else [a + b for a, b in
                                                  zip(grads, gi)]
            n = torch.full((), float(micro_batches), dtype=torch.float32,
                           device=loss.device)
            loss = loss / n
            grads = [g / n for g in grads]
        grads = tree_unflatten(params, grads)
        if compress_grads is not None:
            grads = compress_grads(grads)
        params, opt_state = optimizer.update(grads, opt_state, params, step)
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
