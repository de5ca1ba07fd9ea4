"""Mixture-of-Experts with sort-based capacity dispatch (port of
``repro.models.moe``).

Routing variants of the assigned archs:
- llama4-scout    : 16 experts, top-1 + shared expert
- deepseek-v3     : 256 routed top-8 (softmax-after-topk, aux-loss-free
                    bias), 1 shared expert, first-k dense layers
- jamba-1.5       : 16 experts, top-2 softmax

Each batch row is a dispatch group with its own capacity (GShard's grouped
dispatch): a group's tokens are sorted by expert, the first ``capacity``
of each expert take its slots and the rest are dropped, the experts run as
one batched product over (E, G·C, D), and a weighted f32 scatter-add
brings the results back to the tokens.  Everything stays on the device:
the capacity comes from the shapes, and no count is read on the host.

Where the reference and PyTorch differ:
- ``jax.lax.top_k`` ranks the lower expert first on ties, ``torch.topk``
  promises no order, so experts are ranked by a stable sort on −logits.
- The reference scatters into E·C + 1 slots with ``mode="drop"`` and
  slices off the sentinel; torch's indexed writes raise out of range, so
  the sentinel slot is allocated, shared by the dropped tokens only, and
  sliced off the same way.
- The combine is a float ``index_add_``.  With top-1 or top-2 a token sums
  at most two terms onto zero, which is exact in any order; with top-k > 2
  the card's atomics may move the last bit.
- Expert parallelism (``moe_apply``'s ``axis``): the reference's
  ``shard`` constraints put the experts on the model axis, and GSPMD
  moves each group's slots to their experts' devices with an all-to-all.
  The port's activations are whole on every model rank and the router is
  replicated, so every rank builds the same dispatch tables and reads
  its own experts' slots from its own ``x``: the all-to-all becomes a
  local read.  Each rank adds its experts' gated f32 outputs into the
  (B, T + 1, D) buffer, and the buffers are summed over the axis in rank
  order (``moe.combine``) before the cast.  With top-1 or top-2 a
  token's terms (one or two, each on its expert's rank) are added onto
  zeros in expert order, as the one-device ``index_add_`` adds them, so
  the combine is the one device's bit for bit in f32 on the CPU.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..dist import collectives as coll
from .layers import Params, _normal, ffn, ffn_init, linear, linear_init


def moe_init(gen, d_model: int, d_expert: int, n_experts: int,
             n_shared: int = 0, dtype=torch.float32) -> Params:
    """The reference's tree: ``router`` (D, E), ``experts`` {gate, up:
    (E, D, F), down: (E, F, D)} and, with ``n_shared``, a gated ``shared``
    FFN of width ``n_shared · d_expert``; the same scales."""
    s = 1.0 / math.sqrt(d_model)
    p = {"router": linear_init(gen, d_model, n_experts, dtype=dtype),
         "experts": {
             "gate": _normal(gen, (n_experts, d_model, d_expert), dtype, s),
             "up": _normal(gen, (n_experts, d_model, d_expert), dtype, s),
             "down": _normal(gen, (n_experts, d_expert, d_model), dtype,
                             1.0 / math.sqrt(d_expert))}}
    if n_shared:
        p["shared"] = ffn_init(gen, d_model, n_shared * d_expert,
                               gated=True, dtype=dtype)
    return p


def expert_capacity(tokens: int, top_k: int, n_experts: int,
                    capacity_factor: float) -> int:
    """Slots per expert in a group of ``tokens``, in Python floats in the
    reference's order (``moe.py:62``): at least 1."""
    return max(1, int(capacity_factor * tokens * top_k / n_experts))


def top_k_experts(sel, top_k: int):
    """The ``top_k`` largest of ``sel`` along the last dim, largest first
    and the lower expert first on ties, as ``jax.lax.top_k`` ranks them."""
    return torch.sort(-sel, dim=-1, stable=True).indices[..., :top_k]


def route(p: Params, x, *, top_k: int,
          router_softmax_after_topk: bool = False, router_bias=None):
    """x (..., D) → (expert ids (..., K) int64, f32 gates (..., K))."""
    logits = linear(p["router"], x).to(torch.float32)
    sel = logits if router_bias is None else logits + router_bias
    top_idx = top_k_experts(sel, top_k)
    if router_softmax_after_topk:
        gates = torch.softmax(logits.gather(-1, top_idx), -1)
    else:
        gates = torch.softmax(logits, -1).gather(-1, top_idx)
    return top_idx, gates


def dispatch_tables(top_idx, gates, *, n_experts: int, capacity: int):
    """Per group: (G, T, K) expert ids and gates → the token (T where the
    slot is empty) and gate (0 there) of each of the E·C slots, (G, E·C).
    A group's (token, choice) pairs are sorted stably by expert; the one
    at rank ``pos`` within its expert takes slot ``e·C + pos`` when
    ``pos < C`` and is dropped otherwise."""
    G, T, K = top_idx.shape
    flat_e = top_idx.reshape(G, T * K)
    e_s, order = torch.sort(flat_e, dim=1, stable=True)
    t_s = order // K                        # pair i is token i // K
    g_s = gates.reshape(G, T * K).gather(1, order)
    pos = torch.arange(T * K, device=top_idx.device) \
        - torch.searchsorted(e_s, e_s)
    keep = pos < capacity
    slot = torch.where(keep, e_s * capacity + pos, n_experts * capacity)
    n = n_experts * capacity + 1                       # + the sentinel slot
    tok = torch.full((G, n), T, dtype=torch.int64, device=top_idx.device)
    tok = tok.scatter_(1, slot, t_s)[:, :-1]
    gat = torch.zeros((G, n), dtype=torch.float32, device=top_idx.device)
    gat = gat.scatter_(1, slot, torch.where(keep, g_s, 0.0))[:, :-1]
    return tok, gat


def moe_apply(p: Params, x, *, n_experts: int, top_k: int,
              capacity_factor: float = 1.25,
              router_softmax_after_topk: bool = False,
              router_bias=None, axis=None, shared_axis=None):
    """x (B, S, D) → (B, S, D).  Each batch row is a dispatch group of
    S tokens with ``expert_capacity(S, ...)`` slots per expert; tokens
    over capacity get no routed term (GShard semantics); the shared
    expert (if any) is always on.  With ``axis`` (a bound one-axis mesh)
    the banks in ``p`` are this rank's experts, [r·E/n, (r + 1)·E/n) on
    rank r, and the combine is summed over the axis (module docstring);
    with ``shared_axis`` the shared expert runs column/row-parallel over
    it (``layers.ffn``)."""
    B, S, D = x.shape
    T = S
    capacity = expert_capacity(T, top_k, n_experts, capacity_factor)
    top_idx, gates = route(p, x, top_k=top_k,
                           router_softmax_after_topk=router_softmax_after_topk,
                           router_bias=router_bias)
    tok, gat = dispatch_tables(top_idx, gates, n_experts=n_experts,
                               capacity=capacity)
    w = p["experts"]
    held = w["gate"].shape[0]
    first = 0
    if axis is not None:
        if held * axis.size != n_experts:
            raise ValueError(f"{held} experts a rank over {axis.size} ranks "
                             f"is not {n_experts}")
        first = axis.rank * held
    # dispatch gather, expert-major: (B, T+1, D)[g, tok] → (E, B·C, D), the
    # experts held here only
    xg = torch.cat([x, x.new_zeros(B, 1, D)], 1)
    tok_e = tok.reshape(B, n_experts, capacity).transpose(0, 1)[
        first:first + held]                                     # (E, B, C)
    gat_e = gat.reshape(B, n_experts, capacity).transpose(0, 1)[
        first:first + held]
    rows = torch.arange(B, device=x.device)[None, :, None]
    ex_in = xg[rows, tok_e].reshape(held, B * capacity, D)

    h = F.silu(torch.bmm(ex_in, w["gate"].to(x.dtype))) \
        * torch.bmm(ex_in, w["up"].to(x.dtype))
    ex_out = torch.bmm(h, w["down"].to(x.dtype))          # (E, B·C, D)

    # combine: each slot's gated f32 output added onto its token's row of
    # (B, T+1, D); empty slots add zeros onto the sentinel row T; the
    # ranks' buffers summed in rank order
    weighted = ex_out.to(torch.float32).reshape(held, B, capacity, D) \
        * gat_e[..., None]
    dest = (tok_e + rows * (T + 1)).reshape(-1)
    y = torch.zeros(B * (T + 1), D, dtype=torch.float32, device=x.device)
    y.index_add_(0, dest, weighted.reshape(-1, D))
    y = coll.psum(y, axis, site="moe.combine")
    out = y.reshape(B, T + 1, D)[:, :T].to(x.dtype)
    if "shared" in p:
        out = out + ffn(p["shared"], x, shared_axis)
    return out


def moe_reference(p: Params, x, *, n_experts: int, top_k: int,
                  router_softmax_after_topk: bool = False,
                  router_bias=None):
    """No-capacity oracle: every token visits its top-k experts densely
    (small shapes only — the tests' and the card check's reference)."""
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    top_idx, gates = route(p, xt, top_k=top_k,
                           router_softmax_after_topk=router_softmax_after_topk,
                           router_bias=router_bias)
    w = p["experts"]
    h = F.silu(torch.einsum("td,edf->tef", xt, w["gate"].to(xt.dtype))) \
        * torch.einsum("td,edf->tef", xt, w["up"].to(xt.dtype))
    all_out = torch.einsum("tef,efd->ted", h, w["down"].to(h.dtype))
    onehot = F.one_hot(top_idx, n_experts).to(torch.float32)   # (T, K, E)
    comb = torch.einsum("tke,tk->te", onehot, gates)
    out = torch.einsum("ted,te->td", all_out.to(torch.float32), comb)
    y = out.to(x.dtype)
    if "shared" in p:
        y = y + ffn(p["shared"], xt)
    return y.reshape(B, S, D)
