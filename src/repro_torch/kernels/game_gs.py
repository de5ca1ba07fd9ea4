"""G — the Gauss–Seidel best-response sweep and its plain version.

The reference plays the scan game (``repro.core.game.jax_game_rounds_gs``)
as a ``lax.scan`` of ``cluster_step`` over the clusters and has no Pallas
kernel for it.  One sweep plays cluster i = 0, 1, … against the live load
table, with the round's cut mass ``aff`` fixed:

    cost[p] = (λ/k)·s_i·(loads_p − s_i·[p = cur_i] + s_i) + ½·(rt_i − aff[i, p])
    best    = the first-index argmin over the k lanes
    move    = cost[best] + 1e-6 + 1e-5·|cost[cur_i]| < cost[cur_i]

and a move takes s_i off ``loads[cur_i]`` and puts it on ``loads[best]``.
``game_gs`` launches ``csrc/game_gs.cu`` (one launch a sweep) on CUDA
tensors and runs ``game_gs_plain`` on CPU tensors; the plain version is
the reference's step as tensor code, one cluster at a time, in the
reference's order of roundings.

A cluster with no size and no row total costs 0 on every lane and never
moves, so both walk only the first ``n`` rows: the game passes the rows
up to the last live one, and the pad rows past it keep their assignment.
"""
from __future__ import annotations

import torch

from . import _build

MAX_K = 1024          # the walking warp keeps the loads in registers, ⌈k/32⌉ a lane


def game_gs_plain(aff, sizes, row_tot, assign, loads, *, lam, k: int,
                  n: int | None = None):
    """One sweep over rows 0 … n − 1 (all rows when None).  ``aff`` (m, k)
    f32, ``sizes``/``row_tot`` (m,) f32, ``assign`` (m,) int32, ``loads``
    (k,) f32, ``lam`` a (1,) f32 tensor.  Returns new (assign, loads,
    moved) tensors; ``moved`` is a 0-dim int64 count."""
    dev = aff.device
    n = aff.shape[0] if n is None else n
    assign, loads = assign.clone(), loads.clone()
    lanes = torch.arange(k, device=dev)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the rounded quotient
    a = (lam.reshape(1) / torch.full((1,), float(k), device=dev))[0]
    moved = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(n):
        sz, rt, cur = sizes[i], row_tot[i], assign[i].long()
        own = (lanes == cur).to(torch.float32)
        cost = a * sz * (loads - sz * own + sz) + 0.5 * (rt - aff[i])
        best = torch.argmin(cost)
        c_cur = cost[cur]
        move = cost[best] + 1e-6 + 1e-5 * torch.abs(c_cur) < c_cur
        newa = torch.where(move, best, cur)
        loads = loads + sz * ((lanes == newa).to(torch.float32) - own) \
            * move.to(torch.float32)
        assign[i] = newa.to(torch.int32)
        moved += move.to(torch.int64)
    return assign, loads, moved


def _check(aff, sizes, row_tot, assign, loads, lam, k, n):
    m = aff.shape[0]
    if (aff.shape != (m, k) or sizes.shape != (m,) or row_tot.shape != (m,)
            or assign.shape != (m,) or loads.shape != (k,)
            or lam.numel() != 1 or not 0 <= n <= m):
        raise ValueError("game_gs: inconsistent shapes")
    if not 0 < k <= MAX_K:
        raise ValueError(f"game_gs: k={k} is outside 1..{MAX_K} (the walk "
                         "keeps the loads in a warp's registers)")


def game_gs(aff, sizes, row_tot, assign, loads, *, lam, k: int,
            n: int | None = None):
    """One Gauss–Seidel sweep (see the module docstring); returns new
    (assign (m,) int32, loads (k,) f32, moved 0-dim) tensors."""
    n = aff.shape[0] if n is None else n
    _check(aff, sizes, row_tot, assign, loads, lam, k, n)
    if aff.device.type == "cpu":
        return game_gs_plain(aff, sizes, row_tot, assign, loads, lam=lam,
                             k=k, n=n)
    if assign.dtype != torch.int32 or any(
            t.dtype != torch.float32 for t in (aff, sizes, row_tot, loads,
                                               lam)):
        raise ValueError("game_gs: f32 tables and an int32 assignment")
    _build.require_cuda(aff, sizes, row_tot, assign, loads, lam)
    assign, loads = assign.clone(), loads.clone()
    moved = torch.zeros(1, dtype=torch.int32, device=aff.device)
    _build.launch("game_gs", "g_game_gs", aff, sizes, row_tot, lam, assign,
                  loads, moved, int(n), int(k))
    return assign, loads, moved[0]
