"""K2 — the game's best-response sweep and its plain version.

Port of ``repro.kernels.game_bestresponse``: for every cluster row i and
partition lane p < k,

    cost(i, p) = (λ/k)·s_i·(loads_p − s_i·[p = cur_i] + s_i)
               + ½·(row_tot_i − aff[i, p])

(lanes p ≥ k cost 3e38), and per row the first-index argmin and the min
cost.  ``game_bestresponse`` runs the plain version on CPU tensors and
launches ``csrc/game_bestresponse.cu`` on CUDA tensors.  The plain
version evaluates the expression in the reference's order, one rounded
PyTorch operation at a time — the same roundings the kernel makes with
its ``__fmul_rn``/``__fadd_rn`` intrinsics.
"""
from __future__ import annotations

import torch

from . import _build

BIG = 3.0e38


def game_bestresponse_plain(aff, sizes, row_tot, cur, loads, *, lam, k):
    """``lam`` is a (1,) f32 tensor on the inputs' device."""
    M, kpad = aff.shape
    pids = torch.arange(kpad, device=aff.device)[None, :]
    own = (pids == cur[:, None].long()).to(torch.float32)
    loads_ex = loads[None, :] - sizes[:, None] * own
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not the rounded quotient
    a = lam / torch.full_like(lam, float(k))
    cost = a * sizes[:, None] * (loads_ex + sizes[:, None]) \
        + 0.5 * (row_tot[:, None] - aff)
    cost = torch.where(pids < k, cost, torch.full_like(cost, BIG))
    return torch.argmin(cost, dim=1).to(torch.int32), cost.min(dim=1).values


def game_bestresponse(aff, sizes, row_tot, cur, loads, *, lam, k: int):
    """aff (M, kpad) f32 cut mass; sizes/row_tot (M,) f32; cur (M,)
    int32; loads (kpad,) f32; ``lam`` (1,) f32 tensor; ``k`` the real
    partition count.  Returns (best (M,) int32, cost (M,) f32)."""
    if aff.device.type == "cpu":
        return game_bestresponse_plain(aff, sizes, row_tot, cur, loads,
                                       lam=lam, k=k)
    M, kpad = aff.shape
    if (sizes.shape != (M,) or row_tot.shape != (M,) or cur.shape != (M,)
            or loads.shape != (kpad,) or lam.numel() != 1
            or not 0 < k <= kpad):
        raise ValueError("game_bestresponse: inconsistent shapes")
    if cur.dtype != torch.int32 or any(
            t.dtype != torch.float32 for t in (aff, sizes, row_tot, loads,
                                               lam)):
        raise ValueError("game_bestresponse: expected f32 tables and an "
                         "int32 cur")
    _build.require_cuda(aff, sizes, row_tot, cur, loads, lam)
    best = torch.empty(M, dtype=torch.int32, device=aff.device)
    cost = torch.empty(M, dtype=torch.float32, device=aff.device)
    _build.launch("game_bestresponse", "k2_game_bestresponse", aff, sizes,
                  row_tot, cur, loads, lam, best, cost, int(M), int(kpad),
                  int(k))
    return best, cost
