"""K2 — the game's best-response sweep and its plain versions.

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

The game's main path runs ``game_bestresponse_csr`` instead: the same
sweep over one batch's rows only, each row's affinity counted from the
symmetrized cross-edge CSR inside the kernel
(``csrc/game_bestresponse_csr.cu``), so no m × k table is built.
"""
from __future__ import annotations

import torch

from . import _build

BIG = 3.0e38
CSR_MAX_K = 1024     # 8 rows' k-bin histograms share the kernel's shared memory


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


def _csr_affinity(rowptr, col, assign, row0: int, row1: int, k: int):
    """Dense cut mass of rows [row0, row1) from the CSR: aff[r, p] = the
    row's entries whose column sits on partition p, as integer-valued
    f32 (exact in any order).  Returns (row1 − row0, k) f32."""
    n = row1 - row0
    ptr = rowptr[row0:row1 + 1].long()
    lo, hi = (int(x) for x in ptr[[0, -1]].tolist())
    rows = torch.repeat_interleave(torch.arange(n, device=col.device),
                                   ptr[1:] - ptr[:-1], output_size=hi - lo)
    aff = torch.zeros(n * k, dtype=torch.float32, device=col.device)
    aff.index_add_(0, rows * k + assign[col[lo:hi].long()].long(),
                   torch.ones(hi - lo, dtype=torch.float32, device=col.device))
    return aff.view(n, k)


def game_bestresponse_csr_plain(rowptr, col, assign, sizes, row_tot, loads,
                                *, lam, k, row0, row1):
    """The dense affinity of the row range (``_csr_affinity``) and
    ``game_bestresponse_plain`` on those rows, plus each row's cost at
    its current partition in the game's order."""
    aff = _csr_affinity(rowptr, col, assign, row0, row1, k)
    s, rt = sizes[row0:row1], row_tot[row0:row1]
    cur = assign[row0:row1]
    best, cost = game_bestresponse_plain(aff, s, rt, cur, loads, lam=lam,
                                         k=k)
    a = lam / torch.full_like(lam, float(k))
    c = cur.long()
    ar = torch.arange(c.shape[0], device=c.device)
    cost_cur = a * s * loads[c] + 0.5 * (rt - aff[ar, c])
    return best, cost, cost_cur


def game_bestresponse_csr(rowptr, col, assign, sizes, row_tot, loads, *,
                          lam, k: int, row0: int, row1: int):
    """Best response of rows [row0, row1) with their affinity counted
    from the symmetrized cross-edge CSR: ``rowptr`` (m + 1,) and ``col``
    int32, ``assign`` (m,) int32, ``sizes``/``row_tot`` (m,) f32,
    ``loads`` (k,) f32, ``lam`` (1,) f32.  Returns (best int32, cost f32,
    cost_cur f32), each (row1 − row0,)."""
    m = assign.shape[0]
    if (rowptr.shape != (m + 1,) or sizes.shape != (m,)
            or row_tot.shape != (m,) or loads.shape != (k,)
            or lam.numel() != 1 or not 0 <= row0 < row1 <= m):
        raise ValueError("game_bestresponse_csr: inconsistent shapes or "
                         "row range")
    if not 0 < k <= CSR_MAX_K:
        raise ValueError(f"game_bestresponse_csr: k={k} is outside "
                         f"1..{CSR_MAX_K}")
    if assign.device.type == "cpu":
        return game_bestresponse_csr_plain(rowptr, col, assign, sizes,
                                           row_tot, loads, lam=lam, k=k,
                                           row0=row0, row1=row1)
    if {rowptr.dtype, col.dtype, assign.dtype} != {torch.int32} or any(
            t.dtype != torch.float32 for t in (sizes, row_tot, loads, lam)):
        raise ValueError("game_bestresponse_csr: expected int32 CSR and "
                         "assign, f32 sizes, row_tot, loads and lam")
    _build.require_cuda(rowptr, col, assign, sizes, row_tot, loads, lam)
    n = row1 - row0
    best = torch.empty(n, dtype=torch.int32, device=assign.device)
    cost = torch.empty(n, dtype=torch.float32, device=assign.device)
    cost_cur = torch.empty(n, dtype=torch.float32, device=assign.device)
    _build.launch("game_bestresponse_csr", "k2_game_bestresponse_csr",
                  rowptr, col, assign, sizes, row_tot, loads, lam, best,
                  cost, cost_cur, int(row0), int(n), int(k))
    return best, cost, cost_cur
