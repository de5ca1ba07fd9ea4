"""Pass 2 — game-theoretic cluster partitioning (paper §V, Alg. 3).

Port of the reference's device game (``repro.core.game``):

- ``game_rounds`` — batched best-response rounds (``jax_game_rounds``):
  Jacobi within a batch, Gauss–Seidel on the load table across batches,
  damped moves, and termination on the potential Φ (Thm 4).  Each batch's
  argmin sweep is K2 (``kernels.game_bestresponse``), or its plain
  version with ``mode="torch"``.
- ``greedy_assign`` — the CLUGP-G ablation (``jax_greedy_assign``), bit
  for bit.

``jax.random`` draws cannot be reproduced in PyTorch, so ``game_rounds``
takes an optional start assignment ``assign0`` and an optional damping
draw ``draw(rnd, b) -> bool mask``; by default both come from a
``torch.Generator`` seeded with ``seed``.  The Gauss–Seidel scan game
(``jax_game_rounds_gs``) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.game_bestresponse import (game_bestresponse,
                                         game_bestresponse_plain)

_STALL_ROUNDS = 4
_DAMPING = 0.5       # share of improving players that move in round 0


def greedy_assign(sizes, k: int):
    """Big clusters → least-loaded partitions over padded (m_cap,) f32
    sizes: stable sort by (-size, id), load ties → lowest partition, f32
    load sums — ``jax_greedy_assign`` bit for bit.  A sequential walk, so
    it runs on the host; returns (m_cap,) int32 on the sizes' device."""
    order = torch.argsort(-sizes, stable=True).cpu().tolist()
    sz = sizes.cpu().tolist()
    loads = [0.0] * k
    assign = [0] * len(sz)
    for c in order:
        p = loads.index(min(loads))
        assign[c] = p
        loads[p] = float(np.float32(loads[p] + sz[c]))
    return torch.tensor(assign, dtype=torch.int32, device=sizes.device)


def _affinity(xs, xd, assign, m_cap: int, k: int):
    """Cut mass aff[i, p] = Σ cross edges between cluster i and clusters
    on partition p (both directions).  ``xs``/``xd`` hold real cross
    edges only; the counts are integer-valued f32, exact in any order."""
    aff = torch.zeros(m_cap * k, dtype=torch.float32, device=xs.device)
    ones = torch.ones(xs.shape[0], dtype=torch.float32, device=xs.device)
    aff.index_add_(0, xs * k + assign[xd].long(), ones)
    aff.index_add_(0, xd * k + assign[xs].long(), ones)
    return aff.view(m_cap, k)


def game_rounds(xs, xd, sizes, row_tot, k: int, lam, *, batch_size: int,
                max_rounds: int, seed: int, mode: str = "cuda",
                assign0=None, draw=None):
    """Batched best-response rounds (Alg. 3 + §V-D).

    ``xs``/``xd``: cross-edge cluster endpoints, padded with the sentinel
    ``m_cap`` (dropped).  ``sizes``/``row_tot``: (m_cap,) f32.  ``lam``: a
    0-dim or (1,) f32 tensor.  Returns (assign (m_cap,) int32, rounds)."""
    device = sizes.device
    m_cap = sizes.shape[0]
    sizes = sizes.to(torch.float32)
    row_tot = row_tot.to(torch.float32)
    lam = lam.reshape(1).to(torch.float32)
    kf = torch.full((1,), float(k), dtype=torch.float32, device=device)
    a = lam / kf
    n_batches = max(1, -(-m_cap // batch_size))
    ar = torch.arange(m_cap, device=device)
    real = (xs < m_cap) & (xd < m_cap)
    xs, xd = xs[real].long(), xd[real].long()

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    if assign0 is None:
        assign0 = torch.randint(0, k, (m_cap,), generator=gen,
                                device=device, dtype=torch.int32)
    if draw is None:
        def draw(rnd, b):
            p = max(_DAMPING * 0.92 ** rnd, 0.08)
            return torch.rand(m_cap, generator=gen, device=device) < p
    assign = assign0.to(device=device, dtype=torch.int32)
    loads = torch.zeros(k, dtype=torch.float32, device=device)
    loads.index_add_(0, assign.long(), sizes)
    br = game_bestresponse if mode == "cuda" else game_bestresponse_plain

    def potential(assign, loads):
        """Φ (Definition 4); Σ_i (row_tot − aff[i, a_i]) counts each
        symmetrized pair twice, hence the 0.25."""
        aff = _affinity(xs, xd, assign, m_cap, k)
        cut = torch.sum(row_tot - aff[ar, assign.long()])
        return (lam / (2 * kf)) * torch.sum(loads * loads) + 0.25 * cut

    best_assign = assign
    best_phi = torch.full((1,), 3e38, dtype=torch.float32, device=device)
    rnd, moved, stall = 0, 1, 0
    while moved > 0 and rnd < max_rounds and stall < _STALL_ROUNDS:
        moved_t = torch.zeros((), dtype=torch.int64, device=device)
        for b in range(n_batches):
            aff = _affinity(xs, xd, assign, m_cap, k)
            best, best_cost = br(aff, sizes, row_tot, assign, loads,
                                 lam=lam, k=k)
            cur = assign.long()
            cost_cur = a * sizes * loads[cur] + 0.5 * (row_tot - aff[ar, cur])
            in_batch = (ar >= b * batch_size) & (ar < (b + 1) * batch_size)
            margin = 1e-6 + 1e-5 * torch.abs(cost_cur)
            wants = in_batch & (best_cost + margin < cost_cur)
            move = wants & draw(rnd, b)
            msz = torch.where(move, sizes, 0.0)
            delta = torch.zeros(k, dtype=torch.float32, device=device)
            delta.index_add_(0, best.long(), msz)
            delta.index_add_(0, cur, -msz)
            assign = torch.where(move, best, assign)
            loads = loads + delta
            moved_t = moved_t + wants.sum()
        phi = potential(assign, loads)
        better = phi < best_phi - 1e-6 * torch.abs(best_phi)
        best_assign = torch.where(better, assign, best_assign)
        best_phi = torch.minimum(phi, best_phi)
        moved, improved = torch.stack(
            [moved_t, better.to(torch.int64).reshape(())]).tolist()
        stall = 0 if improved else stall + 1
        rnd += 1
    return best_assign, rnd
