"""Pass 2 — game-theoretic cluster partitioning (paper §V, Alg. 3).

Port of ``repro.core.game``, in three parts:

- The host game, in numpy and scipy as the reference keeps it: the
  oracle of the ``np`` backend, which ``expert_placement`` also plays —
  ``ClusterGraph``, ``contract``,
  ``lambda_max``, ``lambda_from_weight``, ``GameResult``, ``potential``,
  ``global_cost``, ``best_response_rounds`` and ``greedy_assign_np``, bit
  for bit.
- ``game_rounds`` — batched best-response rounds (``jax_game_rounds``):
  Jacobi within a batch, Gauss–Seidel on the load table across batches,
  damped moves, and termination on the potential Φ (Thm 4).  With
  ``mode="cuda"`` each batch is one launch of the fused K2
  (``kernels.game_bestresponse_csr``) over the batch's rows, which counts
  their affinity from the cluster CSR built once per game (``cluster_csr``);
  ``mode="torch"`` is the reference's dense form: the whole m_cap × k
  affinity rebuilt per batch and swept by K2's plain version.
  ``greedy_assign`` is the CLUGP-G ablation (``jax_greedy_assign``), bit
  for bit.
- ``game_rounds_gs`` — the Gauss–Seidel scan game
  (``jax_game_rounds_gs``) over the aggregated cluster pairs
  (``cluster_pairs``, the counterpart of ``jax_cluster_csr``): per round
  the cut mass of the round-start assignment, Φ, best-Φ tracking, then
  one sweep on the G kernel (``kernels.game_gs``), which plays the
  clusters one after another against the live loads.

``jax.random`` draws cannot be reproduced in PyTorch, so both device
games take an optional start assignment ``assign0`` (and ``game_rounds``
an optional damping draw ``draw(rnd, b) -> bool mask``); by default they
come from ``hash_draws``, a counter-based hash of (seed, stream, row) in
int64 arithmetic that gives the same bits on every device, as
``jax.random`` does (a ``torch.Generator``'s stream is the device's own).

On a mesh (``axis``, the sharded partitioner's bound mesh) each rank
plays its slice's private clusters as one §V-D batch against global
loads: the start loads, every batch's load delta and move count (Jacobi)
or each round's loads and moves (scan), and Φ's cut are summed over the
ranks (``dist.collectives.psum``).  Φ weighs the loads by the rank's own
λ, so the stall counter counts rounds in which no rank improved: every
rank leaves the round loop together (the reference's per-device
``while_loop`` leaves that to each device).  Where the reference folds
the rank into its key (``fold_in(key, axis_index)``), the port folds it
into the hash's seed (``rank_seed``), only when an axis is bound, so one
rank's draws are the same on the CPU and on the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..dist import collectives as coll
from ..kernels.game_bestresponse import (game_bestresponse_csr,
                                         game_bestresponse_plain)
from ..kernels.game_gs import game_gs

_STALL_ROUNDS = 4
_DAMPING = 0.5       # share of improving players that move in round 0
PAIR_KEY_LIMIT = 2 ** 31   # the reference's int32 pair keys: m_cap·(m_cap+1) below it
# the draws' hash: odd multipliers below 2³¹ (the golden ratio's, and two
# of a 32-bit finalizer's), so a product with a 32-bit value stays below
# 2⁶³ in int64 and no step wraps on any device
_MASK32 = 0xFFFFFFFF
_ROW_MUL = 0x61C88647
_MIX_MUL = (0x7FEB352D, 0x5BD1E995)
_SEED_SALT = 0x9E3779B9    # keeps seed 0 off the finalizer's fixed point 0
_RANK_SALT = 0x85EBCA6B    # separates a rank's seed from the seed's streams
_DRAW_BITS = 24            # a Bernoulli draw compares the hash's top 24 bits


# --------------------------------------------------------------- host game
# numpy/scipy copies of the reference's host game: the np backend's oracle.

@dataclass
class ClusterGraph:
    """Contracted graph: vertices = clusters."""
    sizes: np.ndarray          # |c_i| = intra-cluster edge counts, int64[m]
    adj: sp.csr_matrix         # symmetrized inter-cluster edge counts, m×m
    vertex_cluster: np.ndarray  # original vertex -> cluster id
    m: int

    @property
    def total_cut_capacity(self) -> int:
        """Σ_i |e(c_i, V\\c_i)|: the adjacency's row sums (adj = W + Wᵀ)."""
        return int(self.adj.sum()) // 1


def contract(src: np.ndarray, dst: np.ndarray, clu: np.ndarray) -> ClusterGraph:
    """Build the cluster multigraph from the vertex→cluster table."""
    cs, cd = clu[src], clu[dst]
    m = int(clu.max()) + 1 if clu.size else 0
    intra = cs == cd
    sizes = np.bincount(cs[intra], minlength=m).astype(np.int64)
    xs, xd = cs[~intra], cd[~intra]
    w = np.ones(xs.shape[0], dtype=np.int64)
    W = sp.coo_matrix((w, (xs, xd)), shape=(m, m)).tocsr()
    S = (W + W.T).tocsr()
    S.sum_duplicates()
    return ClusterGraph(sizes, S, clu, m)


def lambda_max(cg: ClusterGraph, k: int) -> float:
    """Thm 5 upper end of the feasible λ range (the paper's default):
    k²·(adj.sum()/2) / (Σ sizes)²."""
    total_sizes = float(cg.sizes.sum())
    if total_sizes <= 0:
        return 1.0
    total_cut = float(cg.adj.sum()) / 2.0
    return (k * k) * total_cut / (total_sizes * total_sizes)


def lambda_from_weight(cg: ClusterGraph, k: int, weight: float) -> float:
    """Relative-weight parameterization (paper Fig. 11b): weight ∈ (0, 1)
    is the share of the load-balance term."""
    total_sizes = float(cg.sizes.sum())
    total_cut = float(cg.adj.sum()) / 2.0
    if total_sizes <= 0 or total_cut <= 0:
        return 1.0
    base = k * total_cut / (total_sizes * total_sizes / k)
    w = min(max(weight, 1e-3), 1 - 1e-3)
    return base * (w / (1 - w))


@dataclass
class GameResult:
    assign: np.ndarray         # cluster -> partition, int32[m]
    rounds: int
    potential_trace: list
    moves: int


def potential(cg: ClusterGraph, assign: np.ndarray, k: int,
              lam: float) -> float:
    """Φ(Λ) (Definition 4)."""
    loads = np.bincount(assign, weights=cg.sizes, minlength=k)
    load_term = lam / (2.0 * k) * float((loads ** 2).sum())
    A = cg.adj.tocoo()
    cross = float(A.data[assign[A.row] != assign[A.col]].sum()) / 2.0
    return load_term + 0.5 * cross


def global_cost(cg: ClusterGraph, assign: np.ndarray, k: int,
                lam: float) -> float:
    """φ(Λ) (Eq. 10)."""
    loads = np.bincount(assign, weights=cg.sizes, minlength=k)
    load_term = lam / k * float((loads ** 2).sum())
    A = cg.adj.tocoo()
    cross = float(A.data[assign[A.row] != assign[A.col]].sum()) / 2.0
    return load_term + cross


def best_response_rounds(cg: ClusterGraph, k: int, lam: float | None = None,
                         batch_size: int | None = None,
                         max_rounds: int = 64, seed: int = 0,
                         track_potential: bool = False,
                         base_loads: np.ndarray | None = None) -> GameResult:
    """Alg. 3 with the paper's §V-D batching, on the host in f64.

    A batch plays sequentially (Gauss–Seidel) against the live load
    table; the cut mass is read from the live assignment.
    ``batch_size=None`` ⇒ one batch.  ``base_loads`` adds exogenous
    per-partition load (the Mint-like baseline's window)."""
    m = cg.m
    if m == 0:
        return GameResult(np.zeros(0, np.int32), 0, [], 0)
    if lam is None:
        lam = lambda_max(cg, k)
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, k, size=m).astype(np.int64)   # Alg.3 line 2
    sizes = cg.sizes.astype(np.float64)
    loads = np.bincount(assign, weights=sizes, minlength=k)
    if base_loads is not None:
        loads = loads + base_loads.astype(np.float64)
    S = cg.adj.astype(np.float64)
    indptr, indices, data = S.indptr, S.indices, S.data
    row_tot = np.asarray(S.sum(axis=1)).ravel().astype(np.float64)
    if batch_size is None:
        batch_size = m
    trace = []
    total_moves = 0
    ar = np.arange(k)
    for rnd in range(max_rounds):
        moved = 0
        for lo in range(0, m, batch_size):
            hi = min(m, lo + batch_size)
            for i in range(lo, hi):          # Gauss–Seidel sweep (live state)
                sz = sizes[i]
                cur = assign[i]
                nbrs = indices[indptr[i]:indptr[i + 1]]
                w = data[indptr[i]:indptr[i + 1]]
                aff = np.bincount(assign[nbrs], weights=w, minlength=k)
                loads_ex = loads - sz * (ar == cur)
                cost = (lam / k) * sz * (loads_ex + sz) \
                    + 0.5 * (row_tot[i] - aff)
                best = int(np.argmin(cost))
                if cost[best] + 1e-9 < cost[cur]:
                    loads[cur] -= sz
                    loads[best] += sz
                    assign[i] = best
                    moved += 1
        total_moves += moved
        if track_potential:
            trace.append(potential(cg, assign, k, lam))
        if moved == 0:
            return GameResult(assign.astype(np.int32), rnd + 1, trace,
                              total_moves)
    return GameResult(assign.astype(np.int32), max_rounds, trace, total_moves)


def greedy_assign_np(cg: ClusterGraph, k: int) -> np.ndarray:
    """CLUGP-G ablation (§VI-B) on the host: big clusters → least-loaded
    partitions, stable sort so ties break by cluster id."""
    order = np.argsort(-cg.sizes, kind="stable")
    loads = np.zeros(k, dtype=np.int64)
    assign = np.zeros(cg.m, dtype=np.int32)
    for c in order:
        p = int(np.argmin(loads))
        assign[c] = p
        loads[p] += int(cg.sizes[c])
    return assign


# ------------------------------------------------------------- device games

def _mix32(h):
    """A 32-bit finalizer (xor-shift, multiply, xor-shift, multiply,
    xor-shift) on a Python int or an int64 tensor of values below 2³²:
    each product is below 2⁶³ and is masked back to 32 bits."""
    for mul, shift in zip(_MIX_MUL, (16, 15)):
        h = ((h ^ (h >> shift)) * mul) & _MASK32
    return h ^ (h >> 16)


def stream_base(seed: int, stream: int) -> int:
    """The 32-bit base of one stream: seed and stream mixed in Python
    integers (the reference folds the stream into its key with
    ``jax.random.fold_in``)."""
    return _mix32(_mix32((int(seed) ^ _SEED_SALT) & _MASK32)
                  ^ (int(stream) & _MASK32))


def rank_seed(seed: int, rank: int) -> int:
    """The seed a rank of a sharded run draws from: ``seed`` and the rank
    mixed (the counterpart of the reference's ``fold_in(key,
    axis_index)``)."""
    return _mix32(stream_base(seed, rank) ^ _RANK_SALT)


def _axis_seed(seed: int, axis) -> int:
    return seed if axis is None else rank_seed(seed, coll.axis_index(axis))


def _any_rank(flag, axis):
    """A round's Φ-improvement flag as an int64 0-dim, true on every rank
    when any rank improved.  Φ carries each rank's own λ (local cluster
    graph), so the flags differ across ranks; the stall counter, which
    ends the loop, must not, or the ranks would leave the loop apart and
    wait on each other's collectives."""
    return coll.pmax(flag.to(torch.int64).reshape(()), axis,
                     site="game.improved")


def hash_draws(base, rows):
    """(rows,) 32-bit draws of the hash: ``base`` (a Python int or an
    int64 tensor broadcast over ``rows``) plus the row times an odd
    multiplier, mixed.  int64 on ``rows``' device, equal bit for bit on
    every device."""
    return _mix32((rows.long() * _ROW_MUL + base) & _MASK32)


def damping_draws(seed: int, m_cap: int, batch_size: int, n_batches: int,
                  max_rounds: int, device):
    """The Jacobi game's default ``draw(rnd, b)``: batch b of round rnd
    plays stream ``rnd·n_batches + b + 1`` (the reference's ``fold_in``),
    each row a Bernoulli(p) as the integer compare ``draw >> 8 <
    floor(p·2²⁴)``.  The stream bases of every round and batch go to the
    device in one table, and a round is drawn once over all m_cap rows
    (each row on its batch's stream) at its first batch's call; the
    round's later batches slice the same mask."""
    bases = torch.tensor(
        [[stream_base(seed, rnd * n_batches + b + 1)
          for b in range(n_batches)] for rnd in range(max_rounds)],
        dtype=torch.int64).to(device)
    rows = torch.arange(m_cap, device=device)
    batch_of = rows // batch_size
    drawn = {}

    def draw(rnd, b):
        if rnd not in drawn:
            drawn.clear()
            p = max(_DAMPING * 0.92 ** rnd, 0.08)
            h = hash_draws(bases[rnd][batch_of], rows)
            drawn[rnd] = (h >> (32 - _DRAW_BITS)) < int(p * (1 << _DRAW_BITS))
        return drawn[rnd]
    return draw


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


def cluster_csr(xs, xd, m_cap: int):
    """The symmetrized cross-edge CSR of the cluster graph: every real
    cross edge in both endpoints' rows, multiplicities kept (the
    counterpart of ``jax_cluster_csr`` without its aggregation).  Returns
    (rowptr (m_cap + 1,), col) int32."""
    rows = torch.cat([xs, xd])
    cols = torch.cat([xd, xs])
    order = torch.argsort(rows, stable=True)
    rowptr = torch.zeros(m_cap + 1, dtype=torch.int64, device=xs.device)
    rowptr[1:] = torch.cumsum(torch.bincount(rows, minlength=m_cap), 0)
    return rowptr.to(torch.int32), cols[order].to(torch.int32).contiguous()


def game_rounds(xs, xd, sizes, row_tot, k: int, lam, *, batch_size: int,
                max_rounds: int, seed: int, mode: str = "cuda",
                assign0=None, draw=None, axis=None):
    """Batched best-response rounds (Alg. 3 + §V-D).

    ``xs``/``xd``: cross-edge cluster endpoints, padded with the sentinel
    ``m_cap`` (dropped).  ``sizes``/``row_tot``: (m_cap,) f32.  ``lam``: a
    0-dim or (1,) f32 tensor.  Returns (assign (m_cap,) int32, rounds).
    Under ``axis`` the loads, each batch's load delta and move count and
    Φ's cut are summed over the ranks, and a batch no rank has a live row
    in is skipped by every rank."""
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
    if mode == "cuda":
        rowptr, col = cluster_csr(xs, xd, m_cap)
        # a row with no size and no cross edge costs 0 on every lane and
        # never moves: a batch of such rows (the padding past the live
        # clusters) launches nothing
        live = ((sizes != 0) | (row_tot != 0)).long()
        has_live = torch.zeros(n_batches, dtype=torch.int64, device=device)
        has_live.index_add_(0, ar // batch_size, live)
        has_live = (coll.pmax(has_live, axis, site="game.live") > 0).tolist()

    seed = _axis_seed(seed, axis)
    if assign0 is None:
        assign0 = start_assignment(m_cap, k, seed, device)
    if draw is None:
        draw = damping_draws(seed, m_cap, batch_size, n_batches, max_rounds,
                             device)
    assign = assign0.to(device=device, dtype=torch.int32)
    loads = torch.zeros(k, dtype=torch.float32, device=device)
    loads.index_add_(0, assign.long(), sizes)
    loads = coll.psum(loads, axis, site="game.loads")
    total_tot = row_tot.sum()

    def potential(assign, loads):
        """Φ (Definition 4).  Σ_i (row_tot − aff[i, a_i]) counts each
        cross edge twice, so it is Σ row_tot − 2·#{cross edges whose
        endpoints share a partition}: integers, exact in f32 (as the
        reference's dense sum is) while Σ row_tot = 2·n_cross < 2²⁴."""
        same = (assign[xs] == assign[xd]).sum().to(torch.float32)
        cut = coll.psum(total_tot - 2.0 * same, axis, site="game.cut")
        return (lam / (2 * kf)) * torch.sum(loads * loads) + 0.25 * cut

    best_assign = assign
    best_phi = torch.full((1,), 3e38, dtype=torch.float32, device=device)
    rnd, moved, stall = 0, 1, 0
    while moved > 0 and rnd < max_rounds and stall < _STALL_ROUNDS:
        moved_t = torch.zeros((), dtype=torch.int64, device=device)
        assign = assign.clone()          # best_assign may alias it
        for b in range(n_batches):
            r0, r1 = b * batch_size, min((b + 1) * batch_size, m_cap)
            # the damping draw of every batch, moving or not, so an
            # injected draw sees the same calls in either mode
            keep = draw(rnd, b)[r0:r1]
            if mode == "cuda":
                if not has_live[b]:
                    continue
                best, best_cost, cost_cur = game_bestresponse_csr(
                    rowptr, col, assign, sizes, row_tot, loads, lam=lam,
                    k=k, row0=r0, row1=r1)
                cur = assign[r0:r1].long()
            else:
                aff = _affinity(xs, xd, assign, m_cap, k)
                best, best_cost = game_bestresponse_plain(
                    aff, sizes, row_tot, assign, loads, lam=lam, k=k)
                cur = assign.long()
                cost_cur = a * sizes * loads[cur] \
                    + 0.5 * (row_tot - aff[ar, cur])
                best, best_cost, cost_cur, cur = (
                    x[r0:r1] for x in (best, best_cost, cost_cur, cur))
            margin = 1e-6 + 1e-5 * torch.abs(cost_cur)
            wants = best_cost + margin < cost_cur
            move = wants & keep
            msz = torch.where(move, sizes[r0:r1], 0.0)
            # the load delta and the move count in one vector, so a mesh
            # sums both in one call (integer-valued f32, exact below 2²⁴)
            delta = torch.zeros(k + 1, dtype=torch.float32, device=device)
            delta.index_add_(0, best.long(), msz)
            delta.index_add_(0, cur, -msz)
            delta[k] = wants.sum()
            delta = coll.psum(delta, axis, site="game.delta")
            assign[r0:r1] = torch.where(move, best, assign[r0:r1])
            loads = loads + delta[:k]
            moved_t = moved_t + delta[k].to(torch.int64)
        phi = potential(assign, loads)
        better = phi < best_phi - 1e-6 * torch.abs(best_phi)
        best_assign = torch.where(better, assign, best_assign)
        best_phi = torch.minimum(phi, best_phi)
        moved, improved = torch.stack(
            [moved_t, _any_rank(better, axis)]).tolist()
        stall = 0 if improved else stall + 1
        rnd += 1
    return best_assign, rnd


# ------------------------------------------------------ the scan game (G)

def start_assignment(m_cap: int, k: int, seed: int, device):
    """Both device games' default random start: (m_cap,) int32 lanes
    ``draw % k`` from stream 0 of the hash, the same on every device.  The
    modulo's bias is below k / 2³² a lane."""
    rows = torch.arange(m_cap, device=device)
    return (hash_draws(stream_base(seed, 0), rows) % k).to(torch.int32)


def cluster_pairs(xs, xd, m_cap: int):
    """The distinct symmetrized cluster pairs and their multiplicities
    (``jax_cluster_csr``): (row, col) int64 and w f32, sorted by
    row·m_cap + col, from cross-edge endpoints padded with the sentinel
    ``m_cap``.  The list is sized exactly, so the reference's ``nnz_cap``
    and its retry have no counterpart."""
    real = (xs < m_cap) & (xd < m_cap)
    xs, xd = xs[real].long(), xd[real].long()
    key = torch.cat([xs * m_cap + xd, xd * m_cap + xs])
    uniq, mult = torch.unique(key, sorted=True, return_counts=True)
    return uniq // m_cap, uniq % m_cap, mult.to(torch.float32)


def _sum32(x):
    """Σ x as f32: the f64 sum of the f32 terms, rounded once.  Equal on
    every device, and equal to an f32 sum in any order wherever that sum
    is exact (the integer-valued terms of Φ below 2²⁴)."""
    return x.to(torch.float64).sum().to(torch.float32)


def game_rounds_gs(row, col, w, sizes, row_tot, k: int, lam, *,
                   max_rounds: int, seed: int, assign0=None, axis=None):
    """Gauss–Seidel-on-loads best response (``jax_game_rounds_gs``).

    ``row``/``col``/``w``: the aggregated cluster pairs
    (``cluster_pairs``); ``sizes``/``row_tot`` (m_cap,) f32; ``lam`` a
    0-dim or (1,) f32 tensor.  Per round: the cut mass ``aff`` of the
    round-start assignment (an accumulating ``index_put_``: integer-valued
    f32, exact in any order), Φ, best-Φ tracking with a stall counter,
    then one sweep on G.  The loop stops when a sweep moves nothing, at
    ``max_rounds`` or after 4 stalled rounds, and a final Φ check decides
    between the last sweep and the best snapshot.  Returns (assign
    (m_cap,) int32, rounds).

    The reference also takes a traced ``k_real`` to play the live lanes
    of a k_max-padded sweep step; the port runs each k at its own lane
    count (``partitioner.partition_sweep``), so every lane is live here.
    The sweep walks the rows up to the last one with a size or a row
    total: the rows past it cost 0 on every lane and never move.

    Under ``axis`` each rank sweeps its private clusters (one batch a
    rank): the start loads and Φ's cut are summed over the ranks, and
    after each sweep the loads are recounted from the assignment and
    summed with the move counts (the other ranks see a round's moves
    only then, the reference's §V-D shared-nothing approximation)."""
    device = sizes.device
    m_cap = sizes.shape[0]
    sizes = sizes.to(torch.float32)
    row_tot = row_tot.to(torch.float32)
    lam = lam.reshape(1).to(torch.float32)
    kf = torch.full((1,), float(k), dtype=torch.float32, device=device)
    live = torch.nonzero((sizes != 0) | (row_tot != 0))
    n = int(live.max()) + 1 if live.numel() else 0
    ar = torch.arange(m_cap, device=device)
    if assign0 is None:
        assign0 = start_assignment(m_cap, k, _axis_seed(seed, axis), device)
    assign = assign0.to(device=device, dtype=torch.int32)

    def loads_of(assign):
        loads = torch.zeros(k, dtype=torch.float32, device=device)
        loads.index_add_(0, assign.long(), sizes)
        return coll.psum(loads, axis, site="game.loads")

    loads = loads_of(assign)

    def aff_of(assign):
        aff = torch.zeros(m_cap, k, dtype=torch.float32, device=device)
        return aff.index_put_((row, assign[col].long()), w, accumulate=True)

    def phi_of(assign, loads, aff):
        """Φ (Definition 4); Σ_i (row_tot − aff[i, a_i]) counts each
        symmetrized pair twice, hence the 0.25."""
        cut = coll.psum(_sum32(row_tot - aff[ar, assign.long()]), axis,
                        site="game.cut")
        return (lam / (2 * kf)) * _sum32(loads * loads) + 0.25 * cut

    best_assign = assign
    best_phi = torch.full((1,), 3e38, dtype=torch.float32, device=device)
    rnd, moved, stall = 0, 1, 0
    while moved > 0 and rnd < max_rounds and stall < _STALL_ROUNDS:
        aff = aff_of(assign)
        phi = phi_of(assign, loads, aff)
        best_assign = torch.where(phi < best_phi, assign, best_assign)
        improved = phi < best_phi - 1e-6 * torch.abs(best_phi)
        best_phi = torch.minimum(phi, best_phi)
        assign, loads, moved_t = game_gs(aff, sizes, row_tot, assign, loads,
                                         lam=lam, k=k, n=n)
        if axis is not None:
            loads = loads_of(assign)
            moved_t = coll.psum(moved_t.to(torch.int64).reshape(1), axis,
                                site="game.moves")
        moved, improved = torch.stack(
            [moved_t.to(torch.int64).reshape(()),
             _any_rank(improved, axis)]).tolist()
        stall = 0 if improved else stall + 1
        rnd += 1
    phi = phi_of(assign, loads, aff_of(assign))
    return torch.where(phi < best_phi, assign, best_assign), rnd
