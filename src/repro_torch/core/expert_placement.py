"""CLUGP → MoE expert placement (beyond-paper bridge).

The paper's cluster-partitioning game (§V) assigns clusters to partitions
minimizing load imbalance + cut edges.  An MoE layer's all-to-all volume
has exactly this structure: experts that co-fire for the same token want
to live on the same EP shard (one dispatch hop instead of two); shard load
must stay balanced or the slowest shard gates the step.

Mapping:  cluster  → expert,   |c_i| → expert token-load,
          e(c_i,c_j) → co-activation count (tokens routing to both i and j
          within the same top-k set),  k → EP shards.

The shared expert (DeepSeek) is the paper's "high-degree vertex": it
co-fires with everything, so — like the splitting rule would — we replicate
it on every shard rather than place it.

Output: a permutation mapping expert id → shard, usable to re-order the
expert bank so a contiguous EP sharding realizes the placement.

A numpy copy of ``repro.core.expert_placement`` on the port's host game
(``best_response_rounds``); the MoE model that would use it is not
ported yet.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .game import ClusterGraph, best_response_rounds


def coactivation_graph(top_idx: np.ndarray, n_experts: int,
                       loads: np.ndarray | None = None) -> ClusterGraph:
    """top_idx: (T, K) routed expert ids per token."""
    T, K = top_idx.shape
    sizes = np.bincount(top_idx.reshape(-1), minlength=n_experts) \
        .astype(np.int64)
    rows, cols = [], []
    for a in range(K):
        for b in range(a + 1, K):
            rows.append(top_idx[:, a])
            cols.append(top_idx[:, b])
    if rows:
        r = np.concatenate(rows)
        c = np.concatenate(cols)
        W = sp.coo_matrix((np.ones(r.shape[0], np.int64), (r, c)),
                          shape=(n_experts, n_experts)).tocsr()
        S = (W + W.T).tocsr()
    else:
        S = sp.csr_matrix((n_experts, n_experts), dtype=np.int64)
    return ClusterGraph(sizes, S, np.arange(n_experts), n_experts)


def place_experts(top_idx: np.ndarray, n_experts: int, n_shards: int,
                  seed: int = 0) -> np.ndarray:
    """Returns perm (n_experts,): expert id → new position, such that
    contiguous blocks of n_experts/n_shards land on the same EP shard and
    co-activated experts share blocks."""
    cg = coactivation_graph(top_idx, n_experts)
    res = best_response_rounds(cg, n_shards, batch_size=None, seed=seed)
    shard_of = res.assign
    per = n_experts // n_shards
    # pack: fill shards to exactly `per` experts each (stable overflow spill)
    order = np.argsort(shard_of, kind="stable")
    perm = np.zeros(n_experts, dtype=np.int64)
    slots = {s: 0 for s in range(n_shards)}
    spill = []
    for e in order:
        s = int(shard_of[e])
        if slots[s] < per:
            perm[e] = s * per + slots[s]
            slots[s] += 1
        else:
            spill.append(e)
    for e in spill:
        s = min(slots, key=slots.get)
        perm[e] = s * per + slots[s]
        slots[s] += 1
    return perm


def a2a_volume(top_idx: np.ndarray, shard_of_expert: np.ndarray,
               n_shards: int) -> int:
    """Dispatch fan-out: Σ_tokens #distinct destination shards among the
    token's top-k experts.  Tokens are spread over DP shards independent of
    topic, so per-expert hop counts are placement-invariant; what the game
    minimizes is the *fan-out* — co-activated experts on one shard turn two
    dispatch messages (and two combine returns) into one."""
    T, K = top_idx.shape
    shards = shard_of_expert[top_idx]              # (T, K)
    shards_sorted = np.sort(shards, axis=1)
    distinct = 1 + (shards_sorted[:, 1:] != shards_sorted[:, :-1]).sum(1)
    return int(distinct.sum())
