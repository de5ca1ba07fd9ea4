"""Deterministic, seek-addressable synthetic data pipeline (the port's
own copy of ``repro.data.pipeline``: numpy, bit for bit the reference's).

batch(step) is a pure function of (seed, step, host): a restarted host
replays its shard exactly (the checkpoint-restart contract), and no host
ever needs another host's stream.  Tokens follow a Zipf distribution so
the loss curve is non-trivial; a markov-ish structure makes it learnable.
The arrays stay numpy; the caller moves them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


def _rng_for(cfg: DataConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))


def batch_at(cfg: DataConfig, step: int) -> dict:
    """Returns {'tokens','labels'}: host-local slice of the global batch."""
    local = cfg.global_batch // cfg.n_hosts
    rng = _rng_for(cfg, step)
    # zipf body + learnable bigram: tok[t+1] ≡ (a·tok[t] + b) mod V with
    # noise; a model that learns the map beats the unigram entropy
    base = rng.zipf(1.5, size=(local, cfg.seq_len)).astype(np.int64)
    toks = base % cfg.vocab
    a, b = 31, 17
    follow = (a * toks[:, :-1] + b) % cfg.vocab
    mask = rng.random((local, cfg.seq_len - 1)) < 0.7
    toks[:, 1:] = np.where(mask, follow, toks[:, 1:])
    labels = np.concatenate(
        [toks[:, 1:], np.full((local, 1), -1, np.int64)], axis=1)
    return {"tokens": toks.astype(np.int32),
            "labels": labels.astype(np.int32)}


def graph_edge_shards(src: np.ndarray, dst: np.ndarray, n_hosts: int):
    """Contiguous edge-stream shards per host (the CLUGP distributed mode's
    reader), seek-addressable by (host, offset)."""
    E = src.shape[0]
    bounds = np.linspace(0, E, n_hosts + 1).astype(np.int64)
    return [(src[bounds[i]:bounds[i + 1]], dst[bounds[i]:bounds[i + 1]])
            for i in range(n_hosts)]
