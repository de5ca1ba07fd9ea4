"""CLUGP configuration/result types (port of ``repro.core.pipeline``).

``kernel`` picks the game's best-response sweep and ``cluster_kernel``
the two stream scans (the clustering block scan and the transform walk):
``"cuda"`` = the hand-written kernels (K2 / K1 and T), ``"torch"`` =
their plain PyTorch versions, ``"auto"`` = the kernels.
On CPU tensors the kernel wrappers run the plain version anyway, so the
two values differ only on the card, where ``"torch"`` exists to compare
the paths.  The reference's lowering-only ``unroll`` knob has no
counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .clustering import ClusteringResult

KERNELS = ("auto", "cuda", "torch")


@dataclass(frozen=True)
class CLUGPConfig:
    k: int
    tau: float = 1.0
    vmax: float | None = None          # default |E|/k (paper §VI-A)
    split: bool = True                 # CLUGP-S ablation switch
    game: bool = True                  # CLUGP-G ablation switch
    split_degree_factor: float = 0.0   # 0 = paper-faithful; 4 = optimized
    batch_size: int = 6400             # paper §VI-A default
    max_rounds: int = 64
    relative_weight: float | None = None   # Fig. 11b sweep; None ⇒ λ_max
    effective_sizes: bool = False      # beyond-paper: balance |c_i|+boundary
    restream: int = 0                  # extra prioritized-restream passes
    kernel: str = "auto"               # game sweep: "auto" | "cuda" | "torch"
    cluster_kernel: str = "auto"       # clustering: "auto" | "cuda" | "torch"
    seed: int = 0

    def __post_init__(self):
        for name in ("kernel", "cluster_kernel"):
            if getattr(self, name) not in KERNELS:
                raise ValueError(f"{name}={getattr(self, name)!r}; expected "
                                 f"one of {KERNELS}")

    @staticmethod
    def paper(k: int, **kw) -> "CLUGPConfig":
        """Paper-faithful profile (§VI-A defaults)."""
        return CLUGPConfig(k=k, **kw)

    @staticmethod
    def optimized(k: int, **kw) -> "CLUGPConfig":
        """Beyond-paper profile: the game balances effective cluster sizes
        (intra + boundary edges) and τ=1.1 gives spill headroom."""
        kw.setdefault("tau", 1.1)
        kw.setdefault("effective_sizes", True)
        return CLUGPConfig(k=k, **kw)


@dataclass
class CLUGPResult:
    """Edge assignment + per-pass state + stats.  The reference's host
    contraction object (``cluster_graph``) is not materialized: the
    device pipeline keeps the cluster graph as cross-edge lists."""
    assign: np.ndarray
    clustering: ClusteringResult | None
    cluster_assign: np.ndarray | None
    game_rounds: int
    stats: dict = field(default_factory=dict)
