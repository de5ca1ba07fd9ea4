"""The port's kernel entry points in one place (counterpart of
``repro.kernels.ops``).  Each wrapper runs its plain PyTorch version on
CPU tensors and launches its hand-written CUDA kernel on CUDA tensors;
``launch_counts`` reports the kernel launches since
``reset_launch_counts``."""
from __future__ import annotations

from ._build import build_all, launch_counts, reset_launch_counts  # noqa: F401
from .cluster_scatter import cluster_scatter, cluster_scatter_plain  # noqa: F401
from .ell_spmv import ell_spmv, ell_spmv_plain, row_split_ell  # noqa: F401
from .game_bestresponse import game_bestresponse, game_bestresponse_plain  # noqa: F401
from .transform_scan import transform_inputs, transform_scan, transform_scan_plain  # noqa: F401

KERNELS = ("cluster_scatter", "game_bestresponse", "ell_spmv",
           "transform_scan")
