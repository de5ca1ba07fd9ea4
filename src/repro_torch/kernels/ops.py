"""The port's kernel entry points in one place (counterpart of
``repro.kernels.ops``).  Each wrapper runs its plain PyTorch version on
CPU tensors and launches its hand-written CUDA kernel on CUDA tensors;
``launch_counts`` reports the kernel launches since
``reset_launch_counts``."""
from __future__ import annotations

from ._build import build_all, launch_counts, reset_launch_counts  # noqa: F401
from .cluster_scatter import (cluster_pass, cluster_pass_plain,  # noqa: F401
                              cluster_scatter, cluster_scatter_plain)
from .ell_spmv import ell_spmv, ell_spmv_plain, row_split_ell  # noqa: F401
from .flash_attention import flash_attention, flash_attention_plain  # noqa: F401
from .game_bestresponse import (game_bestresponse,  # noqa: F401
                                game_bestresponse_csr,
                                game_bestresponse_csr_plain,
                                game_bestresponse_plain)
from .transform_scan import (transform_inputs, transform_scan,  # noqa: F401
                             transform_scan_plain, transform_scan_tiered_plain,
                             transform_scan_tiers)

# the kernels of each path, by the path that launches them: the graph path
# (partition → layout → PageRank), the GAS program library on a built
# layout (pagerank, ppr and centrality gather on K3; the other programs
# launch no kernel) and the LM serving path (prefill).  The dense
# game_bestresponse is on none: the game runs the CSR form.
KERNELS = {"graph": ("cluster_scatter", "game_bestresponse_csr", "ell_spmv",
                     "transform_scan"),
           "gas": ("ell_spmv",),
           "lm": ("flash_attention",)}
