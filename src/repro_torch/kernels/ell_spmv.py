"""K3 — ELL SpMV and the row-split ELL table the PageRank gather uses.

Port of ``repro.kernels.ell_spmv``: ``y[r] = Σ_j vals[r, j]·x[cols[r, j]]``
with f32 accumulation.  ``ell_spmv`` runs the plain version on CPU
tensors and launches ``csrc/ell_spmv.cu`` on CUDA tensors (f32 or bf16
``vals``/``x``).

The reference pads each row to the largest in-degree of its block.  Web
graphs have hubs (the top in-degree of ``web_graph(scale=20)`` is 191,269),
so a padded ELL would be V × 191k wide.  ``row_split_ell`` instead splits
every destination's in-edges over ⌈indeg/W⌉ rows of one fixed width W,
chosen from the in-degree distribution, and keeps a row → destination map;
the caller segment-sums the row results into destinations.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import _build

WIDTHS = (1, 2, 4, 8, 16, 32)


def ell_spmv_plain(vals, cols, x):
    return (vals.to(torch.float32) * x.to(torch.float32)[cols.long()]).sum(1)


def ell_spmv(vals, cols, x):
    """vals (R, W) f32/bf16, cols (R, W) int32 indices into x (N,) of
    vals' dtype.  Returns y (R,) f32."""
    if vals.device.type == "cpu":
        return ell_spmv_plain(vals, cols, x)
    R, W = vals.shape
    if cols.shape != (R, W) or cols.dtype != torch.int32 or x.dim() != 1:
        raise ValueError("ell_spmv: cols must be (R, W) int32 and x 1-D")
    if vals.dtype != x.dtype or vals.dtype not in (torch.float32,
                                                   torch.bfloat16):
        raise ValueError("ell_spmv: vals and x must share f32 or bf16")
    _build.require_cuda(vals, cols, x)
    y = torch.empty(R, dtype=torch.float32, device=vals.device)
    fn = "k3_ell_spmv_f32" if vals.dtype == torch.float32 \
        else "k3_ell_spmv_bf16"
    _build.launch("ell_spmv", fn, vals, cols, x, y, int(R), int(W))
    return y


@dataclass
class RowSplitELL:
    vals: torch.Tensor       # (R, W) f32 lane weights (0 on pad lanes)
    cols: torch.Tensor       # (R, W) int32 x indices (pad lanes: pad_col)
    row_slot: torch.Tensor   # (R,) int64 destination of each row
    width: int
    num_slots: int

    def spmv(self, x):
        """Σ over each destination's in-lanes: K3 then the row → slot
        segment sum (f32; the order differs from a plain segment sum)."""
        y = ell_spmv(self.vals, self.cols, x)
        out = torch.zeros(self.num_slots, dtype=torch.float32,
                          device=y.device)
        return out.index_add_(0, self.row_slot, y)


def choose_width(indeg: np.ndarray) -> int:
    """The W that moves the fewest bytes through K3 and the row sum:
    each row costs W lanes of (value + column) plus its result and slot
    entry, 8·W + 8 bytes."""
    cost = [int(-(-indeg // w).sum()) * (8 * w + 8) for w in WIDTHS]
    return WIDTHS[int(np.argmin(cost))]


def row_split_ell(dst_slot, src_col, weights, num_slots: int, pad_col: int,
                  device) -> RowSplitELL:
    """Row-split ELL of the edge list (dst_slot[e] ← weights[e]·x[src_col
    [e]]).  Built on the host once per layout; lanes of one destination
    keep their edge order."""
    dst_slot = np.asarray(dst_slot, np.int64)
    src_col = np.asarray(src_col, np.int64)
    weights = np.asarray(weights, np.float32)
    order = np.argsort(dst_slot, kind="stable")
    ds, sc, w = dst_slot[order], src_col[order], weights[order]
    indeg = np.bincount(ds, minlength=num_slots)
    W = choose_width(indeg)
    rows_per = -(-indeg // W)
    row_start = np.cumsum(rows_per) - rows_per
    slot_start = np.cumsum(indeg) - indeg
    pos = np.arange(ds.shape[0]) - slot_start[ds]
    row = row_start[ds] + pos // W
    lane = pos % W
    R = int(rows_per.sum())
    vals = np.zeros((R, W), np.float32)
    cols = np.full((R, W), pad_col, np.int32)
    vals[row, lane] = w
    cols[row, lane] = sc
    row_slot = np.repeat(np.arange(num_slots), rows_per)
    return RowSplitELL(torch.from_numpy(vals).to(device),
                       torch.from_numpy(cols).to(device),
                       torch.from_numpy(row_slot).to(device), W, num_slots)
