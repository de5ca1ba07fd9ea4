"""Pass 3 — partition transformation (paper Alg. 1) and the restream prior.

Port of ``repro.core.transform``: ``transform`` (``transform_jax``) turns
the vertex → partition prior into an edge → partition assignment under
the balance cap L_max = τ·|E|/k, walking the stream on the T kernel
(``kernels.transform_scan``); ``majority_vertex_map``
(``majority_vertex_map_jax``) is the prioritized-restream prior.  Both
are bit-identical to the reference.
"""
from __future__ import annotations

import torch

from ..kernels.transform_scan import (transform_inputs, transform_scan,
                                      transform_scan_plain)


def transform(src, dst, vertex_part, deg, divided, k: int, tau: float = 1.0,
              mask=None, kernel: str = "cuda"):
    """Alg. 1 over int32 ``src``/``dst`` tensors under the cap
    τ·E/k.  ``mask`` marks live edges (padding lanes get partition 0 and
    add no load).  ``kernel="torch"`` walks with the plain version.
    Returns (E,) int32."""
    lmax = tau * src.shape[0] / float(k)
    pu, pv, normal = transform_inputs(src.long(), dst.long(),
                                      vertex_part.to(torch.int32),
                                      deg, divided.to(torch.bool),
                                      None if mask is None
                                      else mask.to(torch.bool))
    walk = transform_scan if kernel == "cuda" else transform_scan_plain
    return walk(pu, pv, normal, k, lmax)


def majority_vertex_map(src, dst, assign, num_vertices: int, k: int,
                        mask=None):
    """Per vertex, the partition holding most of its edges (ties → the
    lowest partition id, as ``jnp.argmax``).  Masked lanes drop into one
    extra row that is sliced off."""
    src, dst = src.long(), dst.long()
    if mask is not None:
        src = torch.where(mask, src, num_vertices)
        dst = torch.where(mask, dst, num_vertices)
    a = assign.long()
    cnt = torch.zeros((num_vertices + 1) * k, dtype=torch.int32,
                      device=src.device)
    one = torch.ones(src.shape[0], dtype=torch.int32, device=src.device)
    cnt.index_add_(0, src * k + a, one)
    cnt.index_add_(0, dst * k + a, one)
    return torch.argmax(cnt.view(num_vertices + 1, k)[:num_vertices],
                        dim=1).to(torch.int32)
