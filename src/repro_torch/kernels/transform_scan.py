"""T — the transform scan (paper Alg. 1) and its plain version.

The reference runs ``repro.core.transform._transform_step`` under a
``lax.scan`` over every edge and has no Pallas kernel for it.  The port
splits the step in two: ``transform_inputs`` computes, vectorized, what
does not depend on the running loads (each edge's endpoint partitions and
its Alg. 1 lines 15-22 choice), and ``transform_scan`` walks the stream
against the load table — ``csrc/transform_scan.cu`` on CUDA tensors, the
plain Python loop on CPU tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _build

MAX_K = 16384        # the load table lives in the kernel's shared memory


def transform_inputs(src, dst, vertex_part, deg, divided, live=None):
    """Per-edge (pu, pv, normal) int32: the endpoints' prior partitions
    and the choice Alg. 1 makes when neither partition is full — same
    partition → keep, a divided endpoint → its mirror side, else cut the
    higher-degree endpoint.  ``normal`` is -1 on padding lanes."""
    pu = vertex_part[src]
    pv = vertex_part[dst]
    du, dv = deg[src], deg[dst]
    divu, divv = divided[src], divided[dst]
    mirror = torch.where(divu, pv, pu)
    degree = torch.where(dv > du, pu, pv)
    normal = torch.where(pu == pv, pu,
                         torch.where(divu | divv, mirror, degree))
    if live is not None:
        normal = torch.where(live, normal, torch.full_like(normal, -1))
    return (pu.to(torch.int32).contiguous(), pv.to(torch.int32).contiguous(),
            normal.to(torch.int32).contiguous())


def transform_scan_plain(pu, pv, normal, k: int, lmax: float):
    """The walk in Python over host copies; returns on the inputs'
    device.  The cap test is an f32 compare, as in the reference's jit
    path: loads below 2**24 are exact in f32."""
    lmax = float(np.float32(lmax))
    loads = [0] * k
    out = []
    for a, b, nm in zip(pu.cpu().tolist(), pv.cpu().tolist(),
                        normal.cpu().tolist()):
        if nm < 0:
            out.append(0)
            continue
        la, lb = loads[a], loads[b]
        full_u = (la if la < 16777216 else float(np.float32(la))) >= lmax
        full_v = (lb if lb < 16777216 else float(np.float32(lb))) >= lmax
        p = nm
        if full_u or full_v:
            if not full_u:
                p = a
            elif not full_v:
                p = b
            else:
                p = loads.index(min(loads))
        out.append(p)
        loads[p] += 1
    return torch.tensor(out, dtype=torch.int32, device=pu.device)


def transform_scan(pu, pv, normal, k: int, lmax: float):
    """Edge → partition under the balance cap ``lmax`` (rounded to f32).
    Returns (E,) int32."""
    if pu.device.type == "cpu":
        return transform_scan_plain(pu, pv, normal, k, lmax)
    E = pu.shape[0]
    if pv.shape != (E,) or normal.shape != (E,) or not 0 < k <= MAX_K:
        raise ValueError("transform_scan: inconsistent shapes or k")
    if {pu.dtype, pv.dtype, normal.dtype} != {torch.int32}:
        raise ValueError("transform_scan: inputs must be int32")
    _build.require_cuda(pu, pv, normal)
    out = torch.empty(E, dtype=torch.int32, device=pu.device)
    _build.launch("transform_scan", "t_transform_scan", pu, pv, normal, out,
                  int(E), int(k), float(lmax))
    return out
