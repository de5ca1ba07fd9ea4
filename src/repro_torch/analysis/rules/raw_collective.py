"""RAW-COLLECTIVE: ``torch.distributed`` goes through
``repro_torch.dist.collectives``.

That module is the port's one door to ``torch.distributed``: it counts
every call's bytes, seconds and calls by call site (what the graph
dry-run reads), stages CUDA tensors to the host on gloo and makes float
sums deterministic.  A raw ``torch.distributed`` call elsewhere bypasses
all of it.  Flags, anywhere under ``src/repro_torch`` except
``dist/collectives.py``, a collective, point-to-point or group call
reached as ``<alias>.<op>`` where the alias is bound to
``torch.distributed`` (``import torch.distributed as dist``, ``from torch
import distributed``), as ``torch.distributed.<op>``, or imported with
``from torch.distributed import <op>``.  The reference's door is all of
``repro/dist`` (``lax.<collective>`` elsewhere); the port's is narrower.
"""
from __future__ import annotations

import ast

from ..lint import Rule

MODULE = "torch.distributed"
COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "all_to_all", "all_to_all_single", "broadcast",
    "broadcast_object_list", "reduce", "reduce_scatter",
    "reduce_scatter_tensor", "gather", "gather_object", "scatter",
    "scatter_object_list", "send", "recv", "isend", "irecv",
    "batch_isend_irecv", "P2POp", "barrier", "monitored_barrier",
    "init_process_group", "new_group", "destroy_process_group",
})


def _dotted(node: ast.expr) -> str | None:
    """`torch.distributed` → "torch.distributed"; None if not a pure
    chain of names."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _aliases(tree: ast.Module) -> set[str]:
    """Names the file binds to the ``torch.distributed`` module."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == MODULE and a.asname:
                    out.add(a.asname)
        elif isinstance(node, ast.ImportFrom) and node.module == "torch":
            for a in node.names:
                if a.name == "distributed":
                    out.add(a.asname or a.name)
    return out


class RawCollective(Rule):
    id = "RAW-COLLECTIVE"
    description = ("no raw torch.distributed collectives outside "
                   "repro_torch/dist/collectives.py — route through "
                   "repro_torch.dist.collectives")
    roots = ("src/repro_torch",)
    excludes = ("src/repro_torch/dist/collectives.py",
                "src/repro_torch/analysis")

    def run(self, tree, relpath, text):
        aliases = _aliases(tree)
        out = []
        for node in ast.walk(tree):
            if (isinstance(node, ast.Attribute)
                    and node.attr in COLLECTIVES):
                owner = _dotted(node.value)
                if owner == MODULE or owner in aliases:
                    out.append(self.finding(
                        relpath, node, node.attr,
                        f"raw torch.distributed.{node.attr} — route "
                        f"through repro_torch.dist.collectives"))
            elif (isinstance(node, ast.ImportFrom)
                  and node.module == MODULE):
                for alias in node.names:
                    if alias.name in COLLECTIVES:
                        out.append(self.finding(
                            relpath, node, alias.name,
                            f"imports {alias.name} from torch.distributed "
                            f"— route through repro_torch.dist.collectives"))
        return out
