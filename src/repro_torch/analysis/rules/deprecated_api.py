"""DEPRECATED-API: no new callers of retired surfaces.

Two retired families, as in the reference:

- the per-wire ``comm_bytes_*`` methods (consolidated into the
  keyword-routed ``PartitionLayout.comm_bytes(...)`` and
  ``GraphSession.comm_bytes(...)``); the port keeps the shims, which
  warn, but its code must use the router.  The port's shim-equivalence
  test calls them through ``getattr`` by name, which is no finding.
- the removed ``clugp_partition`` / ``clugp_partition_parallel`` entry
  points.  Any *identifier* reference (name, attribute, import) is a
  finding; mentions inside strings and docstrings are fine.

Scans the port (``src/repro_torch``), its tests (``tests/test_torch_*``),
the examples' twins (``examples/*_torch.py``) and ``chip_smoke.py``.
"""
from __future__ import annotations

import ast

from ..lint import Rule

REMOVED_NAMES = frozenset({"clugp_partition", "clugp_partition_parallel"})
DEPRECATED_PREFIX = "comm_bytes_"


class DeprecatedApi(Rule):
    id = "DEPRECATED-API"
    description = ("no calls to the deprecated comm_bytes_* shims; no "
                   "identifier references to the removed clugp_partition* "
                   "entry points")
    roots = ("src/repro_torch", "examples", "tests", "chip_smoke.py")
    excludes = ("src/repro_torch/analysis",)

    def applies_to(self, relpath: str) -> bool:
        rp = relpath.replace("\\", "/")
        if rp.startswith("examples/"):
            return rp.endswith("_torch.py")
        if rp.startswith("tests/"):
            return rp.startswith("tests/test_torch_")
        return super().applies_to(rp)

    def run(self, tree, relpath, text):
        out = []
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr.startswith(DEPRECATED_PREFIX)):
                out.append(self.finding(
                    relpath, node, node.func.attr,
                    f"calls deprecated shim .{node.func.attr}() — use "
                    f"comm_bytes(...) / session.comm_bytes(...)"))
            elif isinstance(node, ast.Name) and node.id in REMOVED_NAMES:
                out.append(self.finding(
                    relpath, node, node.id,
                    f"references removed entry point {node.id!r}"))
            elif (isinstance(node, ast.Attribute)
                  and node.attr in REMOVED_NAMES):
                out.append(self.finding(
                    relpath, node, node.attr,
                    f"references removed entry point {node.attr!r}"))
            elif isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    if alias.name in REMOVED_NAMES:
                        out.append(self.finding(
                            relpath, node, alias.name,
                            f"imports removed entry point {alias.name!r}"))
        return out
