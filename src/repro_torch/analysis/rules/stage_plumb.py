"""STAGE-PLUMB: strategies compose stages; they may not re-plumb stage
internals.

``src/repro_torch/core/partitioner.py`` holds the partitioning
*strategies* (the torch, np and sharded backends, the sweep) — they go
through ``run_clugp_body`` / the ``core.stages`` tables, not the
pass-level functions (clustering, the game's rounds, the transform, the
restream majority) or their kernels' wrappers.  Keeping the strategies
free of them is what makes every strategy run the ONE pipeline body the
tests and ``chip_smoke.py`` cover.  Any identifier reference to a stage
internal (name, attribute or import) is a finding.
"""
from __future__ import annotations

import ast

from ..lint import Rule

# the port's pass-level functions that only the stage layer may touch;
# prefix-matched, so e.g. majority_vertex_map_np and game_rounds_gs are
# covered.  The reference's jax_game_rounds is the port's game_rounds;
# its transform_jax is the port's core.transform.transform, whose bare
# name is also its module's, so the rule holds the pass by its kernel
# wrapper transform_scan
STAGE_INTERNALS = (
    "streaming_clustering",
    "localize_stream",
    "cluster_pass",
    "game_rounds",
    "best_response_rounds",
    "transform_np",
    "transform_scan",
    "majority_vertex_map",
)


def _match(name: str) -> str | None:
    for forb in STAGE_INTERNALS:
        if name == forb or name.startswith(forb + "_"):
            return forb
    return None


class StagePlumb(Rule):
    id = "STAGE-PLUMB"
    description = ("strategies (core/partitioner.py) may not call stage "
                   "internals — compose run_clugp_body / stages instead")
    roots = ("src/repro_torch/core/partitioner.py",)

    def run(self, tree, relpath, text):
        out = []
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                forb = _match(node.id)
                if forb:
                    out.append(self.finding(
                        relpath, node, forb,
                        f"strategy references stage internal {node.id!r}"))
            elif isinstance(node, ast.Attribute):
                forb = _match(node.attr)
                if forb:
                    out.append(self.finding(
                        relpath, node, forb,
                        f"strategy references stage internal {node.attr!r}"))
            elif isinstance(node, ast.ImportFrom):
                for alias in node.names:
                    forb = _match(alias.name)
                    if forb:
                        out.append(self.finding(
                            relpath, node, forb,
                            f"strategy imports stage internal "
                            f"{alias.name!r}"))
        return out
