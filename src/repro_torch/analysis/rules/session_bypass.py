"""SESSION-BYPASS: the port's launchers and the examples' twins drive
``GraphSession`` — they don't hand-wire partition → layout → engine.

``GraphSession`` owns the device, the layout's cached tables and the
serving lifecycle; an entry point that calls ``build_layout`` or
``simulate_gas`` directly gets none of that and silently forks the
supported path.  Scans ``src/repro_torch/launch`` and
``examples/*_torch.py``; an entry point that measures the primitives
themselves goes in the allowlist with its reason.
"""
from __future__ import annotations

import ast

from ..lint import Rule

ENGINE_INTERNALS = frozenset({
    "build_layout", "build_layout_reference",
    "simulate_gas", "simulate_gas_many",
    "shard_map_gas", "shard_map_gas_many",
    "simulate_pagerank", "simulate_cc",
    "shard_map_pagerank", "shard_map_cc",
    "gas_step_for_dryrun",
})


class SessionBypass(Rule):
    id = "SESSION-BYPASS"
    description = ("entry points (repro_torch/launch, the examples' "
                   "*_torch.py twins) drive GraphSession, not raw "
                   "layout/engine internals")
    roots = ("src/repro_torch/launch", "examples")

    def applies_to(self, relpath: str) -> bool:
        rp = relpath.replace("\\", "/")
        if rp.startswith("examples/"):
            return rp.endswith("_torch.py")
        return super().applies_to(rp)

    def run(self, tree, relpath, text):
        out = []
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            name = (fn.id if isinstance(fn, ast.Name)
                    else fn.attr if isinstance(fn, ast.Attribute)
                    else None)
            if name in ENGINE_INTERNALS:
                out.append(self.finding(
                    relpath, node, name,
                    f"calls engine internal {name}() — drive GraphSession "
                    f"instead"))
        return out
