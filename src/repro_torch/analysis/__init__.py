"""Static analysis of the port: machine-checked architecture guardrails.

Port of ``repro.analysis``'s source lint: an AST rule engine
(``lint``: ``Finding``, ``Allow``, ``Rule``, ``Report``, ``lint_file``,
``run_lint`` and the exact-count burn-down of the tracked allowlist)
with the reference's rules pointed at the port (``rules``):

- RAW-COLLECTIVE: every ``torch.distributed`` collective, point-to-point
  or group call under ``src/repro_torch`` is in ``dist/collectives.py``,
  the one door;
- SESSION-BYPASS: the launchers (``src/repro_torch/launch``) and the
  examples' twins (``examples/*_torch.py``) drive ``GraphSession``, not
  the layout and engine internals;
- STAGE-PLUMB: the strategies (``core/partitioner.py``) touch no
  pass-level stage internal;
- DEPRECATED-API: no calls to the ``comm_bytes_*`` shims and no
  identifier references to the removed ``clugp_partition*`` entry points
  in the port, its examples' twins, its tests and ``chip_smoke.py``.

The reference's JIT-PURITY rule and its IR analyzers
(``repro.analysis.ir``) are not ported: they audit traced jaxprs and
compiled HLO, and the port traces and compiles nothing.  Its byte
counting is the graph dry-run's (``launch.dryrun``), over the bytes each
rank hands to ``dist.collectives``.

CLI: ``python -m repro_torch.analysis --check`` runs the lint, writes
``results/ANALYSIS_torch.json`` (or ``--json PATH``) and exits non-zero
on any non-allowlisted finding or allowlist count off in either
direction.
"""
from .lint import (Allow, Finding, Report, Rule,  # noqa: F401
                   lint_file, repo_root, run_lint)
