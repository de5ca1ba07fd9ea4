"""CLI: ``python -m repro_torch.analysis --check``.

Runs the source lint, prints its findings, writes the artifact to
``results/ANALYSIS_torch.json`` (or ``--json PATH``) and exits non-zero
on any non-allowlisted finding, allowlist-count mismatch or file that
does not parse.  ``--check`` is accepted for symmetry with the other
gates (``launch.dryrun --check``); it is the default and only
behaviour.  The reference's ``--ir`` self-audit has no counterpart: the
port compiles nothing.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .lint import repo_root, run_lint


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    ap.add_argument("--check", action="store_true",
                    help="run the lint gate (default behaviour)")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="artifact path (default results/ANALYSIS_torch."
                         "json under the repo root)")
    ap.add_argument("--root", default=None,
                    help="tree to lint (default: the repo root)")
    ap.add_argument("--verbose", action="store_true",
                    help="also print allowlisted findings")
    args = ap.parse_args(argv)

    root = Path(args.root) if args.root else repo_root()
    report = run_lint(root=root)
    print(report.format(verbose=args.verbose))
    out = Path(args.json_out) if args.json_out \
        else root / "results" / "ANALYSIS_torch.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(report.summary_rows(), indent=1))
    print(f"wrote {out}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
