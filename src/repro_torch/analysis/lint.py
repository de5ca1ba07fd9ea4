"""AST lint engine: rules, findings, the tracked allowlist, reporting.

Port of ``repro.analysis.lint``, the same engine.  A ``Rule`` owns its
scan scope (``roots``/``excludes``, repo-relative) and emits
``Finding``s with a *stable key* (the offending symbol, not a line
number) so allowlist entries survive unrelated edits.  The engine parses
each file once, fans the tree out to every rule in scope, then
reconciles findings against the allowlist:

- a finding matched by an entry is demoted from violation to
  ``allowlisted`` (it still lands in ``results/ANALYSIS_torch.json``
  with the flag, so the burn-down is visible in the artifact);
- an entry whose match count differs from its recorded ``count`` is an
  engine error either way — more matches is a regression, fewer means
  the entry must be tightened or deleted.  Counts only burn down.

``run_lint()`` is what ``python -m repro_torch.analysis --check`` and
``tests/test_torch_analysis.py`` both call.  It takes any rule objects
with ``id``, ``roots``, ``applies_to`` and ``run`` and any allowlist
entries with ``rule``, ``path``, ``key``, ``count`` and ``why``.
"""
from __future__ import annotations

import ast
import json
from dataclasses import dataclass, field, replace
from pathlib import Path

SKIP_DIRS = {"__pycache__", ".git", ".ruff_cache", "results",
             ".pytest_cache", "node_modules"}


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str           # repo-relative, posix separators
    line: int
    col: int
    key: str            # stable, rule-specific (offending symbol)
    message: str
    severity: str = "error"
    allowlisted: bool = False
    justification: str = ""

    @property
    def location(self) -> str:
        return f"{self.path}:{self.line}"


@dataclass(frozen=True)
class Allow:
    """One tracked exemption: ``count`` occurrences of ``key`` under
    ``rule`` in ``path``, with a one-line justification.  The engine
    errors when the live count drifts from ``count`` in either
    direction — the list can only shrink deliberately."""
    rule: str
    path: str
    key: str
    count: int
    why: str


class Rule:
    """Base rule: subclasses set ``id``/``description``/``roots`` and
    implement ``run(tree, relpath, text) -> list[Finding]``."""

    id: str = "?"
    description: str = ""
    roots: tuple[str, ...] = ("src/repro_torch",)
    excludes: tuple[str, ...] = ()

    def applies_to(self, relpath: str) -> bool:
        rp = relpath.replace("\\", "/")
        hit = any(rp == r or rp.startswith(r.rstrip("/") + "/")
                  for r in self.roots)
        return hit and not any(rp == e or rp.startswith(e.rstrip("/") + "/")
                               for e in self.excludes)

    def run(self, tree: ast.Module, relpath: str,
            text: str) -> list[Finding]:
        raise NotImplementedError

    def finding(self, relpath: str, node: ast.AST, key: str,
                message: str) -> Finding:
        return Finding(rule=self.id, path=relpath,
                       line=getattr(node, "lineno", 0),
                       col=getattr(node, "col_offset", 0),
                       key=key, message=message)


@dataclass
class Report:
    root: str
    findings: list[Finding] = field(default_factory=list)
    errors: list[str] = field(default_factory=list)   # allowlist mismatches
    parse_failures: list[str] = field(default_factory=list)
    rules: tuple = ()

    @property
    def violations(self) -> list[Finding]:
        return [f for f in self.findings if not f.allowlisted]

    @property
    def ok(self) -> bool:
        return not self.violations and not self.errors \
            and not self.parse_failures

    def by_rule(self, rule_id: str) -> list[Finding]:
        return [f for f in self.findings if f.rule == rule_id]

    def summary_rows(self) -> list[dict]:
        """One trend-diffable row per rule (+ a TOTAL row): ``rule`` is
        the identity, finding counts are lower-is-better numerics, and
        the per-finding detail rides along as a non-numeric list."""
        rows = []
        for rule in self.rules:
            fs = self.by_rule(rule.id)
            allowed = [f for f in fs if f.allowlisted]
            rows.append({
                "bench": "static_analysis", "rule": rule.id,
                "findings": len(fs), "allowlisted": len(allowed),
                "violations": len(fs) - len(allowed),
                "detail": [f"{f.location} {f.key}"
                           + (" [allowlisted]" if f.allowlisted else "")
                           for f in fs],
            })
        rows.append({
            "bench": "static_analysis", "rule": "TOTAL",
            "findings": len(self.findings),
            "allowlisted": sum(f.allowlisted for f in self.findings),
            "violations": len(self.violations),
            "errors": len(self.errors) + len(self.parse_failures),
        })
        return rows

    def format(self, verbose: bool = False) -> str:
        lines = []
        for f in sorted(self.findings,
                        key=lambda f: (f.rule, f.path, f.line)):
            if f.allowlisted and not verbose:
                continue
            tag = " [allowlisted]" if f.allowlisted else ""
            lines.append(f"{f.location}: {f.rule}: {f.message}{tag}")
        lines += [f"allowlist error: {e}" for e in self.errors]
        lines += [f"parse error: {e}" for e in self.parse_failures]
        n_allow = sum(f.allowlisted for f in self.findings)
        lines.append(f"{len(self.findings)} finding(s): "
                     f"{len(self.violations)} violation(s), "
                     f"{n_allow} allowlisted; "
                     f"{len(self.errors)} allowlist error(s)")
        return "\n".join(lines)


def repo_root() -> Path:
    """Nearest ancestor of this file carrying pyproject.toml — the tree
    the default scan covers."""
    p = Path(__file__).resolve()
    for parent in p.parents:
        if (parent / "pyproject.toml").exists():
            return parent
    # editable installs always hit pyproject above; a site-packages
    # install has no tree to lint — caller must pass root explicitly
    raise RuntimeError("repro_torch.analysis: could not locate the repo "
                       "root "
                       "(no pyproject.toml above the package); pass "
                       "root= explicitly")


def iter_python_files(root: Path, subdirs) -> list[Path]:
    out = []
    for sub in subdirs:
        base = root / sub
        if base.is_file() and base.suffix == ".py":
            out.append(base)
            continue
        if not base.is_dir():
            continue
        for p in sorted(base.rglob("*.py")):
            if not any(part in SKIP_DIRS for part in p.parts):
                out.append(p)
    # a file can sit under two roots (e.g. "src" and "src/repro_torch/launch")
    seen, uniq = set(), []
    for p in out:
        if p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq


def lint_file(path: Path, relpath: str, rules) -> tuple[list[Finding],
                                                        str | None]:
    """Parse one file and run every in-scope rule.  Returns (findings,
    parse-error-or-None)."""
    try:
        text = path.read_text()
        tree = ast.parse(text, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError) as e:
        return [], f"{relpath}: {type(e).__name__}: {e}"
    found = []
    for rule in rules:
        if rule.applies_to(relpath):
            found.extend(rule.run(tree, relpath, text))
    return found, None


def _apply_allowlist(findings: list[Finding], allowlist) -> tuple[
        list[Finding], list[str]]:
    errors = []
    out = list(findings)
    for entry in allowlist:
        idxs = [i for i, f in enumerate(out)
                if f.rule == entry.rule and f.path == entry.path
                and f.key == entry.key]
        for i in idxs:
            out[i] = replace(out[i], allowlisted=True,
                             justification=entry.why)
        if len(idxs) != entry.count:
            direction = ("regressed — fix the new sites or justify them"
                         if len(idxs) > entry.count else
                         "burned down — shrink the entry's count (or "
                         "delete it) so it cannot grow back")
            errors.append(
                f"{entry.rule} @ {entry.path} key={entry.key!r}: "
                f"allowlist says {entry.count}, tree has {len(idxs)} — "
                f"{direction}")
    return out, errors


def run_lint(root: Path | str | None = None, rules=None,
             allowlist=None) -> Report:
    """Lint the tree under ``root`` (default: the repo) with ``rules``
    (default: the full registry) against ``allowlist`` (default: the
    tracked ``repro_torch.analysis.allowlist.ALLOWLIST``)."""
    if rules is None:
        from .rules import DEFAULT_RULES
        rules = DEFAULT_RULES
    if allowlist is None:
        from .allowlist import ALLOWLIST
        allowlist = ALLOWLIST
    root = Path(root) if root is not None else repo_root()
    # a partial-rule run (pytest wrappers) must not reconcile entries
    # belonging to rules that never scanned
    active = {rule.id for rule in rules}
    allowlist = [a for a in allowlist if a.rule in active]
    subdirs = sorted({r for rule in rules for r in rule.roots})
    report = Report(root=str(root), rules=tuple(rules))
    for path in iter_python_files(root, subdirs):
        relpath = path.relative_to(root).as_posix()
        found, err = lint_file(path, relpath, rules)
        report.findings.extend(found)
        if err:
            report.parse_failures.append(err)
    report.findings, report.errors = _apply_allowlist(report.findings,
                                                      allowlist)
    return report


def write_json(report: Report, out_path: Path) -> list[dict]:
    """Write the artifact: one summary row a rule (its findings in
    detail) and a TOTAL row — a flat list."""
    rows = report.summary_rows()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rows, indent=1))
    return rows
