"""The port's static lint: runner and file walker (counterpart of
``kubeflow_rm_tpu/analysis/lint``).

``python -m kubeflow_rm_tpu_torch.analysis.lint kubeflow_rm_tpu_torch``
walks the tree, runs every rule over each ``.py`` file, filters findings
through ``# kfrm: disable=`` comments, and exits non-zero if anything
survives. ``python -m kubeflow_rm_tpu_torch.analysis.torchcheck`` runs
the same rules beside the cost model's self-check.
"""

from __future__ import annotations

import ast
import os

from .base import Finding, parse_disables
from .rules import ALL_RULES, Rule

__all__ = ["ALL_RULES", "ALLOWLIST", "Finding", "Rule", "lint_source",
           "lint_paths", "iter_python_files"]

#: files where a rule is structurally inapplicable, by rule id (path
#: suffixes); every other finding is fixed or disabled inline with a
#: reason. ``lockgraph.py`` IS the lock factory: it must make raw
#: primitives, and each of its sites carries an inline reason too.
ALLOWLIST: dict[str, tuple[str, ...]] = {
    "KFRM001": ("kubeflow_rm_tpu_torch/analysis/lockgraph.py",),
}


def _norm(path: str) -> str:
    return path.replace(os.sep, "/")


def _allowlisted(rule_id: str, path: str) -> bool:
    return any(_norm(path).endswith(suffix)
               for suffix in ALLOWLIST.get(rule_id, ()))


def lint_source(source: str, path: str,
                rule_ids: set[str] | None = None) -> list[Finding]:
    """Lint one file's source. ``rule_ids`` restricts to a subset
    (default: all). A syntax error is reported as rule KFRM000 rather
    than aborting the run."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding("KFRM000", path, exc.lineno or 0,
                        exc.offset or 0, f"syntax error: {exc.msg}")]
    file_wide, per_line = parse_disables(source)
    findings: list[Finding] = []
    for cls in ALL_RULES:
        if rule_ids is not None and cls.rule_id not in rule_ids:
            continue
        if cls.rule_id in file_wide or _allowlisted(cls.rule_id, path):
            continue
        findings.extend(cls(path).run(tree))
    kept = [f for f in findings
            if f.rule not in per_line.get(f.line, ())]
    return sorted(kept, key=lambda f: (f.path, f.line, f.col, f.rule))


def iter_python_files(paths: list[str]):
    for path in paths:
        if os.path.isfile(path):
            yield path
            continue
        for root, dirs, files in os.walk(path):
            dirs[:] = sorted(d for d in dirs
                             if not d.startswith(".")
                             and d != "__pycache__")
            for name in sorted(files):
                if name.endswith(".py"):
                    yield os.path.join(root, name)


def lint_paths(paths: list[str],
               rule_ids: set[str] | None = None) -> list[Finding]:
    findings: list[Finding] = []
    for path in iter_python_files(paths):
        with open(path, encoding="utf-8") as f:
            findings.extend(lint_source(f.read(), path, rule_ids))
    return findings
