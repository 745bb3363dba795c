"""Shared machinery for the port's KFRM lint rules (counterpart of
``kubeflow_rm_tpu/analysis/lint/base.py``).

Each rule is an :class:`ast.NodeVisitor` subclass that appends
:class:`Finding` records. Findings are line-addressed and
machine-readable (``as_dict``); the runner filters them through
``# kfrm: disable=RULE`` comments before reporting.

- **lockish** — an expression reads as a lock if its terminal name (the
  last attribute/name segment, unwrapping a call) matches
  ``(?i)(lock|cond|cv|guard|mutex)``. Deliberately broad: the port
  names every lock that way, a false positive on a ``with`` statement
  is cheap to silence with a disable comment, and a miss would exempt a
  critical section silently.
- **disable comments** — ``# kfrm: disable=KFRM006`` silences rules on
  that line; ``# kfrm: disable-file=KFRM006`` silences them for the
  whole file. Both accept a comma-separated list and should carry a
  rationale in the surrounding text.
"""

from __future__ import annotations

import ast
import dataclasses
import re

LOCKISH = re.compile(r"(?i)(lock|cond|cv|guard|mutex)")

_DISABLE = re.compile(
    r"#\s*kfrm:\s*disable(?P<file>-file)?\s*=\s*"
    r"(?P<rules>[A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def parse_disables(source: str) -> tuple[set, dict]:
    """Extract ``# kfrm: disable=`` comments: (file-wide rule set,
    {lineno: rule set})."""
    file_wide: set[str] = set()
    per_line: dict[int, set[str]] = {}
    for lineno, text in enumerate(source.splitlines(), start=1):
        m = _DISABLE.search(text)
        if not m:
            continue
        rules = {r.strip().upper()
                 for r in m.group("rules").split(",") if r.strip()}
        if m.group("file"):
            file_wide |= rules
        else:
            per_line.setdefault(lineno, set()).update(rules)
    return file_wide, per_line


def terminal_name(node: ast.AST) -> str | None:
    """The last name segment of an expression: ``a.b.c`` -> ``c``,
    ``f(x).region`` -> ``region``, ``name`` -> ``name``."""
    while isinstance(node, ast.Call):
        node = node.func
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def dotted(node: ast.AST) -> str | None:
    """Render a pure Name/Attribute chain as ``a.b.c``; None if the
    chain contains anything else (calls, subscripts)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    parts.append(node.id)
    return ".".join(reversed(parts))


def is_lockish(node: ast.AST) -> bool:
    name = terminal_name(node)
    return bool(name and LOCKISH.search(name))


class Rule(ast.NodeVisitor):
    """Base class: one instance per (rule, file) pass."""

    rule_id = ""
    synopsis = ""

    def __init__(self, path: str):
        self.path = path
        self.findings: list[Finding] = []

    def emit(self, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            self.rule_id, self.path,
            getattr(node, "lineno", 0), getattr(node, "col_offset", 0),
            message))

    def run(self, tree: ast.AST) -> list[Finding]:
        self.visit(tree)
        return self.findings


class LockScopeRule(Rule):
    """Base for rules that fire only *lexically inside* a
    ``with <lockish>:`` body. Tracks nesting depth; nested function and
    lambda bodies run later (not under the lock at definition time), so
    the depth resets across them."""

    def __init__(self, path: str):
        super().__init__(path)
        self._depth = 0

    def visit_With(self, node: ast.With) -> None:
        locks = sum(1 for item in node.items
                    if is_lockish(item.context_expr))
        for item in node.items:
            self.visit(item)
        self._depth += locks
        try:
            for stmt in node.body:
                self.visit(stmt)
        finally:
            self._depth -= locks

    def _visit_scope(self, node) -> None:
        saved, self._depth = self._depth, 0
        try:
            self.generic_visit(node)
        finally:
            self._depth = saved

    def visit_FunctionDef(self, node) -> None:
        self._visit_scope(node)

    def visit_AsyncFunctionDef(self, node) -> None:
        self._visit_scope(node)

    def visit_Lambda(self, node) -> None:
        self._visit_scope(node)
