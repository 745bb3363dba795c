"""The port's KFRM rules, one visitor class each (counterpart of
``kubeflow_rm_tpu/analysis/lint/rules.py``).

| Rule    | Invariant                                                   |
|---------|-------------------------------------------------------------|
| KFRM001-005 | the control plane's locking rules: not in this copy; they come with the port's lock factory and serving fleet, the first port code that takes locks |
| KFRM006 | no scalar host sync in a hot region inside a loop           |
| KFRM007 | no ``torch.compile`` or CUDA graph built inside a loop body |
| KFRM008 | no carried state or gradient tree rebuilt out of place in a loop |

KFRM006-008 are the static half of ``analysis/torchcheck``: each encodes
a stall or memory class one of its dynamic probes (``hostsync``,
``recompile``, ``costmodel``) shows at run time. The JAX rules key on
``jax.jit``; the port runs eagerly, so each rule below states its torch
meaning beside the JAX rule it mirrors.

All are heuristics biased toward catching real violations in this
codebase's idiom; the escape hatch for a justified exception is a
``# kfrm: disable=RULE`` comment with a rationale next to it.
"""

from __future__ import annotations

import ast

from .base import Rule, dotted, terminal_name

#: ``with`` targets that open a hot region: the host-sync probe's
#: ``hostsync.region(...)`` and the profiler's ``profiling.annotate(...)``
HOT_REGIONS = frozenset({"region", "annotate"})
#: ``hostsync.sanctioned(...)``: syncs under it are the feature
SANCTIONED = frozenset({"sanctioned"})


class _ScopedRule(Rule):
    """Depth counters (loops, hot regions, sanctioned sites) with the JAX
    rules' scope convention: nested function and lambda bodies run later,
    not per iteration nor inside the region, so every depth resets across
    them (their decorators and defaults run where they are written)."""

    def __init__(self, path: str):
        super().__init__(path)
        self._depth = {"loop": 0, "region": 0, "sanctioned": 0}

    def _visit_loop(self, node) -> None:
        self._depth["loop"] += 1
        try:
            self.generic_visit(node)
        finally:
            self._depth["loop"] -= 1

    visit_For = visit_AsyncFor = visit_While = _visit_loop

    def _visit_with(self, node) -> None:
        kinds = [terminal_name(item.context_expr) for item in node.items
                 if isinstance(item.context_expr, ast.Call)]
        opened = {"region": sum(k in HOT_REGIONS for k in kinds),
                  "sanctioned": sum(k in SANCTIONED for k in kinds)}
        for item in node.items:
            self.visit(item)
        for k, n in opened.items():
            self._depth[k] += n
        try:
            for stmt in node.body:
                self.visit(stmt)
        finally:
            for k, n in opened.items():
                self._depth[k] -= n

    visit_With = visit_AsyncWith = _visit_with

    def _visit_scope(self, node) -> None:
        for dec in getattr(node, "decorator_list", ()):
            self.visit(dec)
        self.visit(node.args)
        saved = dict(self._depth)
        self._depth = dict.fromkeys(saved, 0)
        try:
            body = node.body if isinstance(node.body, list) else [node.body]
            for stmt in body:
                self.visit(stmt)
        finally:
            self._depth = saved

    visit_FunctionDef = visit_AsyncFunctionDef = _visit_scope
    visit_Lambda = _visit_scope


class ScalarSyncInHotLoop(_ScopedRule):
    """KFRM006: a scalar host sync in a hot region inside a loop.

    JAX's rule flags ``int()``/``.item()``/``np.asarray()`` on a jitted
    call's result inside a loop: a device→host round trip every
    iteration. The port has no jit; its hot code is what it marks with
    ``hostsync.region(...)`` or ``profiling.annotate(...)``, the regions
    the dynamic probe (``torchcheck/hostsync.py``) watches. So the rule
    flags, lexically inside such a ``with`` block and inside a loop
    (either around the other), ``int()``, ``float()`` or ``bool()`` of a
    call, ``.item()``, ``.tolist()`` or ``.numpy()``, and ``np.asarray``
    or ``np.array`` of a call: on a CUDA tensor each waits for the
    card's queue to drain. Read the value outside the region (a metric
    at a log boundary), or keep the consumer on the card. Syncs under
    ``hostsync.sanctioned(...)`` are the feature and pass."""

    rule_id = "KFRM006"
    synopsis = "scalar host sync in a hot region inside a loop"

    _SYNC_BUILTINS = {"int", "float", "bool"}
    _SYNC_ATTRS = {"item", "tolist", "numpy"}
    _SYNC_DOTTED = {"np.asarray", "np.array", "numpy.asarray",
                    "numpy.array"}

    def visit_Call(self, node: ast.Call) -> None:
        d = self._depth
        if d["loop"] and d["region"] and not d["sanctioned"]:
            sync = None
            first = node.args[0] if node.args else None
            if isinstance(node.func, ast.Name) and \
                    node.func.id in self._SYNC_BUILTINS and \
                    isinstance(first, ast.Call):
                sync = f"{node.func.id}()"
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in self._SYNC_ATTRS:
                sync = f".{node.func.attr}()"
            elif dotted(node.func) in self._SYNC_DOTTED and \
                    isinstance(first, ast.Call):
                sync = f"{dotted(node.func)}()"
            if sync:
                self.emit(node, f"{sync} inside a hot region in a loop "
                                f"waits on the card every iteration — "
                                f"read it outside the region, or keep "
                                f"the consumer on the card")
        self.generic_visit(node)


class CaptureInLoop(_ScopedRule):
    """KFRM007: ``torch.compile(...)``, ``torch.cuda.CUDAGraph()`` or
    ``torch.cuda.graph(...)`` built inside a loop body.

    JAX's rule flags ``jax.jit`` constructed in a loop: a fresh trace
    cache per iteration, nothing reused. The port's counterparts of a
    compile cache are a ``torch.compile`` wrapper (its own guard and
    graph cache) and a captured CUDA graph: built per iteration, each is
    compiled or captured again every time. Build one outside the loop.
    The dynamic twin is ``torchcheck.recompile``."""

    rule_id = "KFRM007"
    synopsis = "torch.compile or a CUDA graph built inside a loop body"

    _BUILDERS = {"torch.compile", "torch.cuda.CUDAGraph", "torch.cuda.graph"}

    def run(self, tree: ast.AST) -> list:
        # ``from torch import compile`` / ``from torch.cuda import graph``
        self._refs = set(self._BUILDERS)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module in (
                    "torch", "torch.cuda"):
                for alias in node.names:
                    if f"{node.module}.{alias.name}" in self._BUILDERS:
                        self._refs.add(alias.asname or alias.name)
        return super().run(tree)

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted(node.func)
        if self._depth["loop"] and name in self._refs:
            self.emit(node, f"{name} built inside a loop — compiled or "
                            f"captured again every iteration; build it "
                            f"once outside the loop")
        self.generic_visit(node)


def _is_carried(name: str) -> bool:
    """A name that holds the step's carried state or gradient tree:
    ``state``, ``cache``, ``*_state``, ``*_cache``, ``grads``,
    ``acc*``."""
    return (name in ("state", "cache", "grads")
            or name.endswith(("_state", "_cache"))
            or name.startswith("acc"))


_COMPREHENSIONS = (ast.ListComp, ast.DictComp, ast.SetComp,
                   ast.GeneratorExp)


def _operand_reads(node: ast.AST, name: str) -> bool:
    """``name`` read as a value or a subscript base (``x``, ``x[k]``), not
    through an attribute (``x.offset``: a scalar the state carries)."""
    if isinstance(node, ast.Attribute):
        return False
    if isinstance(node, ast.Name):
        return node.id == name and isinstance(node.ctx, ast.Load)
    return any(_operand_reads(c, name) for c in ast.iter_child_nodes(node))


def _rebuilds(value: ast.AST, name: str) -> bool:
    """``value`` (or a branch of it) is arithmetic or a comprehension over
    ``name``'s old value; a call's arguments are the callee's business."""
    if isinstance(value, ast.IfExp):
        return _rebuilds(value.body, name) or _rebuilds(value.orelse, name)
    if isinstance(value, _COMPREHENSIONS):
        return any(isinstance(n, ast.Name) and n.id == name
                   for n in ast.walk(value))
    if isinstance(value, ast.BinOp):
        return _operand_reads(value, name)
    return False


class CarriedStateOutOfPlace(_ScopedRule):
    """KFRM008: carried state rebuilt out of place inside a loop.

    JAX's rule flags a jitted step that does not donate its
    ``state``/``cache`` argument: XLA keeps the old buffer live across
    the call and the step double-buffers the largest allocation. Eager
    PyTorch has no donation; the same purpose, never holding the largest
    carried tree twice, is kept by updating in place. So the rule flags,
    inside a loop, a name bound to carried state (``state``, ``cache``,
    ``*_state``, ``*_cache``, ``grads``, ``acc*``) rebound to arithmetic
    on its own old value or a comprehension over it, directly or in a
    branch of a conditional (``x = {k: x[k] + y[k] for k in x}``,
    ``x = x + y``): the old tree, the operand and the new tree are alive
    at once. Add into the old tree in place (``x[k].add_(y[k])``). A
    call that takes the old value (``cache = rewind(cache, n)``) and
    arithmetic on its attributes (``cache.offset - 1``) are not flagged.
    The dynamic twin is the cost model's live-range peak
    (``torchcheck.costmodel``)."""

    rule_id = "KFRM008"
    synopsis = "carried state rebuilt out of place inside a loop"

    def visit_Assign(self, node: ast.Assign) -> None:
        target = node.targets[0] if len(node.targets) == 1 else None
        if self._depth["loop"] and isinstance(target, ast.Name) and \
                _is_carried(target.id) and _rebuilds(node.value, target.id):
            self.emit(node, f"'{target.id}' is rebuilt out of place from "
                            f"its own old value inside a loop — the old "
                            f"and new trees are alive at once; update it "
                            f"in place")
        self.generic_visit(node)


ALL_RULES: tuple[type[Rule], ...] = (
    ScalarSyncInHotLoop,
    CaptureInLoop,
    CarriedStateOutOfPlace,
)
