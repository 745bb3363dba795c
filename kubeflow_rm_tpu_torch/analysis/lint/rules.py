"""The port's KFRM rules, one visitor class each (counterpart of
``kubeflow_rm_tpu/analysis/lint/rules.py``).

| Rule    | Invariant                                                   |
|---------|-------------------------------------------------------------|
| KFRM001 | locks come from the ``analysis.lockgraph`` factory          |
| KFRM002 | no blocking call lexically inside ``with <lock>:``          |
| KFRM003 | manual ``.acquire()`` has a ``try/finally`` release         |
| KFRM004 | no apiserver/kubeclient write while a lock is held          |
| KFRM005 | ``except Exception:`` must log, count, or re-raise          |
| KFRM006 | no scalar host sync in a hot region inside a loop           |
| KFRM007 | no ``torch.compile`` or CUDA graph built inside a loop body |
| KFRM008 | no carried state or gradient tree rebuilt out of place in a loop |

KFRM001-005 audit the locking of the port's serving fleet, gateway and
probes; they are plain Python and JAX's rules word for word.
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

from .base import LockScopeRule, Rule, dotted, is_lockish, terminal_name

_THREADING_PRIMITIVES = ("Lock", "RLock", "Condition")

# Calls that park the thread in the kernel (or for unbounded time)
# while any lock is held. ``.wait`` is deliberately absent: a condvar
# wait RELEASES its lock for the duration.
BLOCKING_DOTTED = {
    "time.sleep",
    "os.fsync", "os.fdatasync",
    "socket.create_connection",
    "subprocess.run", "subprocess.call", "subprocess.check_call",
    "subprocess.check_output", "subprocess.Popen",
    "urllib.request.urlopen",
}
BLOCKING_ATTRS = {
    "fsync", "fdatasync",          # durability
    "sendall", "recv", "recv_into", "accept",  # sockets
    "getresponse",                 # http.client round trip
    "result",                      # Future.result parks the caller
}

WRITE_VERBS = {
    "create", "create_many", "update", "update_status", "patch",
    "delete", "record_event",
}
# receivers that read as an apiserver/kubeclient handle; bare ``self``
# is excluded so the apiserver's own verb implementations (which run
# under their kind lock by design) don't self-flag
CLIENTISH = {
    "api", "kapi", "capi", "client", "kube", "kubeclient", "_api",
    "backend",
}

# a handler is non-silent if it raises or calls one of these
_HANDLED_CALLS = {
    "debug", "info", "warning", "warn", "error", "exception", "log",
    "critical",                   # logging
    "inc", "observe", "swallowed",  # metrics
    "print_exc",                  # traceback (tests/tools)
}


class RawLockConstruction(Rule):
    """KFRM001: construct locks through ``lockgraph.make_lock`` /
    ``make_rlock`` / ``make_condition``, never ``threading.Lock()``
    directly — otherwise the dynamic analysis is blind to them."""

    rule_id = "KFRM001"
    synopsis = ("raw threading.Lock/RLock/Condition construction "
                "outside the lockgraph factory")

    def __init__(self, path: str):
        super().__init__(path)
        # local name -> the primitive it was imported as
        self._from_imports: dict[str, str] = {}

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.module == "threading":
            for alias in node.names:
                if alias.name in _THREADING_PRIMITIVES:
                    self._from_imports[alias.asname or alias.name] = \
                        alias.name
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted(node.func)
        hit = prim = None
        if name and name.startswith("threading."):
            prim = name.split(".", 1)[1]
            if prim in _THREADING_PRIMITIVES:
                hit = name
        elif isinstance(node.func, ast.Name) and \
                node.func.id in self._from_imports:
            hit = node.func.id
            # JAX's rule looks an alias (``RLock as R``) up by its local
            # name and raises KeyError; the port names the primitive
            prim = self._from_imports[hit]
        if hit:
            factory = {"Lock": "make_lock", "RLock": "make_rlock",
                       "Condition": "make_condition"}[prim]
            self.emit(node, f"raw {hit}() — use "
                            f"analysis.lockgraph.{factory}(name) so the "
                            f"dynamic analysis can see this lock")
        self.generic_visit(node)


class BlockingUnderLock(LockScopeRule):
    """KFRM002: a blocking call lexically inside a ``with <lock>:``
    body serializes every other thread contending for that lock behind
    a syscall/network round trip."""

    rule_id = "KFRM002"
    synopsis = "blocking call lexically inside a with-lock body"

    def visit_Call(self, node: ast.Call) -> None:
        if self._depth > 0:
            name = dotted(node.func)
            hit = name if name in BLOCKING_DOTTED else None
            if hit is None and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in BLOCKING_ATTRS:
                hit = f".{node.func.attr}"
            if hit:
                self.emit(node, f"blocking call {hit}() while holding "
                                f"a lock — move it outside the "
                                f"critical section")
        self.generic_visit(node)


class AcquireWithoutFinally(Rule):
    """KFRM003: a manual ``<lock>.acquire()`` (a multi-lock pattern)
    must have a ``try/finally`` in the same
    function whose finalbody releases a matching lock — otherwise an
    exception between acquire and release leaks the lock forever."""

    rule_id = "KFRM003"
    synopsis = "manual .acquire() without a try/finally release"

    def _check_function(self, node) -> None:
        acquires: list[ast.Call] = []
        released: set[str] = set()
        stack: list[tuple[ast.AST, bool]] = [(node, False)]
        while stack:
            cur, in_finally = stack.pop()
            for child in ast.iter_child_nodes(cur):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.Lambda)):
                    continue  # separate scope, checked on its own
                child_in_finally = in_finally
                if isinstance(child, ast.Call) and \
                        isinstance(child.func, ast.Attribute) and \
                        is_lockish(child.func.value):
                    if child.func.attr == "acquire" and not in_finally:
                        acquires.append(child)
                    elif child.func.attr == "release" and in_finally:
                        released.add(
                            terminal_name(child.func.value) or "")
                if isinstance(cur, ast.Try) and \
                        child in getattr(cur, "finalbody", ()):
                    child_in_finally = True
                stack.append((child, child_in_finally))
        for call in acquires:
            recv = terminal_name(call.func.value) or "<lock>"
            if recv not in released:
                self.emit(call, f"{recv}.acquire() has no matching "
                                f"release in a try/finally in this "
                                f"function — an exception leaks the "
                                f"lock")

    def visit_FunctionDef(self, node) -> None:
        self._check_function(node)
        self.generic_visit(node)

    def visit_AsyncFunctionDef(self, node) -> None:
        self._check_function(node)
        self.generic_visit(node)


class WriteUnderLock(LockScopeRule):
    """KFRM004: an apiserver/kubeclient write verb issued while a lock
    is held couples the critical section to admission webhooks, WAL
    fsync, and (cluster backend) a network round trip — and a write
    re-entering the same kind lock from another thread's watch fanout
    is the classic control-plane deadlock."""

    rule_id = "KFRM004"
    synopsis = "apiserver/kubeclient write call while a lock is held"

    def visit_Call(self, node: ast.Call) -> None:
        if self._depth > 0 and isinstance(node.func, ast.Attribute) \
                and node.func.attr in WRITE_VERBS:
            recv = terminal_name(node.func.value)
            if recv in CLIENTISH:
                self.emit(node, f"{recv}.{node.func.attr}() while "
                                f"holding a lock — issue API writes "
                                f"after the critical section")
        self.generic_visit(node)


class SilentSwallow(Rule):
    """KFRM005: ``except Exception:`` that neither re-raises, logs,
    nor counts turns real faults into silence. Use
    ``metrics.swallowed(module)`` for intentional best-effort paths."""

    rule_id = "KFRM005"
    synopsis = "except Exception: swallowed without logging or counting"

    @staticmethod
    def _is_broad(handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            return True
        names = t.elts if isinstance(t, ast.Tuple) else [t]
        return any(terminal_name(n) in ("Exception", "BaseException")
                   for n in names)

    @staticmethod
    def _is_handled(handler: ast.ExceptHandler) -> bool:
        for sub in ast.walk(handler):
            if isinstance(sub, ast.Raise):
                return True
            if isinstance(sub, ast.Call) and \
                    terminal_name(sub.func) in _HANDLED_CALLS:
                return True
            # the bound exception flowing anywhere (stored for a later
            # gather-raise, handed to a retry/record helper) is not a
            # swallow — the fault stays visible to the program
            if handler.name and isinstance(sub, ast.Name) and \
                    sub.id == handler.name and \
                    isinstance(sub.ctx, ast.Load):
                return True
        return False

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if self._is_broad(node) and not self._is_handled(node):
            self.emit(node, "except Exception: swallows the error — "
                            "re-raise, log it, or count it via "
                            "metrics.swallowed(module)")
        self.generic_visit(node)


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
    RawLockConstruction,
    BlockingUnderLock,
    AcquireWithoutFinally,
    WriteUnderLock,
    SilentSwallow,
    ScalarSyncInHotLoop,
    CaptureInLoop,
    CarriedStateOutOfPlace,
)
