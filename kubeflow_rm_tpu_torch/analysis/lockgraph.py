"""Dynamic lock-order analysis: an instrumented lock factory
(counterpart of ``kubeflow_rm_tpu/analysis/lockgraph.py``, plain Python
copied so that the port's locks are checked as the JAX package's are).

Every lock of the port is made through :func:`make_lock` /
:func:`make_rlock` / :func:`make_condition` instead of a bare
``threading`` primitive (the KFRM001 lint rule holds the tree to it).
The factory has two modes:

**Off (default):** each call returns the *raw* ``threading`` primitive
— not a wrapper, the object itself — so hot paths pay nothing.

**On** (``KFRM_LOCK_ANALYSIS=1`` in the environment at import, or
:func:`set_enabled` before the locks are made): each call returns an
instrumented wrapper that feeds a process-global :class:`LockAnalysis`:

- **held-sets** — a thread-local stack of (lock, acquire-time) entries
  kept across acquire/release and ``Condition.wait`` (which releases the
  lock while it waits);
- **acquisition-order graph** — on every acquire, one directed edge per
  held lock name → acquired lock name, with a witness stack pair (where
  each was taken) captured on first sight;
- **cycle detection** — :meth:`LockAnalysis.cycles` runs Tarjan SCC over
  the name graph; a non-trivial SCC is a potential deadlock;
- **ordered groups** — a many-instance family acquired in a sorted order
  passes a ``rank``; taking a lower-ranked sibling while holding a
  higher-ranked one is an **order violation**;
- **the hierarchy** — :data:`LOCK_HIERARCHY` gives every lock family of
  the port a level, and :func:`check_edges` reports a measured edge that
  runs downhill (a latent deadlock before any cycle shows) or names a
  lock missing from the table;
- **blocking-under-lock** — ``os.fsync``, ``time.sleep``, the
  ``subprocess.run`` family, ``socket.create_connection`` and
  ``http.client`` calls are probed while analysis is on; a call made
  with a factory lock held is recorded with the held set and a witness;
- **held-time percentiles** — per lock name, p50/p95/p99/max of the
  hold time from a bounded reservoir.

:func:`report` serialises all of it; :func:`reset` clears it between
scenarios; :func:`dump` writes the report as JSON.
"""

from __future__ import annotations

import json
import os
import threading
import time
import traceback

__all__ = [
    "enabled", "set_enabled", "make_lock", "make_rlock",
    "make_condition", "analysis", "report", "reset", "dump",
    "LOCK_HIERARCHY", "check_edges",
]

_ENV = "KFRM_LOCK_ANALYSIS"

# how many stack frames a witness keeps (innermost last)
_STACK_LIMIT = 12
# held-time reservoir bound per lock name
_RESERVOIR = 8192

_enabled = os.environ.get(_ENV, "").strip().lower() not in (
    "", "0", "false", "no")

_tls = threading.local()


def _held_list() -> list:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


#: the port's lock families (the ``make_lock`` label) -> level. A
#: thread may take only a lock whose level is strictly above every lock
#: it holds (a ranked same-name family ties with itself and orders its
#: instances by ``rank``). The levels are the JAX package's
#: (``analysis/hierarchy.py``) for every family both packages have: the
#: control plane's apiserver, scheduler, runtime and cache locks; the
#: fleet routes INTO gateways, and the store sits above the gateway
#: because promote-on-evict fires inside an engine step, under the
#: owning gateway's lock.
LOCK_HIERARCHY: dict[str, int] = {
    # -- the control plane: coarse, outermost --------------------------
    "apiserver.global": 10,         # the --global-lock arm's verb lock
    "scheduler.registry": 20,       # per-backend cache registry
    "scheduler.relist": 30,         # rebuild vs bind-commit exclusion
    "scheduler.nodes_map": 40,      # node-map membership
    "scheduler.node": 50,           # ranked family: sorted by node name
    "scheduler.pods_map": 60,       # pod -> entry accounting map
    # suspend's per-notebook checkpoint guard is held across the state-
    # store call AND its annotation CAS, so it sits below every
    # apiserver verb lock; the registry hands out the per-key instances
    "suspend.store_registry": 70,
    "suspend.store": 80,            # ranked family: by "ns/name" key
    # -- the apiserver's write path --------------------------------------
    "apiserver.kind": 110,          # per-kind verb locks (DAG inside)
    "apiserver.kind_locks_map": 120,
    "apiserver.event_seq": 130,     # atomic Event name counter
    "apiserver.write_log": 140,     # write audit append
    "apiserver.pod_logs": 140,      # kubelet stdout store
    "apiserver.rv": 145,            # atomic resourceVersion counter
    "apiserver.admission_pool": 150,
    "apiserver.watch_channel": 160,  # per-watcher fanout condvar
    # taken inside publish (under watch_channel); takes nothing while held
    "chaos.plan": 165,
    # -- the controller runtime and the informer cache ------------------
    "runtime.queue": 210,
    "runtime.child_pool": 220,
    "workqueue": 230,
    "leases.elector": 240,
    "informer.prime": 250,
    "cache.store": 260,             # ObjectStore RLock + its condvar
    # held across an ENTIRE split/merge handoff, which routes into the
    # runner's watchdog (370), the kube client's transport (310+) and
    # the router, so it sits below the whole transport tier
    "shard.elastic": 280,
    # -- transport, serving, the auditor --------------------------------
    "kubeclient.token_bucket": 310,
    # the kube adapter's keep-alive pool, its Event name counter and the
    # router's per-kind listed-shards map; then the REST facade's watch
    # registry and its accepted-socket set: each is a leaf its holder
    # takes nothing under but metrics
    "kubeclient.conn_pool": 320,
    "kubeclient.events_seen": 330,
    "kubeclient.router_listed": 340,
    "restserver.watch_registry": 350,
    "restserver.conns": 360,
    # the shard supervisor's membership map: spawn and retire under it,
    # never a call out
    "shard.watchdog": 370,
    # -- the web apps: the readiness hub's key registry, its per-notebook
    # condvars (a waiter's registration takes the key's under the
    # registry) and the jupyter app's lazy hub
    "readiness.registry": 410,
    "readiness.key": 420,
    "jupyter.hub_registry": 430,
    # the lease table only: every gang_bind and fleet drain runs after
    # it is released, but it logically precedes routing into the fleet
    "harvest.controller": 433,
    "serving.fleet": 435,
    "serving.gateway": 440,
    "serving.store": 445,
    # the dashboard's metrics history: its lazy sampler-thread start,
    # then its ring (a sample is appended under it; nothing nests)
    "metrics_service.sampler_thread": 450,
    "metrics_service.sampler": 460,
    # obs locks never nest with each other (burn rates are computed
    # before the engine lock; flight bundles are assembled lock-free and
    # only appended under obs.flight), and they sit below
    # tracing.collector, so a capture reading the span ring while
    # holding one would still be uphill
    "obs.engine": 470,              # SLO alert state machine
    "obs.tsdb": 480,                # ring-buffer TSDB series map
    "obs.flight": 490,              # flight-recorder bundle ring
    "tracing.collector": 510,
    "torchcheck.pricer": 520,
    # installs observers into the probes (540, 550) while held
    "obs.bridges": 530,
    # the probes notify their observers (the bridges' counters, 700+)
    # while held
    "torchcheck.hostsync": 540,
    "torchcheck.recompile": 550,
    "kernels.build": 560,
    # -- persistence, innermost -------------------------------------------
    "persistence.snapshot_guard": 610,
    "wal.cv": 620,                  # group-commit condvar; leaf
    # metrics are set from under every lock above; leaves
    "metrics.family": 700,
    "metrics.series": 710,
}


def check_edges(edges) -> list[str]:
    """Validate measured acquisition-order edges (``{"from", "to"}``
    dicts of :func:`report`) against :data:`LOCK_HIERARCHY`: downhill
    edges (a higher-level lock held while a lower one is taken) and
    locks missing from the table, as readable lines."""
    problems = []
    for e in edges:
        a, b = e["from"], e["to"]
        la, lb = LOCK_HIERARCHY.get(a), LOCK_HIERARCHY.get(b)
        if la is None or lb is None:
            problems.append("unregistered lock in hierarchy: "
                            f"{a if la is None else b}")
            continue
        if a != b and lb <= la:
            problems.append(
                f"downhill acquisition {a} (level {la}) -> {b} "
                f"(level {lb}): violates the canonical order")
    return sorted(set(problems))


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Flip analysis mode. Must be called BEFORE the locks to observe
    are made — existing raw primitives stay raw. Turning on installs the
    blocking-call probes; turning off removes them."""
    global _enabled
    _enabled = bool(on)
    if _enabled:
        _install_probes()
    else:
        _uninstall_probes()


class _Held:
    """One entry of a thread's held-set: the wrapper, its acquire
    timestamp, the acquire stack (witness material), and a recursion
    count for reentrant locks."""

    __slots__ = ("lock", "t0", "stack", "count")

    def __init__(self, lock, t0, stack):
        self.lock = lock
        self.t0 = t0
        self.stack = stack
        self.count = 1


class _SiteStats:
    __slots__ = ("acquires", "samples", "held_max", "held_sum",
                 "held_n", "ranked")

    def __init__(self):
        self.acquires = 0
        self.samples: list[float] = []
        self.held_max = 0.0
        self.held_sum = 0.0
        self.held_n = 0
        self.ranked = False


def _pct(samples: list[float], q: float) -> float:
    if not samples:
        return 0.0
    if len(samples) == 1:
        return samples[0]
    pos = q * (len(samples) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(samples) - 1)
    return samples[lo] + (samples[hi] - samples[lo]) * (pos - lo)


def _fmt_stack(stack) -> str:
    return "".join(traceback.format_list(stack)).rstrip()


class LockAnalysis:
    """Process-global accumulator behind the instrumented wrappers.

    All mutation happens under one raw guard — analysis mode trades
    some acquire-path serialization for observability, which is why
    it is opt-in and why the off path returns raw primitives."""

    def __init__(self):
        # the analyser's own guard must be a raw primitive: an
        # instrumented one would recurse into itself
        self._guard = threading.Lock()  # kfrm: disable=KFRM001
        self._sites: dict[str, _SiteStats] = {}
        # (held_name, acquired_name) -> {count, held_stack, acq_stack}
        self._edges: dict[tuple[str, str], dict] = {}
        # same-name rank inversions: name -> {count, witness...}
        self._order_violations: dict[str, dict] = {}
        # (op, held-names tuple) -> {count, stack}
        self._blocking: dict[tuple[str, tuple], dict] = {}

    # -- feed (called by the wrappers) ---------------------------------
    def on_acquired(self, lock, held: list, stack) -> None:
        with self._guard:
            st = self._sites.get(lock.name)
            if st is None:
                st = self._sites[lock.name] = _SiteStats()
            st.acquires += 1
            if lock.rank is not None:
                st.ranked = True
            for h in held:
                other = h.lock
                if other is lock:
                    continue
                if other.name == lock.name:
                    # intra-group nesting (e.g. sorted per-node locks):
                    # legal iff ranks are acquired in ascending order
                    if (other.rank is not None and lock.rank is not None
                            and other.rank > lock.rank):
                        v = self._order_violations.get(lock.name)
                        if v is None:
                            self._order_violations[lock.name] = {
                                "count": 1,
                                "held_rank": str(other.rank),
                                "acquired_rank": str(lock.rank),
                                "witness": _fmt_stack(stack),
                            }
                        else:
                            v["count"] += 1
                    continue
                edge = self._edges.get((other.name, lock.name))
                if edge is None:
                    self._edges[(other.name, lock.name)] = {
                        "count": 1,
                        "held_stack": _fmt_stack(h.stack),
                        "acquired_stack": _fmt_stack(stack),
                    }
                else:
                    edge["count"] += 1

    def on_released(self, lock, held_s: float) -> None:
        with self._guard:
            st = self._sites.get(lock.name)
            if st is None:
                st = self._sites[lock.name] = _SiteStats()
            st.held_n += 1
            st.held_sum += held_s
            if held_s > st.held_max:
                st.held_max = held_s
            if len(st.samples) < _RESERVOIR:
                st.samples.append(held_s)

    def on_blocking(self, op: str, held: list, stack) -> None:
        key = (op, tuple(sorted({h.lock.name for h in held})))
        with self._guard:
            b = self._blocking.get(key)
            if b is None:
                self._blocking[key] = {
                    "count": 1, "witness": _fmt_stack(stack)}
            else:
                b["count"] += 1

    # -- analysis ------------------------------------------------------
    def cycles(self) -> list[dict]:
        """Non-trivial SCCs of the acquisition-order name graph: each
        is a set of locks some pair of threads can acquire in opposite
        orders — a potential deadlock. Witnessed by the member edges'
        stack pairs."""
        with self._guard:
            edges = {k: dict(v) for k, v in self._edges.items()}
        graph: dict[str, set[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        sccs = _tarjan(graph)
        out = []
        for scc in sccs:
            if len(scc) < 2:
                continue
            members = sorted(scc)
            witness_edges = [
                {"from": a, "to": b, "count": e["count"],
                 "held_stack": e["held_stack"],
                 "acquired_stack": e["acquired_stack"]}
                for (a, b), e in sorted(edges.items())
                if a in scc and b in scc
            ]
            out.append({"locks": members, "edges": witness_edges})
        return out

    def order_violations(self) -> list[dict]:
        with self._guard:
            return [dict(v, group=name) for name, v in
                    sorted(self._order_violations.items())]

    def blocking_under_lock(self) -> list[dict]:
        with self._guard:
            return [
                {"op": op, "held": list(names), "count": b["count"],
                 "witness": b["witness"]}
                for (op, names), b in sorted(self._blocking.items())
            ]

    def report(self) -> dict:
        cycles = self.cycles()
        violations = self.order_violations()
        blocking = self.blocking_under_lock()
        with self._guard:
            locks = {}
            for name, st in sorted(self._sites.items()):
                samples = sorted(st.samples)
                locks[name] = {
                    "acquires": st.acquires,
                    "ranked_group": st.ranked,
                    "held_ms": {
                        "p50": round(_pct(samples, 0.50) * 1e3, 4),
                        "p95": round(_pct(samples, 0.95) * 1e3, 4),
                        "p99": round(_pct(samples, 0.99) * 1e3, 4),
                        "max": round(st.held_max * 1e3, 4),
                        "mean": round(
                            (st.held_sum / st.held_n if st.held_n
                             else 0.0) * 1e3, 4),
                        "samples": st.held_n,
                    },
                }
            edges = [
                {"from": a, "to": b, "count": e["count"]}
                for (a, b), e in sorted(self._edges.items())
            ]
        return {
            "enabled": _enabled,
            "locks": locks,
            "edges": edges,
            "cycles": cycles,
            "order_violations": violations,
            "blocking_under_lock": blocking,
        }

    def reset(self) -> None:
        with self._guard:
            self._sites.clear()
            self._edges.clear()
            self._order_violations.clear()
            self._blocking.clear()


def _tarjan(graph: dict[str, set[str]]) -> list[set[str]]:
    """Iterative Tarjan strongly-connected components."""
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    counter = [0]
    sccs: list[set[str]] = []

    for root in graph:
        if root in index:
            continue
        work = [(root, iter(sorted(graph.get(root, ()))))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for succ in it:
                if succ not in index:
                    index[succ] = low[succ] = counter[0]
                    counter[0] += 1
                    stack.append(succ)
                    on_stack.add(succ)
                    work.append((succ, iter(sorted(graph.get(succ,
                                                             ())))))
                    advanced = True
                    break
                if succ in on_stack:
                    low[node] = min(low[node], index[succ])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = set()
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.add(w)
                    if w == node:
                        break
                sccs.append(scc)
    # a self-edge (same-name nesting never reaches the edge map, but a
    # one-node SCC with an explicit a->a edge would be a real cycle)
    return sccs


_analysis = LockAnalysis()


def analysis() -> LockAnalysis:
    return _analysis


def report() -> dict:
    return _analysis.report()


def reset() -> None:
    _analysis.reset()


def dump(path: str) -> dict:
    rep = report()
    with open(path, "w") as f:
        json.dump(rep, f, indent=1, sort_keys=True)
    return rep


# ---- instrumented wrappers -------------------------------------------


def _capture_stack():
    return traceback.extract_stack(limit=_STACK_LIMIT)[:-2]


class _InstrumentedLock:
    """Wrapper over a raw primitive that maintains the thread's
    held-set and feeds the global analysis. Reentrant acquires (the
    RLock subclass) bump the existing held entry instead of recording
    a self-edge."""

    _REENTRANT = False

    __slots__ = ("name", "rank", "_raw")

    def __init__(self, name: str, rank=None):
        self.name = name
        self.rank = rank
        if self._REENTRANT:
            self._raw = threading.RLock()  # kfrm: disable=KFRM001
        else:
            self._raw = threading.Lock()  # kfrm: disable=KFRM001

    def _entry(self):
        for h in reversed(_held_list()):
            if h.lock is self:
                return h
        return None

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._raw.acquire(blocking, timeout)
        if ok:
            self._note_acquired()
        return ok

    def _note_acquired(self) -> None:
        held = _held_list()
        if self._REENTRANT:
            entry = self._entry()
            if entry is not None:
                entry.count += 1
                return
        stack = _capture_stack()
        _analysis.on_acquired(self, held, stack)
        held.append(_Held(self, time.perf_counter(), stack))

    def release(self) -> None:
        self._note_released()
        self._raw.release()

    def _note_released(self) -> None:
        held = _held_list()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is self:
                held[i].count -= 1
                if held[i].count == 0:
                    entry = held.pop(i)
                    _analysis.on_released(
                        self, time.perf_counter() - entry.t0)
                return

    def locked(self) -> bool:
        return self._raw.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<{type(self).__name__} {self.name!r}>"


class _InstrumentedRLock(_InstrumentedLock):
    _REENTRANT = True
    __slots__ = ()

    def _is_owned(self) -> bool:
        return self._entry() is not None


class _InstrumentedCondition:
    """Condition over an instrumented lock. ``wait`` releases the lock
    for its duration, so the held-set entry is suspended (its held
    segment recorded) and re-established on wake — without this every
    parked waiter would look like an eternal lock hold."""

    __slots__ = ("name", "_wrap", "_cond")

    def __init__(self, name: str, lock=None):
        self.name = name
        if lock is None:
            lock = _InstrumentedRLock(name)
        if not isinstance(lock, _InstrumentedLock):
            raise TypeError(
                "make_condition(lock=...) requires a factory-made lock "
                "while analysis is enabled")
        self._wrap = lock
        # the stdlib Condition manages the RAW primitive; the wrapper
        # handles held-set accounting around it
        self._cond = threading.Condition(lock._raw)  # kfrm: disable=KFRM001

    def acquire(self, *a, **kw):
        return self._wrap.acquire(*a, **kw)

    def release(self) -> None:
        self._wrap.release()

    def __enter__(self):
        self._wrap.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._wrap.release()

    def _suspend(self):
        held = _held_list()
        for i in range(len(held) - 1, -1, -1):
            if held[i].lock is self._wrap:
                entry = held.pop(i)
                _analysis.on_released(
                    self._wrap, time.perf_counter() - entry.t0)
                return entry
        return None

    def _resume(self, entry) -> None:
        if entry is not None:
            entry.t0 = time.perf_counter()
            _held_list().append(entry)

    def wait(self, timeout: float | None = None) -> bool:
        entry = self._suspend()
        try:
            return self._cond.wait(timeout)
        finally:
            self._resume(entry)

    def wait_for(self, predicate, timeout: float | None = None):
        # reimplemented over self.wait so the held-set suspension
        # applies (the stdlib version would call the raw wait)
        endtime = None
        result = predicate()
        while not result:
            if timeout is not None:
                if endtime is None:
                    endtime = time.monotonic() + timeout
                waittime = endtime - time.monotonic()
                if waittime <= 0:
                    break
                self.wait(waittime)
            else:
                self.wait()
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()


# ---- the factory -----------------------------------------------------


def make_lock(name: str, *, rank=None):
    """A mutex. ``name`` labels the lock's site in the analysis (one
    name per lock *family* — instances of a many-instance family share
    it and pass ``rank``, the key their sorted-acquisition discipline
    orders them by, so the analyser can verify the discipline instead
    of seeing false same-name cycles)."""
    if not _enabled:
        return threading.Lock()  # kfrm: disable=KFRM001 (off path)
    return _InstrumentedLock(name, rank=rank)


def make_rlock(name: str):
    """A reentrant mutex (for verbs that nest)."""
    if not _enabled:
        return threading.RLock()  # kfrm: disable=KFRM001 (off path)
    return _InstrumentedRLock(name)


def make_condition(name: str, lock=None):
    """A condition variable, optionally over an existing factory-made
    lock (one RLock shared by a mutex and its condvar)."""
    if not _enabled:
        return threading.Condition(lock)  # kfrm: disable=KFRM001 (off)
    return _InstrumentedCondition(name, lock=lock)


# ---- blocking-call probes --------------------------------------------

_probes: dict[tuple, object] = {}


def _check_blocking(op: str) -> None:
    held = _held_list()
    if held:
        _analysis.on_blocking(op, held, _capture_stack())


def _wrap_callable(owner, attr: str, op: str) -> None:
    fn = getattr(owner, attr, None)
    if fn is None or (owner, attr) in _probes:  # pragma: no cover
        return

    def probe(*a, **kw):
        _check_blocking(op)
        return fn(*a, **kw)

    probe.__wrapped__ = fn
    probe.__name__ = getattr(fn, "__name__", attr)
    _probes[(owner, attr)] = fn
    setattr(owner, attr, probe)


def _install_probes() -> None:
    """Patch the blocking calls a lock must never wait on: fsync,
    sleep, subprocess, socket dials and the ``http.client`` request
    path. Only calls made WHILE HOLDING a factory lock are recorded."""
    if _probes:
        return
    import http.client
    import socket
    import subprocess
    _wrap_callable(os, "fsync", "os.fsync")
    _wrap_callable(os, "fdatasync", "os.fdatasync")
    _wrap_callable(time, "sleep", "time.sleep")
    for name in ("run", "call", "check_call", "check_output"):
        _wrap_callable(subprocess, name, f"subprocess.{name}")
    _wrap_callable(socket, "create_connection",
                   "socket.create_connection")
    _wrap_callable(http.client.HTTPConnection, "request",
                   "http.request")
    _wrap_callable(http.client.HTTPConnection, "getresponse",
                   "http.getresponse")
    _wrap_callable(http.client.HTTPConnection, "connect",
                   "http.connect")


def _uninstall_probes() -> None:
    while _probes:
        (owner, attr), fn = _probes.popitem()
        setattr(owner, attr, fn)


if _enabled:  # pragma: no cover - env-driven boot path
    _install_probes()
