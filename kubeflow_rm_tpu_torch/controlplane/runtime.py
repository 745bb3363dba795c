"""Controller runtime: watches, work queues, level-triggered reconciling.

A thin, deterministic stand-in for controller-runtime: each Controller
reconciles one primary kind, may watch other kinds mapped back to
primary requests (the reference watches Pods and Events and maps them to
their parent Notebook — ``notebook_controller.go:739-787``), and the
Manager drains all queues to quiescence. ``requeue_after`` plus the
injected clock give the culler its periodic loop without wall-clock
sleeps.

Reconcilers must be idempotent and cheap — run_until_idle re-runs them
until nothing changes, which is exactly the level-triggered semantics
the reference relies on for failure recovery (SURVEY.md §5).

(The port's copy of ``kubeflow_rm_tpu/controlplane/runtime.py``;
``run_forever(elector=...)`` gates reconciling on
:class:`~.ha.leases.LeaderElector`.)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    annotations_of,
    deep_get,
    labels_of,
    name_of,
    namespace_of,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer, Conflict, NotFound
from kubeflow_rm_tpu_torch.controlplane import tracing
from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock


@dataclass(frozen=True, order=True)
class Request:
    namespace: str | None
    name: str


def _chaos_reconcile_sleep(controller: str) -> None:
    """Reconcile-span fault injection, delegated to the chaos engine:
    seeded ``FaultPlan`` stalls plus the legacy perf-ratchet env hook
    (``KFRM_CHAOS_RECONCILE_SLEEP_MS`` / ``_CONTROLLER``) both land
    inside the reconcile span so injected latency sits on the trace's
    critical path exactly where a real slow hop would. No-op unless a
    plan is installed or the env var is set."""
    from kubeflow_rm_tpu_torch.controlplane import chaos
    chaos.maybe_stall(controller)


class Controller:
    """Subclass contract: set ``kind``, implement ``reconcile``."""

    kind: str = ""
    name: str = ""

    def reconcile(self, api: APIServer, req: Request) -> float | None:
        """Reconcile one object. Return seconds to requeue after, or
        None. Raise to retry with backoff."""
        raise NotImplementedError

    def watches(self) -> Iterable[tuple[str, Callable[[dict], list[Request]]]]:
        """Extra (kind, map_fn) watches; map_fn maps an event's object to
        primary requests."""
        return ()


def map_to_owner(owner_kind: str) -> Callable[[dict], list[Request]]:
    """Map a dependent object to its controller-owner of ``owner_kind``."""

    def fn(obj: dict) -> list[Request]:
        for ref in obj["metadata"].get("ownerReferences", []):
            if ref.get("kind") == owner_kind and ref.get("controller"):
                return [Request(namespace_of(obj), ref["name"])]
        return []

    return fn


def map_by_label(label: str) -> Callable[[dict], list[Request]]:
    def fn(obj: dict) -> list[Request]:
        v = labels_of(obj).get(label)
        return [Request(namespace_of(obj), v)] if v else []

    return fn


def map_all_in_namespace(kind: str):
    """Map an event to EVERY object of ``kind`` in the event object's
    namespace — for namespace-scoped admission inputs (ResourceQuota)
    whose change can unblock any primary in that namespace. Needs the
    manager's api handle to enumerate, so it's marked ``wants_api`` and
    ``Manager._on_event`` calls it as ``fn(api, obj)``."""

    def fn(api: APIServer, obj: dict) -> list[Request]:
        ns = namespace_of(obj)
        return [Request(namespace_of(o), name_of(o))
                for o in getattr(api, "scan", api.list)(kind, ns)]

    fn.wants_api = True
    return fn


class Manager:
    """Runs controllers against an APIServer until the system is idle."""

    MAX_RETRIES = 5
    # resourceVersion conflicts are EXPECTED under cached reads (the
    # informer lags writes by a watch event) and always resolve once
    # the cache catches up — give them a far larger budget than real
    # reconcile errors, as controller-runtime's rate limiter does
    MAX_CONFLICT_RETRIES = 40

    def __init__(self, api: APIServer):
        import threading
        self.api = api
        self.controllers: list[Controller] = []
        # one rate-limited work queue per controller (ha/workqueue.py):
        # dedup on enqueue, per-item backoff with jitter, max-retries
        # terminal path, per-controller concurrency caps
        self._queues: dict[str, "WorkQueue"] = {}
        # guards the errors list; each queue carries its own lock
        self._queue_lock = make_lock("runtime.queue")
        self.errors: list[tuple[str, Request, Exception]] = []
        # trace context riding the workqueue: items are deduped frozen
        # dataclasses, so causality travels in this side map keyed by
        # (controller, request) and is popped when the reconcile opens
        # its span. Bounded defensively — entries for requests that
        # never dequeue (terminal retry paths) must not accumulate.
        self._trace_ctx: dict[tuple[str, Request], str] = {}
        # run_forever blocks on this between drains; enqueue sets it so
        # watch events are served at HTTP latency, not poll latency
        self._wake = threading.Event()
        api.add_watcher(self._on_event, name="manager")

    def _queue_clock(self) -> float:
        # queues measure time on the apiserver's injected clock, so
        # requeue_after and backoff stay deterministic under test clocks
        return self.api.clock().timestamp()

    def add(self, controller: Controller) -> None:
        from kubeflow_rm_tpu_torch.controlplane.ha.workqueue import WorkQueue
        if not controller.name:
            controller.name = type(controller).__name__
        self.controllers.append(controller)
        self._queues.setdefault(controller.name, WorkQueue(
            name=controller.name, clock=self._queue_clock,
            max_retries=self.MAX_RETRIES,
            max_conflict_retries=self.MAX_CONFLICT_RETRIES,
            max_concurrent=getattr(controller, "max_concurrent", None)))

    def enqueue(self, controller: Controller | str, req: Request, *,
                trace: str | None = None) -> None:
        name = controller if isinstance(controller, str) else controller.name
        if trace is not None:
            with self._queue_lock:
                if len(self._trace_ctx) > 4096:
                    self._trace_ctx.clear()  # defensive bound
                self._trace_ctx[(name, req)] = trace
        self._queues[name].add(req)
        self._wake.set()

    def enqueue_all(self) -> None:
        """Seed every controller's queue with all existing primaries
        (informer initial list; also the leader-promotion resync).
        ``scan`` — only names/namespaces are read, so the read-only
        reference contract holds and a cache-backed api serves the
        whole resync from memory with zero server round-trips."""
        for c in self.controllers:
            for obj in getattr(self.api, "scan", self.api.list)(c.kind):
                self.enqueue(c, Request(namespace_of(obj), name_of(obj)))

    def _on_event(self, event: str, obj: dict, old: dict | None) -> None:
        if event == "TOO_OLD":
            # this watcher's fanout queue overflowed and the dropped
            # window can't be replayed — resync every controller from
            # a fresh list (the informer's 410 relist runs first: it
            # registered its watcher before ours)
            self.enqueue_all()
            return
        # lift the stamped context off the event object so the async
        # hop (watch → queue → reconcile thread) stays one trace
        trace = None
        if tracing.enabled():
            ctx = tracing.context_of(obj)
            trace = ctx.to_traceparent() if ctx is not None else None
        for c in self.controllers:
            if obj["kind"] == c.kind:
                self.enqueue(c, Request(namespace_of(obj), name_of(obj)),
                             trace=trace)
            for kind, map_fn in c.watches():
                if obj["kind"] == kind:
                    reqs = (map_fn(self.api, obj)
                            if getattr(map_fn, "wants_api", False)
                            else map_fn(obj))
                    for req in reqs:
                        if req.name:
                            self.enqueue(c, req, trace=trace)

    def _reconcile_span(self, c: Controller, req: Request):
        """Span context for one reconcile, parented on the trace the
        workqueue item carried (consumed exactly once). No carried
        context → no span: a periodic resync reconcile is not part of
        any request's causal chain."""
        import contextlib
        if not tracing.enabled():
            return contextlib.nullcontext()
        with self._queue_lock:
            tp = self._trace_ctx.pop((c.name, req), None)
        if tp is None:
            return contextlib.nullcontext()
        return tracing.start_span(
            f"reconcile {c.name}", kind="consumer", parent=tp,
            attrs={"namespace": req.namespace or "", "name": req.name})

    def run_until_idle(self, max_iterations: int = 10_000) -> int:
        """Process queues until empty (timed requeues fire only when the
        injected clock passes them; backoff requeues are promoted
        immediately — deterministic drains keep the historical
        immediate-retry semantics). Returns reconcile count."""
        count = 0
        # async fanout barrier: events from the previous batch's writes
        # must land in the queues before we decide "idle" (the kube
        # adapter has no drain — its watch threads are real-time and
        # run_forever is the serving loop there)
        drain = getattr(self.api, "drain_watchers", None)
        for _ in range(max_iterations):
            if drain is not None:
                drain()
            batch = [(c, req) for c in self.controllers
                     for req in self._queues[c.name].pop_ready(
                         ignore_backoff=True)]
            if not batch:
                return count
            for c, req in batch:
                count += 1
                q = self._queues[c.name]
                try:
                    with self._reconcile_span(c, req):
                        _chaos_reconcile_sleep(c.name)
                        requeue_after = c.reconcile(self.api, req)
                    q.forget(req)
                    if requeue_after is not None:
                        q.add_after(req, requeue_after)
                except (Conflict,) as e:
                    self._retry(c, req, e)
                except NotFound:
                    pass  # object vanished; level-triggered — nothing to do
                except Exception as e:  # reconcile error: retry w/ backoff
                    self._retry(c, req, e)
                finally:
                    q.done(req)
        hot = {c.name: self._queues[c.name].snapshot()
               for c in self.controllers
               if self._queues[c.name].depth()}
        raise RuntimeError(
            f"manager did not quiesce in {max_iterations} iterations "
            f"(hot objects: {hot})"
        )

    def _poll_timeout(self, poll_interval_s: float) -> float:
        """Bound the inter-drain sleep by the earliest delayed item so
        backoff/timed requeues fire on time, not a poll late."""
        earliest = None
        for q in self._queues.values():
            due = q.next_due()
            if due is not None and (earliest is None or due < earliest):
                earliest = due
        if earliest is None:
            return poll_interval_s
        delta = earliest - self._queue_clock()
        return max(0.001, min(poll_interval_s, delta))

    def run_forever(self, stop=None, poll_interval_s: float = 1.0,
                    on_error: Callable | None = None,
                    workers: int = 1, elector=None,
                    resync_interval_s: float | None = None) -> None:
        """In-cluster serving loop: drain the queues whenever watch
        events (fanned into ``_on_event`` by the kube adapter's watch
        threads) or timed requeues produce work; sleep ``poll_interval_s``
        between drains. ``stop`` is a ``threading.Event``; reconcile
        errors that exhaust retries go to ``on_error`` (default: log).

        ``workers`` > 1 reconciles DIFFERENT objects concurrently on a
        thread pool while keeping the one-reconcile-per-key invariant
        (controller-runtime's MaxConcurrentReconciles). This is the
        20-way provisioning fix: a reconcile against a real apiserver
        is a chain of HTTP round-trips, and one serial drain thread
        turns N simultaneous spawns into an N× latency queue — the
        reference exposes --qps/--burst for exactly this path
        (notebook-controller/main.go:71-85).

        ``elector`` (ha.LeaderElector) gates reconciling on holding the
        lease: its loop runs on a daemon thread, watch events keep
        accumulating in the (deduped) queues while standing by, and on
        promotion the queues are resynced with ``enqueue_all`` — so a
        standby takes over within one lease duration with a warm cache
        and a complete work list.

        ``resync_interval_s`` (opt-in) periodically re-enqueues every
        primary — controller-runtime's SyncPeriod. Level-triggered
        reconcilers converge from any state, so a periodic resync heals
        whatever a lost watch event (network blip, chaos ``watch_drop``)
        left stale, bounding staleness by the interval."""
        import logging
        import threading
        import time as _time
        stop = stop or threading.Event()
        logger = logging.getLogger("kubeflow_rm_tpu_torch.manager")

        last_resync = _time.monotonic()

        def maybe_resync():
            nonlocal last_resync
            if resync_interval_s is None:
                return
            if elector is not None and not elector.is_leader:
                return
            now = _time.monotonic()
            if now - last_resync >= resync_interval_s:
                last_resync = now
                self.enqueue_all()

        if elector is not None:
            def _on_promoted():
                self.enqueue_all()
                self._wake.set()
            elector.on_started_leading.append(_on_promoted)
            elector.on_stopped_leading.append(self._wake.set)
            threading.Thread(
                target=elector.run, args=(stop,), daemon=True,
                name=f"leader-elect-{elector.identity}").start()

        def report_errors():
            with self._queue_lock:
                errs, self.errors = self.errors, []
            for cname, req, err in errs:
                if on_error:
                    on_error(cname, req, err)
                else:
                    logger.error("%s %s gave up after retries: %s",
                                 cname, req, err)

        if workers <= 1:
            while not stop.is_set():
                self._wake.clear()
                if elector is not None and not elector.is_leader:
                    report_errors()
                    self._wake.wait(poll_interval_s)
                    continue
                maybe_resync()
                try:
                    self._drain_serial(stop, elector)
                except RuntimeError as e:
                    logger.error("manager drain failed: %s", e)
                report_errors()
                # woken immediately by enqueue; the timeout only bounds
                # how late a timed/backoff requeue (or stop) can fire
                self._wake.wait(self._poll_timeout(poll_interval_s))
            return

        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="reconcile") as pool:
            while not stop.is_set():
                self._wake.clear()
                if elector is not None and not elector.is_leader:
                    report_errors()
                    self._wake.wait(poll_interval_s)
                    continue
                # brief dwell so an event burst (pod ADDED + MODIFIED +
                # STS MODIFIED from one spawn) coalesces into ONE
                # reconcile per key instead of one per event — the
                # work-queue rate limiter's job in controller-runtime
                if stop.wait(0.01):
                    break
                maybe_resync()
                for c in self.controllers:
                    for req in self._queues[c.name].pop_ready():
                        pool.submit(self._reconcile_one, c, req)
                report_errors()
                self._wake.wait(self._poll_timeout(poll_interval_s))

    def _drain_serial(self, stop, elector) -> int:
        """Serial run_forever drain: like run_until_idle but honoring
        backoff delays (real time passes between drains) and bailing
        out on stop/demotion."""
        count = 0
        for _ in range(10_000):
            if stop.is_set() or \
                    (elector is not None and not elector.is_leader):
                return count
            batch = [(c, req) for c in self.controllers
                     for req in self._queues[c.name].pop_ready()]
            if not batch:
                return count
            for c, req in batch:
                count += 1
                self._reconcile_one(c, req)
        raise RuntimeError("manager did not quiesce in 10000 iterations")

    def _reconcile_one(self, c: Controller, req: Request) -> None:
        """One reconcile with retry/requeue semantics (both the serial
        drain and the worker pool land here)."""
        import logging
        q = self._queues[c.name]
        try:
            try:
                with self._reconcile_span(c, req):
                    _chaos_reconcile_sleep(c.name)
                    requeue_after = c.reconcile(self.api, req)
                q.forget(req)
                if requeue_after is not None:
                    q.add_after(req, requeue_after)
            except Conflict as e:
                self._retry(c, req, e)
            except NotFound:
                pass  # object vanished; level-triggered
            except Exception as e:
                logging.getLogger("kubeflow_rm_tpu_torch.manager").debug(
                    "%s %s: %s", c.name, req, e)
                self._retry(c, req, e)
        finally:
            # the key may have been re-enqueued mid-flight: the queue
            # returns it to pending; wake the dispatcher so it gets
            # picked up at HTTP latency
            q.done(req)
            self._wake.set()

    def _retry(self, c: Controller, req: Request, e: Exception) -> None:
        from kubeflow_rm_tpu_torch.controlplane import metrics
        metrics.RECONCILE_ERRORS_TOTAL.labels(controller=c.name).inc()
        conflict = isinstance(e, Conflict)
        if self._queues[c.name].add_rate_limited(req, conflict=conflict):
            self._wake.set()
        else:
            with self._queue_lock:
                self.errors.append((c.name, req, e))


def rwo_mounting_node(api: APIServer, namespace: str,
                      pvc_name: str) -> str | None:
    """Node pinning for ReadWriteOnce PVCs: the node where a running pod
    already mounts the claim, or None (shared by the tensorboard and
    pvcviewer controllers — ref ``tensorboard_controller.go:207-232``)."""
    pvc = api.try_get("PersistentVolumeClaim", pvc_name, namespace)
    if pvc is None:
        return None
    modes = deep_get(pvc, "spec", "accessModes", default=[]) or []
    if "ReadWriteOnce" not in modes:
        return None
    for pod in api.list("Pod", namespace):
        node = deep_get(pod, "spec", "nodeName")
        if not node or deep_get(pod, "status", "phase") != "Running":
            continue
        for v in deep_get(pod, "spec", "volumes", default=[]) or []:
            if deep_get(v, "persistentVolumeClaim",
                        "claimName") == pvc_name:
                return node
    return None


# ---- reconcilehelper: create-or-update field-copy semantics ----------
# Mirrors components/common/reconcilehelper/util.go:18-219 — deliberately
# copy only the fields the controller owns, so we don't fight defaulters
# or status writers.

def reconcile_child(api: APIServer, owner: dict, desired: dict,
                    copy_fields: Callable[[dict, dict], bool]) -> dict:
    """Create ``desired`` (owned by ``owner``) if absent; else copy the
    controller-owned fields onto the found object and update when
    changed. Returns the live object."""
    from kubeflow_rm_tpu_torch.controlplane.api.meta import set_controller_reference

    set_controller_reference(owner, desired)
    found = api.try_get(desired["kind"], name_of(desired),
                        namespace_of(desired))
    if found is None:
        return api.create(desired)
    if copy_fields(desired, found):
        return api.update(found)
    return found


# ---- parallel child fan-out ------------------------------------------
# A Notebook's StatefulSet, Services, and VirtualService have no mutual
# ordering — issuing them serially turns one reconcile into a string of
# HTTP round-trips (PROVISION_r08: cr_to_statefulset 204ms p50 under the
# 20-way storm). reconcile_children fans independent child writes onto a
# bounded shared pool; --serial-writes flips the module switch below to
# restore the serial arm for A/B runs.

_serial_writes = False
_child_pool = None
_child_pool_lock = None
_CHILD_POOL_WORKERS = 16
_CHILD_CONFLICT_RETRIES = 4


def set_serial_writes(enabled: bool) -> None:
    """Force the pre-batched write path: reconcile_children runs its
    children sequentially and controllers fall back to per-object
    creates (the ``--serial-writes`` conformance arm)."""
    global _serial_writes
    _serial_writes = bool(enabled)


def serial_writes() -> bool:
    return _serial_writes


def _shared_child_pool():
    global _child_pool, _child_pool_lock
    if _child_pool_lock is None:
        _child_pool_lock = make_lock("runtime.child_pool")
    with _child_pool_lock:
        if _child_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            _child_pool = ThreadPoolExecutor(
                max_workers=_CHILD_POOL_WORKERS,
                thread_name_prefix="child-fanout")
        return _child_pool


def _run_child(api: APIServer, owner: dict, child) -> dict:
    """One child write with a per-child Conflict retry budget.
    reconcile_child re-reads via try_get on every attempt, so a retry
    sees the rv that beat us; a Conflict that survives the budget
    surfaces to the Manager's rate limiter like any serial write."""
    for attempt in range(_CHILD_CONFLICT_RETRIES + 1):
        try:
            if callable(child):
                return child()
            desired, copy_fields = child
            return reconcile_child(api, owner, desired, copy_fields)
        except Conflict:
            if attempt >= _CHILD_CONFLICT_RETRIES:
                raise


def reconcile_children(api: APIServer, owner: dict,
                       children: list) -> list:
    """Issue independent child writes concurrently on a bounded shared
    pool. Each child is either a ``(desired, copy_fields)`` pair routed
    through :func:`reconcile_child` or a zero-arg callable (for
    controllers with bespoke ensure logic). Conflicts retry per child
    before surfacing; every child runs to completion even when a
    sibling fails, then the first error (in input order) is raised —
    one bad child still fails the reconcile, but it can't strand its
    siblings half-written. Returns results in input order."""
    if not children:
        return []
    if _serial_writes or len(children) == 1:
        return [_run_child(api, owner, child) for child in children]
    pool = _shared_child_pool()
    futures = [pool.submit(_run_child, api, owner, child)
               for child in children[1:]]
    results: list = [None] * len(children)
    errors: list = [None] * len(children)
    # run the first child on the calling thread: the reconcile worker
    # contributes a hand instead of idling, and the fan-out makes
    # progress even with the shared pool saturated by sibling reconciles
    try:
        results[0] = _run_child(api, owner, children[0])
    except Exception as e:
        errors[0] = e
    for i, fut in enumerate(futures, start=1):
        try:
            results[i] = fut.result()
        except Exception as e:
            errors[i] = e
    for err in errors:
        if err is not None:
            raise err
    return results


def phase_observer(controller: str, recorder=None):
    """Per-reconcile phase timing: returns ``observe(phase)`` context
    managers feeding both the ``reconcile_phase_duration_seconds``
    histogram (label children bound once — the observer sits on the
    reconcile hot path) and an optional ``PhaseRecorder``."""
    import contextlib
    import time as _time

    from kubeflow_rm_tpu_torch.controlplane import metrics
    bound: dict = {}

    @contextlib.contextmanager
    def observe(phase: str):
        hist = bound.get(phase)
        if hist is None:
            hist = bound.setdefault(
                phase, metrics.RECONCILE_PHASE_SECONDS.labels(
                    controller=controller, phase=phase))
        t0 = _time.perf_counter()
        try:
            # the same boundary also emits a trace span: reconcile
            # phases become hops of the request's causal chain (no-op
            # when tracing is off or no reconcile span is open)
            with tracing.start_span_if_active(f"{controller}.{phase}"):
                yield
        finally:
            dt = _time.perf_counter() - t0
            hist.observe(dt)
            if recorder is not None:
                recorder.record(phase, dt)

    return observe


def copy_statefulset_fields(desired: dict, found: dict) -> bool:
    """Replicas, labels, annotations, pod template (util.go:107-134)."""
    changed = False
    for field in ("labels", "annotations"):
        want = desired["metadata"].get(field) or {}
        if (found["metadata"].get(field) or {}) != want:
            found["metadata"][field] = dict(want)
            changed = True
    if deep_get(desired, "spec", "replicas") != deep_get(found, "spec",
                                                         "replicas"):
        found.setdefault("spec", {})["replicas"] = deep_get(
            desired, "spec", "replicas")
        changed = True
    if deep_get(desired, "spec", "template") != deep_get(found, "spec",
                                                         "template"):
        found["spec"]["template"] = deep_get(desired, "spec", "template")
        changed = True
    return changed


def copy_service_fields(desired: dict, found: dict) -> bool:
    """Selector + ports only; clusterIP etc. belong to the cluster
    (util.go:166-219)."""
    changed = False
    for field in ("labels", "annotations"):
        want = desired["metadata"].get(field) or {}
        if (found["metadata"].get(field) or {}) != want:
            found["metadata"][field] = dict(want)
            changed = True
    for key in ("selector", "ports", "clusterIP", "type"):
        want = deep_get(desired, "spec", key)
        if want is not None and deep_get(found, "spec", key) != want:
            found.setdefault("spec", {})[key] = want
            changed = True
    return changed


def copy_deployment_fields(desired: dict, found: dict) -> bool:
    return copy_statefulset_fields(desired, found)


def copy_simple_spec(desired: dict, found: dict) -> bool:
    """Whole-spec ownership (quota, RBAC, network policy objects)."""
    changed = False
    for field in ("labels", "annotations"):
        want = desired["metadata"].get(field) or {}
        if (found["metadata"].get(field) or {}) != want:
            found["metadata"][field] = dict(want)
            changed = True
    for top in ("spec", "rules", "roleRef", "subjects", "data"):
        if top in desired and found.get(top) != desired[top]:
            found[top] = desired[top]
            changed = True
    return changed


def stamp(obj: dict) -> str:
    """Debug stamp kind/ns/name."""
    return f"{obj['kind']}/{namespace_of(obj)}/{name_of(obj)}"


def is_stopped(obj: dict) -> bool:
    from kubeflow_rm_tpu_torch.controlplane.api.notebook import STOP_ANNOTATION
    return STOP_ANNOTATION in annotations_of(obj)
