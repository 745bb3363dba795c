"""Suspend/resume lifecycle + priority preemption: card oversubscription
(the port's copy of ``kubeflow_rm_tpu/controlplane/suspend.py``).

NotebookOS (arxiv 2503.20591) allocates accelerators to interactive
notebooks *on demand*: a notebook between bursts checkpoints its state
and releases its devices, and any incoming request transparently
restores it. This module is that loop for card slices, composed from
pieces the platform already had:

- **Suspend** (``SuspendController`` + ``initiate_suspend``): snapshot
  the notebook's training state through a Checkpointer-backed state
  store, stamp ``SUSPEND_ANNOTATION`` — the notebook controller renders
  the StatefulSet to zero replicas exactly as it does for the stop
  annotation, the fake kubelet deletes the ordinal pods, and the
  scheduler cache gives the cards back (``release()`` short-circuits
  the watch-event lag so a waiting gang can bind in the same reconcile).
- **Resume** (``request_resume`` + the controller's rebind half): any
  incoming request clears the suspend annotation and stamps
  ``RESUME_REQUESTED_ANNOTATION``; the StatefulSet scales back up,
  ``gang_bind`` re-gangs the slice (anywhere it fits — slices are
  location-transparent), the state store restores the checkpoint token
  (:class:`CheckpointerStateStore` over the port's
  ``training/checkpoint.Checkpointer``: the last durable step), and the
  latency is recorded per phase (drain / rebind / restore).
- **Preemption** (``try_preempt``): when a higher-priority gang cannot
  bind, pick victim slices — lowest priority first, then longest idle,
  then best fragmentation fit — suspend them through the same
  lifecycle, delete their pods (kube-scheduler's preemption deletes
  victims directly), and bind the newcomer all-or-nothing.

Beside it: replica failover (:class:`ReplicaFailoverController`),
compaction migration and active defragmentation. The switch defaults to
on, as JAX's does; the ``--no-oversubscribe`` arm
(``set_oversubscribe(False)``) restores pin-for-lifetime behavior: no
idle suspension, no preemption. Event messages keep JAX's words, so the
two packages' object graphs stay equal.
"""

from __future__ import annotations

import contextlib
import datetime
import json
import logging
import time
from typing import Callable

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock
from kubeflow_rm_tpu_torch.controlplane import chaos, metrics, scheduler
from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    annotations_of,
    deep_get,
    name_of,
    namespace_of,
    set_annotation,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import (
    APIServer, Conflict, NotFound,
)
from kubeflow_rm_tpu_torch.controlplane.runtime import (
    Controller, Request, map_by_label,
)

DEFAULT_CHECK_PERIOD_MIN = 1.0

log = logging.getLogger("kubeflow_rm_tpu_torch.suspend")

# annotation bumped on pending pods to requeue their owner StatefulSet
# when a drain returns chips to the pool (see kick_pending_pods)
_KICK_ANNOTATION = "notebooks.kubeflow.org/reschedule-kick"


# ---- the oversubscription A/B switch ---------------------------------

_oversubscribe = True


def set_oversubscribe(enabled: bool) -> None:
    """``--no-oversubscribe`` arm: keep today's pin-for-lifetime
    behavior — no idle suspension, no preemptive gang-bind."""
    global _oversubscribe
    _oversubscribe = bool(enabled)


def oversubscribe() -> bool:
    return _oversubscribe


# ---- Checkpointer-backed state stores --------------------------------

class InMemoryStateStore:
    """Default state store: holds each notebook's snapshot payload in
    process memory, keyed (namespace, name). The snapshot records the
    workload's durable training step (the launcher agent maintains
    ``TRAINING_STEP_ANNOTATION``); restore hands the payload back so
    the controller can prove exactness via ``RESTORED_STEP_ANNOTATION``."""

    def __init__(self):
        self._saved: dict[tuple, dict] = {}

    def snapshot(self, notebook: dict) -> dict:
        chaos.checkpoint_write_fault(
            f"store:{namespace_of(notebook)}/{name_of(notebook)}")
        ann = annotations_of(notebook)
        try:
            step = int(ann.get(nb_api.TRAINING_STEP_ANNOTATION) or 0)
        except (TypeError, ValueError):
            step = 0
        token = {"step": step}
        self._saved[(namespace_of(notebook), name_of(notebook))] = token
        return dict(token)

    def restore(self, notebook: dict, token: dict | None) -> dict | None:
        saved = self._saved.get(
            (namespace_of(notebook), name_of(notebook)))
        if saved is None:
            return dict(token) if token else None
        return dict(saved)


class CheckpointerStateStore:
    """State store bridged to ``training/checkpoint.py``: each notebook
    workspace has a Checkpointer-compatible manager (``latest_step()``,
    optionally ``wait()``). Suspend records the last *durable* step —
    the slice can be torn down because training resumes exactly there;
    resume verifies the checkpoint still holds a step ≥ the token's.

    ``manager_for(namespace, name)`` is injected so deployments map
    notebooks to their PVC/GCS checkpoint directories and tests pass
    fakes or real orbax ``Checkpointer`` instances."""

    def __init__(self, manager_for: Callable[[str, str], object]):
        self._manager_for = manager_for

    def snapshot(self, notebook: dict) -> dict:
        chaos.checkpoint_write_fault(
            f"store:{namespace_of(notebook)}/{name_of(notebook)}")
        mgr = self._manager_for(namespace_of(notebook), name_of(notebook))
        wait = getattr(mgr, "wait", None)
        if wait is not None:
            wait()  # pending async saves must be durable before teardown
        step = mgr.latest_step()
        return {"step": int(step) if step is not None else 0}

    def restore(self, notebook: dict, token: dict | None) -> dict | None:
        mgr = self._manager_for(namespace_of(notebook), name_of(notebook))
        step = mgr.latest_step()
        restored = {"step": int(step) if step is not None else 0}
        want = (token or {}).get("step")
        if want is not None and restored["step"] < want:
            # checkpoint regressed under us (GC raced, storage lost a
            # write): restore the best durable step and say which
            restored["degraded_from"] = want
        return restored


_state_store = InMemoryStateStore()

# ---- per-notebook checkpoint serialization ---------------------------
# A suspend (snapshot + stamp) racing a promote/resume (restore + stamp)
# on the SAME notebook must never interleave: the loser could restore a
# half-written token into a standby. One ranked lock per notebook key,
# held across the store call AND its annotation CAS; distinct notebooks
# never contend.
_store_locks: dict[tuple, object] = {}
_store_locks_guard = make_lock("suspend.store_registry")


@contextlib.contextmanager
def _store_guard(namespace: str, name: str):
    key = (namespace, name)
    with _store_locks_guard:
        lock = _store_locks.get(key)
        if lock is None:
            lock = _store_locks[key] = make_lock(
                "suspend.store", rank=f"{namespace}/{name}")
    with lock:
        yield


def set_state_store(store) -> None:
    """Swap the module-default state store (conformance wires a
    CheckpointerStateStore; tests reset to a fresh InMemoryStateStore)."""
    global _state_store
    _state_store = store


def state_store():
    return _state_store


# ---- lifecycle verbs (shared by controller, webapp, preemption) ------

def _update_retrying(api: APIServer, notebook: dict,
                     mutate: Callable[[dict], bool]) -> dict:
    """Apply ``mutate`` (returns False to abort) and update, retrying
    the read-modify-write on Conflict — suspend races the culler and
    the webapp on the same annotations map. Always starts from a fresh
    ``get()`` copy: callers may hold ``scan()`` store references, and
    mutating those in place would make the write a self-comparing
    no-op under the cache's suppression.

    Kind-agnostic: the suspend annotation vocabulary is shared by
    Notebook and TPUJob, so the verbs below drive both — the kind is
    taken from the object itself."""
    kind = notebook.get("kind") or nb_api.KIND
    notebook = api.get(kind, name_of(notebook),
                       namespace_of(notebook))
    for _ in range(8):
        if not mutate(notebook):
            return notebook
        try:
            return api.update(notebook)
        except Conflict:
            notebook = api.get(kind, name_of(notebook),
                               namespace_of(notebook))
    raise Conflict(f"could not update {kind} {name_of(notebook)} "
                   "after 8 attempts")


def initiate_suspend(api: APIServer, notebook: dict, *,
                     reason: str, store=None) -> dict:
    """Drive a notebook into the Suspended lifecycle: snapshot state,
    stamp the suspend annotations (the notebook controller scales the
    StatefulSet to zero from them), emit the event. Idempotent."""
    store = store if store is not None else _state_store
    token_box: list = []

    def mutate(nb: dict) -> bool:
        ann = annotations_of(nb)
        if nb_api.SUSPEND_ANNOTATION in ann:
            return False  # already suspending/suspended
        if nb_api.RESUME_REQUESTED_ANNOTATION in ann:
            # a resume (or a replica promotion — failover stamps the
            # same annotation) owns the slice right now; parking on
            # top would clobber its checkpoint token mid-restore
            return False
        if not token_box:
            token_box.append(store.snapshot(nb))
        set_annotation(nb, nb_api.SUSPEND_ANNOTATION,
                       api.clock().isoformat())
        set_annotation(nb, nb_api.SUSPEND_REASON_ANNOTATION, reason)
        set_annotation(nb, nb_api.SUSPEND_CHECKPOINT_ANNOTATION,
                       json.dumps(token_box[0]))
        # a fresh cycle: clear residue from any previous one
        ann.pop(nb_api.SUSPEND_DRAINED_ANNOTATION, None)
        return True

    # snapshot + stamp is one critical section per notebook: a
    # concurrent promote/resume must observe either the pre-suspend
    # or the fully-stamped state, never a half-written token
    with _store_guard(namespace_of(notebook), name_of(notebook)):
        live = _update_retrying(api, notebook, mutate)
    if token_box:  # we actually initiated (not a no-op)
        api.record_event(
            live, "Normal", "Suspending",
            f"suspending slice ({reason}); checkpoint token "
            f"{json.dumps(token_box[0])} — chips return to the pool, "
            "the notebook resumes on next request")
        metrics.NOTEBOOK_SUSPEND_TOTAL.labels(reason=reason).inc()
    return live


def request_resume(api: APIServer, notebook: dict, *,
                   source: str = "request") -> dict:
    """Flip a suspended notebook back toward Running: clear the suspend
    annotation (the StatefulSet scales back up and re-gangs) and stamp
    the resume-request time — earliest stamp wins, it is the latency
    clock the rebind phase is measured against. Idempotent."""
    acted: list = []

    def mutate(nb: dict) -> bool:
        ann = annotations_of(nb)
        if nb_api.SUSPEND_ANNOTATION not in ann:
            return False  # not suspended (or resume already in flight)
        ann.pop(nb_api.SUSPEND_ANNOTATION, None)
        if nb_api.RESUME_REQUESTED_ANNOTATION not in ann:
            set_annotation(nb, nb_api.RESUME_REQUESTED_ANNOTATION,
                           api.clock().isoformat())
        acted.append(True)
        return True

    live = _update_retrying(api, notebook, mutate)
    if acted:
        api.record_event(
            live, "Normal", "Resuming",
            f"resume requested ({source}); re-ganging the slice and "
            "restoring checkpointed state")
    return live


def initiate_migration(api: APIServer, notebook: dict, *,
                       trigger: str = "api", store=None) -> dict:
    """Live migration = the suspend/resume primitive aimed at a
    *different* placement: record the nodes the slice currently
    occupies as the rebind's exclusion set, stamp the migrate request,
    and drive the normal suspend lifecycle (reason="migrate"). The
    drain auto-resumes (never parks) and ``gang_bind`` skips the
    excluded nodes, so the slice comes back elsewhere with its state
    restored. ``trigger`` is "api" (explicit drain verb) or
    "fragmentation" (the compaction autopilot). Idempotent."""
    name, ns = name_of(notebook), namespace_of(notebook)
    nodes = sorted({
        deep_get(p, "spec", "nodeName")
        for p in api.list("Pod", ns)
        if (p["metadata"].get("labels") or {}).get(
            nb_api.NOTEBOOK_NAME_LABEL) == name
        and deep_get(p, "spec", "nodeName")})
    acted: list = []

    def mutate(nb: dict) -> bool:
        ann = annotations_of(nb)
        if (nb_api.MIGRATE_REQUESTED_ANNOTATION in ann
                or nb_api.SUSPEND_ANNOTATION in ann
                or nb_api.STOP_ANNOTATION in ann
                or nb_api.RESUME_REQUESTED_ANNOTATION in ann):
            return False  # mid-lifecycle: nothing to migrate from
        set_annotation(nb, nb_api.MIGRATE_REQUESTED_ANNOTATION,
                       api.clock().isoformat())
        set_annotation(nb, nb_api.MIGRATE_EXCLUDE_ANNOTATION,
                       json.dumps(nodes))
        acted.append(True)
        return True

    live = _update_retrying(api, notebook, mutate)
    if acted:
        metrics.NOTEBOOK_MIGRATION_TOTAL.labels(trigger=trigger).inc()
        api.record_event(
            live, "Normal", "Migrating",
            f"live migration requested ({trigger}): checkpoint, drain "
            f"off {nodes}, re-bind elsewhere")
        live = initiate_suspend(api, live, reason="migrate", store=store)
    return live


def kick_pending_pods(api: APIServer, *, now: str) -> None:
    """Requeue every slice still waiting for chips: freed capacity
    doesn't emit an event any controller watches, so after a drain we
    bump an annotation on each unbound Pending pod — its update event
    maps to the owning StatefulSet, whose reconcile retries the
    gang-bind. Best-effort: a lost kick is recovered by the next drain
    or the long-poll's periodic backstop."""
    scan = getattr(api, "scan", api.list)
    for p in scan("Pod"):
        if deep_get(p, "spec", "nodeName"):
            continue
        if deep_get(p, "status", "phase") not in (None, "Pending"):
            continue
        pod = api.try_get("Pod", name_of(p), namespace_of(p))
        if pod is None:
            continue
        set_annotation(pod, _KICK_ANNOTATION, now)
        try:
            api.update(pod)
        except (Conflict, NotFound):
            pass


# ---- the controller --------------------------------------------------

class SuspendController(Controller):
    """Owns both halves of the lifecycle.

    Suspend half: once a suspend-annotated notebook's pods are gone,
    release any cache residue, stamp the drained timestamp, observe the
    drain latency. With ``suspend_idle_minutes`` set it also *initiates*
    suspension for idle notebooks (last-activity / worker-0 start,
    same clock the culler uses) — a gentler tier below culling.

    Resume half: when a resume-requested notebook is ready again,
    restore the state store token, stamp ``RESTORED_STEP_ANNOTATION``,
    observe rebind+restore latency. Pod events requeue it (same label
    watch as the notebook controller), so the loop is event-driven —
    deterministic under ``run_until_idle`` with an injected clock.
    """

    kind = nb_api.KIND

    def __init__(self, suspend_idle_minutes: float | None = None,
                 check_period_minutes: float = DEFAULT_CHECK_PERIOD_MIN,
                 store=None):
        self.suspend_idle = (
            datetime.timedelta(minutes=suspend_idle_minutes)
            if suspend_idle_minutes is not None else None)
        self.check_period = datetime.timedelta(minutes=check_period_minutes)
        self._store = store

    @property
    def store(self):
        return self._store if self._store is not None else _state_store

    def watches(self):
        return (("Pod", map_by_label(nb_api.NOTEBOOK_NAME_LABEL)),)

    def reconcile(self, api: APIServer, req: Request):
        try:
            notebook = api.get(nb_api.KIND, req.name, req.namespace)
        except NotFound:
            return None
        if notebook["metadata"].get("deletionTimestamp"):
            return None
        ann = annotations_of(notebook)
        if nb_api.STOP_ANNOTATION in ann:
            return None  # user-stopped: the stop lifecycle owns it
        if nb_api.SUSPEND_ANNOTATION in ann:
            return self._reconcile_suspending(api, notebook)
        if nb_api.RESUME_REQUESTED_ANNOTATION in ann:
            return self._reconcile_resuming(api, notebook)
        return self._maybe_suspend_idle(api, notebook)

    # -- suspend half --------------------------------------------------
    def _reconcile_suspending(self, api: APIServer, notebook: dict):
        ann = annotations_of(notebook)
        if nb_api.SUSPEND_DRAINED_ANNOTATION in ann:
            if nb_api.MIGRATE_REQUESTED_ANNOTATION in ann:
                # a migration never parks: the drain completing IS the
                # resume trigger — the re-bind excludes the old nodes
                request_resume(api, notebook, source="migration")
            return None  # drained and parked; resume is event-driven
        name, ns = name_of(notebook), namespace_of(notebook)
        pods = [p for p in api.list("Pod", ns)
                if (p["metadata"].get("labels") or {}).get(
                    nb_api.NOTEBOOK_NAME_LABEL) == name]
        if pods:
            return None  # scale-down in flight; pod deletes requeue us
        # drained: purge any cache residue (assumed binds whose delete
        # events haven't cleared the fanout) so the pool sees the chips
        if not scheduler.legacy_scan():
            sched = scheduler.cache_for(api)
            for i in range(nb_api.total_hosts(notebook)):
                sched.release((ns, f"{name}-{i}"))
        now = api.clock()

        def mutate(nb: dict) -> bool:
            a = annotations_of(nb)
            if (nb_api.SUSPEND_ANNOTATION not in a
                    or nb_api.SUSPEND_DRAINED_ANNOTATION in a):
                return False
            set_annotation(nb, nb_api.SUSPEND_DRAINED_ANNOTATION,
                           now.isoformat())
            return True

        live = _update_retrying(api, notebook, mutate)
        drained = annotations_of(live).get(
            nb_api.SUSPEND_DRAINED_ANNOTATION)
        if drained == now.isoformat():  # we won the stamp: observe once
            since = _parse_ts(annotations_of(live).get(
                nb_api.SUSPEND_ANNOTATION))
            if since is not None:
                metrics.SUSPEND_RESUME_SECONDS.labels(
                    phase="drain").observe(
                        max(0.0, (now - since).total_seconds()))
            api.record_event(
                live, "Normal", "Suspended",
                f"slice drained; {nb_api.total_hosts(live)} host(s) of "
                "chips returned to the pool")
            kick_pending_pods(api, now=now.isoformat())
        if nb_api.MIGRATE_REQUESTED_ANNOTATION in annotations_of(live):
            request_resume(api, live, source="migration")
        return None

    # -- resume half -----------------------------------------------------
    def _reconcile_resuming(self, api: APIServer, notebook: dict):
        want = nb_api.total_hosts(notebook)
        ready = deep_get(notebook, "status", "readyReplicas", default=0)
        if ready < want:
            # not re-ganged yet: pod/status events requeue us; the
            # periodic tick below is only a backstop for lost events
            return self.check_period.total_seconds()
        ann = annotations_of(notebook)
        was_migration = nb_api.MIGRATE_REQUESTED_ANNOTATION in ann
        token = None
        raw = ann.get(nb_api.SUSPEND_CHECKPOINT_ANNOTATION)
        if raw:
            try:
                token = json.loads(raw)
            except ValueError:
                token = None
        now = api.clock()
        requested = _parse_ts(ann.get(nb_api.RESUME_REQUESTED_ANNOTATION))

        def mutate(nb: dict) -> bool:
            a = annotations_of(nb)
            if nb_api.RESUME_REQUESTED_ANNOTATION not in a:
                return False
            a.pop(nb_api.RESUME_REQUESTED_ANNOTATION, None)
            a.pop(nb_api.SUSPEND_CHECKPOINT_ANNOTATION, None)
            a.pop(nb_api.SUSPEND_DRAINED_ANNOTATION, None)
            a.pop(nb_api.SUSPEND_REASON_ANNOTATION, None)
            a.pop(nb_api.MIGRATE_REQUESTED_ANNOTATION, None)
            a.pop(nb_api.MIGRATE_EXCLUDE_ANNOTATION, None)
            if restored is not None and "step" in restored:
                set_annotation(nb, nb_api.RESTORED_STEP_ANNOTATION,
                               str(restored["step"]))
            return True

        # restore + finalize under the same per-notebook guard the
        # suspend half holds: two racers (suspend vs promote) serialize
        # here instead of interleaving a half-restored standby
        with _store_guard(namespace_of(notebook), name_of(notebook)):
            t0 = time.perf_counter()
            restored = self.store.restore(notebook, token)
            restore_s = time.perf_counter() - t0
            live = _update_retrying(api, notebook, mutate)
        if nb_api.RESUME_REQUESTED_ANNOTATION not in annotations_of(live):
            metrics.SUSPEND_RESUME_SECONDS.labels(
                phase="restore").observe(restore_s)
            if requested is not None:
                metrics.SUSPEND_RESUME_SECONDS.labels(
                    phase="rebind").observe(
                        max(0.0, (now - requested).total_seconds()))
            metrics.NOTEBOOK_RESUME_TOTAL.inc()
            api.record_event(
                live, "Normal", "Resumed",
                "slice re-ganged and state restored"
                + (f" at step {restored['step']}"
                   if restored and "step" in restored else ""))
            if was_migration:
                nodes = sorted({
                    deep_get(p, "spec", "nodeName")
                    for p in api.list("Pod", namespace_of(live))
                    if (p["metadata"].get("labels") or {}).get(
                        nb_api.NOTEBOOK_NAME_LABEL) == name_of(live)
                    and deep_get(p, "spec", "nodeName")})
                api.record_event(
                    live, "Normal", "Migrated",
                    f"slice live-migrated: re-ganged on {nodes} with "
                    "state restored")
        return None

    # -- idle initiation -------------------------------------------------
    def _maybe_suspend_idle(self, api: APIServer, notebook: dict):
        if self.suspend_idle is None or not oversubscribe():
            return None
        if nb_api.tpu_spec(notebook) is None:
            return None  # CPU notebooks hold no chips worth reclaiming
        ann = annotations_of(notebook)
        if (nb_api.is_pinned(notebook)
                or ann.get(nb_api.CULLING_EXCLUDE_ANNOTATION) == "true"):
            return None
        want = nb_api.total_hosts(notebook)
        ready = deep_get(notebook, "status", "readyReplicas", default=0)
        if ready < want:
            return self.check_period.total_seconds()
        now = api.clock()
        idle_since = _parse_ts(ann.get(nb_api.LAST_ACTIVITY_ANNOTATION))
        pod0 = api.try_get("Pod", f"{name_of(notebook)}-0",
                           namespace_of(notebook))
        started = _parse_ts(deep_get(
            pod0, "status", "containerStatuses", 0, "state", "running",
            "startedAt") if pod0 else None)
        # a freshly (re)started slice restarts its idle clock — a
        # resumed notebook gets a full idle window before re-parking
        if started is not None and (idle_since is None
                                    or started > idle_since):
            idle_since = started
        if idle_since is None:
            idle_since = _parse_ts(
                notebook["metadata"].get("creationTimestamp")) or now
        if now - idle_since >= self.suspend_idle:
            initiate_suspend(api, notebook, reason="idle",
                             store=self.store)
            return None
        return self.check_period.total_seconds()


# ---- replicated kernels: warm standbys + demand-resume failover ------

def _parse_states(ann: dict) -> dict | None:
    raw = ann.get(nb_api.REPLICA_STATES_ANNOTATION)
    if not raw:
        return None
    try:
        st = json.loads(raw)
    except ValueError:
        return None
    return st if isinstance(st, dict) else None


class ReplicaFailoverController(Controller):
    """NotebookOS replicated kernels over the suspend/resume primitive.

    ``spec.replicas: R`` > 1 keeps one *active* replica holding the
    chips and R−1 parked CPU-only standbys (rendered by the notebook
    controller as a ``{name}-standby`` StatefulSet) whose warm state is
    the checkpoint token this controller refreshes as the active
    replica's durable training step advances.

    On active-replica death — a Failed gang pod (kubelet detection) or
    a rump slice — a standby promotes by *demand-resume*: one CAS
    stamps the warm checkpoint token + resume request + failover clock
    and rotates the active-replica pointer; the dead gang's pods are
    deleted and their cache charges released, and the existing resume
    machinery re-binds chips through ``gang_bind`` and restores state.
    Promotion completes (promoting → active, failover latency observed)
    when the resume finishes — warm-standby takeover at resume latency
    instead of cold-provision latency."""

    kind = nb_api.KIND

    def __init__(self, store=None):
        self._store = store

    @property
    def store(self):
        return self._store if self._store is not None else _state_store

    def watches(self):
        return (("Pod", map_by_label(nb_api.NOTEBOOK_NAME_LABEL)),)

    def reconcile(self, api: APIServer, req: Request):
        try:
            nb = api.get(nb_api.KIND, req.name, req.namespace)
        except NotFound:
            return None
        if nb["metadata"].get("deletionTimestamp"):
            return None
        replicas = nb_api.replicas_of(nb)
        ann = annotations_of(nb)
        states = _parse_states(ann)
        if replicas <= 1:
            if states is not None:
                self._clear_replica_state(api, nb)
            return None
        if states is None:
            return self._init_states(api, nb, replicas)
        if nb_api.STOP_ANNOTATION in ann:
            return None  # user-stopped: drained pods are expected
        if (nb_api.SUSPEND_ANNOTATION in ann
                or nb_api.RESUME_REQUESTED_ANNOTATION in ann):
            return None  # mid suspend/resume; pod events requeue us
        hosts = nb_api.total_hosts(nb)
        name, ns = req.name, req.namespace
        pods = [p for p in api.list("Pod", ns)
                if (p["metadata"].get("labels") or {}).get(
                    nb_api.NOTEBOOK_NAME_LABEL) == name
                and not p["metadata"].get("deletionTimestamp")]
        failed = [p for p in pods
                  if deep_get(p, "status", "phase") == "Failed"]
        running = [p for p in pods
                   if deep_get(p, "status", "phase") == "Running"]
        promoting = [i for i, s in states.items() if s == "promoting"]
        ready = deep_get(nb, "status", "readyReplicas", default=0)
        if promoting:
            # promotion in flight: the informer can still hold the dead
            # gang's Failed pods (we just deleted them) and the re-bound
            # slice recreates pods one at a time — both read as "death"
            # and would ping-pong the active pointer. Deaths of the
            # promoted gang itself heal through slice restart, so the
            # only move here is finishing the promotion.
            if ready >= hosts:
                return self._finalize_promotion(api, nb, ann)
            return None
        if ready >= hosts:
            # a Failed pod (or rump) while status still reads fully
            # Ready is single-source evidence: either a genuine death
            # whose status mirror hasn't landed (the mirror write
            # requeues us in ms) or a stale informer view of a gang we
            # already replaced (which must NOT rotate the pointer
            # again). Require both sources to agree before acting.
            self._refresh_warm(api, nb, ann)
            return None
        if failed or (running and len(pods) < hosts):
            evidence = "; ".join(
                [f"{name_of(p)}({p['metadata'].get('uid', '?')})="
                 f"{deep_get(p, 'status', 'phase')}" for p in failed]
                or [f"rump slice {len(pods)}/{hosts}"])
            return self._failover(api, nb, ann, hosts, evidence)
        return None

    def _clear_replica_state(self, api: APIServer, nb: dict):
        def mutate(o: dict) -> bool:
            a = annotations_of(o)
            if nb_api.REPLICA_STATES_ANNOTATION not in a:
                return False
            for k in (nb_api.REPLICA_STATES_ANNOTATION,
                      nb_api.ACTIVE_REPLICA_ANNOTATION,
                      nb_api.WARM_CHECKPOINT_ANNOTATION,
                      nb_api.FAILOVER_T0_ANNOTATION):
                a.pop(k, None)
            return True
        _update_retrying(api, nb, mutate)
        return None

    def _init_states(self, api: APIServer, nb: dict, replicas: int):
        def mutate(o: dict) -> bool:
            a = annotations_of(o)
            if nb_api.REPLICA_STATES_ANNOTATION in a:
                return False
            st = {"0": "active"}
            st.update({str(i): "standby" for i in range(1, replicas)})
            set_annotation(o, nb_api.REPLICA_STATES_ANNOTATION,
                           json.dumps(st))
            set_annotation(o, nb_api.ACTIVE_REPLICA_ANNOTATION, "0")
            return True
        live = _update_retrying(api, nb, mutate)
        if _parse_states(annotations_of(live)):
            api.record_event(
                live, "Normal", "ReplicasInitialized",
                f"replica 0 active, {replicas - 1} warm standby(s)")
        return None

    def _refresh_warm(self, api: APIServer, nb: dict, ann: dict):
        """Keep the standbys' warm token at the active replica's
        durable step — what a promotion will restore."""
        try:
            cur = int(ann.get(nb_api.TRAINING_STEP_ANNOTATION) or 0)
        except (TypeError, ValueError):
            cur = 0
        raw = ann.get(nb_api.WARM_CHECKPOINT_ANNOTATION)
        if raw:
            try:
                if json.loads(raw).get("step", -1) >= cur:
                    return  # warm state already current
            except ValueError:
                pass
        token = self.store.snapshot(nb)
        blob = json.dumps(token)

        def mutate(o: dict) -> bool:
            a = annotations_of(o)
            if (nb_api.SUSPEND_ANNOTATION in a
                    or nb_api.RESUME_REQUESTED_ANNOTATION in a
                    or a.get(nb_api.WARM_CHECKPOINT_ANNOTATION) == blob):
                return False
            set_annotation(o, nb_api.WARM_CHECKPOINT_ANNOTATION, blob)
            return True
        _update_retrying(api, nb, mutate)

    def _failover(self, api: APIServer, nb: dict, ann: dict,
                  hosts: int, evidence: str = ""):
        """Active replica died: promote the lowest standby by
        demand-resume. One CAS stamps checkpoint token + resume request
        + failover clock and rotates the pointer; then the dead gang is
        torn down so the resume machinery re-binds cleanly."""
        name, ns = name_of(nb), namespace_of(nb)
        t0 = api.clock().isoformat()
        warm = None
        raw = ann.get(nb_api.WARM_CHECKPOINT_ANNOTATION)
        if raw:
            try:
                warm = json.loads(raw)
            except ValueError:
                warm = None
        acted: list = []

        def mutate(o: dict) -> bool:
            a = annotations_of(o)
            if (nb_api.SUSPEND_ANNOTATION in a
                    or nb_api.RESUME_REQUESTED_ANNOTATION in a
                    or nb_api.STOP_ANNOTATION in a
                    # failover clock still stamped: the previous
                    # promotion hasn't finalized — refuse inside the
                    # CAS so a stale reread can't double-rotate
                    or nb_api.FAILOVER_T0_ANNOTATION in a):
                return False  # a lifecycle already owns the slice
            st = _parse_states(a)
            if not st:
                return False
            standbys = sorted(int(i) for i, s in st.items()
                              if s == "standby")
            if not standbys:
                return False  # nothing to promote
            target = standbys[0]
            old = a.get(nb_api.ACTIVE_REPLICA_ANNOTATION, "0")
            token = warm if warm is not None else self.store.snapshot(o)
            set_annotation(o, nb_api.SUSPEND_REASON_ANNOTATION,
                           "failover")
            set_annotation(o, nb_api.SUSPEND_CHECKPOINT_ANNOTATION,
                           json.dumps(token))
            set_annotation(o, nb_api.RESUME_REQUESTED_ANNOTATION, t0)
            set_annotation(o, nb_api.FAILOVER_T0_ANNOTATION, t0)
            set_annotation(o, nb_api.ACTIVE_REPLICA_ANNOTATION,
                           str(target))
            if str(old) in st:
                st[str(old)] = "standby"
            st[str(target)] = "promoting"
            set_annotation(o, nb_api.REPLICA_STATES_ANNOTATION,
                           json.dumps(st))
            acted[:] = [old, target]
            return True

        # the promotion CAS is a restore-path writer: serialize with
        # any concurrent suspend of the same notebook
        with _store_guard(ns, name):
            live = _update_retrying(api, nb, mutate)
        if not acted:
            return None
        api.record_event(
            live, "Warning", "FailingOver",
            f"active replica {acted[0]} died"
            + (f" ({evidence})" if evidence else "")
            + f"; standby {acted[1]} promoting by demand-resume "
            "(warm checkpoint, re-binding chips)")
        # tear the dead gang down by ordinal and release cache charges
        # so the re-bind sees the chips immediately
        sched = (scheduler.cache_for(api)
                 if not scheduler.legacy_scan() else None)
        for i in range(hosts):
            try:
                api.delete("Pod", f"{name}-{i}", ns)
            except NotFound:
                pass
            if sched is not None:
                sched.release((ns, f"{name}-{i}"))
        return None

    def _finalize_promotion(self, api: APIServer, nb: dict, ann: dict):
        now = api.clock()
        t0 = _parse_ts(ann.get(nb_api.FAILOVER_T0_ANNOTATION))
        acted: list = []

        def mutate(o: dict) -> bool:
            a = annotations_of(o)
            if nb_api.RESUME_REQUESTED_ANNOTATION in a:
                return False  # resume still in flight
            st = _parse_states(a)
            if not st:
                return False
            promoting = [i for i, s in st.items() if s == "promoting"]
            if not promoting:
                return False
            for i in promoting:
                st[i] = "active"
            set_annotation(o, nb_api.REPLICA_STATES_ANNOTATION,
                           json.dumps(st))
            a.pop(nb_api.FAILOVER_T0_ANNOTATION, None)
            acted[:] = promoting
            return True

        live = _update_retrying(api, nb, mutate)
        if acted:
            metrics.NOTEBOOK_FAILOVER_TOTAL.inc()
            if t0 is not None:
                metrics.NOTEBOOK_FAILOVER_SECONDS.observe(
                    max(0.0, (now - t0).total_seconds()))
            step = annotations_of(live).get(
                nb_api.RESTORED_STEP_ANNOTATION)
            api.record_event(
                live, "Normal", "FailedOver",
                f"replica {acted[0]} promoted to active; state restored"
                + (f" at step {step}" if step is not None else ""))
        return None


# ---- fragmentation-triggered live migration (compaction) -------------

_auto_migration = False


def set_auto_migration(enabled: bool) -> None:
    """Enable the compaction autopilot: a gang admissible only after
    defragmentation triggers a live migration of a small victim slice.
    Off by default — the static-placement arm and pre-existing suites
    keep today's behavior."""
    global _auto_migration
    _auto_migration = bool(enabled)


def auto_migration() -> bool:
    return _auto_migration


def try_compact_migration(api: APIServer, sts: dict,
                          unbound: list[dict],
                          sched: "scheduler.SchedulerCache", *,
                          allow_virtual: bool) -> None:
    """A gang failed to bind AND the fragmentation gauge says the free
    chips would seat it if they weren't stranded: live-migrate the
    smallest victim whose removal admits the waiter. The victim drains
    off its nodes (checkpoint → drain, excluded from rebinding there)
    and the freed contiguous capacity admits the waiter; the victim
    re-gangs wherever fits (best-effort — it parks until capacity
    otherwise). At most one migration in flight cluster-wide keeps the
    autopilot deterministic and non-thrashing."""
    if (not _auto_migration or not oversubscribe()
            or scheduler.legacy_scan()):
        return
    needed = sum(scheduler._pod_chips(p) for p in unbound)
    if not needed:
        return
    stats = sched.stats()
    if stats["free_chips"] < needed or stats["fragmentation"] <= 0.0:
        return  # not a fragmentation problem: capacity is simply short
    scan = getattr(api, "scan", api.list)
    waiter_key = (namespace_of(sts),
                  (sts["metadata"].get("labels") or {}).get(
                      nb_api.NOTEBOOK_NAME_LABEL) or name_of(sts))
    candidates: list[_Victim] = []
    for nb in scan(nb_api.KIND):
        ann = annotations_of(nb)
        if nb_api.MIGRATE_REQUESTED_ANNOTATION in ann:
            return  # a migration is already in flight: let it land
        if (nb["metadata"].get("deletionTimestamp")
                or nb_api.SUSPEND_ANNOTATION in ann
                or nb_api.STOP_ANNOTATION in ann
                or nb_api.RESUME_REQUESTED_ANNOTATION in ann
                or nb_api.is_pinned(nb)):
            continue
        if (namespace_of(nb), name_of(nb)) == waiter_key:
            continue
        name, ns = name_of(nb), namespace_of(nb)
        pods = [p for p in scan("Pod", ns)
                if (p["metadata"].get("labels") or {}).get(
                    nb_api.NOTEBOOK_NAME_LABEL) == name
                and deep_get(p, "spec", "nodeName")
                and deep_get(p, "status", "phase")
                not in scheduler.TERMINAL_PHASES]
        v = _Victim(nb, pods, nb_api.priority_of(nb), "")
        if v.chips:
            candidates.append(v)
    # smallest slice first: compaction should shuffle the cheapest
    # tenant, not shatter a big one
    candidates.sort(key=lambda v: (v.chips, name_of(v.notebook)))
    by_node = sched.free_by_node()
    free = {node: f for node, (f, _labels) in by_node.items()}
    labels = {node: lb for node, (_f, lb) in by_node.items()}
    for v in candidates:
        if _fits(unbound, free, dict(v.per_node), labels, allow_virtual):
            api.record_event(
                sts, "Normal", "CompactionMigration",
                f"gang admissible only after compaction (fragmentation "
                f"{stats['fragmentation']:.2f}, {stats['free_chips']:.0f}"
                f" chips free); live-migrating "
                f"{name_of(v.notebook)} ({v.chips:.0f} chips) off "
                f"{sorted(v.per_node)}")
            initiate_migration(api, v.notebook, trigger="fragmentation")
            return
    return


# ---- active fragmentation-driven defrag (scheduler policy arm) -------
# r11 added the fragmentation gauge; r15 made compaction migration a
# LAST RESORT (only when a gang already failed to bind). This promotes
# it to an ACTIVE placement policy: whenever fragmentation crosses the
# threshold, proactively migrate the cheapest victim whose removal
# grows the largest contiguous free block — so the next gang arrival
# finds contiguous capacity instead of paying the migrate-under-
# pressure latency. ON by default since the ratchet A/B proved the
# admission-latency win (the off arm failed the provision gate the
# active arm passed, ~30% higher spawn p50); --no-active-defrag is the
# escape hatch / baseline arm.

_active_defrag = True
ACTIVE_DEFRAG_FRAGMENTATION = 0.5


def set_active_defrag(enabled: bool) -> None:
    global _active_defrag
    _active_defrag = bool(enabled)


def active_defrag() -> bool:
    return _active_defrag


def maybe_active_defrag(api: APIServer,
                        sched: "scheduler.SchedulerCache", *,
                        allow_virtual: bool = False) -> bool:
    """One proactive compaction step, threshold-gated. Returns True if
    a migration was initiated. Reuses the last-resort machinery's
    victim model and in-flight guard (at most one migration cluster-
    wide), but is driven by the fragmentation gauge alone — no waiting
    gang required. The victim must (a) grow the largest contiguous
    free block and (b) plausibly re-land elsewhere (its biggest pod
    fits on some node it does not currently occupy), so defrag never
    evicts a slice into indefinite parking."""
    if not _active_defrag or not oversubscribe() \
            or scheduler.legacy_scan():
        return False
    stats = sched.stats()
    if stats["free_chips"] <= 0 \
            or stats["fragmentation"] < ACTIVE_DEFRAG_FRAGMENTATION:
        return False
    scan = getattr(api, "scan", api.list)
    candidates: list[_Victim] = []
    for nb in scan(nb_api.KIND):
        ann = annotations_of(nb)
        if nb_api.MIGRATE_REQUESTED_ANNOTATION in ann:
            return False  # one migration in flight: let it land
        if (nb["metadata"].get("deletionTimestamp")
                or nb_api.SUSPEND_ANNOTATION in ann
                or nb_api.STOP_ANNOTATION in ann
                or nb_api.RESUME_REQUESTED_ANNOTATION in ann
                or nb_api.is_pinned(nb)):
            continue
        name, ns = name_of(nb), namespace_of(nb)
        pods = [p for p in scan("Pod", ns)
                if (p["metadata"].get("labels") or {}).get(
                    nb_api.NOTEBOOK_NAME_LABEL) == name
                and deep_get(p, "spec", "nodeName")
                and deep_get(p, "status", "phase")
                not in scheduler.TERMINAL_PHASES]
        v = _Victim(nb, pods, nb_api.priority_of(nb), "")
        if v.chips:
            candidates.append(v)
    candidates.sort(key=lambda v: (v.chips, name_of(v.notebook)))
    by_node = sched.free_by_node()
    free = {node: f for node, (f, _labels) in by_node.items()}
    cur_block = max(free.values(), default=0.0)
    for v in candidates:
        grown = dict(free)
        for node, c in v.per_node.items():
            grown[node] = grown.get(node, 0.0) + c
        if max(grown.values(), default=0.0) <= cur_block:
            continue  # moving it wouldn't consolidate anything
        biggest_pod = max(
            (scheduler._pod_chips(p) for p in v.pods), default=0.0)
        elsewhere = max(
            (f for node, f in free.items() if node not in v.per_node),
            default=0.0)
        if elsewhere < biggest_pod and not allow_virtual:
            continue  # nowhere to re-land: would park, not defrag
        api.record_event(
            v.notebook, "Normal", "ActiveDefrag",
            f"fragmentation {stats['fragmentation']:.2f} >= "
            f"{ACTIVE_DEFRAG_FRAGMENTATION}: proactively migrating "
            f"{name_of(v.notebook)} ({v.chips:.0f} chips) off "
            f"{sorted(v.per_node)} to consolidate free capacity")
        initiate_migration(api, v.notebook, trigger="fragmentation")
        return True
    return False


# ---- preemptive gang-bind --------------------------------------------

class _Victim:
    __slots__ = ("notebook", "pods", "chips", "per_node", "priority",
                 "idle_key")

    def __init__(self, notebook, pods, priority, idle_key):
        self.notebook = notebook
        self.pods = pods
        self.priority = priority
        self.idle_key = idle_key
        self.per_node: dict[str, float] = {}
        self.chips = 0.0
        for p in pods:
            node = deep_get(p, "spec", "nodeName")
            c = scheduler._pod_chips(p)
            if node and c:
                self.per_node[node] = self.per_node.get(node, 0.0) + c
                self.chips += c


def try_preempt(api: APIServer, sts: dict, unbound: list[dict],
                sched: "scheduler.SchedulerCache", *,
                allow_virtual: bool) -> dict[tuple, str] | None:
    """A gang that couldn't bind gets one more chance: suspend strictly
    lower-priority victim slices (never pinned ones) through the normal
    suspend lifecycle, delete their pods (kube-scheduler's preemption
    semantics — the victim's controller converges on replicas=0 from
    the suspend annotation), and retry the gang-bind. Victim choice is
    simulated first so an insufficient pool suspends nobody; selection
    order is (priority asc, idleness desc, fragmentation fit). Returns
    a bind plan like ``gang_bind`` or None."""
    if not oversubscribe() or scheduler.legacy_scan():
        _preempt_skipped(
            "oversubscribe_off" if not oversubscribe() else "legacy_scan",
            sts)
        return None
    # harvest leases first (r20): serving work on borrowed notebook
    # chips is instantly reclaimable by ANY gang — no priority check,
    # no victim simulation. A resuming notebook's failed re-bind lands
    # here, which is exactly the "notebook resume outranks serving"
    # contract.
    plan = _try_harvest_reclaim(api, sts, unbound, sched,
                                allow_virtual=allow_virtual)
    if plan is not None:
        return plan
    nb_name = (sts["metadata"].get("labels") or {}).get(
        nb_api.NOTEBOOK_NAME_LABEL)
    if not nb_name:
        # TPUJob-vs-TPUJob preemption (ROADMAP item 5) lands here: the
        # gang's owner carries no Notebook priority to preempt with —
        # a visible gap now, not a silent one
        _preempt_skipped("not_notebook_owner", sts)
        return None
    ns = namespace_of(sts)
    incoming = api.try_get(nb_api.KIND, nb_name, ns)
    if incoming is None:
        _preempt_skipped("owner_missing", sts)
        return None
    incoming_pri = nb_api.priority_of(incoming)
    needed = sum(scheduler._pod_chips(p) for p in unbound)
    if not needed:
        _preempt_skipped("no_chips_needed", sts)
        return None

    victims = _candidate_victims(api, incoming, incoming_pri, needed)
    if not victims:
        _preempt_skipped("no_viable_victims", sts)
        return None

    by_node = sched.free_by_node()
    free = {node: f for node, (f, _labels) in by_node.items()}
    labels = {node: lb for node, (_f, lb) in by_node.items()}
    chosen: list[_Victim] = []
    for v in victims:
        chosen.append(v)
        extra: dict[str, float] = {}
        for c in chosen:
            for node, chips in c.per_node.items():
                extra[node] = extra.get(node, 0.0) + chips
        if _fits(unbound, free, extra, labels, allow_virtual):
            break
    else:
        # even suspending every candidate wouldn't fit
        _preempt_skipped("insufficient_victims", sts)
        return None

    for v in chosen:
        initiate_suspend(api, v.notebook, reason="preempted")
        # scale the victim's StatefulSet down ourselves before deleting
        # its pods — its kubelet reconcile must not race a recreate in
        # the window before the notebook controller re-renders
        v_sts = api.try_get("StatefulSet", name_of(v.notebook),
                            namespace_of(v.notebook))
        if v_sts is not None and deep_get(
                v_sts, "spec", "replicas", default=0):
            for _ in range(4):
                v_sts["spec"]["replicas"] = 0
                try:
                    api.update(v_sts)
                    break
                except Conflict:
                    v_sts = api.try_get(
                        "StatefulSet", name_of(v.notebook),
                        namespace_of(v.notebook))
                    if v_sts is None:
                        break
        for p in v.pods:
            key = (namespace_of(p), name_of(p))
            try:
                api.delete("Pod", key[1], key[0])
            except NotFound:
                pass
            sched.release(key)
        metrics.NOTEBOOK_PREEMPT_TOTAL.inc()
    api.record_event(
        sts, "Normal", "Preempted",
        f"suspended {len(chosen)} lower-priority slice(s) "
        f"({', '.join(name_of(v.notebook) for v in chosen)}) to admit "
        f"this {len(unbound)}-host gang")
    return sched.gang_bind(unbound, allow_virtual=allow_virtual)


def _try_harvest_reclaim(api: APIServer, sts: dict,
                         unbound: list[dict],
                         sched: "scheduler.SchedulerCache", *,
                         allow_virtual: bool
                         ) -> dict[tuple, str] | None:
    """Give harvested chips back to a waiting gang. The attached
    ChipHarvestController drains its serving replicas (in-flight
    requests migrate bit-exactly through the fleet) and releases the
    leases synchronously; the gang then retries its bind against the
    freed capacity. Returns a bind plan or None."""
    if sched.harvested_chips() <= 0:
        return None
    trigger = "preempt"
    nb_name = (sts["metadata"].get("labels") or {}).get(
        nb_api.NOTEBOOK_NAME_LABEL)
    if nb_name:
        owner = api.try_get(nb_api.KIND, nb_name, namespace_of(sts))
        if owner is not None and (nb_api.RESUME_REQUESTED_ANNOTATION
                                  in annotations_of(owner)):
            trigger = "resume"
    freed = sched.reclaim_harvested(trigger=trigger)
    if freed <= 0:
        return None
    api.record_event(
        sts, "Normal", "HarvestReclaimed",
        f"reclaimed {freed:.0f} harvested chip(s) from the serving "
        f"fleet ({trigger}) — notebook demand outranks harvested "
        "serving")
    return sched.gang_bind(unbound, allow_virtual=allow_virtual)


def _preempt_skipped(reason: str, sts: dict) -> None:
    """Account for a preemption opportunity that could not be served —
    the counter (``preempt_skipped_total{reason}``) plus a log line
    turn the silent skips (notably non-Notebook gang owners) into a
    measurable gap."""
    metrics.PREEMPT_SKIPPED_TOTAL.labels(reason=reason).inc()
    log.info("preemption skipped for %s/%s: %s",
             namespace_of(sts), name_of(sts), reason)


def _candidate_victims(api: APIServer, incoming: dict,
                       incoming_pri: int, needed: float) -> list:
    scan = getattr(api, "scan", api.list)
    out: list[_Victim] = []
    in_key = (namespace_of(incoming), name_of(incoming))
    for nb in scan(nb_api.KIND):
        if (namespace_of(nb), name_of(nb)) == in_key:
            continue
        if nb["metadata"].get("deletionTimestamp"):
            continue
        ann = annotations_of(nb)
        if (nb_api.SUSPEND_ANNOTATION in ann
                or nb_api.STOP_ANNOTATION in ann
                or nb_api.RESUME_REQUESTED_ANNOTATION in ann):
            continue
        if nb_api.is_pinned(nb):
            continue
        pri = nb_api.priority_of(nb)
        if pri >= incoming_pri:
            continue  # preemption displaces strictly lower priority only
        name, ns2 = name_of(nb), namespace_of(nb)
        pods = [p for p in scan("Pod", ns2)
                if (p["metadata"].get("labels") or {}).get(
                    nb_api.NOTEBOOK_NAME_LABEL) == name
                and deep_get(p, "spec", "nodeName")
                and deep_get(p, "status", "phase")
                not in scheduler.TERMINAL_PHASES]
        v = _Victim(nb, pods, pri,
                    ann.get(nb_api.LAST_ACTIVITY_ANNOTATION)
                    or nb["metadata"].get("creationTimestamp") or "")
        if not v.chips:
            continue
        out.append(v)
    # lowest priority, then longest idle (oldest activity stamp), then
    # the fragmentation fit: smallest sufficient slice first so a big
    # victim isn't shattered to seat a small gang
    out.sort(key=lambda v: (
        v.priority, v.idle_key,
        (v.chips < needed, abs(v.chips - needed))))
    return out


def _fits(unbound: list[dict], free: dict[str, float],
          extra: dict[str, float], labels: dict[str, dict],
          allow_virtual: bool) -> bool:
    """Dry-run of the gang first-fit against free+released capacity —
    mirrors ``SchedulerCache._try_gang`` selection without locks."""
    from kubeflow_rm_tpu_torch.controlplane.api.meta import matches_selector
    tentative: dict[str, float] = {}
    for pod in sorted(unbound, key=name_of):
        selector = deep_get(pod, "spec", "nodeSelector", default={}) or {}
        need = scheduler._pod_chips(pod)
        chosen = None
        for node, f in free.items():
            if selector and not matches_selector(
                    labels.get(node, {}), {"matchLabels": selector}):
                continue
            if need:
                avail = f + extra.get(node, 0.0) - tentative.get(node, 0.0)
                if need > avail:
                    continue
            chosen = node
            break
        if chosen is None:
            if allow_virtual and not selector and not need:
                continue
            return False
        if need:
            tentative[chosen] = tentative.get(chosen, 0.0) + need
    return True


def _parse_ts(raw) -> datetime.datetime | None:
    if not raw:
        return None
    try:
        return datetime.datetime.fromisoformat(
            str(raw).replace("Z", "+00:00"))
    except ValueError:
        return None
