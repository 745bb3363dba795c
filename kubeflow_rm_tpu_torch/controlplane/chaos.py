"""Deterministic seeded fault-injection engine.

PR 12 proved the ratchet gate with one ad-hoc env hook
(``KFRM_CHAOS_RECONCILE_SLEEP_MS`` stalling reconciles); this module
subsumes it into a first-class engine: a seeded :class:`FaultPlan`
describes WHICH faults fire, WHERE (substring match on the injection
site), HOW OFTEN (per-opportunity probability) and HOW MANY times
(optional cap), and the existing choke points ask the engine at every
opportunity:

- ``maybe_stall``        — runtime reconcile span (``Manager``)
- ``api_request_fault``  — ``_FastSession._request`` (every kubeclient
                           verb of every session, incl. shard routes)
- ``watch_fault``        — ``_WatcherChannel.publish``/``publish_many``
- ``checkpoint_write_fault`` — suspend state stores + ``Checkpointer``
- ``pod_kill_victim``    — the fake kubelet (StatefulSetController)
- ``shard_kill_victim``  — ``ShardRunner``'s watchdog tick

Every hook is a no-op returning on the first branch while no plan is
installed — the engine costs one module-global load on hot paths, so
the ``--no-chaos`` arms and the perf ratchet see the unpolluted system.

Semantics notes:

- A dropped watch event is injected as the channel's ``TOO_OLD``
  sentinel in place of the item: the platform's watch contract is
  "ordered window or a detectable gap" (kube's 410), so a drop
  manifests as the gap and exercises the relist/resync recovery path
  rather than silently corrupting an informer forever.
- An injected apiserver 5xx is a synthesized HTTP 503 response object
  (``Synthetic503``) returned from the client choke point, so the
  normal ``_raise_for`` → ``APIError`` → reconcile-retry machinery
  runs exactly as it would for a real overloaded shard.
- Determinism: each spec owns its own ``random.Random`` stream seeded
  from ``(seed, spec index, fault)``, so one spec's draw sequence is
  independent of how often other faults are consulted. Under free
  threading the *interleaving* of opportunities is scheduling-
  dependent, but a fixed seed reproduces the same fault mix and the
  per-fault counts are attributable injection by injection via the
  ledger.
- Attribution: every injection increments
  ``chaos_faults_injected_total{fault}``, appends a ledger row, and
  (when a flight recorder is attached) triggers a rate-limited
  ``chaos_<fault>`` bundle. Watch-channel injections defer their
  flight trigger — the publisher may hold verb locks, and a bundle
  capture does network I/O — and the next lock-free injection (or an
  explicit ``flush_flight``) emits them.
"""

from __future__ import annotations

import json
import os
import random
import time
from collections import Counter, deque
from dataclasses import dataclass, field

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock

#: the fault vocabulary (README "chaos engine" section documents each)
FAULT_KINDS = (
    "reconcile_stall",   # stall a reconcile inside its span
    "api_error",         # synthesized HTTP 503 from the client choke point
    "api_timeout",       # injected TimeoutError before the request is sent
    "watch_drop",        # watch event replaced by a TOO_OLD gap sentinel
    "watch_dup",         # watch event delivered twice (idempotency probe)
    "checkpoint_fail",   # checkpoint write raises OSError
    "pod_kill",          # fake kubelet SIGKILLs one running pod
    "shard_kill",        # ShardRunner watchdog SIGKILLs one shard
    "shard_split",       # SIGKILL the donor mid-split (tail-replay
                         # must recover from the respawned donor's WAL
                         # with zero loss)
    "replica_kill",      # serving-fleet replica SIGKILLed mid-decode
                         # (in-flight requests migrate bit-exact; a
                         # HARVESTED replica's chips must still return
                         # to the notebook pool clean)
)


@dataclass(frozen=True)
class FaultSpec:
    """One fault arm of a plan.

    ``rate`` is the per-opportunity injection probability; ``match``
    is a substring filter on the site string each choke point passes
    (controller name, ``"VERB /path"``, watcher name, ``"ns/name"``);
    ``limit`` caps total injections (None = unbounded);
    ``stall_ms`` is the stall duration for ``reconcile_stall``."""

    fault: str
    rate: float = 0.0
    match: str = ""
    limit: int | None = None
    stall_ms: float = 0.0

    def __post_init__(self):
        if self.fault not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault {self.fault!r}; known: {FAULT_KINDS}")


@dataclass
class _Ledger:
    rows: deque = field(default_factory=lambda: deque(maxlen=4096))


class FaultPlan:
    """A seeded set of :class:`FaultSpec` arms plus the injection
    ledger. Install with :func:`install`; the choke-point hooks below
    consult the installed plan on every opportunity."""

    def __init__(self, seed: int, specs: list[FaultSpec], *,
                 flight=None):
        self.seed = int(seed)
        self.specs = list(specs)
        self.flight = flight
        self._lock = make_lock("chaos.plan")
        self._rngs = [random.Random(f"{self.seed}:{i}:{s.fault}")
                      for i, s in enumerate(self.specs)]
        self.counts: Counter = Counter()
        self.opportunities: Counter = Counter()
        self._ledger = _Ledger()
        self._pending_flight: deque = deque(maxlen=256)

    # ---- decision ----------------------------------------------------

    def _draw(self, fault: str, site: str) -> FaultSpec | None:
        """Roll every matching spec's stream; first hit wins. Runs
        under the plan lock; callers fire flight triggers AFTER
        release (bundle capture does I/O)."""
        with self._lock:
            self.opportunities[fault] += 1
            for i, spec in enumerate(self.specs):
                if spec.fault != fault:
                    continue
                if spec.match and spec.match not in site:
                    continue
                if spec.limit is not None and \
                        self.counts[fault] >= spec.limit:
                    continue
                if spec.rate < 1.0 and \
                        self._rngs[i].random() >= spec.rate:
                    continue
                self.counts[fault] += 1
                self._ledger.rows.append({
                    "n": sum(self.counts.values()), "fault": fault,
                    "site": site, "t": round(time.time(), 4)})
                return spec
        return None

    def _record(self, fault: str, site: str, *,
                defer_flight: bool) -> None:
        from kubeflow_rm_tpu_torch.controlplane import metrics
        metrics.CHAOS_FAULTS_INJECTED_TOTAL.labels(fault=fault).inc()
        if self.flight is None:
            return
        if defer_flight:
            self._pending_flight.append((fault, site))
        else:
            self.flush_flight()
            try:
                self.flight.trigger(f"chaos_{fault}",
                                    detail={"site": site}, auto=True)
            except Exception:  # noqa: BLE001
                metrics.swallowed("chaos", "flight trigger")

    def flush_flight(self) -> None:
        """Emit deferred (lock-context) injection bundles. Safe to call
        from harness loops; never raises."""
        from kubeflow_rm_tpu_torch.controlplane import metrics
        while self._pending_flight:
            try:
                fault, site = self._pending_flight.popleft()
            except IndexError:
                return
            try:
                self.flight.trigger(f"chaos_{fault}",
                                    detail={"site": site}, auto=True)
            except Exception:  # noqa: BLE001 - attribution must never
                metrics.swallowed("chaos", "flight trigger")  # hurt SUT

    def ledger(self) -> list[dict]:
        with self._lock:
            return list(self._ledger.rows)

    def summary(self) -> dict:
        with self._lock:
            return {"seed": self.seed,
                    "faults": dict(self.counts),
                    "opportunities": dict(self.opportunities)}


# ---- global install point --------------------------------------------

_plan: FaultPlan | None = None


def install(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` process-wide. Returns it for chaining."""
    global _plan
    _plan = plan
    return plan


def uninstall() -> FaultPlan | None:
    """Remove the installed plan (hooks go back to zero-cost no-ops)
    and return it so the harness can read counts/ledger."""
    global _plan
    plan, _plan = _plan, None
    return plan


def active() -> FaultPlan | None:
    return _plan


def plan_from_args(seed: int, faults: str, *, flight=None) -> FaultPlan:
    """Build a plan from a CLI string like
    ``"reconcile_stall:0.05:25,api_error:0.03,watch_drop:0.02"``
    (fault[:rate[:stall_ms]], comma-separated)."""
    specs = []
    for part in faults.split(","):
        part = part.strip()
        if not part:
            continue
        bits = part.split(":")
        spec = FaultSpec(
            fault=bits[0],
            rate=float(bits[1]) if len(bits) > 1 else 0.05,
            stall_ms=float(bits[2]) if len(bits) > 2 else 0.0)
        specs.append(spec)
    return FaultPlan(seed, specs, flight=flight)


# ---- choke-point hooks -----------------------------------------------

def maybe_stall(controller: str) -> None:
    """Runtime reconcile-span hook. Subsumes (and keeps honoring) the
    PR 12 env hook: ``KFRM_CHAOS_RECONCILE_SLEEP_MS=<ms>`` stalls every
    reconcile (or only ``KFRM_CHAOS_RECONCILE_CONTROLLER=<name>``'s) —
    the perf-ratchet red-run demo keeps working unchanged."""
    plan = _plan
    if plan is not None:
        spec = plan._draw("reconcile_stall", controller)
        if spec is not None:
            plan._record("reconcile_stall", controller,
                         defer_flight=False)
            if spec.stall_ms > 0:
                time.sleep(spec.stall_ms / 1000.0)
    ms = os.environ.get("KFRM_CHAOS_RECONCILE_SLEEP_MS")
    if not ms:
        return
    only = os.environ.get("KFRM_CHAOS_RECONCILE_CONTROLLER", "")
    if only and only != controller:
        return
    time.sleep(float(ms) / 1000.0)


class Synthetic503:
    """Duck-typed stand-in for the kubeclient's ``_Resp`` carrying an
    injected apiserver 5xx: ``_raise_for`` turns it into the same
    ``APIError`` a real overloaded shard would produce."""

    status_code = 503
    ok = False

    def __init__(self, site: str):
        self.text = json.dumps({
            "kind": "Status", "status": "Failure", "code": 503,
            "message": f"chaos: injected 503 on {site}"})

    def json(self):
        return json.loads(self.text)


def api_request_fault(method: str, path: str):
    """kubeclient choke point. Returns None (no fault), a
    :class:`Synthetic503` the caller must return as the response, or
    raises ``TimeoutError`` for an injected client-side timeout."""
    plan = _plan
    if plan is None:
        return None
    site = f"{method} {path}"
    if plan._draw("api_timeout", site) is not None:
        plan._record("api_timeout", site, defer_flight=False)
        raise TimeoutError(f"chaos: injected timeout on {site}")
    if plan._draw("api_error", site) is not None:
        plan._record("api_error", site, defer_flight=False)
        return Synthetic503(site)
    return None


def watch_fault(watcher: str, etype: str) -> str | None:
    """Watch-fanout choke point. Returns ``"drop"`` (the publisher
    substitutes a ``TOO_OLD`` gap sentinel), ``"dup"`` (publish the
    item twice), or None. ``TOO_OLD`` sentinels themselves are never
    faulted — the recovery path must stay reliable."""
    plan = _plan
    if plan is None or etype == "TOO_OLD":
        return None
    site = f"{watcher}:{etype}"
    if plan._draw("watch_drop", site) is not None:
        plan._record("watch_drop", site, defer_flight=True)
        return "drop"
    if plan._draw("watch_dup", site) is not None:
        plan._record("watch_dup", site, defer_flight=True)
        return "dup"
    return None


def checkpoint_write_fault(site: str) -> None:
    """State-store / Checkpointer choke point: raises ``OSError`` when
    the plan injects a checkpoint-write failure (the suspend reconcile
    retries with backoff, exactly like a wedged storage backend)."""
    plan = _plan
    if plan is None:
        return
    if plan._draw("checkpoint_fail", site) is not None:
        plan._record("checkpoint_fail", site, defer_flight=False)
        raise OSError(f"chaos: injected checkpoint write failure "
                      f"({site})")


def pod_kill_victim(site: str, pod_names: list[str]) -> str | None:
    """Fake-kubelet choke point: one opportunity per reconcile of an
    StatefulSet with running pods; returns the pod to kill."""
    plan = _plan
    if plan is None or not pod_names:
        return None
    spec = plan._draw("pod_kill", site)
    if spec is None:
        return None
    plan._record("pod_kill", site, defer_flight=False)
    # deterministic victim given the ledger position: hash-free pick
    with plan._lock:
        n = plan.counts["pod_kill"]
    return sorted(pod_names)[n % len(pod_names)]


def split_kill_fault(site: str) -> bool:
    """Elastic-handoff choke point: one opportunity per split, drawn
    between the bulk copy and the tail-replay loop (the window where a
    donor death is most likely to lose the moving range). True tells
    the coordinator to SIGKILL the donor; the watchdog respawns it
    from its WAL and the tail-replay loop resumes against the
    recovered log — the zero-loss assertion covers exactly this."""
    plan = _plan
    if plan is None:
        return False
    if plan._draw("shard_split", site) is None:
        return False
    plan._record("shard_split", site, defer_flight=False)
    return True


def replica_kill_victim(names: list[str]) -> str | None:
    """Serving-fleet choke point: one opportunity per harness tick;
    returns the replica to SIGKILL (``fleet.kill`` — queued AND
    mid-decode requests migrate to surviving replicas via the
    store-held prefixes). The harvest chaos arm feeds HARVESTED
    replica names here: the assertion downstream is that the donor
    notebook's chips come back clean even when the borrower dies
    without a drain."""
    plan = _plan
    if plan is None or not names:
        return None
    spec = plan._draw("replica_kill", "serving_fleet")
    if spec is None:
        return None
    plan._record("replica_kill", "serving_fleet", defer_flight=False)
    with plan._lock:
        n = plan.counts["replica_kill"]
    return sorted(names)[n % len(names)]


def shard_kill_victim(names: list[str]) -> str | None:
    """ShardRunner watchdog choke point: one opportunity per tick."""
    plan = _plan
    if plan is None or not names:
        return None
    spec = plan._draw("shard_kill", "watchdog")
    if spec is None:
        return None
    plan._record("shard_kill", "watchdog", defer_flight=False)
    with plan._lock:
        n = plan.counts["shard_kill"]
    return sorted(names)[n % len(names)]
