"""The control plane's metrics, on the standard library alone (the JAX
control plane's are ``prometheus_client`` metrics in
``kubeflow_rm_tpu/controlplane/metrics.py``, a package the card's
machine does not have): the seams', the serving fleet's, and the spawn
path's (apiserver watch fan-out, work queues, reconciles, the scheduler
cache) and the rest of the control plane's (culling, profiles, TPUJobs,
the informer cache, suspend/resume, harvesting, the WAL, leader
election and the shard ring) and the web apps' (KFAM's requests, the
readiness hub), each under JAX's series name.
:func:`registry_value` reads a sample back by its scraped name, as JAX's does.

A metric is labelled like ``prometheus_client``'s: ``.labels(...)``
(label values by name or in ``labelnames`` order) gives the child
series, which ``.inc()``s (counter), ``.set()``s, ``.inc()``s or
``.dec()``s (gauge) or ``.observe()``s (histogram), and ``.get()``
reads it back (a histogram's: its count). :func:`render` (and
:func:`scrape`, its bytes)
writes the Prometheus text format under the JAX control plane's series
names: a counter's series carries one ``_total`` suffix, whether or not
its name already ended in it (``serving_migrations`` scrapes as
``serving_migrations_total``), and a histogram writes ``_bucket``,
``_sum`` and ``_count``, as ``prometheus_client`` does.
"""

from __future__ import annotations

import bisect
import logging
import math

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock

_swallow_log = logging.getLogger("kubeflow_rm_tpu_torch.swallowed")

#: ``prometheus_client``'s default histogram buckets
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75,
                   1.0, 2.5, 5.0, 7.5, 10.0, math.inf)


class _Series:
    def __init__(self):
        self._lock = make_lock("metrics.series")
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("a counter only goes up")
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def get(self) -> float:
        with self._lock:
            return self._value

    def lines(self, name: str, labels: dict) -> list[str]:
        return [f"{name}{_labels(labels)} {_format(self.get())}"]

    def samples(self, name: str, labels: dict) -> list[tuple]:
        return [(name, labels, self.get())]


class _GaugeSeries(_Series):
    """A gauge's series: it also goes down."""

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _HistogramSeries:
    """Cumulative bucket counts, the sum and the count of observations."""

    def __init__(self, bounds: tuple):
        self._lock = make_lock("metrics.series")
        self.bounds = bounds
        self._counts = [0] * len(bounds)
        self._sum = 0.0

    def observe(self, value: float) -> None:
        with self._lock:
            self._counts[bisect.bisect_left(self.bounds, value)] += 1
            self._sum += value

    def get(self) -> float:
        """The number of observations."""
        with self._lock:
            return float(sum(self._counts))

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def lines(self, name: str, labels: dict) -> list[str]:
        with self._lock:
            counts, total = list(self._counts), self._sum
        out, run = [], 0
        for bound, n in zip(self.bounds, counts):
            run += n
            le = _labels({**labels, "le": _format(bound)})
            out.append(f"{name}_bucket{le} {_format(run)}")
        out.append(f"{name}_count{_labels(labels)} {_format(run)}")
        out.append(f"{name}_sum{_labels(labels)} {_format(total)}")
        return out

    def samples(self, name: str, labels: dict) -> list[tuple]:
        with self._lock:
            counts, total = list(self._counts), self._sum
        out, run = [], 0
        for bound, n in zip(self.bounds, counts):
            run += n
            out.append((f"{name}_bucket", {**labels, "le": _format(bound)},
                        float(run)))
        out.append((f"{name}_count", labels, float(run)))
        out.append((f"{name}_sum", labels, total))
        return out


class _Metric:
    kind = ""

    def __init__(self, name: str, documentation: str,
                 labelnames: tuple = (), *, registry: list | None = None):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = make_lock("metrics.family")
        self._series: dict[tuple, object] = {}
        if not self.labelnames:
            self._series[()] = self._new_series()
        (REGISTRY if registry is None else registry).append(self)

    def _new_series(self):
        return _Series()

    def _key(self, values: tuple, labels: dict) -> tuple:
        if values and labels:
            raise ValueError("labels by position or by name, not both")
        if values:
            if len(values) != len(self.labelnames):
                raise ValueError(f"{self.name} takes labels "
                                 f"{self.labelnames}, got {values}")
            return tuple(str(v) for v in values)
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name} takes labels "
                             f"{self.labelnames}, got {sorted(labels)}")
        return tuple(str(labels[n]) for n in self.labelnames)

    def labels(self, *values, **labels):
        key = self._key(values, labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = self._new_series()
            return series

    def _unlabelled(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labelled: use .labels()")
        return self._series[()]

    def get(self, *values, **labels) -> float:
        """The series' value (0 for a series never touched)."""
        if not values and not labels:
            return self._unlabelled().get()
        key = self._key(values, labels)
        with self._lock:
            series = self._series.get(key)
        return 0.0 if series is None else series.get()

    def series_name(self) -> str:
        return self.name

    def samples(self) -> list[tuple]:
        """Every sample of the family as ``(sample name, labels,
        value)``, under the names :meth:`render_lines` writes."""
        name = self.series_name()
        with self._lock:
            items = list(self._series.items())
        out = []
        for key, series in items:
            out.extend(series.samples(name, dict(zip(self.labelnames, key))))
        return out

    def render_lines(self) -> list[str]:
        name = self.series_name()
        with self._lock:
            items = list(self._series.items())
        out = [f"# HELP {name} {self.documentation}",
               f"# TYPE {name} {self.kind}"]
        for key, series in items:
            out.extend(series.lines(name, dict(zip(self.labelnames, key))))
        return out


class Counter(_Metric):
    """A monotonic counter; its series carries the ``_total`` suffix
    once, as ``prometheus_client``'s does."""
    kind = "counter"

    def series_name(self) -> str:
        return self.name.removesuffix("_total") + "_total"

    def inc(self, amount: float = 1.0) -> None:
        self._unlabelled().inc(amount)


class Gauge(_Metric):
    kind = "gauge"

    def _new_series(self):
        return _GaugeSeries()

    def set(self, value: float) -> None:
        self._unlabelled().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._unlabelled().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._unlabelled().dec(amount)


class Histogram(_Metric):
    """Observations in cumulative buckets (``le``), with their sum and
    count."""
    kind = "histogram"

    def __init__(self, name: str, documentation: str,
                 labelnames: tuple = (), buckets: tuple = DEFAULT_BUCKETS,
                 *, registry: list | None = None):
        bounds = tuple(float(b) for b in buckets)
        if bounds[-1] != math.inf:
            bounds += (math.inf,)
        self.bounds = bounds
        super().__init__(name, documentation, labelnames, registry=registry)

    def _new_series(self):
        return _HistogramSeries(self.bounds)

    def observe(self, value: float) -> None:
        self._unlabelled().observe(value)


#: every metric of this module, in definition order (a metric made with
#: ``registry=`` joins that list instead)
REGISTRY: list[_Metric] = []


def _format(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def _labels(labels: dict) -> str:
    """``{k="v",...}`` in label-name order, as ``prometheus_client``
    writes it; "" for none."""
    body = ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items()))
    return f"{{{body}}}" if body else ""


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def render(registry: list | None = None) -> str:
    """The Prometheus text exposition of ``registry``'s metrics (this
    module's by default)."""
    lines = []
    for m in REGISTRY if registry is None else registry:
        lines.extend(m.render_lines())
    return "\n".join(lines) + "\n"


def scrape() -> bytes:
    """:func:`render` as the bytes of a ``/metrics`` response."""
    return render().encode()


def registry_value(sample_name: str,
                   labels: dict[str, str] | None = None) -> float:
    """The sum of every sample named ``sample_name`` (a counter's with its
    ``_total``, a histogram's ``_count``/``_sum``/``_bucket``) whose
    labels include ``labels`` — JAX's ``metrics.registry_value``."""
    total = 0.0
    for family in REGISTRY:
        for name, lab, value in family.samples():
            if name != sample_name:
                continue
            if labels and any(lab.get(k) != v for k, v in labels.items()):
                continue
            total += value
    return total


DECLARED_HBM_DRIFT_RATIO = Gauge(
    "declared_hbm_drift_ratio",
    "Worst relative divergence between a workload's observed on-card "
    "peak memory and its webhook-priced declared peak "
    "(|observed - declared| / declared, max over tracked workloads) — "
    "sustained > 0.2 trips the warn-only declared-hbm-drift SLO",
)

JIT_RECOMPILES_TOTAL = Counter(
    "jit_recompiles",
    "New (shape, dtype, static-arg) signatures observed by the "
    "torchcheck recompile sentinel, per tenant (the JAX control plane's "
    "jit_recompiles_total series)",
    ["tenant"],
)

IMPLICIT_HOSTSYNCS_TOTAL = Counter(
    "implicit_hostsyncs",
    "Implicit device->host syncs (bool()/.item()/np.asarray on tensors) "
    "witnessed by the torchcheck host-sync probe inside instrumented "
    "regions, per tenant — each one stalls the card for a host round "
    "trip",
    ["tenant"],
)

SWALLOWED_ERRORS_TOTAL = Counter(
    "swallowed_errors",
    "Exceptions intentionally absorbed on best-effort paths, by module",
    ["module"],
)


# ---- the serving gateway and fleet (JAX: controlplane/metrics.py:364-500)
SERVING_QUEUE_DEPTH = Gauge(
    "serving_queue_depth",
    "Requests admitted by the gateway but not yet holding a decode "
    "slot (the engine's internal admission queue)",
)
SERVING_ACTIVE_SLOTS = Gauge(
    "serving_active_slots",
    "Decode slots currently mid-generation in the continuous-batching "
    "engine (capacity is serving_slot_capacity)",
)
SERVING_SLOT_CAPACITY = Gauge(
    "serving_slot_capacity",
    "Total decode slots in the engine's KV pool",
)
SERVING_BATCH_OCCUPANCY = Gauge(
    "serving_batch_occupancy",
    "Mean fraction of decode slots doing useful work per decode step "
    "since boot — the utilization win continuous batching exists for",
)
SERVING_REQUESTS_TOTAL = Counter(
    "serving_requests_total",
    "Gateway requests by tenant and result (ok | shed | error)",
    ["tenant", "result"],
)
SERVING_SHED_TOTAL = Counter(
    "serving_shed_total",
    "Requests shed before touching the engine, by tenant and reason "
    "(rate | tokens | queue | slo)",
    ["tenant", "reason"],
)
SERVING_REQUEST_LATENCY_SECONDS = Histogram(
    "serving_request_latency_seconds",
    "End-to-end request latency (admission to last token) per tenant",
    ["tenant"],
    buckets=(0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             30.0),
)
SERVING_GENERATED_TOKENS_TOTAL = Counter(
    "serving_generated_tokens_total",
    "Tokens decoded and returned, per tenant (the token-budget meter)",
    ["tenant"],
)
SERVING_CLASS_QUEUE_DEPTH = Gauge(
    "serving_class_queue_depth",
    "Engine admission-queue depth per SLO class (interactive | batch | "
    "best_effort) — the weighted-round-robin backlog each class drains "
    "from at token boundaries",
    ["slo_class"],
)
SERVING_PREFIX_HIT_RATIO = Gauge(
    "serving_prefix_hit_ratio",
    "Fraction of prompt tokens served from the shared-prefix block "
    "cache instead of prefilled (cumulative since boot)",
)
SERVING_PREFIX_MISS_RATIO = Gauge(
    "serving_prefix_miss_ratio",
    "1 - serving_prefix_hit_ratio, set only once prompts have flowed — "
    "the burn signal for the prefix-hit-collapse SLO (sustained ~1.0 "
    "under prefix-heavy traffic means the cache stopped working)",
)
SERVING_FREE_BLOCK_FRACTION = Gauge(
    "serving_free_block_fraction",
    "Fraction of the paged-KV pool's usable blocks free or evictable "
    "right now — sustained ~0 predicts admission OOM rejections",
)
SERVING_MIGRATIONS_TOTAL = Counter(
    "serving_migrations",
    "In-flight requests re-routed to another replica after their "
    "original replica drained or died (resumed, not failed)",
)
SERVING_FLEET_REPLICAS = Gauge(
    "serving_fleet_replicas",
    "Serving-fleet replicas by state (ready | draining | dead)",
    ["state"],
)
SERVING_STORE_HIT_RATIO = Gauge(
    "serving_store_hit_ratio",
    "Fraction of GlobalBlockStore lookups that found a chain "
    "(cumulative since boot) — the fleet-wide prefix economy's "
    "effectiveness across replica deaths and rebalancing",
)
SERVING_STORE_MISS_RATIO = Gauge(
    "serving_store_miss_ratio",
    "1 - serving_store_hit_ratio, set only once lookups have flowed — "
    "the burn signal for the store-hit-collapse SLO (sustained ~1.0 "
    "under steady traffic means the global prefix tier stopped "
    "absorbing re-prefills)",
)
SERVING_STORE_CHAINS = Gauge(
    "serving_store_chains",
    "Chains currently resident in the GlobalBlockStore",
)
SERVING_STORE_BYTES = Gauge(
    "serving_store_bytes",
    "Bytes of chain payload resident in the GlobalBlockStore (LRU "
    "evicts ref-0 chains past the byte budget)",
)
SERVING_STORE_PROMOTED_TOTAL = Counter(
    "serving_store_promoted_chains",
    "Hot ref-0 chains promoted into the GlobalBlockStore at local "
    "eviction time instead of dying with the replica's pool",
)
SERVING_CHAIN_HANDOFF_SECONDS = Histogram(
    "serving_chain_handoff_seconds",
    "Prefill-tier handoff latency: route to a prefill replica, "
    "prefill the prompt, export the chain, publish it to the global "
    "store — the added cost a disaggregated request pays before its "
    "decode replica installs the chain",
)
SERVING_TIER_OCCUPANCY = Gauge(
    "serving_tier_occupancy",
    "Mean busy fraction per serving tier (prefill: active prefill "
    "fraction of READY prefill replicas' queue+work; decode: active "
    "slot fraction of READY decode replicas)",
    ["tier"],
)


# ---- the control plane's spawn path: apiserver, workqueue, runtime,
# scheduler, chaos and the notebook/StatefulSet controllers (JAX:
# controlplane/metrics.py, the same names)
NOTEBOOK_RUNNING = Gauge(
    "notebook_running",
    "Current number of notebooks with at least one ready replica",
)
NOTEBOOK_CREATE_TOTAL = Counter(
    "notebook_create_total",
    "Total notebook StatefulSets created",
)
NOTEBOOK_CREATE_FAILED_TOTAL = Counter(
    "notebook_create_failed_total",
    "Total notebook StatefulSet creations that failed",
)
RECONCILE_ERRORS_TOTAL = Counter(
    "reconcile_errors_total",
    "Total reconcile errors across controllers",
    ["controller"],
)
TPU_CHIPS_REQUESTED = Gauge(
    "tpu_chips_requested",
    "TPU chips currently requested by scheduled notebook pods",
)
WORKQUEUE_DEPTH = Gauge(
    "workqueue_depth",
    "Items waiting in a controller's work queue",
    ["name"],
)
WORKQUEUE_NAMESPACE_DEPTH = Gauge(
    "workqueue_namespace_depth",
    "Pending work-queue items broken down by the namespace they "
    "reconcile — the hot-namespace signal the shard autoscaler's "
    "carve-off reads; drained namespaces are zeroed, not dropped, so "
    "federated last-value sums never hold stale depth",
    ["name", "namespace"],
)
WORKQUEUE_ADDS_TOTAL = Counter(
    "workqueue_adds_total",
    "Total items added to a controller's work queue (pre-dedup)",
    ["name"],
)
WORKQUEUE_REQUEUES_TOTAL = Counter(
    "workqueue_requeues_total",
    "Total rate-limited (backoff) requeues per work queue",
    ["name"],
)
WORKQUEUE_RETRIES_EXHAUSTED_TOTAL = Counter(
    "workqueue_retries_exhausted_total",
    "Items dropped after exhausting their retry budget",
    ["name"],
)
WORKQUEUE_QUEUE_SECONDS = Histogram(
    "workqueue_queue_duration_seconds",
    "Time items spend waiting in a work queue before hand-out",
    ["name"],
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
)
WATCH_FANOUT_QUEUE_DEPTH = Gauge(
    "watch_fanout_queue_depth",
    "Events waiting in a watcher's fanout queue (kube-apiserver's "
    "apiserver_watch_cache_events_dispatched analogue, per consumer)",
    ["watcher"],
)
WATCH_FANOUT_OVERFLOWS_TOTAL = Counter(
    "watch_fanout_overflows_total",
    "Times a watcher's bounded queue overflowed and was collapsed to a "
    "TOO_OLD sentinel forcing that watcher to relist (410 Gone analogue)",
    ["watcher"],
)
WATCH_FANOUT_DELIVERED_TOTAL = Counter(
    "watch_fanout_delivered_total",
    "Events delivered to a watcher callback by its dispatch thread",
    ["watcher"],
)
WATCH_FANOUT_DISPATCH_LAG = Gauge(
    "watch_fanout_dispatch_lag_seconds",
    "Enqueue-to-delivery latency of the most recent event per watcher",
    ["watcher"],
)
RECONCILE_PHASE_SECONDS = Histogram(
    "reconcile_phase_duration_seconds",
    "Per-reconcile phase timing (render / child_writes / status / "
    "events) — attributes the provisioning write chain per controller",
    ["controller", "phase"],
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
)
BULK_CREATE_BATCHES_TOTAL = Counter(
    "bulk_create_batches_total",
    "create_many batches accepted by the apiserver, per kind",
    ["kind"],
)
BULK_CREATE_OBJECTS_TOTAL = Counter(
    "bulk_create_objects_total",
    "Objects submitted through create_many by kind and per-item result",
    ["kind", "result"],
)
SCHEDULE_LATENCY_SECONDS = Histogram(
    "schedule_latency_seconds",
    "Gang-bind latency per scheduling attempt: node selection + "
    "capacity check + assume, over the incremental usage cache "
    "(kube-scheduler's scheduling_attempt_duration_seconds analogue); "
    "result=bound|unschedulable",
    ["result"],
    buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0,
             5.0),
)
SCHEDULER_ASSUMED_PODS = Gauge(
    "scheduler_assumed_pods",
    "Pods assumed (bound in the usage cache, bind write not yet "
    "confirmed by its watch event) — kube-scheduler's assumed-pod set",
)
SCHEDULER_CACHE_EVENTS_TOTAL = Counter(
    "scheduler_cache_events_total",
    "Pod/Node watch events folded into the scheduler's usage cache "
    "(the O(Δ) accounting replacing the per-reconcile full Pod scan)",
    ["kind"],
)
SCHEDULER_CACHE_REBUILDS_TOTAL = Counter(
    "scheduler_cache_rebuilds_total",
    "Full usage-cache rebuilds from a fresh snapshot (initial prime + "
    "TOO_OLD relists)",
)
SCHEDULER_FREE_CHIPS = Gauge(
    "scheduler_free_chips",
    "Unclaimed TPU chips across the tracked node fleet (capacity minus "
    "charged usage in the scheduler cache)",
)
SCHEDULER_LARGEST_FREE_GANG = Gauge(
    "scheduler_largest_free_gang_chips",
    "Largest slice placeable as one gang of identical hosts given the "
    "current free-chip distribution (ParvaGPU's largest allocatable "
    "unit) — free_chips minus this is stranded capacity",
)
SCHEDULER_FRAGMENTATION = Gauge(
    "scheduler_fragmentation",
    "Bin-packing fragmentation gauge: 1 - largest_free_gang/free_chips "
    "(0 = all free capacity gang-placeable, 1 = fully stranded)",
)
SCHEDULER_FREE_HBM_GIB = Gauge(
    "scheduler_free_hbm_gib",
    "Unclaimed predicted-HBM (GiB) across the tracked node fleet — the "
    "second gang-packing axis under --hbm-packing; unlike chips this "
    "axis is never overcommitted, so free approaching 0 is the true "
    "admission ceiling for declared workloads",
)
PROVISION_LATENCY_SECONDS = Histogram(
    "provision_latency_seconds",
    "Notebook provision latency observed in-platform: CR "
    "creationTimestamp to the status mirror first seeing readyReplicas "
    "reach desired — the SLI behind the provision-p50 SLO (the "
    "conformance harness measures the same edge from the client side)",
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
             120.0),
)
CHAOS_FAULTS_INJECTED_TOTAL = Counter(
    "chaos_faults_injected_total",
    "Faults injected by the seeded chaos engine, by fault kind — the "
    "attribution counter every chaos-matrix artifact asserts against "
    "(each injection also lands in the plan ledger and, when a flight "
    "recorder is attached, a chaos_<fault> incident bundle)",
    ["fault"],
)
PREEMPT_SKIPPED_TOTAL = Counter(
    "preempt_skipped_total",
    "try_preempt opportunities that could not be served, by reason "
    "(oversubscribe_off | not_notebook_owner | legacy_scan | "
    "no_viable_victims) — makes the TPUJob-vs-TPUJob preemption gap "
    "(ROADMAP item 5) a visible counter instead of a silent skip",
    ["reason"],
)
HARVESTED_CHIPS = Gauge(
    "harvested_chips",
    "TPU chips currently on loan to the serving fleet under harvest "
    "leases (charges marked harvested=true in the scheduler cache) — "
    "capacity a notebook resume reclaims instantly",
)



# ---- the web apps (JAX: controlplane/metrics.py:54-59, 237-249)
KFAM_REQUESTS_TOTAL = Counter(
    "kfam_requests_total",
    "KFAM API requests by action and result "
    "(ref access-management/kfam/monitoring.go:46-77)",
    ["action", "result"],
)
READINESS_WAKE_TO_OBSERVE_SECONDS = Histogram(
    "readiness_wake_to_observe_seconds",
    "Watch-event arrival at the web app's readiness hub to a blocked "
    "readiness long-poll observing the change — the push-path latency "
    "that replaces the client's fixed-interval status polling",
    buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0),
)
READINESS_WAITERS = Gauge(
    "readiness_waiters",
    "Readiness long-polls currently blocked on the hub",
)


# ---- the rest of the control plane: culling, profiles, TPUJobs and the
# informer cache (JAX: controlplane/metrics.py, the same names)
NOTEBOOK_CULL_TOTAL = Counter(
    "notebook_cull_total",
    "Total notebooks culled for idleness",
)
PROFILE_CREATE_TOTAL = Counter(
    "profile_create_total",
    "Total profiles reconciled into namespaces",
)
CACHE_READS_TOTAL = Counter(
    "cache_reads_total",
    "Read verbs against the CachedAPI by verb and whether the shared "
    "informer store served them (hit) or they fell through (miss)",
    ["verb", "result"],
)
CACHE_SUPPRESSED_WRITES_TOTAL = Counter(
    "cache_suppressed_writes_total",
    "Writes dropped by no-op suppression (desired object semantically "
    "equal to the cached current one after normalization)",
    ["verb"],
)
CACHE_CONFLICT_FASTPATH_TOTAL = Counter(
    "cache_conflict_fastpath_total",
    "Conflict resolutions attempted from the cache: noop (write already "
    "reflected in latest), rebased (disjoint three-way rebase retried), "
    "fallthrough (re-raised for the caller's retry loop)",
    ["result"],
)
INFORMER_EVENTS_TOTAL = Counter(
    "informer_events_total",
    "Watch events folded into the shared informer store, per kind",
    ["kind"],
)
INFORMER_SYNCED_KINDS = Gauge(
    "informer_synced_kinds",
    "Kinds whose initial list completed (serving reads from memory)",
)
INFORMER_LAST_EVENT_TIMESTAMP = Gauge(
    "informer_last_event_timestamp_seconds",
    "Wall time the informer last folded an event in (staleness proxy)",
)
TPUJOB_RUNNING = Gauge(
    "tpujob_running",
    "TPUJobs whose whole heterogeneous gang (every role) is Running",
)
TPUJOB_READY_PODS = Gauge(
    "tpujob_ready_pods",
    "Ready gang pods across all TPUJobs, by role name (learner slice "
    "hosts vs CPU actors)",
    ["role"],
)
TPUJOB_PHASE_TRANSITIONS_TOTAL = Counter(
    "tpujob_phase_transitions_total",
    "TPUJob phase-ladder transitions (Pending -> Provisioning -> "
    "Running -> Succeeded/Failed, plus Suspended), by entered phase",
    ["phase"],
)

# ---- suspend/resume, preemption, failover and migration (JAX:
# controlplane/metrics.py, the same names and labels)
NOTEBOOK_SUSPEND_TOTAL = Counter(
    "notebook_suspend_total",
    "Notebooks driven to Suspended, by reason (idle | preempted | api)",
    ["reason"],
)
NOTEBOOK_RESUME_TOTAL = Counter(
    "notebook_resume_total",
    "Suspended notebooks resumed back to Running with state restored",
)
NOTEBOOK_PREEMPT_TOTAL = Counter(
    "notebook_preempt_total",
    "Victim slices suspended by the preemptive gang-bind path so a "
    "higher-priority slice could bind all-or-nothing",
)
SUSPEND_RESUME_SECONDS = Histogram(
    "suspend_resume_phase_seconds",
    "Suspend/resume lifecycle latency per phase: drain (suspend "
    "decision -> slice fully scaled to zero), rebind (resume request "
    "-> slice ready again), restore (state-store restore call)",
    ["phase"],
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0, 120.0),
)
NOTEBOOK_FAILOVER_TOTAL = Counter(
    "notebook_failover_total",
    "Active-replica deaths that promoted a warm standby via "
    "demand-resume (NotebookOS replicated-kernel failover)",
)
NOTEBOOK_FAILOVER_SECONDS = Histogram(
    "notebook_failover_seconds",
    "Active-replica death detection to the promoted standby fully "
    "ready (state restored, chips re-bound through gang_bind) — the "
    "latency that must beat cold provisioning by >=10x",
    buckets=(0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             30.0),
)
NOTEBOOK_MIGRATION_TOTAL = Counter(
    "notebook_migration_total",
    "Live migrations (checkpoint -> drain -> re-bind on different "
    "nodes) by trigger (api | fragmentation)",
    ["trigger"],
)

# ---- harvesting: serving on idle notebook cards -------------------------
HARVEST_GRANTS_TOTAL = Counter(
    "harvest_grants_total",
    "Harvest leases granted: an idle/suspended notebook's slice "
    "checkpointed, drained, and re-bound as a serving replica gang",
)
HARVEST_RECLAIMS_TOTAL = Counter(
    "harvest_reclaims_total",
    "Harvest leases reclaimed, by trigger (resume | preempt | "
    "idle_giveback | chaos) — resume means a notebook demanded its "
    "chips back and outranked serving",
    ["trigger"],
)
HARVEST_RECLAIM_SECONDS = Histogram(
    "harvest_reclaim_seconds",
    "Demand-resume reclaim latency: resume request observed to the "
    "harvested replica drained and its lease released — must fit "
    "inside the r15 failover SLO (notebook_failover_seconds envelope)",
    buckets=(0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
             30.0),
)

# ---- durability and leader election ---------------------------------------
WAL_FSYNC_SECONDS = Histogram(
    "wal_fsync_seconds",
    "Group-commit flush latency: buffered frames written + fsynced in "
    "one batch (etcd's wal_fsync_duration_seconds analogue)",
    ["shard"],
    buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0),
)
WAL_BYTES_TOTAL = Counter(
    "wal_bytes",
    "Bytes appended to the write-ahead log (CRC frame headers included)",
    ["shard"],
)
SNAPSHOT_DURATION_SECONDS = Histogram(
    "snapshot_duration_seconds",
    "Compacting-snapshot write latency: cut under the write lock, "
    "serialize, fsync, rename, drop compacted WAL segments",
    ["shard"],
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0),
)
SHARD_RING_MEMBERS = Gauge(
    "shard_ring_members",
    "Shards on the consistent-hash ring this process routes to (router) "
    "or participates in (shard worker)",
    ["shard"],
)
SHARD_DEATHS_TOTAL = Counter(
    "shard_deaths",
    "Shard worker processes the ShardRunner watchdog observed dead and "
    "respawned, by shard — feeds the shard-deaths critical SLO so a "
    "respawn is an *alert*, not just a log line. A deliberate "
    "scale-down (elastic merge) does NOT count here — the runner's "
    "intentional-shutdown handshake excludes it",
    ["shard"],
)
# ---- the elastic shard layer (split / merge / autoscale) ----------------
SHARD_SPLITS_TOTAL = Counter(
    "shard_splits_total",
    "Completed live shard splits (new member admitted to the ring "
    "after snapshot + WAL tail-replay handoff)",
)
SHARD_MERGES_TOTAL = Counter(
    "shard_merges_total",
    "Completed live shard merges (member retired from the ring after "
    "its key-range was handed to the survivors)",
)
SHARD_HANDOFF_SECONDS = Histogram(
    "shard_handoff_seconds",
    "End-to-end live handoff duration by kind (split | merge | "
    "migrate): donor snapshot, bulk copy, tail-replay to "
    "under-threshold lag, fence, final drain, ring flip",
    ["kind"],
    buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0),
)
SHARD_HANDOFF_OBJECTS = Counter(
    "shard_handoff_objects_total",
    "Objects copied to a recipient shard during handoffs, by phase "
    "(bulk | tail) — the tail share is the live-traffic cost a "
    "split pays",
    ["phase"],
)
SHARD_HANDOFF_REPLAY_LAG = Gauge(
    "shard_handoff_replay_lag",
    "WAL records still to tail-replay in the in-flight handoff "
    "(0 when none is running) — the convergence signal the fence "
    "waits on",
)
SHARD_AUTOSCALE_DECISIONS_TOTAL = Counter(
    "shard_autoscale_decisions_total",
    "Autoscaler verdicts by decision (split | merge | hold | "
    "cooldown) — sustained queue depth or SLO burn scales out, "
    "sustained idle merges back",
    ["decision"],
)
LEADER_IS_LEADER = Gauge(
    "leader_is_leader",
    "1 while this identity holds the controller-manager lease "
    "(controller-runtime's leader_election_master_status)",
    ["identity"],
)

# the shard identity this process reports under — "" outside sharded
# deployments so single-process metrics stay label-stable
_SHARD = ""


def set_shard(name: str) -> None:
    """Tag this process's per-shard metric series."""
    global _SHARD
    _SHARD = name


def shard_label() -> str:
    return _SHARD


def swallowed(module: str, context: str = "") -> None:
    """Account for an intentionally absorbed exception. Call from inside
    an ``except`` block: increments ``swallowed_errors_total{module}``
    and debug-logs the traceback."""
    SWALLOWED_ERRORS_TOTAL.labels(module=module).inc()
    _swallow_log.debug("swallowed in %s%s", module,
                       f" ({context})" if context else "", exc_info=True)
