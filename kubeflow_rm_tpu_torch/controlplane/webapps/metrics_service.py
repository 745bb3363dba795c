"""Pluggable cluster-metrics backends for the dashboard (the port's copy
of ``kubeflow_rm_tpu/controlplane/webapps/metrics_service.py``).

The reference abstracts its chart data source behind a factory that
picks Prometheus or Stackdriver at boot
(``centraldashboard/app/metrics_service_factory.ts``,
``prometheus_metrics_service.ts``, ``stackdriver_metrics_service.ts``).
Same shape here, with backends that fit the card platform:

- ``inventory`` (default): compute fleet numbers straight from the
  apiserver's Node/Pod/Notebook objects — zero extra infrastructure,
  always available. A card is an ``nvidia.com/gpu`` limit or
  allocatable, a node one with the ``gke-accelerator`` label.
- ``prometheus``: scrape a Prometheus text exposition endpoint (the
  controller manager's ``/metrics``, or a real Prometheus federate
  URL via ``KFRM_PROMETHEUS_URL``) and read the platform's own gauges
  (``controlplane/metrics.py``).

Both return the same ``snapshot()`` dict, under JAX's keys (``tpu``,
``chips_capacity``, ``chips_requested``: the SPA reads them), and
``MetricsHistory`` rings
snapshots for the dashboard's utilization-over-time charts (the
reference's ``resource-chart.js`` backs onto interval queries; here
the history lives in-process).
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Protocol

from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    deep_get, parse_quantity,
)
from kubeflow_rm_tpu_torch.controlplane import metrics as cp_metrics
from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock


class MetricsService(Protocol):
    def snapshot(self) -> dict: ...


def _controlplane_section(api=None) -> dict:
    """HA runtime health for the dashboard pills: who holds the
    controller-manager lease (from the store) plus the in-process
    workqueue/leadership gauges (``controlplane/metrics.py``)."""
    from kubeflow_rm_tpu_torch.controlplane import metrics as cp_metrics
    from kubeflow_rm_tpu_torch.controlplane import scheduler as cp_scheduler
    # free/fragmentation gauges are computed on stats() — bring them
    # current so the pills reflect the live cache, not the last bind
    cp_scheduler.refresh_gauges()
    leader, transitions = None, None
    if api is not None:
        try:
            from kubeflow_rm_tpu_torch.controlplane.ha.leases import (
                DEFAULT_LEASE_NAME,
            )
            lease = api.try_get("Lease", DEFAULT_LEASE_NAME, "kubeflow")
        except Exception:  # noqa: BLE001 - lease kind may not exist
            cp_metrics.swallowed("metrics_service", "lease read")
            lease = None
        if lease:
            spec = lease.get("spec") or {}
            leader = spec.get("holderIdentity") or None
            transitions = spec.get("leaseTransitions")
    # informer-cache health: the api's shared ObjectStore when it has
    # one (KubeAPIServer.cache / CachedAPI.store), else in-process
    # gauge sums — works for both backends
    cache_stats = None
    store = getattr(api, "cache", None) or getattr(api, "store", None)
    if store is not None and hasattr(store, "stats"):
        try:
            cache_stats = store.stats()
        except Exception:  # noqa: BLE001 - pills are best-effort
            cp_metrics.swallowed("metrics_service", "cache stats")
            cache_stats = None
    return {
        "leader": leader,
        "lease_transitions": transitions,
        "is_leader": cp_metrics.registry_value("leader_is_leader"),
        "workqueue_depth": cp_metrics.registry_value("workqueue_depth"),
        "workqueue_requeues": cp_metrics.registry_value(
            "workqueue_requeues_total"),
        "retries_exhausted": cp_metrics.registry_value(
            "workqueue_retries_exhausted_total"),
        "cache": {
            "objects": cache_stats["objects"] if cache_stats else None,
            "synced_kinds": (cache_stats["synced_kinds"]
                             if cache_stats else
                             cp_metrics.registry_value(
                                 "informer_synced_kinds")),
            "events_applied": (cache_stats["events_applied"]
                               if cache_stats else None),
            "last_event_t": (cache_stats["last_event_t"]
                             if cache_stats else
                             cp_metrics.registry_value(
                                 "informer_last_event_timestamp_seconds")),
            "hits": cp_metrics.registry_value(
                "cache_reads_total", {"result": "hit"}),
            "misses": cp_metrics.registry_value(
                "cache_reads_total", {"result": "miss"}),
            "suppressed_writes": cp_metrics.registry_value(
                "cache_suppressed_writes_total"),
            "conflict_fastpath": cp_metrics.registry_value(
                "cache_conflict_fastpath_total"),
        },
        # async watch-fanout health (apiserver per-watcher dispatch
        # queues): sustained depth or overflows mean a consumer can't
        # keep up with the event rate and is being forced to relist
        "fanout": {
            "queue_depth": cp_metrics.registry_value(
                "watch_fanout_queue_depth"),
            "overflows": cp_metrics.registry_value(
                "watch_fanout_overflows_total"),
            "delivered": cp_metrics.registry_value(
                "watch_fanout_delivered_total"),
            "dispatch_lag_s": cp_metrics.registry_value(
                "watch_fanout_dispatch_lag_seconds"),
        },
        # batched write path: where reconcile milliseconds go — render
        # vs child writes vs status vs event re-emission, summed across
        # controllers (per-controller split lives in /metrics)
        "reconcile_phases": {
            p: {
                "count": cp_metrics.registry_value(
                    "reconcile_phase_duration_seconds_count",
                    {"phase": p}),
                "seconds": cp_metrics.registry_value(
                    "reconcile_phase_duration_seconds_sum",
                    {"phase": p}),
            }
            for p in ("render", "child_writes", "status", "events")
        },
        # incremental scheduler: gang-bind latency split by outcome,
        # plus cache health (assumed pods should drain to 0 at idle;
        # rebuilds beyond the initial prime mean fanout overflow)
        "scheduler": {
            "bound": {
                "count": cp_metrics.registry_value(
                    "schedule_latency_seconds_count",
                    {"result": "bound"}),
                "seconds": cp_metrics.registry_value(
                    "schedule_latency_seconds_sum",
                    {"result": "bound"}),
            },
            "unschedulable": {
                "count": cp_metrics.registry_value(
                    "schedule_latency_seconds_count",
                    {"result": "unschedulable"}),
                "seconds": cp_metrics.registry_value(
                    "schedule_latency_seconds_sum",
                    {"result": "unschedulable"}),
            },
            "assumed_pods": cp_metrics.registry_value(
                "scheduler_assumed_pods"),
            "cache_events": cp_metrics.registry_value(
                "scheduler_cache_events_total"),
            "cache_rebuilds": cp_metrics.registry_value(
                "scheduler_cache_rebuilds_total"),
            # bin-packing health: stranded = free - largest_free_gang
            # (chips no single gang can use at the current spread)
            "free_chips": cp_metrics.registry_value(
                "scheduler_free_chips"),
            "largest_free_gang": cp_metrics.registry_value(
                "scheduler_largest_free_gang_chips"),
            "fragmentation": cp_metrics.registry_value(
                "scheduler_fragmentation"),
        },
        # oversubscription lifecycle: suspensions by reason, resumes
        # with state restored, preemption victims, per-phase latency
        "suspend": {
            "suspended": cp_metrics.registry_value(
                "notebook_suspend_total"),
            "resumed": cp_metrics.registry_value(
                "notebook_resume_total"),
            "preempted": cp_metrics.registry_value(
                "notebook_preempt_total"),
            "phase_seconds": {
                p: {
                    "count": cp_metrics.registry_value(
                        "suspend_resume_phase_seconds_count",
                        {"phase": p}),
                    "seconds": cp_metrics.registry_value(
                        "suspend_resume_phase_seconds_sum",
                        {"phase": p}),
                }
                for p in ("drain", "rebind", "restore")
            },
        },
        # multi-role gang jobs (TPUJob): live gangs, per-role
        # readiness (summed across roles here; split by label in the
        # /metrics exposition), phase-transition churn
        "jobs": {
            "running": cp_metrics.registry_value("tpujob_running"),
            "ready_pods": cp_metrics.registry_value(
                "tpujob_ready_pods"),
            "phase_transitions": cp_metrics.registry_value(
                "tpujob_phase_transitions_total"),
        },
        # durable sharded control plane: WAL group-commit and snapshot
        # health plus ring membership. shard is THIS process's identity
        # ("" = unsharded); counters sum across shard labels when a
        # single registry hosts several (in-thread test stacks)
        "persistence": {
            "shard": cp_metrics.shard_label() or None,
            "ring_members": cp_metrics.registry_value(
                "shard_ring_members"),
            "wal_fsyncs": cp_metrics.registry_value(
                "wal_fsync_seconds_count"),
            "wal_fsync_s": cp_metrics.registry_value(
                "wal_fsync_seconds_sum"),
            "wal_bytes": cp_metrics.registry_value("wal_bytes_total"),
            "snapshots": cp_metrics.registry_value(
                "snapshot_duration_seconds_count"),
            "snapshot_s": cp_metrics.registry_value(
                "snapshot_duration_seconds_sum"),
        },
        # push readiness: long-polls currently parked on the hub and
        # the event-arrival -> waiter-observation latency that replaced
        # the clients' fixed-interval status polling
        "readiness": {
            "waiters": cp_metrics.registry_value("readiness_waiters"),
            "wakes": cp_metrics.registry_value(
                "readiness_wake_to_observe_seconds_count"),
            "wake_to_observe_s": cp_metrics.registry_value(
                "readiness_wake_to_observe_seconds_sum"),
        },
        # continuous-batching serving gateway: slot utilization, queue
        # pressure, and SLO enforcement (per-tenant split lives in the
        # labelled /metrics exposition)
        "serving": {
            "queue_depth": cp_metrics.registry_value(
                "serving_queue_depth"),
            "active_slots": cp_metrics.registry_value(
                "serving_active_slots"),
            "slot_capacity": cp_metrics.registry_value(
                "serving_slot_capacity"),
            "batch_occupancy": cp_metrics.registry_value(
                "serving_batch_occupancy"),
            "requests_ok": cp_metrics.registry_value(
                "serving_requests_total", {"result": "ok"}),
            "requests_shed": cp_metrics.registry_value(
                "serving_requests_total", {"result": "shed"}),
            "shed": cp_metrics.registry_value("serving_shed_total"),
            "generated_tokens": cp_metrics.registry_value(
                "serving_generated_tokens_total"),
            "request_latency": {
                "count": cp_metrics.registry_value(
                    "serving_request_latency_seconds_count"),
                "seconds": cp_metrics.registry_value(
                    "serving_request_latency_seconds_sum"),
            },
            # paged-KV fleet (r13): per-class backlog, shared-prefix
            # cache effectiveness, block headroom, replica states
            "class_queue_depth": {
                c: cp_metrics.registry_value(
                    "serving_class_queue_depth", {"slo_class": c})
                for c in ("interactive", "batch", "best_effort")
            },
            "prefix_hit_ratio": cp_metrics.registry_value(
                "serving_prefix_hit_ratio"),
            "free_block_fraction": cp_metrics.registry_value(
                "serving_free_block_fraction"),
            "migrations": cp_metrics.registry_value(
                "serving_migrations_total"),
            "fleet_replicas": {
                s: cp_metrics.registry_value(
                    "serving_fleet_replicas", {"state": s})
                for s in ("ready", "draining", "dead")
            },
        },
        # error accounting: intentionally-absorbed exceptions (KFRM005
        # counts them instead of letting them vanish); per-module split
        # lives in the labelled /metrics exposition, and the
        # swallowed-errors SLO pages on a sustained nonzero rate
        "errors": {
            "swallowed": cp_metrics.registry_value(
                "swallowed_errors_total"),
        },
    }


class InventoryMetricsService:
    """Fleet numbers from the store: per-accelerator-type card
    allocatable/used plus the summary counters the SPA pills show."""

    def __init__(self, api):
        self.api = api

    def snapshot(self) -> dict:
        api = self.api
        scan = getattr(api, "scan", api.list)  # read-only references
        per_type: dict[str, dict] = {}
        used_by_node: dict[str, float] = {}
        for pod in scan("Pod"):
            node = deep_get(pod, "spec", "nodeName")
            if not node:
                continue
            chips = 0.0
            for c in deep_get(pod, "spec", "containers",
                              default=[]) or []:
                amt = deep_get(c, "resources", "limits",
                               gpu_api.NVIDIA_GPU_RESOURCE)
                if amt is not None:
                    chips += parse_quantity(amt)
            if chips:
                used_by_node[node] = used_by_node.get(node, 0.0) + chips
        nodes = 0
        for node in scan("Node"):
            labels = node["metadata"].get("labels") or {}
            accel = labels.get(gpu_api.NODE_LABEL_ACCELERATOR)
            if not accel:
                continue
            nodes += 1
            alloc = parse_quantity(deep_get(
                node, "status", "allocatable",
                gpu_api.NVIDIA_GPU_RESOURCE, default=0))
            entry = per_type.setdefault(
                accel, {"allocatable": 0.0, "used": 0.0, "nodes": 0})
            entry["allocatable"] += alloc
            entry["used"] += used_by_node.get(
                node["metadata"]["name"], 0.0)
            entry["nodes"] += 1
        running = 0
        for nb in scan("Notebook"):
            if (nb.get("status") or {}).get("readyReplicas"):
                running += 1
        return {
            "tpu": per_type,
            "metrics": {
                "nodes": nodes,
                "chips_capacity": sum(e["allocatable"]
                                      for e in per_type.values()),
                "chips_requested": sum(e["used"]
                                       for e in per_type.values()),
                "notebooks_running": running,
            },
            "controlplane": _controlplane_section(api),
        }


class PrometheusMetricsService:
    """Scrape the platform's own gauges from a Prometheus text
    endpoint. Per-accelerator breakdown isn't available from the flat
    gauges, so ``tpu`` is empty — the reference's Prometheus service
    similarly serves only the aggregate chart queries."""

    def __init__(self, url: str, timeout_s: float = 3.0):
        self.url = url
        self.timeout_s = timeout_s

    def _scrape(self) -> dict[str, float]:
        import urllib.request
        out: dict[str, float] = {}
        with urllib.request.urlopen(self.url,
                                    timeout=self.timeout_s) as resp:
            for raw in resp.read().decode().splitlines():
                line = raw.strip()
                if not line or line.startswith("#"):
                    continue
                # exposition: `name value` or `name{labels} value` —
                # federate appends a timestamp, and label VALUES may
                # contain spaces, so split after the closing brace
                if "}" in line:
                    head, _, rest = line.partition("}")
                    name = head.split("{", 1)[0].strip()
                    fields = rest.split()
                else:
                    fields = line.split()
                    name = fields[0] if fields else ""
                    fields = fields[1:]
                if not name or not fields:
                    continue
                try:
                    out[name] = out.get(name, 0.0) + float(fields[0])
                except ValueError:
                    continue
        return out

    def snapshot(self) -> dict:
        g = self._scrape()
        return {
            "tpu": {},
            "metrics": {
                "nodes": None,
                "chips_capacity": None,
                "chips_requested": g.get("tpu_chips_requested"),
                "notebooks_running": g.get("notebook_running"),
            },
            "controlplane": {
                "leader": None,  # identity label lost in the flat sum
                "lease_transitions": None,
                "is_leader": g.get("leader_is_leader"),
                "workqueue_depth": g.get("workqueue_depth"),
                "workqueue_requeues": g.get("workqueue_requeues_total"),
                "retries_exhausted": g.get(
                    "workqueue_retries_exhausted_total"),
                "cache": {
                    "objects": None,  # not exported as a flat gauge
                    "synced_kinds": g.get("informer_synced_kinds"),
                    "events_applied": g.get("informer_events_total"),
                    "last_event_t": g.get(
                        "informer_last_event_timestamp_seconds"),
                    # hit/miss labels are summed by the flat scrape, so
                    # only the combined read count survives here
                    "hits": g.get("cache_reads_total"),
                    "misses": None,
                    "suppressed_writes": g.get(
                        "cache_suppressed_writes_total"),
                    "conflict_fastpath": g.get(
                        "cache_conflict_fastpath_total"),
                },
                "fanout": {
                    "queue_depth": g.get("watch_fanout_queue_depth"),
                    "overflows": g.get("watch_fanout_overflows_total"),
                    "delivered": g.get("watch_fanout_delivered_total"),
                    "dispatch_lag_s": g.get(
                        "watch_fanout_dispatch_lag_seconds"),
                },
                # phase labels are summed by the flat scrape, so only
                # the all-phase totals survive here
                "reconcile_phases": {
                    "count": g.get(
                        "reconcile_phase_duration_seconds_count"),
                    "seconds": g.get(
                        "reconcile_phase_duration_seconds_sum"),
                },
                # result labels (bound/unschedulable) are summed by
                # the flat scrape — only combined attempt totals here
                "scheduler": {
                    "attempts": g.get("schedule_latency_seconds_count"),
                    "seconds": g.get("schedule_latency_seconds_sum"),
                    "assumed_pods": g.get("scheduler_assumed_pods"),
                    "cache_events": g.get(
                        "scheduler_cache_events_total"),
                    "cache_rebuilds": g.get(
                        "scheduler_cache_rebuilds_total"),
                    "free_chips": g.get("scheduler_free_chips"),
                    "largest_free_gang": g.get(
                        "scheduler_largest_free_gang_chips"),
                    "fragmentation": g.get("scheduler_fragmentation"),
                },
                # reason/phase labels summed by the flat scrape
                "suspend": {
                    "suspended": g.get("notebook_suspend_total"),
                    "resumed": g.get("notebook_resume_total"),
                    "preempted": g.get("notebook_preempt_total"),
                    "phase_seconds": {
                        "count": g.get(
                            "suspend_resume_phase_seconds_count"),
                        "seconds": g.get(
                            "suspend_resume_phase_seconds_sum"),
                    },
                },
                # role/phase labels summed by the flat scrape
                "jobs": {
                    "running": g.get("tpujob_running"),
                    "ready_pods": g.get("tpujob_ready_pods"),
                    "phase_transitions": g.get(
                        "tpujob_phase_transitions_total"),
                },
                # shard labels summed by the flat scrape: fleet-wide
                # WAL/snapshot totals (per-shard split needs the
                # labelled exposition, not this backend)
                "persistence": {
                    "shard": None,
                    "ring_members": g.get("shard_ring_members"),
                    "wal_fsyncs": g.get("wal_fsync_seconds_count"),
                    "wal_fsync_s": g.get("wal_fsync_seconds_sum"),
                    "wal_bytes": g.get("wal_bytes_total"),
                    "snapshots": g.get(
                        "snapshot_duration_seconds_count"),
                    "snapshot_s": g.get(
                        "snapshot_duration_seconds_sum"),
                },
                "readiness": {
                    "waiters": g.get("readiness_waiters"),
                    "wakes": g.get(
                        "readiness_wake_to_observe_seconds_count"),
                    "wake_to_observe_s": g.get(
                        "readiness_wake_to_observe_seconds_sum"),
                },
                # tenant/result/reason labels summed by the flat scrape
                "serving": {
                    "queue_depth": g.get("serving_queue_depth"),
                    "active_slots": g.get("serving_active_slots"),
                    "slot_capacity": g.get("serving_slot_capacity"),
                    "batch_occupancy": g.get("serving_batch_occupancy"),
                    "requests_ok": None,
                    "requests_shed": None,
                    "shed": g.get("serving_shed_total"),
                    "generated_tokens": g.get(
                        "serving_generated_tokens_total"),
                    "request_latency": {
                        "count": g.get(
                            "serving_request_latency_seconds_count"),
                        "seconds": g.get(
                            "serving_request_latency_seconds_sum"),
                    },
                },
                # module labels summed by the flat scrape
                "errors": {
                    "swallowed": g.get("swallowed_errors_total"),
                },
            },
        }


def make_metrics_service(api, backend: str | None = None,
                         prometheus_url: str | None = None
                         ) -> MetricsService:
    """The factory (``metrics_service_factory.ts`` equivalent).
    Backend from the arg or ``KFRM_METRICS_BACKEND``; unknown names
    raise so a typo can't silently fall back."""
    backend = backend or os.environ.get("KFRM_METRICS_BACKEND",
                                        "inventory")
    if backend == "inventory":
        return InventoryMetricsService(api)
    if backend == "prometheus":
        url = prometheus_url or os.environ.get("KFRM_PROMETHEUS_URL")
        if not url:
            raise ValueError(
                "prometheus metrics backend needs KFRM_PROMETHEUS_URL")
        return PrometheusMetricsService(url)
    raise ValueError(f"unknown metrics backend {backend!r} "
                     "(inventory|prometheus)")


class MetricsHistory:
    """Ring buffer of timestamped snapshots behind the dashboard's
    utilization-over-time charts. Samples on a daemon thread every
    ``interval_s`` (0 = only on demand); ``series()`` also takes a
    fresh sample when the last one is stale, so a just-opened
    dashboard always has a current point."""

    def __init__(self, service: MetricsService, *,
                 interval_s: float = 10.0, capacity: int = 720):
        self.service = service
        self.interval_s = interval_s
        self._ring: collections.deque = collections.deque(
            maxlen=capacity)
        self._lock = make_lock("metrics_service.sampler")
        self._stop = threading.Event()
        self._thread_started = False
        self._thread_lock = make_lock("metrics_service.sampler_thread")
        # seed one point synchronously so a just-booted dashboard has
        # a current sample; the polling thread starts LAZILY on the
        # first history read, so apps that never chart never pay for
        # (or leak) a sampler thread
        try:
            self.sample()
        except Exception:  # noqa: BLE001 - charts are best-effort
            cp_metrics.swallowed("metrics_service", "seed sample")

    def _ensure_thread(self):
        if self.interval_s <= 0 or self._thread_started:
            return
        with self._thread_lock:
            if not self._thread_started:
                threading.Thread(target=self._loop,
                                 daemon=True).start()
                self._thread_started = True

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.sample()
            except Exception:  # noqa: BLE001 - keep sampling
                cp_metrics.swallowed("metrics_service", "sampler tick")

    def stop(self):
        self._stop.set()

    def sample(self) -> dict:
        snap = self.service.snapshot()
        m = snap.get("metrics") or {}
        point = {"t": time.time(),
                 "chips_used": m.get("chips_requested"),
                 "chips_capacity": m.get("chips_capacity"),
                 "notebooks_running": m.get("notebooks_running")}
        with self._lock:
            self._ring.append(point)
        return point

    def series(self, max_points: int = 360) -> list[dict]:
        self._ensure_thread()
        with self._lock:
            fresh = (not self._ring or
                     time.time() - self._ring[-1]["t"] >
                     max(self.interval_s, 1.0))
        if fresh:
            self.sample()
        with self._lock:
            pts = list(self._ring)
        return pts[-max_points:]
