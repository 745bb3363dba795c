"""Declarative SLOs evaluated as multi-window burn rates over the TSDB
(the port's copy of ``kubeflow_rm_tpu/controlplane/obs/slo.py``: every
SLO named and thresholded as JAX's, and the port's probe bridges).

An SLO here is "target + window set": the target defines an error
budget, and each :class:`Window` pairs a long and a short evaluation
window with a burn-rate threshold and a severity — the classic
multi-window multi-burn-rate alerting shape (long window for
significance, short window so a recovered system stops paging). Burn
rate is always *budget consumption speed*: ``1.0`` means exactly
spending the budget, ``>1`` means on track to blow it.

Three SLO flavours cover every family the registry exports:

- :class:`LatencySLO` — histogram-backed; budget is the allowed
  fraction of events slower than ``threshold_s``; burn =
  bad_fraction / (1 - target).
- :class:`RateSLO` — counter-backed (``swallowed_errors_total``,
  ``shard_deaths_total``); burn = observed rate / allowed rate.
- :class:`GaugeSLO` — gauge-backed (fragmentation); burn =
  windowed mean / threshold, so *sustained* elevation alerts while a
  transient spike does not.

The :class:`SLOEngine` runs the ok -> warning -> critical state
machine with hysteresis: severity escalates the moment any window
pair's burn crosses its threshold, but de-escalates only after the
long-window burn stays below ``clear_ratio x threshold`` for
``hold_s`` — a series oscillating around the boundary latches at its
peak severity instead of flapping. Transitions are recorded and fanned
out to callbacks (the flight recorder hooks ``to == "critical"``).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock

from .timeseries import TimeSeriesDB

_RANK = {"ok": 0, "warning": 1, "critical": 2}


@dataclass(frozen=True)
class Window:
    """One (long, short) burn-rate evaluation pair."""
    long_s: float
    short_s: float
    burn: float          # threshold, as a multiple of budget burn speed
    severity: str        # "warning" | "critical"


@dataclass
class SLO:
    """Base declarative objective; subclasses define ``burn_rate``."""
    name: str
    metric: str
    windows: tuple[Window, ...]
    labels: dict | None = None
    description: str = ""

    def burn_rate(self, tsdb: TimeSeriesDB, window_s: float,
                  now: float | None = None) -> float | None:
        raise NotImplementedError

    def spec(self) -> dict:
        return {"name": self.name, "metric": self.metric,
                "labels": dict(self.labels or {}),
                "kind": type(self).__name__,
                "description": self.description,
                "windows": [vars(w) for w in self.windows]}


@dataclass
class LatencySLO(SLO):
    """``target`` fraction of events must complete under
    ``threshold_s``; evaluated from windowed histogram-bucket deltas."""
    threshold_s: float = 1.0
    target: float = 0.95

    def burn_rate(self, tsdb, window_s, now=None):
        got = tsdb.bad_fraction(self.metric, self.threshold_s,
                                self.labels, window_s, now=now)
        if got is None:
            return None           # no events in window -> no signal
        bad_frac, _total = got
        budget = max(1e-9, 1.0 - self.target)
        return bad_frac / budget

    def spec(self):
        d = super().spec()
        d.update(threshold_s=self.threshold_s, target=self.target)
        return d


@dataclass
class RateSLO(SLO):
    """Counter family whose rate must stay under ``allowed_per_s``."""
    allowed_per_s: float = 1.0

    def burn_rate(self, tsdb, window_s, now=None):
        rate = tsdb.rate(self.metric, self.labels, window_s, now=now)
        if rate is None:
            return None
        return rate / max(1e-12, self.allowed_per_s)

    def spec(self):
        d = super().spec()
        d.update(allowed_per_s=self.allowed_per_s)
        return d


@dataclass
class TenantRateSLO(RateSLO):
    """Per-tenant counter family: the SLO burns at the rate of the
    WORST tenant, not the fleet sum — one notebook recompiling every
    step must page even while a hundred quiet tenants dilute the
    aggregate. The offending tenant is surfaced in
    ``spec()`` so ``/api/alerts`` names the noisy neighbour."""
    label_key: str = "tenant"
    worst_tenant: str | None = None

    def burn_rate(self, tsdb, window_s, now=None):
        worst = None
        offender = None
        for tenant in tsdb.label_values(self.metric, self.label_key):
            rate = tsdb.rate(
                self.metric,
                dict(self.labels or {}, **{self.label_key: tenant}),
                window_s, now=now)
            if rate is None:
                continue
            if worst is None or rate > worst:
                worst, offender = rate, tenant
        if worst is None:
            return None
        self.worst_tenant = offender
        return worst / max(1e-12, self.allowed_per_s)

    def spec(self):
        d = super().spec()
        d.update(label_key=self.label_key, worst_tenant=self.worst_tenant)
        return d


@dataclass
class GaugeSLO(SLO):
    """Gauge whose *windowed mean* must stay under ``threshold`` —
    sustained elevation burns, transient spikes do not."""
    threshold: float = 1.0

    def burn_rate(self, tsdb, window_s, now=None):
        avg = tsdb.gauge_avg(self.metric, self.labels, window_s, now=now)
        if avg is None:
            return None
        return avg / max(1e-12, self.threshold)

    def spec(self):
        d = super().spec()
        d.update(threshold=self.threshold)
        return d


# -- the shipped objective set ----------------------------------------

def default_slos() -> list[SLO]:
    """The concrete SLO set the platform watches out of the box. Window
    lengths are sized for conformance-storm timescales (minutes, not
    the textbook hours); thresholds sit on histogram bucket bounds so
    ``bad_fraction`` reads an exact bucket."""
    crit_warn = (Window(120.0, 30.0, 1.5, "critical"),
                 Window(300.0, 60.0, 1.0, "warning"))
    warn_only = (Window(300.0, 60.0, 1.0, "warning"),)
    return [
        LatencySLO(
            name="provision-p50", metric="provision_latency_seconds",
            windows=crit_warn, threshold_s=2.5, target=0.50,
            description="half of notebook provisions (CR create -> "
                        "readyReplicas == desired) land under 2.5s"),
        LatencySLO(
            name="serving-victim-p95",
            metric="serving_request_latency_seconds",
            windows=crit_warn, threshold_s=4.0, target=0.95,
            description="victim-tenant serving p95 under the 4s "
                        "gateway SLO despite a flooding tenant"),
        LatencySLO(
            name="scheduler-latency", metric="schedule_latency_seconds",
            windows=crit_warn, threshold_s=0.1, target=0.99,
            description="99% of gang placements decided in 100ms"),
        LatencySLO(
            name="wal-fsync", metric="wal_fsync_seconds",
            windows=crit_warn, threshold_s=0.05, target=0.99,
            description="99% of WAL group commits fsync in 50ms"),
        RateSLO(
            name="swallowed-errors", metric="swallowed_errors_total",
            windows=warn_only, allowed_per_s=1.0 / 300.0,
            description="best-effort exception handlers should be "
                        "near-silent; a sustained nonzero swallow rate "
                        "is a hidden fault"),
        GaugeSLO(
            name="scheduler-fragmentation",
            metric="scheduler_fragmentation",
            windows=warn_only, threshold=0.5,
            description="sustained fragmentation >= 0.5 means free "
                        "cards exist but no gang-sized hole does — "
                        "the ROADMAP-3 bin-packing signal"),
        GaugeSLO(
            name="serving-prefix-hit-collapse",
            metric="serving_prefix_miss_ratio",
            windows=warn_only, threshold=0.95,
            description="sustained prefix-cache miss ratio >= 0.95 "
                        "while prompts flow means the shared-prefix "
                        "block cache stopped absorbing prefill "
                        "(thrash/eviction storm, or affinity routing "
                        "gone wrong) — the paged-KV speedup is gone"),
        GaugeSLO(
            name="serving-store-hit-collapse",
            metric="serving_store_miss_ratio",
            windows=warn_only, threshold=0.95,
            description="sustained GlobalBlockStore miss ratio >= "
                        "0.95 while lookups flow means the fleet-wide "
                        "prefix tier stopped absorbing re-prefills "
                        "(byte budget too small, publish path broken, "
                        "or traffic lost all prefix overlap) — decode "
                        "replicas are back to paying full prefill "
                        "after every rebalance or death"),
        GaugeSLO(
            name="declared-hbm-drift",
            metric="declared_hbm_drift_ratio",
            windows=warn_only, threshold=0.2,
            description="warn-only: observed on-card memory peak drifts "
                        ">20% from the declared-workload prediction "
                        "for a sustained window — the declaration the "
                        "admission pricer charged against no longer "
                        "describes the job (model update changed the "
                        "footprint); repack before the next bind, do "
                        "not page"),
        TenantRateSLO(
            name="jit-recompile-storm", metric="jit_recompiles_total",
            windows=warn_only, allowed_per_s=1.0 / 30.0,
            description="a tenant minting new signatures faster "
                        "than ~2/min is retracing in a hot loop — its "
                        "slice burns recompiles instead of steps "
                        "(torchcheck recompile sentinel, per-tenant)"),
        TenantRateSLO(
            name="implicit-hostsync-storm",
            metric="implicit_hostsyncs_total",
            windows=warn_only, allowed_per_s=1.0 / 30.0,
            description="a tenant tripping unsanctioned device->host "
                        "syncs inside declared hot regions serializes "
                        "its GPU behind Python round-trips (torchcheck "
                        "hostsync probe, per-tenant)"),
        RateSLO(
            name="shard-deaths", metric="shard_deaths_total",
            windows=(Window(120.0, 15.0, 1.0, "critical"),),
            allowed_per_s=1.0 / 600.0,
            description="any shard process death inside the window "
                        "pages; the watchdog respawns, the alert "
                        "captures that it had to"),
    ]


# -- the torchcheck probes -> per-tenant fleet counters --------------

def tenant_of(name: str) -> str:
    """Tenant from a probe entry/region name: the convention is
    ``<tenant>/<site>`` (``teamA/decode-step``); unprefixed names fold
    into ``default``."""
    tenant, sep, _ = name.partition("/")
    return tenant if sep and tenant else "default"


_bridges_lock = make_lock("obs.bridges")
_bridges_installed = False


def install_probe_bridges() -> None:
    """Wire the port's recompile sentinel and host-sync probe into the
    per-tenant ``jit_recompiles_total`` / ``implicit_hostsyncs_total``
    counters. Idempotent; the probes stay importable (and free) without
    this module — this is the only coupling point, one-directional."""
    global _bridges_installed
    with _bridges_lock:
        if _bridges_installed:
            return
        from kubeflow_rm_tpu_torch.analysis.torchcheck import (
            hostsync, recompile,
        )
        from kubeflow_rm_tpu_torch.controlplane import metrics

        def _on_recompile(entry: str, n_signatures: int) -> None:
            metrics.JIT_RECOMPILES_TOTAL.labels(
                tenant=tenant_of(entry)).inc()

        def _on_hostsync(region: str, kind: str) -> None:
            metrics.IMPLICIT_HOSTSYNCS_TOTAL.labels(
                tenant=tenant_of(region)).inc()

        recompile.add_observer(_on_recompile)
        hostsync.add_observer(_on_hostsync)
        _bridges_installed = True


@dataclass
class _State:
    severity: str = "ok"
    since: float = 0.0
    below_since: float | None = None
    burns: dict = field(default_factory=dict)


class SLOEngine:
    """Evaluates every SLO against the TSDB and runs the alert state
    machine. ``evaluate()`` is cheap enough to call on every dashboard
    read; harnesses call it on a tick loop."""

    def __init__(self, tsdb: TimeSeriesDB, slos: list[SLO], *,
                 clear_ratio: float = 0.8, hold_s: float = 30.0,
                 max_transitions: int = 256):
        self.tsdb = tsdb
        self.slos = list(slos)
        self.clear_ratio = float(clear_ratio)
        self.hold_s = float(hold_s)
        self._lock = make_lock("obs.engine")
        self._states: dict[str, _State] = {
            s.name: _State() for s in self.slos}
        self._transitions: deque = deque(maxlen=max_transitions)
        self._callbacks: list = []

    def on_transition(self, cb) -> None:
        """``cb(transition_dict)`` on every state change; called with
        no engine lock held."""
        self._callbacks.append(cb)

    # ---- evaluation --------------------------------------------------

    def _desired(self, slo: SLO, now: float
                 ) -> tuple[str, dict]:
        """(severity the burn rates call for right now, burn detail)."""
        burns: dict = {}
        desired = "ok"
        for w in sorted(slo.windows, key=lambda w: -_RANK[w.severity]):
            long_b = slo.burn_rate(self.tsdb, w.long_s, now=now)
            short_b = slo.burn_rate(self.tsdb, w.short_s, now=now)
            burns[f"{int(w.long_s)}s"] = long_b
            burns[f"{int(w.short_s)}s"] = short_b
            if (long_b is not None and short_b is not None
                    and long_b >= w.burn and short_b >= w.burn
                    and _RANK[w.severity] > _RANK[desired]):
                desired = w.severity
        return desired, burns

    def _clear_floor(self, slo: SLO, severity: str) -> float:
        """Burn level below which the *current* severity may clear."""
        thresholds = [w.burn for w in slo.windows
                      if w.severity == severity]
        return self.clear_ratio * (min(thresholds) if thresholds
                                   else 1.0)

    def evaluate(self, now: float | None = None) -> list[dict]:
        """One evaluation pass; returns the transitions it caused.
        Burn rates are computed before the engine lock is taken (TSDB
        queries take their own lock); callbacks fire after release."""
        now = time.time() if now is None else now
        computed = [(slo, *self._desired(slo, now)) for slo in self.slos]
        fired: list[dict] = []
        with self._lock:
            for slo, desired, burns in computed:
                st = self._states[slo.name]
                st.burns = burns
                cur, des = _RANK[st.severity], _RANK[desired]
                if des > cur:
                    fired.append(self._move_locked(slo, st, desired,
                                                   burns, now))
                elif des < cur:
                    # hysteresis: drop only after the long-window burn
                    # sits below the clear floor for hold_s straight
                    floor = self._clear_floor(slo, st.severity)
                    longest = max(slo.windows, key=lambda w: w.long_s)
                    long_b = burns.get(f"{int(longest.long_s)}s")
                    if long_b is None or long_b < floor:
                        if st.below_since is None:
                            st.below_since = now
                        elif now - st.below_since >= self.hold_s:
                            fired.append(self._move_locked(
                                slo, st, desired, burns, now))
                    else:
                        st.below_since = None
                else:
                    st.below_since = None
        for tr in fired:
            for cb in self._callbacks:
                cb(tr)
        return fired

    def _move_locked(self, slo: SLO, st: _State, to: str,
                     burns: dict, now: float) -> dict:
        tr = {"t": round(now, 3), "slo": slo.name,
              "from": st.severity, "to": to,
              "burns": {k: (None if v is None else round(v, 4))
                        for k, v in burns.items()},
              "description": slo.description}
        st.severity = to
        st.since = now
        st.below_since = None
        self._transitions.append(tr)
        return tr

    # ---- snapshots ---------------------------------------------------

    def snapshot(self) -> dict:
        """Everything ``GET /api/alerts`` and the flight recorder
        serialize: per-SLO state + burns, the active (non-ok) alert
        set, and the transition log."""
        with self._lock:
            slos = []
            active = []
            for slo in self.slos:
                st = self._states[slo.name]
                entry = dict(slo.spec(), state=st.severity,
                             since=round(st.since, 3),
                             burns={k: (None if v is None
                                        else round(v, 4))
                                    for k, v in st.burns.items()})
                slos.append(entry)
                if st.severity != "ok":
                    active.append({"slo": slo.name,
                                   "state": st.severity,
                                   "since": round(st.since, 3),
                                   "burns": entry["burns"],
                                   "description": slo.description})
            return {"slos": slos, "active": active,
                    "transitions": list(self._transitions)}

    def state_of(self, name: str) -> str:
        with self._lock:
            return self._states[name].severity
