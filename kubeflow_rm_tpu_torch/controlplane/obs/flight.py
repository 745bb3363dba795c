"""Flight recorder: one self-contained black-box bundle per incident
(the port's copy of ``kubeflow_rm_tpu/controlplane/obs/flight.py``).

Chaos runs (kill-a-shard, preemption storms) used to leave no record
beyond whatever the storm script printed; by the time someone asks
"what did the platform look like when the alert fired", the gauges
have moved on and the span ring has rotated. The recorder freezes all
of it into a single JSON bundle at trigger time:

- the trailing TSDB window (every series, bounded by the ring),
- the SpanCollector's slow traces with their critical paths, merged
  across every shard's ``/debug/traces`` export,
- the active alert set + recent transitions from the SLO engine,
- shard liveness as the ``ShardRunner`` watchdog sees it,
- the lockgraph report when ``KFRM_LOCK_ANALYSIS`` is on.

Three trigger paths: an SLO transition to ``critical`` (wired via
:meth:`attach_engine`), shard death observed by the watchdog, and
explicit calls from chaos scenarios in ``e2e_walk.py``. Automatic
triggers are rate-limited (``min_interval_s``) so a flapping alert
cannot dump-storm the disk; explicit calls always record.
"""

from __future__ import annotations

import json
import time
from collections import deque

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock

SCHEMA_VERSION = 1
_MAX_SLOW_TRACES = 5


class FlightRecorder:
    def __init__(self, tsdb=None, engine=None, *,
                 window_s: float = 120.0, keep: int = 8,
                 liveness=None, shard_urls: dict | None = None,
                 run_meta: dict | None = None,
                 min_interval_s: float = 5.0):
        self.tsdb = tsdb
        self.engine = engine
        self.window_s = float(window_s)
        self.run_meta = run_meta
        self._liveness = liveness          # () -> {shard: bool}
        self._shard_urls = dict(shard_urls or {})
        self.min_interval_s = float(min_interval_s)
        self._lock = make_lock("obs.flight")
        self._bundles: deque = deque(maxlen=keep)
        self._last_auto = 0.0
        self.triggered_total = 0
        self.suppressed_total = 0

    # ---- wiring ------------------------------------------------------

    def attach_engine(self, engine) -> None:
        """Subscribe to the SLO engine: any transition *into* critical
        records a bundle (rate-limited)."""
        self.engine = engine
        engine.on_transition(self._on_transition)

    def set_liveness(self, fn) -> None:
        self._liveness = fn

    def _on_transition(self, tr: dict) -> None:
        if tr.get("to") == "critical":
            self.trigger("alert_critical", detail=tr, auto=True)

    # ---- capture -----------------------------------------------------

    def trigger(self, reason: str, *, detail=None,
                auto: bool = False) -> dict | None:
        """Capture one bundle. ``auto`` triggers (alert / watchdog) are
        rate-limited; explicit chaos-scenario calls always record.
        Returns the bundle, or ``None`` when suppressed."""
        now = time.time()
        if auto and (now - self._last_auto) < self.min_interval_s:
            self.suppressed_total += 1
            return None
        bundle = self._capture(reason, detail, now)
        with self._lock:
            if auto:
                self._last_auto = now
            self._bundles.append(bundle)
            self.triggered_total += 1
        return bundle

    def _capture(self, reason: str, detail, now: float) -> dict:
        """Assemble the bundle with NO recorder lock held — every
        sub-capture takes (and releases) its own component lock."""
        from kubeflow_rm_tpu_torch.controlplane import metrics

        bundle: dict = {
            "schema_version": SCHEMA_VERSION,
            "trigger": {"reason": reason, "t": round(now, 3),
                        "detail": detail},
            "window_s": self.window_s,
        }
        if self.run_meta is not None:
            bundle["run_meta"] = self.run_meta
        if self.tsdb is not None:
            bundle["metrics"] = self.tsdb.dump(self.window_s, now=now)
        if self.engine is not None:
            bundle["alerts"] = self.engine.snapshot()
        bundle["slow_traces"] = self._slow_traces()
        if self._liveness is not None:
            try:
                bundle["shard_liveness"] = self._liveness()
            except Exception:  # noqa: BLE001 - runner may be torn down
                metrics.swallowed("obs.flight", "liveness probe")
                bundle["shard_liveness"] = None
        bundle["lockgraph"] = self._lockgraph()
        return bundle

    def _slow_traces(self) -> list[dict]:
        """Slow traces merged across the local collector and every
        shard's ``/debug/traces``, slowest first, each with its
        critical path attached (self_ms sums to the root wallclock)."""
        from kubeflow_rm_tpu_torch.controlplane import metrics, tracing

        local = tracing.collector()
        span_lists = [local.spans()]
        slow = list(local.slow_traces())
        for name, url in self._shard_urls.items():
            import urllib.request
            try:
                with urllib.request.urlopen(
                        url.rstrip("/") + "/debug/traces",
                        timeout=2.0) as resp:
                    payload = json.loads(resp.read().decode())
            except Exception:  # noqa: BLE001 - shard may be down (that
                # can be exactly why we are dumping)
                metrics.swallowed("obs.flight", f"trace fetch {name}")
                continue
            span_lists.append(payload.get("spans") or [])
            slow.extend(payload.get("slow") or [])
        all_spans = tracing.merge_spans(*span_lists)
        by_trace: dict[str, list] = {}
        for s in all_spans:
            by_trace.setdefault(s["trace_id"], []).append(s)
        out, seen = [], set()
        for t in sorted(slow,
                        key=lambda t: -(t.get("duration_ms") or 0)):
            tid = t["trace_id"]
            if tid in seen:
                continue
            seen.add(tid)
            merged = tracing.merge_spans(t.get("spans") or [],
                                         by_trace.get(tid, []))
            out.append({
                "trace_id": tid,
                "duration_ms": t.get("duration_ms"),
                "processes": sorted({s.get("process") or ""
                                     for s in merged}),
                "critical_path": tracing.critical_path(merged),
                "spans": merged,
            })
            if len(out) >= _MAX_SLOW_TRACES:
                break
        return out

    @staticmethod
    def _lockgraph() -> dict | None:
        from kubeflow_rm_tpu_torch.analysis import lockgraph
        if not lockgraph.enabled():
            return None
        return lockgraph.report()

    # ---- access ------------------------------------------------------

    def bundles(self) -> list[dict]:
        with self._lock:
            return list(self._bundles)

    def last(self) -> dict | None:
        with self._lock:
            return self._bundles[-1] if self._bundles else None

    def dump_json(self, path: str, bundle: dict | None = None) -> str:
        """Write the given (default: most recent) bundle to ``path``."""
        if bundle is None:
            bundle = self.last()
        if bundle is None:
            raise ValueError("no flight bundle recorded yet")
        with open(path, "w") as f:
            json.dump(bundle, f, indent=1, default=str)
        return path
