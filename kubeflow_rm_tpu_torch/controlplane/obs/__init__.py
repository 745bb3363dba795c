"""``obs`` — the layer that closes the loop from raw signals to
decisions (the port's copy of ``kubeflow_rm_tpu/controlplane/obs``).

The platform already *emits* everything (Prometheus families, W3C
traces with critical-path attribution, lockgraph reports); this
package *consumes* them:

- :mod:`.timeseries` — in-process ring-buffer TSDB sampling the shared
  registry, with cross-shard ``/metrics`` federation,
- :mod:`.slo` — declarative SLOs evaluated as multi-window burn rates,
  with an ok/warning/critical state machine and hysteresis,
- :mod:`.flight` — the flight recorder: one self-contained bundle
  (metric window, slow traces + critical paths, alerts, shard
  liveness, lockgraph) per incident,
- :mod:`.runmeta` — the shared artifact header the perf ratchet uses
  to refuse mismatched-arm comparisons.

:class:`Observer` bundles the three runtime pieces behind one object
so the dashboard and the chaos harnesses wire a single thing.
"""

from __future__ import annotations

import threading
import time

from .flight import FlightRecorder
from .runmeta import build_run_meta, compatible
from .slo import (GaugeSLO, LatencySLO, RateSLO, SLO, SLOEngine,
                  TenantRateSLO, Window, default_slos,
                  install_probe_bridges)
from .timeseries import TimeSeriesDB, parse_exposition

__all__ = [
    "FlightRecorder", "GaugeSLO", "LatencySLO", "Observer", "RateSLO",
    "SLO", "SLOEngine", "TenantRateSLO", "TimeSeriesDB", "Window",
    "build_run_meta", "compatible", "default_slos",
    "install_probe_bridges", "parse_exposition",
]


class Observer:
    """TSDB + SLO engine + flight recorder, wired together.

    ``tick()`` is one synchronous sample-and-evaluate pass; callers
    either drive it themselves (harness loops, on-demand dashboard
    reads via :meth:`maybe_tick`) or let :meth:`start` run it on a
    background interval. An SLO transition into ``critical``
    auto-triggers the flight recorder.
    """

    def __init__(self, *, interval_s: float = 2.0,
                 window_s: float = 300.0,
                 shard_urls: dict | None = None,
                 slos: list | None = None,
                 run_meta: dict | None = None,
                 flight_window_s: float = 120.0,
                 liveness=None, registry=None,
                 max_series: int = 4096):
        # 4096 series headroom: federating N shards multiplies every
        # histogram family by its bucket count; at the 1024 default a
        # 4-shard chaos run evicts live series mid-incident
        self.interval_s = float(interval_s)
        self.tsdb = TimeSeriesDB(registry=registry,
                                 interval_s=interval_s,
                                 window_s=window_s,
                                 max_series=max_series)
        for name, url in (shard_urls or {}).items():
            self.tsdb.add_scrape(name, url)
        self.engine = SLOEngine(
            self.tsdb, default_slos() if slos is None else slos)
        # the per-tenant torchcheck SLOs only burn if the probes feed
        # the counters — hang the bridge the moment an Observer exists
        install_probe_bridges()
        self.flight = FlightRecorder(
            self.tsdb, window_s=flight_window_s, liveness=liveness,
            shard_urls=shard_urls, run_meta=run_meta)
        self.flight.attach_engine(self.engine)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._last_tick = 0.0

    # ---- driving -----------------------------------------------------

    def tick(self, now: float | None = None) -> list[dict]:
        """Sample every source, evaluate every SLO; returns the alert
        transitions this pass caused."""
        self.tsdb.sample(now)
        fired = self.engine.evaluate(now)
        self._last_tick = time.time()
        return fired

    def maybe_tick(self) -> None:
        """Tick if the last pass is older than the interval — the
        on-demand mode ``GET /api/alerts`` uses so webapp construction
        never spawns a thread."""
        if time.time() - self._last_tick >= self.interval_s:
            self.tick()

    def start(self) -> None:
        """Background tick loop (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="obs-observer", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)

    def _run(self) -> None:
        from kubeflow_rm_tpu_torch.controlplane import metrics
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - observer must survive
                metrics.swallowed("obs.observer", "tick")

    # ---- event hooks -------------------------------------------------

    def on_shard_death(self, name: str, exitcode=None) -> dict | None:
        """The ``ShardRunner`` watchdog's hook: fold the death into the
        TSDB/SLO state immediately (the counter was just incremented),
        then record a flight bundle."""
        self.tick()
        return self.flight.trigger(
            "shard_death", detail={"shard": name, "exitcode": exitcode},
            auto=True)

    # ---- snapshots ---------------------------------------------------

    def alerts(self) -> dict:
        snap = self.engine.snapshot()
        snap["tsdb"] = {"series": self.tsdb.series_count(),
                        "evictions": self.tsdb.evictions,
                        "scrape_errors": self.tsdb.scrape_errors,
                        "samples_taken": self.tsdb.samples_taken}
        snap["flight"] = {"bundles": len(self.flight.bundles()),
                          "triggered_total":
                              self.flight.triggered_total,
                          "suppressed_total":
                              self.flight.suppressed_total}
        return snap
