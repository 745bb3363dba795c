"""In-process ring-buffer TSDB over the control plane's metrics (the
port's copy of ``kubeflow_rm_tpu/controlplane/obs/timeseries.py``; the
registry is the port's :data:`..metrics.REGISTRY`, a list of the
standard-library metrics, where JAX's is ``prometheus_client``'s).

The platform emits its metric families into ``metrics.REGISTRY``, but a
scrape sees only the instantaneous value. The ``TimeSeriesDB`` samples
every family on an interval and keeps a bounded ring of ``(t, value)``
points per labelled series, reducing at *query* time with the
semantics each family type wants:

- counter    -> windowed per-second **rate** (reset-aware),
- gauge      -> **last** value / windowed average,
- histogram  -> windowed **percentiles** from cumulative-bucket deltas.

Cross-shard federation: the dashboard process registers each shard's
REST URL with :meth:`TimeSeriesDB.add_scrape`; the sampler then pulls
every shard's ``/metrics`` exposition alongside the local registry and
ingests the parsed samples with an ``instance=<shard>`` label. Families
that already carry a ``shard`` label (``wal_fsync_seconds``)
disambiguate on their own; the injected ``instance`` label covers the
rest (two shards both exporting ``workqueue_depth{name="notebook"}``
must not collapse into one series).

Memory is bounded twice over: each series ring holds at most
``window_s / interval_s`` points (plus slack), and the series map is
capped at ``max_series`` — when label cardinality grows past the cap
the least-recently-updated series is evicted (and counted), so a
misbehaving label can never OOM the control plane.
"""

from __future__ import annotations

import math
import re
import threading
import time
from collections import deque
from typing import Iterable

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock

# sample kinds, normalised across local collection and federation
COUNTER = "counter"
GAUGE = "gauge"
BUCKET = "histogram_bucket"   # cumulative counter per ``le``

_SUFFIX_KINDS = (("_bucket", BUCKET), ("_count", COUNTER),
                 ("_sum", COUNTER), ("_total", COUNTER))

_SAMPLE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)\s*$')
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def _sample_kind(family_type: str, sample_name: str) -> str:
    """Kind of one exposition sample given its family's TYPE."""
    if family_type == "gauge":
        return GAUGE
    if family_type in ("histogram", "summary"):
        for suffix, kind in _SUFFIX_KINDS:
            if sample_name.endswith(suffix):
                return kind
        return GAUGE  # summary quantile samples read as gauges
    if family_type == "counter":
        return COUNTER
    # untyped: fall back on the naming convention
    for suffix, kind in _SUFFIX_KINDS:
        if sample_name.endswith(suffix):
            return kind
    return GAUGE


def parse_exposition(text: str) -> list[tuple[str, dict, str, float]]:
    """Parse Prometheus text exposition into
    ``(sample_name, labels, kind, value)`` tuples, keeping labels —
    unlike the metrics-service scraper, which sums them away. ``NaN``
    samples and the ``_created`` timestamps are dropped."""
    types: dict[str, str] = {}
    out: list[tuple[str, dict, str, float]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) == 4 and parts[1] == "TYPE":
                types[parts[2]] = parts[3]
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        name, raw_labels, raw_value = m.groups()
        if name.endswith("_created"):
            continue
        try:
            value = float(raw_value)
        except ValueError:
            continue
        if math.isnan(value):
            continue
        labels = {k: v.replace('\\"', '"').replace("\\\\", "\\")
                  .replace("\\n", "\n")
                  for k, v in _LABEL_RE.findall(raw_labels or "")}
        family = name
        for suffix, _ in _SUFFIX_KINDS:
            if family.endswith(suffix) and family[:-len(suffix)] in types:
                family = family[:-len(suffix)]
                break
        out.append((name, labels, _sample_kind(types.get(family, ""),
                                               name), value))
    return out


class _Series:
    __slots__ = ("name", "labels", "kind", "points", "last_t")

    def __init__(self, name: str, labels: dict, kind: str, maxlen: int):
        self.name = name
        self.labels = labels
        self.kind = kind
        self.points: deque = deque(maxlen=maxlen)
        self.last_t = 0.0


class TimeSeriesDB:
    """Bounded in-memory TSDB; see module docstring for semantics."""

    def __init__(self, *, registry=None, interval_s: float = 2.0,
                 window_s: float = 300.0, max_series: int = 1024,
                 max_points: int | None = None):
        if registry is None:
            from kubeflow_rm_tpu_torch.controlplane import metrics
            registry = metrics.REGISTRY
        self._registry = registry
        self.interval_s = float(interval_s)
        self.window_s = float(window_s)
        self._max_points = max_points or max(
            8, int(self.window_s / self.interval_s) + 8)
        self._max_series = int(max_series)
        self._series: dict[tuple, _Series] = {}
        self._lock = make_lock("obs.tsdb")
        self._scrapes: dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.evictions = 0          # series dropped at the cardinality cap
        self.scrape_errors = 0      # failed shard /metrics pulls
        self.samples_taken = 0

    # ---- federation --------------------------------------------------

    def add_scrape(self, name: str, url: str) -> None:
        """Register a shard's base URL; every sampling pass pulls its
        ``/metrics`` and ingests the series with ``instance=name``."""
        self._scrapes[name] = url.rstrip("/")

    def remove_scrape(self, name: str) -> None:
        """Forget a shard (elastic merge retired it) — otherwise every
        pass after the scale-down counts a scrape error against a
        process that was deliberately stopped. Its historical series
        age out of the window naturally."""
        self._scrapes.pop(name, None)

    # ---- sampling ----------------------------------------------------

    def sample(self, now: float | None = None) -> int:
        """One synchronous sampling pass (local registry + every
        registered shard scrape). Returns the number of samples
        ingested. Collection happens with NO TSDB lock held; only the
        final ingest takes it."""
        now = time.time() if now is None else now
        batch: list[tuple[str, dict, str, float]] = []
        batch.extend(self._collect_local())
        for src, url in list(self._scrapes.items()):
            batch.extend(self._collect_scrape(src, url))
        with self._lock:
            for name, labels, kind, value in batch:
                self._ingest_locked(now, name, labels, kind, value)
            self.samples_taken += 1
        return len(batch)

    def _collect_local(self) -> Iterable[tuple[str, dict, str, float]]:
        from kubeflow_rm_tpu_torch.controlplane import metrics
        try:
            # free-card / fragmentation gauges are recomputed on
            # stats(); refresh so the sample reads the live pool
            from kubeflow_rm_tpu_torch.controlplane import scheduler
            scheduler.refresh_gauges()
        except Exception:  # noqa: BLE001 - a sample must not fail on it
            metrics.swallowed("obs.tsdb", "refresh_gauges")
        out = []
        for fam in self._registry:
            for name, labels, value in fam.samples():
                if math.isnan(value):
                    continue
                out.append((name, dict(labels),
                            _sample_kind(fam.kind, name), float(value)))
        return out

    def _collect_scrape(self, src: str, url: str
                        ) -> list[tuple[str, dict, str, float]]:
        import urllib.request

        from kubeflow_rm_tpu_torch.controlplane import metrics
        try:
            with urllib.request.urlopen(url + "/metrics",
                                        timeout=2.0) as resp:
                text = resp.read().decode()
        except Exception:  # noqa: BLE001 - shard may be down mid-chaos
            metrics.swallowed("obs.tsdb", f"scrape {src}")
            self.scrape_errors += 1
            return []
        out = []
        for name, labels, kind, value in parse_exposition(text):
            labels.setdefault("instance", src)
            out.append((name, labels, kind, value))
        return out

    def ingest(self, now: float, name: str, labels: dict | None,
               kind: str, value: float) -> None:
        """Directly ingest one sample (tests, replay, push sources)."""
        with self._lock:
            self._ingest_locked(now, name, dict(labels or {}), kind,
                                float(value))

    def _ingest_locked(self, now: float, name: str, labels: dict,
                       kind: str, value: float) -> None:
        key = (name, tuple(sorted(labels.items())))
        series = self._series.get(key)
        if series is None:
            if len(self._series) >= self._max_series:
                victim = min(self._series,
                             key=lambda k: self._series[k].last_t)
                del self._series[victim]
                self.evictions += 1
            series = _Series(name, labels, kind, self._max_points)
            self._series[key] = series
        series.points.append((now, value))
        series.last_t = now

    # ---- background sampler ------------------------------------------

    def start(self) -> None:
        """Start the background sampler (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="obs-tsdb-sampler", daemon=True)
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
                self.sample()
            except Exception:  # noqa: BLE001 - sampler must survive
                metrics.swallowed("obs.tsdb", "sample pass")

    # ---- queries -----------------------------------------------------

    def _match_locked(self, name: str, labels: dict | None
                      ) -> list[_Series]:
        want = (labels or {}).items()
        return [s for s in self._series.values()
                if s.name == name
                and all(s.labels.get(k) == v for k, v in want)]

    @staticmethod
    def _points_in(series: _Series, cut: float) -> list[tuple]:
        return [p for p in series.points if p[0] >= cut]

    def range(self, name: str, labels: dict | None = None,
              window_s: float | None = None,
              now: float | None = None) -> list[dict]:
        """Raw points for every series matching ``name`` + the label
        subset, trimmed to the trailing window. Returns copies — the
        caller can hold them without pinning the ring."""
        now = time.time() if now is None else now
        cut = now - (window_s if window_s is not None else self.window_s)
        with self._lock:
            return [{"name": s.name, "labels": dict(s.labels),
                     "kind": s.kind,
                     "points": [[t, v] for t, v in s.points if t >= cut]}
                    for s in self._match_locked(name, labels)]

    def latest(self, name: str, labels: dict | None = None
               ) -> float | None:
        """Sum of each matching series' last value (gauge semantics;
        summing mirrors ``metrics.registry_value`` so federated shard
        gauges aggregate the same way the facade does)."""
        with self._lock:
            matched = self._match_locked(name, labels)
            vals = [s.points[-1][1] for s in matched if s.points]
        return sum(vals) if vals else None

    def rate(self, name: str, labels: dict | None = None,
             window_s: float | None = None,
             now: float | None = None) -> float | None:
        """Windowed per-second rate of a (cumulative) counter, summed
        over matching series. Resets are handled by accumulating only
        positive deltas. ``None`` when no series has >=2 points in the
        window."""
        now = time.time() if now is None else now
        window_s = window_s if window_s is not None else self.window_s
        cut = now - window_s
        total = 0.0
        seen = False
        with self._lock:
            matched = self._match_locked(name, labels)
            windows = [self._points_in(s, cut) for s in matched]
        for pts in windows:
            if len(pts) < 2:
                continue
            seen = True
            inc = sum(max(0.0, b[1] - a[1])
                      for a, b in zip(pts, pts[1:]))
            span = pts[-1][0] - pts[0][0]
            if span > 0:
                total += inc / span
        return total if seen else None

    def gauge_avg(self, name: str, labels: dict | None = None,
                  window_s: float | None = None,
                  now: float | None = None) -> float | None:
        """Time-mean of a gauge over the window (sum across matching
        series of their own means)."""
        now = time.time() if now is None else now
        window_s = window_s if window_s is not None else self.window_s
        cut = now - window_s
        vals = []
        with self._lock:
            matched = self._match_locked(name, labels)
            windows = [self._points_in(s, cut) for s in matched]
        for pts in windows:
            if pts:
                vals.append(sum(v for _, v in pts) / len(pts))
        return sum(vals) if vals else None

    def _bucket_deltas(self, name: str, labels: dict | None,
                       window_s: float, now: float) -> dict[float, float]:
        """Windowed increment per ``le`` of a histogram family,
        aggregated across matching series (multi-shard federation sums
        the per-shard buckets, which is exactly Prometheus semantics)."""
        cut = now - window_s
        deltas: dict[float, float] = {}
        with self._lock:
            matched = self._match_locked(name + "_bucket", labels)
            snap = [(dict(s.labels), self._points_in(s, cut))
                    for s in matched]
        for lbls, pts in snap:
            if len(pts) < 2:
                continue
            le_raw = lbls.get("le", "")
            le = math.inf if le_raw in ("+Inf", "inf") else float(le_raw)
            inc = sum(max(0.0, b[1] - a[1]) for a, b in zip(pts, pts[1:]))
            deltas[le] = deltas.get(le, 0.0) + inc
        return deltas

    def percentile(self, name: str, q: float,
                   labels: dict | None = None,
                   window_s: float | None = None,
                   now: float | None = None) -> float | None:
        """Windowed percentile (``q`` in [0,1]) from cumulative-bucket
        deltas with linear interpolation inside the landing bucket.
        ``name`` is the family base name (no ``_bucket`` suffix)."""
        now = time.time() if now is None else now
        window_s = window_s if window_s is not None else self.window_s
        deltas = self._bucket_deltas(name, labels, window_s, now)
        if not deltas:
            return None
        les = sorted(deltas)
        total = deltas.get(math.inf, max(deltas.values()))
        if total <= 0:
            return None
        target = q * total
        prev_le, prev_cum = 0.0, 0.0
        for le in les:
            cum = deltas[le]
            if cum >= target:
                if le is math.inf:
                    return prev_le
                if cum == prev_cum:
                    return le
                frac = (target - prev_cum) / (cum - prev_cum)
                return prev_le + frac * (le - prev_le)
            prev_le, prev_cum = (0.0 if le is math.inf else le), cum
        return prev_le

    def bad_fraction(self, name: str, threshold: float,
                     labels: dict | None = None,
                     window_s: float | None = None,
                     now: float | None = None
                     ) -> tuple[float, float] | None:
        """``(fraction_of_events_above_threshold, total_events)`` over
        the window — the burn-rate numerator for latency SLOs. Uses the
        smallest bucket bound >= threshold (recorded SLOs should pick
        thresholds on bucket bounds). ``None`` when the window saw no
        events."""
        now = time.time() if now is None else now
        window_s = window_s if window_s is not None else self.window_s
        deltas = self._bucket_deltas(name, labels, window_s, now)
        if not deltas:
            return None
        total = deltas.get(math.inf)
        if total is None:
            total = max(deltas.values())
        if total <= 0:
            return None
        good_les = [le for le in deltas if le >= threshold]
        good = deltas[min(good_les)] if good_les else 0.0
        bad = max(0.0, total - good)
        return (bad / total, total)

    def label_values(self, name: str, key: str) -> list[str]:
        """Distinct values of label ``key`` across series of family
        ``name`` — how per-tenant SLOs enumerate the tenants the
        counters have actually seen (no tenant registry needed)."""
        with self._lock:
            return sorted({s.labels[key] for s in self._series.values()
                           if s.name == name and key in s.labels})

    # ---- introspection / dump ---------------------------------------

    def series_names(self) -> list[str]:
        with self._lock:
            return sorted({s.name for s in self._series.values()})

    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def dump(self, window_s: float | None = None,
             now: float | None = None) -> list[dict]:
        """Every series' trailing window — the flight recorder's
        ``metrics`` section. Bounded by construction (ring x cap)."""
        now = time.time() if now is None else now
        cut = now - (window_s if window_s is not None else self.window_s)
        with self._lock:
            return [{"name": s.name, "labels": dict(s.labels),
                     "kind": s.kind,
                     "points": [[round(t, 3), v] for t, v in s.points
                                if t >= cut]}
                    for s in self._series.values() if s.points]
