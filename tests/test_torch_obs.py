"""The port's observability loop (``kubeflow_rm_tpu_torch/controlplane/
obs``: the TSDB, the SLO engine, the flight recorder, ``run_meta`` and
the ``Observer``) held to JAX's (``kubeflow_rm_tpu/controlplane/obs``).

Every case of ``tests/test_timeseries.py``, ``test_slo.py`` and
``test_flight.py``, the declared-drift case of ``test_admission.py``
and ``compatible()`` on a table of ``run_meta`` pairs run the same
scripted inputs — registry writes, expositions, frozen ``now``s — through
both packages; their whole results (snapshots, dumps, bundles) must be
equal after the TPU→GPU text map of the SLOs' descriptions, floats
exactly: both are the same plain Python arithmetic. JAX's own asserts
then hold on the port's result.
"""

import json
import math
import types

import prometheus_client
import pytest

from kubeflow_rm_tpu.controlplane import metrics as jmetrics
from kubeflow_rm_tpu.controlplane import obs as jobs
from kubeflow_rm_tpu.controlplane import tracing as jtracing
from kubeflow_rm_tpu.controlplane.obs import flight as jflight
from kubeflow_rm_tpu.controlplane.obs import runmeta as jrunmeta
from kubeflow_rm_tpu.controlplane.obs import slo as jslo
from kubeflow_rm_tpu.controlplane.obs import timeseries as jts
from kubeflow_rm_tpu.controlplane.webhook import admission_pricer as jseam
from kubeflow_rm_tpu_torch.controlplane import metrics as tmetrics
from kubeflow_rm_tpu_torch.controlplane import obs as tobs
from kubeflow_rm_tpu_torch.controlplane import tracing as ttracing
from kubeflow_rm_tpu_torch.controlplane.obs import flight as tflight
from kubeflow_rm_tpu_torch.controlplane.obs import runmeta as trunmeta
from kubeflow_rm_tpu_torch.controlplane.obs import slo as tslo
from kubeflow_rm_tpu_torch.controlplane.obs import timeseries as tts
from kubeflow_rm_tpu_torch.controlplane.webhook import (
    admission_pricer as tseam,
)

SIDES = {
    "jax": types.SimpleNamespace(ts=jts, slo=jslo, flight=jflight,
                                 runmeta=jrunmeta, obs=jobs,
                                 metrics=jmetrics, tracing=jtracing,
                                 seam=jseam),
    "port": types.SimpleNamespace(ts=tts, slo=tslo, flight=tflight,
                                  runmeta=trunmeta, obs=tobs,
                                  metrics=tmetrics, tracing=ttracing,
                                  seam=tseam),
}

#: the SLO descriptions: JAX's words → the port's (the only intended
#: difference between the two packages' snapshots)
TEXT_MAP = {
    "free chips": "free cards",
    "on-chip HBM peak": "on-card memory peak",
    "new jit signatures": "new signatures",
    "burns XLA compiles": "burns recompiles",
    "jaxcheck": "torchcheck",
    "its TPU behind": "its GPU behind",
}

#: a frozen wall clock for the flight recorder and ``run_meta``
FROZEN = 1_700_000_000.0


def text_map(obj):
    if isinstance(obj, dict):
        return {k: text_map(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(text_map(v) for v in obj)
    if isinstance(obj, str):
        for old, new in TEXT_MAP.items():
            obj = obj.replace(old, new)
    return obj


def _both(case):
    """``case(side)`` on each package; the port's result must equal JAX's
    after the text map. Returns the port's."""
    got = {pkg: case(side) for pkg, side in SIDES.items()}
    assert got["port"] == text_map(got["jax"])
    return got["port"]


@pytest.fixture
def frozen(monkeypatch):
    """Both packages' flight recorder and ``run_meta`` read
    :data:`FROZEN` for the time; both span collectors start empty."""
    clock = types.SimpleNamespace(time=lambda: FROZEN)
    for side in SIDES.values():
        monkeypatch.setattr(side.flight, "time", clock)
        monkeypatch.setattr(side.runmeta, "time", clock)
        side.tracing.collector().clear()
    yield
    for side in SIDES.values():
        side.tracing.collector().clear()


# ---- the TSDB (tests/test_timeseries.py) --------------------------------

def _db(side, **kw):
    kw.setdefault("interval_s", 1.0)
    kw.setdefault("window_s", 600.0)
    return side.ts.TimeSeriesDB(**kw)


def test_parse_exposition_keeps_labels_and_kinds():
    text = """\
# HELP wal_fsync_seconds WAL fsync latency
# TYPE wal_fsync_seconds histogram
wal_fsync_seconds_bucket{le="0.05",shard="shard-0"} 12.0
wal_fsync_seconds_bucket{le="+Inf",shard="shard-0"} 14.0
wal_fsync_seconds_count{shard="shard-0"} 14.0
wal_fsync_seconds_sum{shard="shard-0"} 0.42
wal_fsync_seconds_created{shard="shard-0"} 1.7e+09
# TYPE workqueue_depth gauge
workqueue_depth{name="notebook"} 3.0
# TYPE api_requests counter
api_requests_total{verb="POST"} 9.0
not a sample line
bad_value_metric NaN
"""
    got = _both(lambda side: side.ts.parse_exposition(text))
    by_name = {}
    for name, labels, kind, value in got:
        by_name.setdefault(name, []).append((labels, kind, value))
    assert "wal_fsync_seconds_created" not in by_name
    assert "bad_value_metric" not in by_name
    assert by_name["wal_fsync_seconds_bucket"][0] == (
        {"le": "0.05", "shard": "shard-0"}, tts.BUCKET, 12.0)
    assert by_name["wal_fsync_seconds_count"][0][1] == tts.COUNTER
    assert by_name["workqueue_depth"][0] == (
        {"name": "notebook"}, tts.GAUGE, 3.0)
    assert by_name["api_requests_total"][0] == (
        {"verb": "POST"}, tts.COUNTER, 9.0)


def test_parse_exposition_unescapes_label_values():
    text = ('# TYPE m gauge\n'
            'm{msg="say \\"hi\\"",p="a\\\\b"} 1.0\n')
    [(name, labels, kind, value)] = _both(
        lambda side: side.ts.parse_exposition(text))
    assert labels == {"msg": 'say "hi"', "p": "a\\b"}


def test_eviction_caps_series_under_label_cardinality_growth():
    def case(side):
        db = _db(side, max_series=16)
        for i in range(50):
            db.ingest(float(i), "cardinality_bomb", {"uid": f"u{i}"},
                      side.ts.GAUGE, float(i))
        return (db.series_count(), db.evictions,
                db.latest("cardinality_bomb", {"uid": "u0"}),
                db.latest("cardinality_bomb", {"uid": "u49"}),
                db.dump(window_s=1000.0, now=49.0))

    count, evictions, first, last, _ = _both(case)
    assert (count, evictions, first, last) == (16, 34, None, 49.0)


def test_eviction_prefers_stale_series_not_hot_ones():
    def case(side):
        db = _db(side, max_series=4)
        for t in range(10):
            db.ingest(float(t), "hot", {}, side.ts.GAUGE, 1.0)
            db.ingest(float(t), "flood", {"i": str(t)}, side.ts.GAUGE, 0.0)
        return db.latest("hot"), db.latest("flood", {"i": "0"}), \
            db.evictions, db.series_names()

    hot, flood0, _, _ = _both(case)
    assert hot == 1.0 and flood0 is None


def test_ring_bounds_points_per_series():
    def case(side):
        db = side.ts.TimeSeriesDB(interval_s=1.0, window_s=10.0,
                                  max_points=8)
        for t in range(100):
            db.ingest(float(t), "g", {}, side.ts.GAUGE, float(t))
        return db.range("g", window_s=1000.0, now=100.0)

    [series] = _both(case)
    assert len(series["points"]) == 8
    assert series["points"][-1] == [99.0, 99.0]


def test_rate_is_windowed_per_second_delta():
    def case(side):
        db = _db(side)
        for t, v in [(0, 0.0), (10, 5.0), (20, 15.0)]:
            db.ingest(float(t), "reqs_total", {}, side.ts.COUNTER, v)
        return (db.rate("reqs_total", window_s=100.0, now=20.0),
                db.rate("reqs_total", window_s=10.0, now=20.0))

    assert _both(case) == (0.75, 1.0)


def test_rate_survives_counter_reset():
    def case(side):
        db = _db(side)
        for t, v in [(0, 90.0), (10, 100.0), (20, 0.0), (30, 30.0)]:
            db.ingest(float(t), "reqs_total", {}, side.ts.COUNTER, v)
        return db.rate("reqs_total", window_s=100.0, now=30.0)

    assert _both(case) == pytest.approx((10.0 + 30.0) / 30.0)


def test_rate_none_without_two_points():
    def case(side):
        db = _db(side)
        nope = db.rate("nope", now=0.0)
        db.ingest(0.0, "one", {}, side.ts.COUNTER, 5.0)
        return nope, db.rate("one", window_s=100.0, now=1.0)

    assert _both(case) == (None, None)


def test_rate_sums_across_federated_instances():
    def case(side):
        db = _db(side)
        for inst in ("shard-0", "shard-1"):
            for t, v in [(0, 0.0), (10, 10.0)]:
                db.ingest(float(t), "reqs_total", {"instance": inst},
                          side.ts.COUNTER, v)
        return (db.rate("reqs_total", window_s=100.0, now=10.0),
                db.rate("reqs_total", {"instance": "shard-0"},
                        window_s=100.0, now=10.0))

    assert _both(case) == (2.0, 1.0)


def _ingest_hist(side, db, name, t0, t1, incs, labels=None):
    """Two scrapes of a cumulative-bucket family whose windowed
    increments are ``incs`` ({le: delta})."""
    les = sorted(incs, key=lambda x: math.inf if x == "+Inf" else float(x))
    run = 0.0
    for le in les:
        run += incs[le]
        lbl = dict(labels or {})
        lbl["le"] = le
        db.ingest(t0, name + "_bucket", lbl, side.ts.BUCKET, 0.0)
        db.ingest(t1, name + "_bucket", lbl, side.ts.BUCKET, run)


def test_percentile_interpolates_inside_bucket():
    def case(side):
        db = _db(side)
        _ingest_hist(side, db, "lat_seconds", 0.0, 10.0,
                     {"0.1": 50.0, "0.5": 30.0, "+Inf": 20.0})
        return [db.percentile("lat_seconds", q, window_s=100.0, now=10.0)
                for q in (0.5, 0.65, 0.95)]

    assert _both(case) == pytest.approx([0.1, 0.3, 0.5])


def test_percentile_none_when_no_events():
    def case(side):
        db = _db(side)
        none = db.percentile("lat_seconds", 0.5, now=0.0)
        _ingest_hist(side, db, "flat_seconds", 0.0, 10.0,
                     {"0.1": 0.0, "+Inf": 0.0})
        return none, db.percentile("flat_seconds", 0.5, window_s=100.0,
                                   now=10.0)

    assert _both(case) == (None, None)


def test_bad_fraction_hand_fixture():
    def case(side):
        db = _db(side)
        _ingest_hist(side, db, "lat_seconds", 0.0, 10.0,
                     {"0.1": 50.0, "0.5": 30.0, "+Inf": 20.0})
        return (db.bad_fraction("lat_seconds", 0.5, window_s=100.0,
                                now=10.0),
                db.bad_fraction("lat_seconds", 0.1, window_s=100.0,
                                now=10.0))

    (bad, total), (bad01, _) = _both(case)
    assert total == 100.0
    assert bad == pytest.approx(0.2)
    assert bad01 == pytest.approx(0.5)


def test_bad_fraction_aggregates_across_shards():
    def case(side):
        db = _db(side)
        _ingest_hist(side, db, "lat_seconds", 0.0, 10.0,
                     {"0.1": 9.0, "+Inf": 1.0}, {"instance": "shard-0"})
        _ingest_hist(side, db, "lat_seconds", 0.0, 10.0,
                     {"0.1": 1.0, "+Inf": 9.0}, {"instance": "shard-1"})
        return db.bad_fraction("lat_seconds", 0.1, window_s=100.0,
                               now=10.0)

    bad, total = _both(case)
    assert total == 20.0 and bad == pytest.approx(0.5)


def test_latest_sums_like_registry_value():
    def case(side):
        db = _db(side)
        db.ingest(0.0, "free_chips", {"pool": "a"}, side.ts.GAUGE, 4.0)
        db.ingest(0.0, "free_chips", {"pool": "b"}, side.ts.GAUGE, 8.0)
        return (db.latest("free_chips"), db.latest("free_chips",
                                                   {"pool": "a"}),
                db.label_values("free_chips", "pool"))

    assert _both(case) == (12.0, 4.0, ["a", "b"])


def test_gauge_avg_is_windowed_mean():
    def case(side):
        db = _db(side)
        for t, v in [(0, 0.0), (10, 0.5), (20, 1.0)]:
            db.ingest(float(t), "frag", {}, side.ts.GAUGE, v)
        return (db.gauge_avg("frag", window_s=100.0, now=20.0),
                db.gauge_avg("frag", window_s=10.0, now=20.0))

    assert _both(case) == pytest.approx((0.5, 0.75))


def test_dump_trims_to_window():
    def case(side):
        db = _db(side)
        for t in range(20):
            db.ingest(float(t), "g", {}, side.ts.GAUGE, float(t))
        return db.dump(window_s=5.0, now=19.0)

    [series] = [s for s in _both(case) if s["name"] == "g"]
    assert [p[0] for p in series["points"]] == [14.0, 15.0, 16.0, 17.0,
                                                18.0, 19.0]


def _registries():
    """The same four families in each package's registry form: JAX's a
    ``prometheus_client`` registry, the port's a list of its metrics."""
    jreg = prometheus_client.CollectorRegistry()
    treg: list = []
    out = {}
    for pkg, make in (
            ("jax", lambda cls, *a, **kw: getattr(prometheus_client, cls)(
                *a, registry=jreg, **kw)),
            ("port", lambda cls, *a, **kw: getattr(tmetrics, cls)(
                *a, registry=treg, **kw))):
        out[pkg] = dict(
            reqs=make("Counter", "obs_reqs", "requests", ["verb"]),
            depth=make("Gauge", "obs_depth", "queue depth", ["name"]),
            lat=make("Histogram", "obs_lat_seconds", "latency",
                     buckets=(0.05, 0.5, 5.0)),
            frag=make("Gauge", "obs_frag", "fragmentation"))
    return {"jax": jreg, "port": treg}, out


def test_sample_reads_the_live_registry():
    """The live registry flows into the ring (JAX's case, on each
    package's own registry), and the same writes to the same families in
    each package's registry form sample into equal dumps and queries."""
    def live(side):
        db = side.ts.TimeSeriesDB()
        before = side.metrics.registry_value(
            "swallowed_errors_total", {"module": "tsdbobs"}) or 0.0
        side.metrics.SWALLOWED_ERRORS_TOTAL.labels(module="tsdbobs").inc()
        n = db.sample(now=1.0)
        return n > 0, db.latest("swallowed_errors_total",
                                {"module": "tsdbobs"}) - before

    assert _both(live) == (True, 1.0)

    regs, fams = _registries()

    def case(side):
        pkg = "jax" if side is SIDES["jax"] else "port"
        f = fams[pkg]
        db = side.ts.TimeSeriesDB(registry=regs[pkg], interval_s=1.0,
                                  window_s=600.0)
        for t, (n, depth, lat) in enumerate(
                [(1, 3.0, 0.01), (4, 0.0, 0.7), (2, 9.0, 0.2)]):
            f["reqs"].labels(verb="POST").inc(n)
            f["depth"].labels(name="notebook").set(depth)
            f["lat"].observe(lat)
            f["frag"].set(depth / 10)
            db.sample(now=10.0 * t)
        dump = sorted(db.dump(window_s=600.0, now=20.0),
                      key=lambda s: (s["name"], sorted(s["labels"].items())))
        return (dump, db.rate("obs_reqs_total", window_s=600.0, now=20.0),
                db.percentile("obs_lat_seconds", 0.5, window_s=600.0,
                              now=20.0),
                db.bad_fraction("obs_lat_seconds", 0.5, window_s=600.0,
                                now=20.0),
                db.gauge_avg("obs_frag", window_s=600.0, now=20.0),
                db.latest("obs_depth", {"name": "notebook"}))

    dump, rate, p50, bad, frag, depth = _both(case)
    assert rate == pytest.approx(6 / 20) and depth == 9.0
    assert {s["name"] for s in dump} >= {"obs_reqs_total", "obs_depth",
                                         "obs_lat_seconds_bucket",
                                         "obs_lat_seconds_count",
                                         "obs_lat_seconds_sum", "obs_frag"}


# ---- the SLO engine (tests/test_slo.py) ----------------------------------

def _win(side):
    return (side.slo.Window(60.0, 10.0, 1.0, "critical"),)


def _hist(side, db, name, t0, t1, incs):
    _ingest_hist(side, db, name, t0, t1, incs)


def test_latency_burn_is_bad_fraction_over_budget():
    def case(side):
        db = _db(side)
        _hist(side, db, "lat_seconds", 0.0, 10.0, {"0.5": 90.0, "+Inf": 10.0})
        slo = side.slo.LatencySLO(name="l", metric="lat_seconds",
                                  windows=_win(side), threshold_s=0.5,
                                  target=0.90)
        return slo.burn_rate(db, 100.0, now=10.0), slo.spec()

    burn, _ = _both(case)
    assert burn == pytest.approx(1.0)


def test_latency_burn_scales_with_badness():
    def case(side):
        db = _db(side)
        _hist(side, db, "lat_seconds", 0.0, 10.0, {"0.5": 70.0, "+Inf": 30.0})
        slo = side.slo.LatencySLO(name="l", metric="lat_seconds",
                                  windows=_win(side), threshold_s=0.5,
                                  target=0.90)
        return slo.burn_rate(db, 100.0, now=10.0)

    assert _both(case) == pytest.approx(3.0)


def test_latency_burn_none_without_traffic():
    def case(side):
        slo = side.slo.LatencySLO(name="l", metric="lat_seconds",
                                  windows=_win(side), threshold_s=0.5,
                                  target=0.90)
        return slo.burn_rate(_db(side), 100.0, now=10.0)

    assert _both(case) is None


def test_rate_burn_is_rate_over_allowance():
    def case(side):
        db = _db(side)
        db.ingest(0.0, "swallowed_errors_total", {}, side.ts.COUNTER, 0.0)
        db.ingest(60.0, "swallowed_errors_total", {}, side.ts.COUNTER, 6.0)
        slo = side.slo.RateSLO(name="r", metric="swallowed_errors_total",
                               windows=_win(side), allowed_per_s=0.05)
        return slo.burn_rate(db, 100.0, now=60.0), slo.spec()

    burn, _ = _both(case)
    assert burn == pytest.approx(2.0)


def test_gauge_burn_is_windowed_mean_over_threshold():
    def case(side):
        db = _db(side)
        for t in range(0, 60, 10):
            db.ingest(float(t), "scheduler_fragmentation", {},
                      side.ts.GAUGE, 0.75)
        slo = side.slo.GaugeSLO(name="g", metric="scheduler_fragmentation",
                                windows=_win(side), threshold=0.5)
        return slo.burn_rate(db, 100.0, now=60.0), slo.spec()

    burn, _ = _both(case)
    assert burn == pytest.approx(1.5)


def test_gauge_burn_ignores_transient_spike():
    def case(side):
        db = _db(side)
        for t in range(0, 100, 10):
            db.ingest(float(t), "frag", {}, side.ts.GAUGE,
                      1.0 if t == 50 else 0.0)
        slo = side.slo.GaugeSLO(name="g", metric="frag", windows=_win(side),
                                threshold=0.5)
        return slo.burn_rate(db, 200.0, now=100.0)

    assert _both(case) < 1.0


def _gauge_engine(side, hold_s=30.0):
    db = _db(side)
    slo = side.slo.GaugeSLO(name="frag", metric="frag", windows=_win(side),
                            threshold=1.0)
    eng = side.slo.SLOEngine(db, [slo], clear_ratio=0.8, hold_s=hold_s)
    return db, eng


def _fill(side, db, t0, t1, value, step=5.0):
    t = t0
    while t <= t1:
        db.ingest(t, "frag", {}, side.ts.GAUGE, value)
        t += step


def _moves(fired):
    return [(tr["from"], tr["to"]) for tr in fired]


def test_engine_escalates_when_both_windows_burn():
    def case(side):
        db, eng = _gauge_engine(side)
        _fill(side, db, 0.0, 100.0, 2.0)
        return eng.evaluate(now=100.0), eng.state_of("frag"), eng.snapshot()

    fired, state, _ = _both(case)
    assert _moves(fired) == [("ok", "critical")] and state == "critical"
    assert fired[0]["burns"]["60s"] == pytest.approx(2.0)
    assert fired[0]["burns"]["10s"] == pytest.approx(2.0)


def test_engine_needs_long_AND_short_window():
    def case(side):
        db, eng = _gauge_engine(side)
        _fill(side, db, 0.0, 80.0, 2.0)
        _fill(side, db, 85.0, 100.0, 0.0)
        return eng.evaluate(now=100.0), eng.state_of("frag"), eng.snapshot()

    fired, state, _ = _both(case)
    assert fired == [] and state == "ok"


def test_engine_hysteresis_holds_before_clearing():
    def case(side):
        db, eng = _gauge_engine(side, hold_s=30.0)
        _fill(side, db, 0.0, 100.0, 2.0)
        eng.evaluate(now=100.0)
        _fill(side, db, 100.0, 300.0, 0.0)
        out = [eng.evaluate(now=250.0), eng.evaluate(now=270.0),
               eng.state_of("frag"), eng.evaluate(now=281.0),
               eng.state_of("frag")]
        return out, eng.snapshot()

    (at250, at270, mid, fired, end), _ = _both(case)
    assert at250 == [] and at270 == [] and mid == "critical"
    assert _moves(fired) == [("critical", "ok")] and end == "ok"


def test_engine_does_not_flap_around_the_boundary():
    def case(side):
        db, eng = _gauge_engine(side, hold_s=30.0)
        _fill(side, db, 0.0, 100.0, 2.0)
        eng.evaluate(now=100.0)
        transitions = []
        _fill(side, db, 100.0, 400.0, 0.9)
        for now in range(160, 400, 10):
            transitions += eng.evaluate(now=float(now))
        return transitions, eng.state_of("frag"), eng.snapshot()

    transitions, state, _ = _both(case)
    assert transitions == [] and state == "critical"


def test_engine_reescalates_if_burn_returns_during_hold():
    def case(side):
        db, eng = _gauge_engine(side, hold_s=30.0)
        _fill(side, db, 0.0, 100.0, 2.0)
        eng.evaluate(now=100.0)
        _fill(side, db, 100.0, 200.0, 0.0)
        eng.evaluate(now=170.0)
        _fill(side, db, 200.0, 260.0, 2.0)
        eng.evaluate(now=260.0)
        _fill(side, db, 260.0, 400.0, 0.0)
        out = [eng.evaluate(now=330.0), eng.state_of("frag"),
               eng.evaluate(now=365.0)]
        return out, eng.snapshot()

    (at330, state, fired), _ = _both(case)
    assert at330 == [] and state == "critical"
    assert _moves(fired) == [("critical", "ok")]


def test_warning_then_critical_ladder():
    def case(side):
        db = _db(side)
        W = side.slo.Window
        slo = side.slo.GaugeSLO(name="frag", metric="frag",
                                windows=(W(60.0, 10.0, 2.0, "critical"),
                                         W(60.0, 10.0, 1.0, "warning")),
                                threshold=1.0)
        eng = side.slo.SLOEngine(db, [slo])
        _fill(side, db, 0.0, 100.0, 1.5)
        first = eng.evaluate(now=100.0)
        _fill(side, db, 100.0, 300.0, 3.0)
        return first, eng.evaluate(now=300.0), eng.snapshot()

    first, second, _ = _both(case)
    assert _moves(first) == [("ok", "warning")]
    assert _moves(second) == [("warning", "critical")]


def test_snapshot_exposes_active_alerts_and_transitions():
    def case(side):
        db, eng = _gauge_engine(side)
        _fill(side, db, 0.0, 100.0, 2.0)
        eng.evaluate(now=100.0)
        return eng.snapshot()

    snap = _both(case)
    assert [a["slo"] for a in snap["active"]] == ["frag"]
    assert snap["active"][0]["state"] == "critical"
    assert len(snap["transitions"]) == 1
    [spec] = snap["slos"]
    assert spec["kind"] == "GaugeSLO" and spec["state"] == "critical"


def test_callbacks_fire_outside_lock_with_transition():
    def case(side):
        db, eng = _gauge_engine(side)
        seen = []
        # a callback that takes the engine's lock again (state_of): it
        # would deadlock if fired under the lock
        eng.on_transition(lambda tr: seen.append(
            (tr, eng.state_of(tr["slo"]))))
        _fill(side, db, 0.0, 100.0, 2.0)
        eng.evaluate(now=100.0)
        return seen

    [(tr, state)] = _both(case)
    assert tr["to"] == "critical" and state == "critical"


def test_default_slos_cover_the_issue_set():
    def case(side):
        return [s.spec() for s in side.slo.default_slos()]

    specs = _both(case)
    assert {"provision-p50", "serving-victim-p95", "scheduler-latency",
            "wal-fsync", "swallowed-errors", "scheduler-fragmentation",
            "shard-deaths"} <= {s["name"] for s in specs}


def test_default_slos_evaluate_clean_on_empty_tsdb():
    def case(side):
        eng = side.slo.SLOEngine(_db(side), side.slo.default_slos())
        return eng.evaluate(now=100.0), eng.snapshot()

    fired, snap = _both(case)
    assert fired == []
    assert all(s["state"] == "ok" for s in snap["slos"])


# ---- the flight recorder (tests/test_flight.py) --------------------------

def _critical_engine(side, db, base):
    """Engine over a gauge burning at 2x, with points anchored to
    ``base`` (the recorder cuts its window at wall-clock time)."""
    slo = side.slo.GaugeSLO(
        name="frag", metric="frag",
        windows=(side.slo.Window(60.0, 10.0, 1.0, "critical"),),
        threshold=1.0)
    eng = side.slo.SLOEngine(db, [slo])
    for t in range(0, 101, 5):
        db.ingest(base - 100.0 + t, "frag", {}, side.ts.GAUGE, 2.0)
    return eng


def test_bundle_contains_every_section(frozen):
    def case(side):
        db = _db(side)
        eng = _critical_engine(side, db, FROZEN)
        eng.evaluate(now=FROZEN)
        fr = side.flight.FlightRecorder(
            db, eng, window_s=120.0,
            liveness=lambda: {"shard-0": True, "shard-1": False},
            run_meta=side.runmeta.build_run_meta("test",
                                                 {"scenario": "unit"}))
        bundle = fr.trigger("chaos_scenario",
                            detail={"scenario": "kill-a-shard"})
        assert fr.last() is bundle
        return bundle

    bundle = _both(case)
    assert bundle["schema_version"] == tflight.SCHEMA_VERSION
    assert bundle["trigger"] == {"reason": "chaos_scenario", "t": FROZEN,
                                 "detail": {"scenario": "kill-a-shard"}}
    assert bundle["run_meta"]["harness"] == "test"
    assert any(s["name"] == "frag" and s["points"]
               for s in bundle["metrics"])
    assert [a["slo"] for a in bundle["alerts"]["active"]] == ["frag"]
    assert bundle["shard_liveness"] == {"shard-0": True, "shard-1": False}
    assert bundle["slow_traces"] == [] and bundle["lockgraph"] is None


def test_auto_triggers_are_rate_limited_explicit_are_not(frozen):
    def case(side):
        fr = side.flight.FlightRecorder(min_interval_s=3600.0)
        out = [fr.trigger("alert_critical", auto=True) is not None,
               fr.trigger("alert_critical", auto=True) is not None,
               fr.trigger("chaos_scenario") is not None]
        return out, fr.suppressed_total, fr.triggered_total, fr.bundles()

    out, suppressed, triggered, _ = _both(case)
    assert out == [True, False, True]
    assert (suppressed, triggered) == (1, 2)


def test_engine_critical_transition_auto_triggers(frozen):
    def case(side):
        db = _db(side)
        eng = _critical_engine(side, db, FROZEN)
        fr = side.flight.FlightRecorder(db, min_interval_s=0.0)
        fr.attach_engine(eng)
        eng.evaluate(now=FROZEN)
        return fr.last()

    bundle = _both(case)
    assert bundle["trigger"]["reason"] == "alert_critical"
    assert bundle["trigger"]["detail"]["slo"] == "frag"
    assert bundle["trigger"]["detail"]["to"] == "critical"


def test_warning_transition_does_not_trigger(frozen):
    def case(side):
        db = _db(side)
        slo = side.slo.GaugeSLO(
            name="frag", metric="frag",
            windows=(side.slo.Window(60.0, 10.0, 1.0, "warning"),),
            threshold=1.0)
        eng = side.slo.SLOEngine(db, [slo])
        for t in range(0, 101, 5):
            db.ingest(float(t), "frag", {}, side.ts.GAUGE, 2.0)
        fr = side.flight.FlightRecorder(db, min_interval_s=0.0)
        fr.attach_engine(eng)
        return eng.evaluate(now=100.0), fr.last()

    fired, last = _both(case)
    assert _moves(fired) == [("ok", "warning")] and last is None


def test_keep_bounds_bundle_ring(frozen):
    def case(side):
        fr = side.flight.FlightRecorder(keep=3)
        for i in range(5):
            fr.trigger(f"r{i}")
        return fr.bundles(), fr.triggered_total

    bundles, triggered = _both(case)
    assert [b["trigger"]["reason"] for b in bundles] == ["r2", "r3", "r4"]
    assert triggered == 5


def test_liveness_failure_is_swallowed_not_raised(frozen):
    def case(side):
        def boom():
            raise RuntimeError("runner torn down")
        before = side.metrics.registry_value(
            "swallowed_errors_total", {"module": "obs.flight"}) or 0.0
        bundle = side.flight.FlightRecorder(liveness=boom).trigger(
            "chaos_scenario")
        return bundle, side.metrics.registry_value(
            "swallowed_errors_total", {"module": "obs.flight"}) - before

    bundle, swallowed = _both(case)
    assert bundle["shard_liveness"] is None and swallowed == 1.0


def test_dump_json_roundtrips(frozen, tmp_path):
    def case(side):
        fr = side.flight.FlightRecorder(
            run_meta=side.runmeta.build_run_meta("test", {}))
        with pytest.raises(ValueError):
            fr.dump_json(str(tmp_path / "none.json"))
        bundle = fr.trigger("chaos_scenario")
        path = fr.dump_json(str(tmp_path / f"FLIGHT_{id(side)}.json"))
        with open(path) as f:
            loaded = json.load(f)
        assert loaded == json.loads(json.dumps(bundle, default=str))
        return loaded

    loaded = _both(case)
    assert loaded["schema_version"] == tflight.SCHEMA_VERSION
    assert loaded["trigger"]["reason"] == "chaos_scenario"


def test_observer_wires_the_stack_together(frozen):
    def case(side):
        o = side.obs.Observer(interval_s=1.0,
                              liveness=lambda: {"shard-0": True})
        o.tick(now=100.0)
        snap = o.alerts()
        assert snap["tsdb"]["series"] > 0
        bundle = o.on_shard_death("shard-0", -9)
        assert o.flight.last() is bundle
        return (sorted(snap), [s["name"] for s in snap["slos"]],
                snap["flight"], bundle["trigger"], sorted(bundle),
                bundle["shard_liveness"], sorted(side.obs.__all__))

    keys, slos, flight, trigger, sections, live, names = _both(case)
    assert {"slos", "active", "transitions", "tsdb", "flight"} <= set(keys)
    assert flight == {"bundles": 0, "triggered_total": 0,
                      "suppressed_total": 0}
    assert trigger == {"reason": "shard_death", "t": FROZEN,
                       "detail": {"shard": "shard-0", "exitcode": -9}}
    assert live == {"shard-0": True}
    assert "Observer" in names


# ---- declared-HBM drift (tests/test_admission.py) ------------------------

def test_declared_hbm_drift_trips_warn_only_alert():
    """The drift bridged into the TSDB surfaces the warn-only
    ``declared-hbm-drift`` SLO once the windowed mean exceeds its
    threshold — warning, never critical; an in-band drift never arms it."""
    rows = [{"preset": "bench_2_7b", "priced_on_chip_peak_gb": 13.24,
             "native_on_chip_peak_gb": 17.2, "delta_pct": 29.9,
             "verdicts_match": True},
            {"preset": "bench_7b", "delta_pct": 4.0}]

    def case(side):
        try:
            drift = side.seam.record_declared_drift(rows)
            o = side.obs.Observer(interval_s=1.0)
            base = 50_000.0
            fired = []
            for t in (0.0, 30.0, 60.0):   # sustained, not a lone spike
                fired += [tr for tr in o.tick(now=base + t)
                          if tr["slo"] == "declared-hbm-drift"]
            snap = o.alerts()
            active = {a["slo"]: a for a in snap["active"]}
            spec = next(s for s in snap["slos"]
                        if s["name"] == "declared-hbm-drift")
            return (drift, fired, active["declared-hbm-drift"], spec,
                    o.engine.state_of("declared-hbm-drift"))
        finally:
            side.seam.record_declared_drift([])

    drift, fired, active, spec, state = _both(case)
    assert drift == pytest.approx((17.2 - 13.24) / 13.24)
    assert _moves(fired) == [("ok", "warning")]
    assert active["state"] == "warning" and state == "warning"
    assert spec["threshold"] == pytest.approx(0.2)
    assert _both(lambda side: side.seam.record_declared_drift(
        [{"delta_pct": 12.0}])) == pytest.approx(0.12)
    _both(lambda side: side.seam.record_declared_drift([]))


# ---- run_meta -------------------------------------------------------------

def _meta(side, harness="conformance", **arms):
    return side.runmeta.build_run_meta(harness, arms, interleave_index=1)


PAIRS = [
    ("same", lambda s: (_meta(s, mode="rest", shards=2),
                        _meta(s, shards=2, mode="rest"))),
    ("arm mismatch", lambda s: (_meta(s, mode="rest", shards=2),
                                _meta(s, mode="rest", shards=4))),
    ("harness mismatch", lambda s: (_meta(s, "e2e_walk", shards=2),
                                    _meta(s, "serve_bench", shards=2))),
    ("one-sided flag", lambda s: (_meta(s, shards=2),
                                  _meta(s, shards=2, wal=True))),
    ("schema major", lambda s: (_meta(s) | {"schema_version": 2},
                                _meta(s))),
    ("cross host", lambda s: (_meta(s), _meta(s) | {
        "host": {"node": "other-host"}})),
    ("missing baseline", lambda s: (None, _meta(s))),
    ("missing both", lambda s: ({}, None)),
]


@pytest.mark.parametrize("name,pair", PAIRS, ids=[p[0] for p in PAIRS])
def test_compatible_on_run_meta_pairs(frozen, name, pair):
    def case(side):
        a, b = pair(side)
        return side.runmeta.compatible(a, b), a, b

    (refusals, warnings), a, _ = _both(case)
    if name == "same":
        assert (refusals, warnings) == ([], [])
        assert a["created_at"] == FROZEN and a["schema_version"] == 1
    elif name in ("arm mismatch", "harness mismatch", "schema major"):
        assert len(refusals) == 1
    else:
        assert refusals == [] and len(warnings) == 1
