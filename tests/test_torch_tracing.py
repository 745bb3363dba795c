"""The port's span collector and trace reductions
(``kubeflow_rm_tpu_torch/controlplane/tracing.py``) held to JAX's
(``kubeflow_rm_tpu/controlplane/tracing.py``): the cases of
``tests/test_tracing.py`` on the collector's ring and slow store, the
cross-process merge and the critical path, each run on the same spans
through both packages, whose whole results must be equal."""

import json

import pytest

from kubeflow_rm_tpu.controlplane import tracing as jtracing
from kubeflow_rm_tpu_torch.controlplane import tracing as ttracing

MODS = {"jax": jtracing, "port": ttracing}


def _mkspan(mod, name, *, trace_id, span_id, parent_id=None, start=0.0,
            end=1.0, process=""):
    s = mod.Span(name, trace_id=trace_id, span_id=span_id,
                 parent_id=parent_id, start=start, process=process)
    s.end = end
    return s


def _both(case):
    """``case(tracing module)`` on each package; the results equal.
    Returns the port's."""
    got = {pkg: case(mod) for pkg, mod in MODS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def _held(col) -> dict:
    """Everything a collector exposes, in a comparable form."""
    def ids(d):
        return d["trace_id"], d["span_id"]

    export = json.loads(col.export_json())
    export["spans"].sort(key=ids)
    return {"spans": sorted(col.spans(), key=ids),
            "slow": col.slow_traces(), "dropped": col.dropped,
            "added": col.added, "export": export, "traces": col.traces()}


# ---- collector: ring + slow retention --------------------------------

def test_ring_eviction_keeps_newest_and_counts_drops():
    def case(mod):
        col = mod.SpanCollector(capacity=4)
        for i in range(6):
            col.add(_mkspan(mod, f"s{i}", trace_id="t" * 32,
                            span_id=f"{i:016d}", parent_id="x",
                            start=i, end=i + 0.5))
        held = _held(col)
        col.clear()
        return held, col.spans(), col.dropped, col.added

    held, after, dropped, added = _both(case)
    assert sorted(s["name"] for s in held["spans"]) == ["s2", "s3", "s4",
                                                        "s5"]
    assert (held["dropped"], held["added"]) == (2, 6)
    assert after == [] and dropped == 0 and added == 0


def test_slow_trace_retention_survives_ring_eviction():
    tid = "a" * 32

    def case(mod):
        col = mod.SpanCollector(capacity=4, slow_threshold_s=0.05,
                                slow_keep=2)
        col.add(_mkspan(mod, "child", trace_id=tid, span_id="c" * 16,
                        parent_id="r" * 16, start=0.01, end=0.09))
        col.add(_mkspan(mod, "root", trace_id=tid, span_id="r" * 16,
                        start=0.0, end=0.1))
        for i in range(8):  # shred the ring
            col.add(_mkspan(mod, f"noise{i}", trace_id="b" * 32,
                            span_id=f"{i:016d}", parent_id="x",
                            start=i, end=i + 0.001))
        return _held(col)

    held = _both(case)
    assert {"root", "child"} <= {s["name"] for s in held["spans"]}
    (slow,) = held["slow"]
    assert slow["trace_id"] == tid
    assert slow["duration_ms"] == pytest.approx(100, abs=1)
    assert {s["name"] for s in slow["spans"]} == {"root", "child"}


def test_slow_store_bounded_keeps_slowest():
    def case(mod):
        col = mod.SpanCollector(capacity=64, slow_threshold_s=0.01,
                                slow_keep=2)
        for i, dur in enumerate([0.02, 0.08, 0.05, 0.03]):
            col.add(_mkspan(mod, f"r{i}", trace_id=f"{i:032d}",
                            span_id=f"{i:016d}", start=0.0, end=dur))
        first = col.slow_traces()
        # a fast root below the threshold is never retained
        col.add(_mkspan(mod, "fast", trace_id="f" * 32, span_id="f" * 16,
                        start=0.0, end=0.005))
        return first, _held(col)

    first, held = _both(case)
    assert [t["duration_ms"] for t in first] == [80.0, 50.0]
    assert held["slow"] == first


def test_open_spans_not_retained_as_slow():
    def case(mod):
        col = mod.SpanCollector(slow_threshold_s=0.01)
        s = mod.Span("open", trace_id="c" * 32, span_id="d" * 16,
                     parent_id=None, start=0.0)
        s.process = ""
        col.add(s)  # end is None: no duration, no retention decision
        return _held(col), s.duration_ms()

    held, dur = _both(case)
    assert held["slow"] == [] and dur is None
    assert held["spans"][0]["duration_ms"] is None


# ---- cross-shard merge -----------------------------------------------

def test_merge_spans_dedupes_across_processes():
    tid = "e" * 32

    def case(mod):
        a = _mkspan(mod, "client", trace_id=tid, span_id="1" * 16,
                    start=0.0, end=1.0, process="harness").to_dict()
        b = _mkspan(mod, "server", trace_id=tid, span_id="2" * 16,
                    parent_id="1" * 16, start=0.2, end=0.8,
                    process="shard-0").to_dict()
        return mod.merge_spans([a, b], [b], [a], []), mod.merge_spans()

    merged, empty = _both(case)
    assert [s["process"] for s in merged] == ["harness", "shard-0"]
    assert empty == []


# ---- critical path ---------------------------------------------------

def test_critical_path_partitions_root_interval():
    tid = "9" * 32

    def case(mod):
        root = _mkspan(mod, "root", trace_id=tid, span_id="r" * 16,
                       start=0.0, end=10.0).to_dict()
        a = _mkspan(mod, "a", trace_id=tid, span_id="a" * 16,
                    parent_id="r" * 16, start=1.0, end=4.0).to_dict()
        b = _mkspan(mod, "b", trace_id=tid, span_id="b" * 16,
                    parent_id="r" * 16, start=5.0, end=9.0).to_dict()
        g = _mkspan(mod, "g", trace_id=tid, span_id="c" * 16,
                    parent_id="b" * 16, start=6.0, end=8.0).to_dict()
        return mod.critical_path([b, g, root, a])  # order-insensitive

    hops = _both(case)
    assert [h["name"] for h in hops] == ["root", "a", "b", "g"]
    by_name = {h["name"]: h["self_ms"] for h in hops}
    assert by_name == {"root": 3000.0, "a": 3000.0, "b": 2000.0,
                       "g": 2000.0}
    assert sum(by_name.values()) == pytest.approx(10_000.0)


def test_critical_path_clips_children_to_parent():
    tid = "8" * 32

    def case(mod):
        root = _mkspan(mod, "root", trace_id=tid, span_id="r" * 16,
                       start=0.0, end=2.0).to_dict()
        late = _mkspan(mod, "late", trace_id=tid, span_id="l" * 16,
                       parent_id="r" * 16, start=1.0, end=5.0).to_dict()
        return mod.critical_path([root, late])

    hops = _both(case)
    assert {h["name"]: h["self_ms"] for h in hops} == {"root": 1000.0,
                                                       "late": 1000.0}


def test_critical_path_ignores_open_spans_and_empty():
    def case(mod):
        open_span = mod.Span("open", trace_id="7" * 32, span_id="o" * 16,
                             parent_id=None).to_dict()
        return mod.critical_path([]), mod.critical_path([open_span])

    assert _both(case) == ([], [])


def test_critical_path_orphan_parent_treated_as_root():
    tid = "6" * 32

    def case(mod):
        orphan = _mkspan(mod, "orphan", trace_id=tid, span_id="o" * 16,
                         parent_id="missing-parent00", start=0.0,
                         end=1.0).to_dict()
        return mod.critical_path([orphan])

    (hop,) = _both(case)
    assert hop["name"] == "orphan"
    assert hop["self_ms"] == pytest.approx(1000.0)


def test_live_spans_parent_and_expose_the_current_context():
    """``current_span`` / ``current_context`` inside an open span, and a
    traced request's spans through the collector, in the port alone (the
    ids are random): a root span and its child form one trace whose
    critical path's self times sum to the root's duration."""
    ttracing.set_enabled(True)
    ttracing.collector().clear()
    try:
        assert ttracing.current_span() is None
        assert ttracing.current_context() is None
        with ttracing.start_span("root") as root:
            assert ttracing.current_span() is root
            ctx = ttracing.current_context()
            assert (ctx.trace_id, ctx.span_id) == (root.trace_id,
                                                   root.span_id)
            with ttracing.start_span("child") as child:
                assert child.parent_id == root.span_id
        assert root.duration_ms() >= child.duration_ms() >= 0
        (trace,) = ttracing.collector().traces().values()
        hops = ttracing.critical_path(trace)
        assert sum(h["self_ms"] for h in hops) == pytest.approx(
            root.duration_ms(), abs=1e-2)
    finally:
        ttracing.set_enabled(False)
        ttracing.collector().clear()
    assert ttracing.current_context() is None
