"""Port parity for the serving gateway (``controlplane/webapps/serving``)
and what it stands on: ``TokenBucket``, ``tracing`` and the stdlib
``metrics``.

Every scenario runs in both packages on the same inputs: the tiny
Llama in float32 on the same numpy-seeded weights (``both_models``).
Tolerance: none. Admission verdicts, shed reasons and counts, tokens
(also against the port's solo ``generate_fused``), HTTP status codes and
JSON bodies (``latency_ms`` aside, a wall time) and the Prometheus text
are compared for equality. No test depends on wall time: the rate
buckets run on an injected clock, and the concurrent case uses a policy
whose SLO cannot shed.
"""

import importlib
import json
import os
import sys

import numpy as np
import prometheus_client
import pytest

from kubeflow_rm_tpu.controlplane import metrics as jmetrics
from kubeflow_rm_tpu.controlplane import tracing as jtracing
from kubeflow_rm_tpu.controlplane.deploy import kubeclient as jkube
from kubeflow_rm_tpu.controlplane.webapps import serving as jserving
from kubeflow_rm_tpu_torch.controlplane import metrics as tmetrics
from kubeflow_rm_tpu_torch.controlplane import tracing as ttracing
from kubeflow_rm_tpu_torch.controlplane.deploy import kubeclient as tkube
from kubeflow_rm_tpu_torch.controlplane.webapps import serving as tserving

from torch_fleet_helpers import (
    both_models, join_all, solo_torch, start_all, wsgi, wsgi_json,
)

jgen = importlib.import_module("kubeflow_rm_tpu.models.generate")
tgen = importlib.import_module("kubeflow_rm_tpu_torch.models.generate")

PKGS = {"jax": (jserving, jkube), "torch": (tserving, tkube)}

#: a policy that admits everything the queue can hold
OPEN = dict(qps=1e9, burst=10**6, tokens_per_s=1e9, token_burst=10**7,
            slo_p95_ms=1e12)


@pytest.fixture(scope="module")
def model():
    return both_models()


def _gateway(model, pkg, **kw):
    jcfg, jparams, tcfg, tparams = model
    eng_kw = dict(slots=kw.pop("slots", 2), slot_len=kw.pop("slot_len", 32))
    if pkg == "jax":
        eng = jgen.ContinuousBatchingEngine(jparams, jcfg, **eng_kw)
    else:
        eng = tgen.ContinuousBatchingEngine(tparams, tcfg, **eng_kw)
    return PKGS[pkg][0].ServingGateway(eng, **kw)


def _both(model, fn, **kw):
    """``fn(gateway, serving module)`` on each package's gateway (closed
    after); returns {package: result}."""
    out = {}
    for pkg in PKGS:
        gw = _gateway(model, pkg, **kw)
        try:
            out[pkg] = fn(gw, PKGS[pkg][0])
        finally:
            gw.close()
    return out


# -- TokenBucket (the non-blocking admission primitive) -------------------


def _bucket_trace(mod):
    t = {"now": 0.0}
    b = mod.TokenBucket(qps=2.0, burst=4, clock=lambda: t["now"])
    got = [b.try_acquire(1.0) for _ in range(5)]
    t["now"] += 1.0                                    # +2 tokens
    got += [b.try_acquire(2.0), b.try_acquire(0.5)]
    t["now"] += 100.0                                  # capped at burst
    got += [b.try_acquire(4.0), b.try_acquire(0.5)]
    w = mod.TokenBucket(qps=10.0, burst=20, clock=lambda: t["now"])
    got += [w.try_acquire(16.0), w.try_acquire(16.0), w.try_acquire(4.0)]
    return got, b.throttled_calls, w.throttled_calls


def test_token_bucket_try_acquire_equals_jax():
    got = {pkg: _bucket_trace(kube) for pkg, (_, kube) in PKGS.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == [True] * 4 + [False, True, False, True,
                                              False, True, False, True]


def test_token_bucket_acquire_sleeps_on_the_injected_clock():
    def trace(mod):
        t, slept = {"now": 0.0}, []

        def sleep(s):
            slept.append(s)
            t["now"] += s

        b = mod.TokenBucket(qps=4.0, burst=2, clock=lambda: t["now"],
                            sleep=sleep)
        waits = [b.acquire(1.0) for _ in range(4)] + [b.acquire(3.0)]
        return waits, slept, b.throttled_calls, b.throttled_seconds

    assert trace(tkube) == trace(jkube)
    with pytest.raises(ValueError):
        tkube.TokenBucket(qps=0)


# -- gateway admission and shedding ---------------------------------------


def test_gateway_sheds_over_rate_tenant(model):
    def run(gw, mod):
        t = {"now": 0.0}
        gw._clock = lambda: t["now"]
        gw.default_policy = mod.TenantPolicy(qps=1.0, burst=2)
        verdicts = [gw.try_submit("noisy", [1, 2, 3], max_new_tokens=2)[1]
                    for _ in range(4)]
        t["now"] += 1.0                   # the bucket refills
        verdicts.append(gw.try_submit("noisy", [1, 2, 3],
                                      max_new_tokens=2)[1])
        return verdicts, dict(gw.shed_counts)

    got = _both(model, run)
    assert got["torch"] == got["jax"]
    assert got["torch"] == ([None, None, "rate", "rate", None], {"rate": 2})


def test_gateway_sheds_over_token_budget(model):
    def run(gw, mod):
        gw._clock = lambda: 0.0
        gw.default_policy = mod.TenantPolicy(qps=1000.0, burst=1000,
                                             tokens_per_s=1.0,
                                             token_burst=20)
        return [gw.try_submit("t", [1], max_new_tokens=n)[1]
                for n in (16, 16, 4)], dict(gw.shed_counts)

    got = _both(model, run)
    assert got["torch"] == got["jax"]
    assert got["torch"] == ([None, "tokens", None], {"tokens": 1})


def test_gateway_queue_cap_slo_and_admission_off(model):
    def run(gw, mod):
        out = {}
        gw.max_queue, gw.admission = 0, False
        out["queue"] = gw.try_submit("t", [1, 2], max_new_tokens=2)[1]
        gw.max_queue, gw.admission = 64, True
        gw.default_policy = mod.TenantPolicy(slo_p95_ms=50.0)
        gw._ema_ms = 1000.0               # recent service times >> SLO
        out["slo"] = gw.try_submit("t", [1, 2], max_new_tokens=2)[1]
        gw.admission = False              # admits what the queue holds
        gw.default_policy = mod.TenantPolicy(qps=0.001, burst=1,
                                             slo_p95_ms=1.0)
        gw._ema_ms = 1e6
        out["off"] = [gw.try_submit("u", [1, 2], max_new_tokens=2)[1]
                      for _ in range(3)]
        out["shed"] = dict(gw.shed_counts)
        return out

    got = _both(model, run)
    assert got["torch"] == got["jax"]
    assert got["torch"] == {"queue": "queue", "slo": "slo",
                            "off": [None] * 3,
                            "shed": {"queue": 1, "slo": 1}}


def test_noisy_neighbor_cannot_starve_victim(model):
    def run(gw, mod):
        t = {"now": 0.0}
        gw._clock = lambda: t["now"]
        gw.default_policy = mod.TenantPolicy(qps=1.0, burst=3)
        flood = sum(gw.try_submit("flood", [1], max_new_tokens=1)[0]
                    is not None for _ in range(20))
        victim = sum(gw.try_submit("victim", [1], max_new_tokens=1)[0]
                     is not None for _ in range(3))
        return flood, victim, dict(gw.shed_counts)

    got = _both(model, run)
    assert got["torch"] == got["jax"] == (3, 3, {"rate": 17})


def test_try_submit_refuses_what_a_slot_cannot_hold(model):
    for pkg in PKGS:
        gw = _gateway(model, pkg)
        try:
            with pytest.raises(ValueError):
                gw.try_submit("t", [1] * 30, max_new_tokens=30)
        finally:
            gw.close()


# -- decode through the gateway, and its observability ---------------------


def test_gateway_decodes_exactly_and_reports(model):
    jcfg, jparams, tcfg, tparams = model
    prompt = [5, 9, 2]

    def run(gw, mod):
        pending, reason = gw.try_submit("alice", prompt, max_new_tokens=6)
        assert reason is None
        tokens = gw.wait(pending, timeout_s=120)
        snap = gw.snapshot()
        lat = gw.tenant_latency("alice")
        return tokens, lat["count"], lat["p95_ms"] > 0, {
            k: snap[k] for k in ("slot_capacity", "finished_total",
                                 "queue_depth", "active_slots", "shed",
                                 "paged")}, sorted(snap["tenants"])

    got = _both(model, run)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == solo_torch(tparams, tcfg, prompt, 6, 32)
    assert got["torch"][1:3] == (1, True)


def test_serving_app_http_surface_equals_jax(model):
    cfgs = {jserving: model[0], tserving: model[2]}
    vocab = model[2].vocab_size

    def run(gw, mod):
        gw.default_policy = mod.TenantPolicy(qps=0.001, burst=2)
        app = mod.make_serving_app(gw, cfgs[mod])
        out = {}
        for i, (body, headers) in enumerate((
                ({"prompt": [1, 2, 3], "tenant": "a", "max_new_tokens": 4},
                 None),
                ({"prompt": [1], "tenant": "a"},
                 {"X-Tenant": "ignored-when-body-has-tenant"}),
                ({"prompt": [1], "tenant": "a"}, None))):   # 429: rate
            status, hdrs, raw = wsgi(app, "POST", "/generate", body,
                                     headers)
            got = json.loads(raw)
            if status == 200:
                assert got.pop("latency_ms") > 0
            out[f"generate{i}"] = (status, hdrs.get("Retry-After"), got)
        # validation 400s; the capacity guard is a 400 too, not a 500
        out["bad"] = [wsgi(app, "POST", "/generate", body)[0] for body in (
            {"prompt": []}, {"prompt": [vocab]},
            {"prompt": [1], "max_new_tokens": 0},
            {"prompt": [1], "slo_class": "gold"},
            {"prompt": [1], "tenant": "x" * 65},
            {"prompt": [1] * 30, "tenant": "b", "max_new_tokens": 30},
            b"{not json")]
        out["healthz"] = wsgi_json(app, "GET", "/healthz")
        api = wsgi_json(app, "GET", "/api/metrics")[1]["serving"]
        out["api"] = (api["shed"], sorted(api["tenants"]),
                      api["finished_total"], api["draining"])
        status, hdrs, text = wsgi(app, "GET", "/metrics")
        text = text.decode()
        out["metrics"] = (status, hdrs["Content-Type"], all(s in text for s in (
            "serving_requests_total", "serving_shed_total",
            'serving_request_latency_seconds_bucket{le="0.005",'
            'tenant="a"}')))
        gw.start_drain()
        out["healthz_draining"] = wsgi_json(app, "GET", "/healthz")
        out["generate_draining"] = wsgi_json(app, "POST", "/generate",
                                             {"prompt": [1]})
        return out

    got = _both(model, run)
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["generate0"][:2] == (200, None)
    assert len(t["generate0"][2]["tokens"]) == 4
    assert t["generate2"] == (429, "1", {"error": "shed", "reason": "rate"})
    assert t["bad"] == [400] * 7
    assert t["healthz"] == (200, {"ok": True, "state": "ready"})
    assert t["api"] == ({"rate": 1}, ["a"], 2, False)
    assert t["metrics"] == (200, "text/plain; version=0.0.4", True)
    assert t["healthz_draining"] == (503, {"ok": False,
                                           "state": "draining"})
    assert t["generate_draining"] == (503, {"error": "shed",
                                            "reason": "draining"})


def test_gateway_concurrent_tenants_all_complete(model):
    """Many waiters against few slots: everything admitted completes with
    the tokens the other package gives, occupancy is accounted and every
    tenant's latency window fills. The policy's SLO cannot shed, so no
    verdict depends on how long a step takes."""
    tcfg, tparams = model[2], model[3]

    def prompt(n):
        return [(n * 7 + 3) % (tcfg.vocab_size - 1) + 1] * (2 + n % 5)

    def run(gw, mod):
        gw.default_policy = mod.TenantPolicy(**OPEN)
        results, reasons = {}, {}

        def one(n):
            pending, reasons[n] = gw.try_submit(f"t{n}", prompt(n),
                                                max_new_tokens=3)
            results[n] = gw.wait(pending, timeout_s=120)

        join_all(start_all([lambda n=n: one(n) for n in range(6)]))
        snap = gw.snapshot()
        return (results, reasons, snap["finished_total"],
                0 < snap["batch_occupancy"] <= 1.0,
                sorted(snap["tenants"]))

    got = _both(model, run)
    assert got["torch"] == got["jax"]
    results, reasons, finished, occupancy_ok, tenants = got["torch"]
    assert set(reasons.values()) == {None} and finished == 6
    assert occupancy_ok and tenants == [f"t{n}" for n in range(6)]
    for n, toks in results.items():
        assert toks == solo_torch(tparams, tcfg, prompt(n), 3, 32)


def test_gateway_drain_thread_and_close_are_bounded(model):
    gw = _gateway(model, "torch")
    thread = gw._thread
    gw.close()
    assert not thread.is_alive()
    assert gw.try_submit("t", [1], max_new_tokens=1) == (None, "draining")


# -- tracing ----------------------------------------------------------------


HEADERS = [None, "", "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
           "00-" + "A1" * 16 + "-" + "0f" * 8 + "-00",
           "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
           "00-" + "g" * 32 + "-" + "b" * 16 + "-01", "garbage",
           " 00-" + "1" * 32 + "-" + "2" * 16 + "-01 "]


@pytest.mark.parametrize("header", HEADERS)
def test_parse_traceparent_equals_jax(header):
    j, t = jtracing.parse_traceparent(header), \
        ttracing.parse_traceparent(header)
    assert (j is None) == (t is None)
    if t is not None:
        assert (t.trace_id, t.span_id) == (j.trace_id, j.span_id)
        assert t.to_traceparent() == j.to_traceparent()


def test_spans_parent_and_stay_off_when_disabled():
    ttracing.collector().clear()
    assert not ttracing.enabled()
    with ttracing.start_span("x") as s:
        s.set_attr("k", 1)
        assert ttracing.current_traceparent() is None
    with ttracing.start_span_if_active("y"):
        pass
    assert ttracing.record_span("z", start=0.0, end=1.0) is None
    assert ttracing.collector().spans() == []
    ttracing.set_enabled(True)
    try:
        with ttracing.start_span_if_active("orphan"):
            pass
        assert ttracing.collector().spans() == []   # no trace in flight
        parent = "00-" + "c" * 32 + "-" + "d" * 16 + "-01"
        with ttracing.start_span("server", kind="server",
                                 parent=parent) as root:
            tp = ttracing.current_traceparent()
            with ttracing.start_span_if_active("admit") as child:
                pass
        ctx = ttracing.record_span("decode", start=1.0, end=2.5, parent=tp)
        spans = {d["name"]: d for d in ttracing.collector().spans()}
        assert spans["server"]["trace_id"] == "c" * 32
        assert spans["server"]["parent_id"] == "d" * 16
        assert spans["admit"]["parent_id"] == root.span_id
        assert child.trace_id == root.trace_id
        assert spans["decode"]["parent_id"] == root.span_id
        assert spans["decode"]["duration_ms"] == 1500.0
        assert ctx.trace_id == "c" * 32
        assert sorted(d["name"] for d in ttracing.collector().get_trace(
            "c" * 32)) == ["admit", "decode", "server"]
    finally:
        ttracing.set_enabled(False)
        ttracing.collector().clear()


def test_gateway_stamps_the_decode_span_and_its_exemplar(model):
    """A traced ``/generate`` joins its caller's trace in both packages:
    a server span, the admission span under it, the decode span the
    drain thread records, and the tenant's exemplar."""
    cfgs = {jserving: model[0], tserving: model[2]}
    mods = {jserving: jtracing, tserving: ttracing}
    header = "00-" + "e" * 32 + "-" + "f" * 16 + "-01"

    def run(gw, mod):
        tr = mods[mod]
        tr.collector().clear()
        tr.set_enabled(True)
        try:
            gw.default_policy = mod.TenantPolicy(**OPEN)
            app = mod.make_serving_app(gw, cfgs[mod])
            status, _ = wsgi_json(app, "POST", "/generate",
                                  {"prompt": [3, 4], "tenant": "tr",
                                   "max_new_tokens": 2},
                                  {"traceparent": header})
            spans = tr.collector().get_trace("e" * 32)
            ex = gw.tenant_latency("tr")["slowest_trace"]
        finally:
            tr.set_enabled(False)
            tr.collector().clear()
        by = {d["name"]: d for d in spans}
        server = by["POST /generate"]
        return (status, sorted(by), server["parent_id"], server["kind"],
                by["serving.admit"]["parent_id"] == server["span_id"],
                by["serving.decode"]["parent_id"] == server["span_id"],
                by["serving.decode"]["attrs"], ex["trace_id"])

    got = _both(model, run)
    assert got["torch"] == got["jax"]
    assert got["torch"][:4] == (200, ["POST /generate", "serving.admit",
                                      "serving.decode"], "f" * 16,
                                "server")


# -- metrics ----------------------------------------------------------------


SERVING_SERIES = sorted(n for n in dir(jmetrics) if n.startswith("SERVING_"))


def test_serving_series_are_jaxs():
    assert len(SERVING_SERIES) == 21
    assert sorted(n for n in dir(tmetrics)
                  if n.startswith("SERVING_")) == SERVING_SERIES
    jtext = prometheus_client.generate_latest(jmetrics.REGISTRY).decode()
    ttext = tmetrics.render()
    for name in SERVING_SERIES:
        j, t = getattr(jmetrics, name), getattr(tmetrics, name)
        kind = {"counter": "counter", "gauge": "gauge",
                "histogram": "histogram"}[j._type]
        assert t.kind == kind
        assert tuple(t.labelnames) == tuple(j._labelnames)
        assert t.documentation == j._documentation
        # the # TYPE line names the same series in both scrapes
        type_lines = [ln for ln in jtext.splitlines()
                      if ln.startswith("# TYPE ")
                      and ln.endswith(f" {kind}")
                      and ln.split()[2].startswith(j._name)]
        assert f"# TYPE {t.series_name()} {kind}" in type_lines
        assert f"# TYPE {t.series_name()} {kind}" in ttext
    assert tmetrics.SERVING_MIGRATIONS_TOTAL.series_name() == \
        "serving_migrations_total"
    assert tmetrics.SERVING_REQUESTS_TOTAL.series_name() == \
        "serving_requests_total"


def test_histogram_and_counter_text_equal_prometheus_client():
    """A fresh metric of each kind in each library, fed the same values,
    renders the same sample lines (``_created`` aside, which the port
    does not keep)."""
    jreg, treg = prometheus_client.CollectorRegistry(), []
    values = [0.004, 0.01, 0.3, 2.5, 40.0, 0.0]
    jh = prometheus_client.Histogram("h_seconds", "doc", ["tenant"],
                                     registry=jreg,
                                     buckets=(0.01, 0.5, 2.5))
    th = tmetrics.Histogram("h_seconds", "doc", ["tenant"],
                            buckets=(0.01, 0.5, 2.5), registry=treg)
    jd = prometheus_client.Histogram("d_seconds", "doc", registry=jreg)
    td = tmetrics.Histogram("d_seconds", "doc", registry=treg)
    jc = prometheus_client.Counter("c_total", "doc", ["r"], registry=jreg)
    tc = tmetrics.Counter("c_total", "doc", ["r"], registry=treg)
    jm = prometheus_client.Counter("m", "doc", registry=jreg)
    tm = tmetrics.Counter("m", "doc", registry=treg)
    jg = prometheus_client.Gauge("g", "doc", ["x"], registry=jreg)
    tg = tmetrics.Gauge("g", "doc", ["x"], registry=treg)
    for v in values:
        jh.labels("a").observe(v)
        th.labels("a").observe(v)
        jd.observe(v)
        td.observe(v)
    jc.labels("ok").inc(3)
    tc.labels(r="ok").inc(3)
    jm.inc()
    tm.inc()
    jg.labels("y").set(0.25)
    tg.labels("y").set(0.25)
    assert th.labels("a").get() == len(values)
    assert tc.get("ok") == tc.get(r="ok") == 3.0

    def samples(text):
        return sorted(ln for ln in text.splitlines()
                      if ln and not ln.startswith("#")
                      and "_created" not in ln)

    assert samples(tmetrics.render(treg)) == samples(
        prometheus_client.generate_latest(jreg).decode())
    with pytest.raises(ValueError):
        tc.labels("a", "b")
    with pytest.raises(ValueError):
        tc.labels("a", r="b")
    with pytest.raises(ValueError):
        tc.labels("a").inc(-1)


def test_scrape_is_the_rendered_text():
    assert tmetrics.scrape().decode().splitlines()[0].startswith("# HELP")
    assert np.isfinite(tmetrics.SERVING_SLOT_CAPACITY.get())


# -- stress: more threads than cores, a short switch interval -------------


def _stress_threads():
    return min(32, 2 * (os.cpu_count() or 2))


def test_token_bucket_loses_no_update_under_contention():
    """Many threads take from one bucket on a frozen clock: exactly
    ``burst`` acquisitions succeed, and every other call is counted as
    throttled (a lost read-modify-write would admit more)."""
    n = _stress_threads()
    b = tkube.TokenBucket(qps=1.0, burst=37, clock=lambda: 0.0)
    got = [0] * n
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def take(i):
            got[i] = sum(b.try_acquire(1.0) for _ in range(10))

        join_all(start_all([lambda i=i: take(i) for i in range(n)]))
    finally:
        sys.setswitchinterval(old)
    assert sum(got) == 37
    assert b.throttled_calls == 10 * n - 37


def test_gateway_under_stress_completes_every_request_exactly(model):
    """More requesting threads than cores against one gateway, with a
    short switch interval: every request completes with its solo
    tokens, and the engine's and gateway's counts agree."""
    tcfg, tparams = model[2], model[3]
    n = _stress_threads()
    gw = _gateway(model, "torch", slots=4, slot_len=32,
                  default_policy=tserving.TenantPolicy(**OPEN))
    prompts = [[(7 * i) % 200 + 1, (3 * i) % 50 + 2] for i in range(n)]
    out = [None] * n
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def one(i):
            pending, _ = gw.try_submit(f"s{i % 5}", prompts[i],
                                       max_new_tokens=3)
            out[i] = gw.wait(pending, timeout_s=120)

        join_all(start_all([lambda i=i: one(i) for i in range(n)]))
        snap = gw.snapshot()
    finally:
        sys.setswitchinterval(old)
        gw.close()
    assert snap["finished_total"] == n and snap["shed"] == {}
    assert snap["queue_depth"] == 0 and snap["active_slots"] == 0
    assert sum(t["count"] for t in snap["tenants"].values()) == n
    want = {tuple(p): solo_torch(tparams, tcfg, p, 3, 32) for p in prompts}
    assert all(out[i] == want[tuple(prompts[i])] for i in range(n))
