"""The port's central dashboard (``controlplane/webapps/dashboard.py``)
and its metrics service (``metrics_service.py``), held to JAX's: every
case of ``tests/test_dashboard.py``, the three dashboard cases of
``tests/test_observability.py``, the dashboard half of
``tests/test_ha.py``'s control-plane section and its Prometheus half,
and the ``/api/alerts`` half of ``tests/test_admission.py``'s
declared-memory drift case, on the port's stack; then the same requests
against each package's app over each package's ``make_control_plane``
(the parity fixture), whose status codes, JSON bodies and object graphs
must be equal after the TPU→GPU key map, apart from these named
differences:

- ``/api/metrics``: the per-type dict is keyed by the node's
  accelerator label value, which the key map maps as a value
  (``tpu-v5p-slice`` → ``nvidia-h100-80gb``); the ``controlplane``
  section reads each package's own process-wide registry, so only its
  keys are compared.
- ``/api/metrics/history``: each point's ``t`` is the wall clock.
- ``/api/alerts``: burn rates, states and times read each package's
  process-wide registry and the wall clock; the SLO specs are compared
  after the SLO descriptions' text map (``tests/test_torch_obs.py``).
- ``/api/harvest``: the lifetime counters read the process-wide
  registry; the ledger's fields are compared.
- ``/api/traces``: ``traces`` counts the process-wide span collector.
- ``env-info``'s ``tpuSliceTypes``: a GPU node's labels name one host's
  shape, so the port lists every type of that shape — two 4-card hosts
  list ``h100-80gb-4`` beside ``h100-80gb-2x4``, where JAX's TPU hosts'
  labels name the slice (``v5p-16`` alone).

Every test that makes a dashboard stops its history's sampler.
"""

import json
import threading

import pytest

from kubeflow_rm_tpu_torch.controlplane import make_control_plane, metrics
from kubeflow_rm_tpu_torch.controlplane import tracing
from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import make_object
from kubeflow_rm_tpu_torch.controlplane.api.notebook import make_notebook
from kubeflow_rm_tpu_torch.controlplane.controllers.statefulset import (
    make_gpu_node,
)
from kubeflow_rm_tpu_torch.controlplane.webapps.dashboard import create_app

from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, NS, VALUE_MAP, jax_switch_defaults, parity, run_full,
)

USER = "alice@corp.com"
SLICE = "h100-80gb-2x4"


@pytest.fixture
def stack():
    return make_control_plane()


@pytest.fixture
def dash_app(stack):
    """A dashboard over ``stack`` sampling on demand; its history is
    stopped at teardown."""
    api, _ = stack
    apps = []

    def make(**kw):
        kw.setdefault("history_interval_s", 0)
        app = create_app(api, **kw)
        apps.append(app)
        return app
    yield make
    for app in apps:
        app.metrics_history.stop()


def get_json(client, url):
    resp = client.get(url)
    assert resp.status_code == 200, resp.get_data()
    return json.loads(resp.get_data())


# ---- tests/test_dashboard.py -------------------------------------------

def test_workgroup_registration_flow(stack, dash_app):
    api, mgr = stack
    client = dash_app().test_client(user=USER)

    # first login: no workgroup yet
    assert get_json(client, "/api/workgroup/exists")["hasWorkgroup"] is False

    resp = client.post("/api/workgroup/create",
                       data=json.dumps({"namespace": "alice"}),
                       headers=[("Content-Type", "application/json")])
    assert resp.status_code == 200, resp.get_data()
    mgr.enqueue_all()
    mgr.run_until_idle()

    assert get_json(client, "/api/workgroup/exists")["hasWorkgroup"] is True
    info = get_json(client, "/api/workgroup/env-info")
    assert {"namespace": "alice", "role": "owner", "user": USER} in \
        info["namespaces"]
    assert info["isClusterAdmin"] is False

    # namespaces endpoint sees the provisioned namespace
    assert "alice" in get_json(client, "/api/namespaces")["namespaces"]


def test_activities_surface_namespace_events(stack, dash_app):
    api, mgr = stack
    client = dash_app().test_client(user=USER)
    api.ensure_namespace("team")
    # JAX's case asks for a v5litepod-16, which no node offers; the
    # port's asks for an 8-card host no node offers
    nb = make_notebook("nb", "team", accelerator_type="h100-80gb-8")
    api.create(nb)
    mgr.run_until_idle()  # no nodes -> FailedScheduling events
    evs = get_json(client, "/api/activities/team")["events"]
    assert any(e["reason"] == "FailedScheduling" for e in evs)


def test_tpu_metrics_report_fleet_utilization(stack, dash_app):
    api, mgr = stack
    client = dash_app().test_client(user=USER)
    api.ensure_namespace("team")
    for i in range(2):
        api.create(make_gpu_node(f"n{i}", SLICE))
    api.create(make_notebook("nb", "team", accelerator_type=SLICE))
    mgr.run_until_idle()

    tpu = get_json(client, "/api/metrics")["tpu"]
    entry = tpu[gpu_api.lookup(SLICE).gke_accelerator]
    assert entry["nodes"] == 2
    assert entry["allocatable"] == 8.0
    assert entry["used"] == 8.0  # both hosts of the slice are scheduled

    links = get_json(client, "/api/dashboard-links")
    assert any(m["link"] == "/jupyter/" for m in links["menuLinks"])


def test_get_all_namespaces_requires_cluster_admin(stack, dash_app):
    api, _ = stack
    client = dash_app().test_client(user=USER)
    assert client.get("/api/workgroup/get-all-namespaces").status_code == 403
    crb = make_object("rbac.authorization.k8s.io/v1", "ClusterRoleBinding",
                      "root")
    crb["roleRef"] = {"kind": "ClusterRole", "name": "cluster-admin"}
    crb["subjects"] = [{"kind": "User", "name": USER}]
    api.create(crb)
    assert client.get("/api/workgroup/get-all-namespaces").status_code == 200


def test_metrics_endpoint_serves_prometheus_exposition(dash_app):
    resp = dash_app().test_client(user=None)._client.get("/metrics")
    assert resp.status_code == 200
    body = resp.get_data(as_text=True)
    assert "notebook_running" in body
    # the port's registry keeps JAX's series names
    assert "tpu_chips_requested" in body


def test_metrics_summary_and_history(stack, dash_app):
    """/api/metrics carries the SPA's pill summary; /api/metrics/history
    rings utilization-over-time points."""
    api, mgr = stack
    api.create(make_gpu_node("n0", SLICE))
    client = dash_app().test_client(user=USER)  # on-demand sampling
    body = get_json(client, "/api/metrics")
    m = body["metrics"]
    assert m["nodes"] >= 1 and m["chips_capacity"] >= 1
    assert "notebooks_running" in m
    hist = get_json(client, "/api/metrics/history")
    assert hist["series"], "on-demand sample must produce a point"
    pt = hist["series"][-1]
    assert {"t", "chips_used", "chips_capacity",
            "notebooks_running"} <= set(pt)


def test_metrics_backend_factory():
    """inventory | prometheus | unknown — the factory contract
    (metrics_service_factory.ts)."""
    from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer
    from kubeflow_rm_tpu_torch.controlplane.webapps.metrics_service import (
        InventoryMetricsService, PrometheusMetricsService,
        make_metrics_service,
    )
    api = APIServer()
    assert isinstance(make_metrics_service(api, "inventory"),
                      InventoryMetricsService)
    svc = make_metrics_service(api, "prometheus",
                               prometheus_url="http://x/metrics")
    assert isinstance(svc, PrometheusMetricsService)
    with pytest.raises(ValueError, match="unknown metrics backend"):
        make_metrics_service(api, "stackdriver-typo")
    with pytest.raises(ValueError, match="KFRM_PROMETHEUS_URL"):
        make_metrics_service(api, "prometheus")


def _serve(app):
    """``app`` on a threaded ``wsgiref`` server on 127.0.0.1; returns
    (server, thread)."""
    import socketserver
    from wsgiref.simple_server import (
        WSGIRequestHandler, WSGIServer, make_server,
    )

    class Server(socketserver.ThreadingMixIn, WSGIServer):
        daemon_threads = True

    class Quiet(WSGIRequestHandler):
        def log_message(self, *args):
            pass

    httpd = make_server("127.0.0.1", 0, app, server_class=Server,
                        handler_class=Quiet)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, thread


def test_prometheus_backend_scrapes_platform_gauges(dash_app):
    """The prometheus backend parses the platform's own exposition —
    served here by a web app's /metrics route."""
    from kubeflow_rm_tpu_torch.controlplane.webapps.metrics_service import (
        PrometheusMetricsService,
    )
    httpd, thread = _serve(dash_app())
    before = metrics.registry_value("tpu_chips_requested")
    try:
        metrics.TPU_CHIPS_REQUESTED.set(12)
        svc = PrometheusMetricsService(
            f"http://127.0.0.1:{httpd.server_port}/metrics")
        snap = svc.snapshot()
        assert snap["metrics"]["chips_requested"] == 12.0
    finally:
        metrics.TPU_CHIPS_REQUESTED.set(before or 0.0)
        httpd.shutdown()
        httpd.server_close()
        thread.join(30)


def test_activities_carry_spa_key(stack, dash_app):
    api, _ = stack
    api.ensure_namespace("team")
    client = dash_app().test_client(user=USER)
    body = get_json(client, "/api/activities/team")
    assert body["activities"] == body["events"]


def test_harvest_endpoint_reports_lease_ledger(stack, dash_app):
    api, _ = stack
    from kubeflow_rm_tpu_torch.controlplane import scheduler
    client = dash_app().test_client(user=USER)
    body = get_json(client, "/api/harvest")
    assert body["harvested_chips"] == 0.0
    assert body["leases"] == []
    assert body["controller"] is None  # no controller attached
    assert set(body["reclaims"]) == {"resume", "preempt", "idle_giveback"}

    # a live lease in the scheduler ledger shows up without any
    # controller: the ledger is ground truth, not the controller
    sched = scheduler.cache_for(api)
    api.ensure_namespace("serving-harvest")
    api.create(make_gpu_node("hn0", SLICE))
    pod = make_object("v1", "Pod", "harvest-9-0",
                      namespace="serving-harvest")
    pod["spec"] = {"containers": [{
        "name": "serve",
        "resources": {"limits": {gpu_api.NVIDIA_GPU_RESOURCE: "4"}}}]}
    plan = sched.gang_bind([pod], allow_virtual=False)
    assert plan == {("serving-harvest", "harvest-9-0"): "hn0"}
    sched.mark_harvested(("serving-harvest", "harvest-9-0"))
    try:
        body = get_json(client, "/api/harvest")
        assert body["harvested_chips"] == 4.0
        assert body["leases"] == [
            {"namespace": "serving-harvest", "pod": "harvest-9-0",
             "node": "hn0", "chips": 4.0}]
    finally:
        sched.release_harvested(("serving-harvest", "harvest-9-0"))


# ---- tests/test_observability.py: traces and the profiling hook ----------

@pytest.fixture
def traced():
    tracing.collector().clear()
    tracing.set_enabled(True)
    yield tracing.collector()
    tracing.set_enabled(False)
    tracing.collector().clear()


def test_api_traces_disabled_is_empty(dash_app):
    client = dash_app().test_client(user=USER)
    body = json.loads(client.get("/api/traces").get_data())
    assert body["enabled"] is False
    assert body["slow"] == []


def test_api_traces_serves_slow_index_and_critical_path(dash_app, traced):
    client = dash_app().test_client(user=USER)
    tid = "d" * 32
    # hand-recorded slow trace: root + one child
    root = tracing.Span("provision", trace_id=tid, span_id="r" * 16,
                        parent_id=None, start=100.0)
    child = tracing.Span("reconcile", trace_id=tid, span_id="c" * 16,
                         parent_id="r" * 16, start=100.1)
    child.end = 100.4
    traced.add(child)
    root.end = 100.5                    # 400ms >= slow threshold
    traced.add(root)

    body = json.loads(client.get("/api/traces").get_data())
    assert body["enabled"] is True
    (slow,) = body["slow"]
    assert slow["trace_id"] == tid
    assert slow["duration_ms"] == pytest.approx(500, abs=1)
    assert slow["spans"] == 2

    detail = json.loads(client.get(f"/api/traces/{tid}").get_data())
    assert [s["name"] for s in detail["spans"]] == [
        "provision", "reconcile"]
    path = detail["critical_path"]
    assert [h["name"] for h in path] == ["provision", "reconcile"]
    assert sum(h["self_ms"] for h in path) == pytest.approx(500, abs=1)

    missing = client.get("/api/traces/" + "0" * 32)
    assert missing.status_code == 404
    assert missing.json["log"] == f"no spans for trace {'0' * 32!r}"


def test_profile_cpu_gated_on_env(dash_app, monkeypatch):
    client = dash_app().test_client(user=USER)
    monkeypatch.delenv("KFRM_ENABLE_PROFILING", raising=False)
    refused = client.get("/api/metrics?profile=cpu")
    assert refused.status_code == 403
    assert refused.json["log"] == \
        "profiling is disabled; set KFRM_ENABLE_PROFILING=1"
    # plain snapshot path unaffected
    assert client.get("/api/metrics").status_code == 200

    monkeypatch.setenv("KFRM_ENABLE_PROFILING", "1")
    resp = client.get("/api/metrics?profile=cpu")
    assert resp.status_code == 200
    body = json.loads(resp.get_data())
    assert "snapshot" in body
    assert "function calls" in body["profile"]


# ---- tests/test_ha.py: the control-plane section -------------------------

def test_dashboard_metrics_expose_controlplane_section(stack, dash_app):
    """/api/metrics grows a controlplane section: lease holder from the
    store plus the in-process HA gauges."""
    from kubeflow_rm_tpu_torch.controlplane.ha import LeaderElector

    api, _ = stack
    api.ensure_namespace("kubeflow")
    el = LeaderElector(api, "dash-mgr")
    assert el.try_acquire_or_renew() is True
    el._set_leader(True, api.clock())
    try:
        client = dash_app().test_client(user=USER)
        resp = client.get("/api/metrics")
        assert resp.status_code == 200, resp.get_data()
        cp = json.loads(resp.get_data())["controlplane"]
        assert cp["leader"] == "dash-mgr"
        assert cp["lease_transitions"] == 0
        assert metrics.registry_value(
            "leader_is_leader", {"identity": "dash-mgr"}) == 1.0
        assert cp["is_leader"] >= 1.0
        assert cp["workqueue_depth"] == metrics.registry_value(
            "workqueue_depth")
        assert cp["workqueue_requeues"] == metrics.registry_value(
            "workqueue_requeues_total")
    finally:
        el._set_leader(False, api.clock())


def test_prometheus_backend_parses_controlplane_gauges():
    from kubeflow_rm_tpu_torch.controlplane.webapps.metrics_service import (
        PrometheusMetricsService,
    )

    svc = PrometheusMetricsService("http://unused")
    svc._scrape = lambda: {
        "leader_is_leader": 1.0,
        "workqueue_depth": 3.0,
        "workqueue_requeues_total": 7.0,
        "notebook_running": 2.0,
    }
    cp = svc.snapshot()["controlplane"]
    assert cp["is_leader"] == 1.0
    assert cp["workqueue_depth"] == 3.0
    assert cp["workqueue_requeues"] == 7.0


# ---- tests/test_admission.py: declared-memory drift at /api/alerts -------

def test_declared_hbm_drift_trips_warn_only_alert(stack, dash_app):
    """The pricer's drift bridged into the TSDB surfaces the warn-only
    declared-hbm-drift SLO at /api/alerts once the windowed mean
    exceeds 20%, and stays warning."""
    from kubeflow_rm_tpu_torch.controlplane import obs
    from kubeflow_rm_tpu_torch.controlplane.webhook.admission_pricer import (
        record_declared_drift,
    )

    rows = [{"preset": "bench_2_7b", "priced_on_chip_peak_gb": 13.24,
             "native_on_chip_peak_gb": 17.2, "delta_pct": 29.9,
             "verdicts_match": True},
            {"preset": "bench_7b", "delta_pct": 4.0}]  # reduced row
    try:
        drift = record_declared_drift(rows)
        assert drift == pytest.approx((17.2 - 13.24) / 13.24)
        o = obs.Observer(interval_s=1.0)
        base = 50_000.0
        for t in (0.0, 30.0, 60.0):   # sustained, not a lone spike
            o.tick(now=base + t)
        client = dash_app(observer=o).test_client(user=USER)
        snap = get_json(client, "/api/alerts")
        active = {a["slo"]: a for a in snap["active"]}
        assert "declared-hbm-drift" in active
        assert active["declared-hbm-drift"]["state"] == "warning"
        assert o.engine.state_of("declared-hbm-drift") == "warning"
        spec = next(s for s in snap["slos"]
                    if s["name"] == "declared-hbm-drift")
        assert spec["threshold"] == pytest.approx(0.2)
    finally:
        record_declared_drift([])   # zero the process-global gauge


# ---- the env-info slice-type rule ---------------------------------------

@pytest.mark.parametrize("hosts,want", [
    ((), []),
    (("h100-80gb-1",), ["h100-80gb-1"]),
    (("h100-80gb-2x4", "h100-80gb-2x4"), ["h100-80gb-2x4", "h100-80gb-4"]),
    (("h100-80gb-8", "h100-80gb-1"),
     ["h100-80gb-1", "h100-80gb-2x8", "h100-80gb-8"]),
])
def test_env_info_slice_types_by_host_shape(stack, dash_app, hosts, want):
    api, _ = stack
    for i, acc in enumerate(hosts):
        api.create(make_gpu_node(f"n{i}", acc))
    info = get_json(dash_app().test_client(user=USER),
                    "/api/workgroup/env-info")
    assert info["tpuSliceTypes"] == want == gpu_api.slice_types_on(
        api.list("Node"))


# ---- parity with JAX's app ---------------------------------------------

def _call(client, method, url, body=None):
    kw = {}
    if body is not None:
        kw = {"data": json.dumps(body),
              "headers": [("Content-Type", "application/json")]}
    resp = client.open(url, method=method, **kw)
    return resp.status_code, json.loads(resp.get_data())


def _keys(obj):
    """The nested key structure of ``obj`` (leaves dropped)."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    return None


def _named(S, url, body, raw):
    """``body`` with the module docstring's named differences taken out;
    what was taken out is kept in ``raw[url]``."""
    from tests.test_torch_obs import text_map

    if url == "/api/metrics":
        per_type = body["tpu"]
        if S.pkg == "jax":
            per_type = {VALUE_MAP.get(k, k): v for k, v in per_type.items()}
        return dict(body, tpu=per_type,
                    controlplane=_keys(body["controlplane"]))
    if url == "/api/metrics/history":
        return dict(body, series=[dict(p, t=None) for p in body["series"]])
    if url == "/api/alerts":
        specs = [{k: v for k, v in s.items()
                  if k not in ("state", "since", "burns")}
                 for s in body["slos"]]
        return {"keys": sorted(body), "tsdb": sorted(body["tsdb"]),
                "flight": sorted(body["flight"]),
                "slos": specs if S.pkg == "port" else text_map(specs)}
    if url == "/api/harvest":
        return {k: (_keys(v) if k in ("grants_total", "reclaims",
                                      "reclaim_seconds_count",
                                      "reclaim_seconds_sum") else v)
                for k, v in body.items()}
    if url == "/api/traces":
        return {k: v for k, v in body.items() if k != "traces"}
    if url == "/api/workgroup/env-info":
        raw[url] = body["tpuSliceTypes"]
        return dict(body, tpuSliceTypes=None)
    return body


def _dashboard_life(S, raw):
    """The dashboard's API through a user's first login: no workgroup,
    the registration, a notebook on two 4-card hosts, then every
    read the SPA makes and the refusals."""
    app = S.m("webapps.dashboard").create_app(S.api, history_interval_s=0)
    try:
        c = app.test_client(user=USER)
        out = [_call(c, "GET", "/api/workgroup/exists"),
               _call(c, "POST", "/api/workgroup/create", {"namespace": NS}),
               _call(c, "POST", "/api/workgroup/create", {})]
        S.run()
        for i in range(2):
            S.node(f"n{i}", SLICE)
        S.api.create(S.notebook("nb", SLICE))
        S.run()
        for url in ("/api/workgroup/exists", "/api/workgroup/env-info",
                    "/api/namespaces", f"/api/activities/{NS}",
                    "/api/dashboard-links", "/api/metrics",
                    "/api/metrics/history", "/api/alerts", "/api/harvest",
                    "/api/traces", "/api/traces/" + "0" * 32,
                    f"/api/workgroup/get-contributors/{NS}",
                    "/api/workgroup/get-all-namespaces",
                    "/api/no/such/route"):
            status, body = _call(c, "GET", url)
            out.append((status, _named(S, url, body, raw[S.pkg])))
        out += [_call(c, "PUT", "/api/namespaces"),
                _call(app.test_client(user=None), "GET", "/api/namespaces")]
        return out
    finally:
        app.metrics_history.stop()


def test_dashboard_life_equals_jax(parity):
    raw = {"port": {}, "jax": {}}
    out, dump = run_full(parity, lambda S: _dashboard_life(S, raw),
                         arms=("cached", "raw"))
    assert [s for s, _ in out] == [200, 200, 400, 200, 200, 200, 200, 200,
                                   200, 200, 200, 200, 200, 404, 200, 403,
                                   404, 405, 401]
    metrics_body = out[8][1]
    assert metrics_body["metrics"] == {
        "nodes": 2, "chips_capacity": 8.0, "chips_requested": 8.0,
        "notebooks_running": 1}
    assert list(metrics_body["tpu"]) == ["nvidia-h100-80gb"]
    # the seed sample, taken when the app was made (a newer one only
    # once it is a second old)
    assert [p["notebooks_running"] for p in out[9][1]["series"]] == [0]
    assert len(dump["Profile"]) == 1
    # the named difference: the port lists the single-host type of the
    # same host shape beside the slice
    key = "/api/workgroup/env-info"
    assert raw["jax"][key] == ["v5p-16"]
    assert raw["port"][key] == ["h100-80gb-2x4", "h100-80gb-4"]
    assert set(raw["port"][key]) - {SLICE} == {"h100-80gb-4"}


def test_metrics_snapshot_keys_equal_jax():
    """Both packages' inventory snapshots (the control-plane section
    included) and Prometheus snapshots have the same keys, at every
    depth."""
    from kubeflow_rm_tpu.controlplane.apiserver import APIServer as JAPI
    from kubeflow_rm_tpu.controlplane.webapps import (
        metrics_service as jms,
    )
    from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer
    from kubeflow_rm_tpu_torch.controlplane.webapps import (
        metrics_service as pms,
    )

    assert _keys(pms.InventoryMetricsService(APIServer()).snapshot()) == \
        _keys(jms.InventoryMetricsService(JAPI()).snapshot())
    gauges = {"tpu_chips_requested": 3.0, "notebook_running": 1.0}
    snaps = []
    for mod in (pms, jms):
        svc = mod.PrometheusMetricsService("http://unused")
        svc._scrape = lambda: dict(gauges)
        snaps.append(svc.snapshot())
    assert _keys(snaps[0]) == _keys(snaps[1])
    assert snaps[0] == snaps[1]


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
    assert not tracing.enabled()
