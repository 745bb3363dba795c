"""The port's browser-facing layer: the SPA shell and static files the
dashboard serves (``controlplane/webapps/static/``), the single-origin
gateway (``webapps/gateway.py``) and the JS↔backend contract — every
case of ``tests/test_frontend.py`` on the port's gateway and the port's
files; each static file equal to JAX's after :data:`WORDS` (the fixed
list of human-visible words) and nothing else; and the same requests
through each package's gateway over each package's
``make_control_plane`` (the parity fixture), whose statuses, content
types and bodies (JSON after the key map, text after :data:`WORDS`) and
object graphs must be equal.

Slice types are the key map's: ``v5p-16`` → ``h100-80gb-2x4``.
"""

import hashlib
import json
import re
import secrets
from pathlib import Path

import pytest

from kubeflow_rm_tpu_torch.controlplane import make_control_plane
from kubeflow_rm_tpu_torch.controlplane.api.meta import deep_get, make_object
from kubeflow_rm_tpu_torch.controlplane.api.profile import make_profile
from kubeflow_rm_tpu_torch.controlplane.controllers.statefulset import (
    make_gpu_node,
)
from kubeflow_rm_tpu_torch.controlplane.webapps import (
    dashboard as dashboard_mod,
)
from kubeflow_rm_tpu_torch.controlplane.webapps.core import (
    CSRF_COOKIE, CSRF_HEADER, USER_HEADER, USER_PREFIX, Client,
)
from kubeflow_rm_tpu_torch.controlplane.webapps.gateway import (
    Dispatcher, make_gateway,
)

from tests.test_frontend import _js_structure_check
from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, NS, jax_switch_defaults, key_map, parity, run_full,
)

USER = "alice@corp.com"
SLICE = "h100-80gb-2x4"
ROOT = Path(__file__).parent.parent
STATIC = ROOT / "kubeflow_rm_tpu_torch/controlplane/webapps/static"
JAX_STATIC = ROOT / "kubeflow_rm_tpu/controlplane/webapps/static"

#: the SPA's human-visible words: JAX's → the port's, file by file (every
#: URL, JSON key, class name and element id stays as it is)
WORDS = {
    "app.js": [
        ("<h2>TPU fleet</h2>", "<h2>GPU fleet</h2>"),
        (" TPU nodes</span>", " GPU nodes</span>"),
        (" chips capacity</span>", " cards capacity</span>"),
        (" chips in use</span>", " cards in use</span>"),
        ("<h3>TPU chips in use</h3>", "<h3>GPU cards in use</h3>"),
        ('unit: "chips",', 'unit: "cards",'),
        ("TPU slices in <b>", "GPU slices in <b>"),
        (">TPU slice<", ">GPU slice<"),
        ("} chips / ", "} cards / "),
        ("— chips, hosts and node", "— cards, hosts and node"),
        ("Slices (DCN-joined)", "Slices (network-joined)"),
        ("One pod per TPU host;", "One pod per GPU host;"),
    ],
    "index.html": [
        ("Kubeflow RM — TPU Notebooks", "Kubeflow RM — GPU Notebooks"),
        ('<span class="accent">/tpu</span>',
         '<span class="accent">/gpu</span>'),
    ],
    # its only TPU-looking words are the ``slice-chip`` class names
    # app.js sets
    "style.css": [],
}


def words(name: str, text: str) -> str:
    for old, new in WORDS.get(name, []):
        text = text.replace(old, new)
    return text


@pytest.fixture
def stack():
    api, mgr = make_control_plane()
    api.create(make_profile("team", USER))
    for i in range(2):
        api.create(make_gpu_node(f"n{i}", SLICE))
    mgr.enqueue_all()
    mgr.run_until_idle()
    return api, mgr


@pytest.fixture
def histories():
    """Dashboards made by a test; each one's history sampler is stopped
    at teardown."""
    apps = []
    yield apps
    for app in apps:
        app.metrics_history.stop()


def gateway_client(api, histories, user=USER):
    gw = make_gateway(api, secure_cookies=False)
    histories.append(gw.app)
    client = Client(gw)
    headers = []
    if user:
        headers.append((USER_HEADER, USER_PREFIX + user))
    token = secrets.token_urlsafe(16)
    client.set_cookie(CSRF_COOKIE, token)
    headers.append((CSRF_HEADER, token))

    class C:
        def open(self, *a, **kw):
            hs = list(kw.pop("headers", []) or []) + headers
            return client.open(*a, headers=hs, **kw)

        def get(self, *a, **kw):
            return self.open(*a, method="GET", **kw)

        def post(self, *a, **kw):
            return self.open(*a, method="POST", **kw)

    return C()


# ---- the SPA's files -----------------------------------------------------

def test_app_js_brackets_balanced():
    # negative controls: the checker must actually catch breakage
    for bad in ("function f() { if (x) { g(); }",
                "const s = `a ${b ? 'x' : 'y'`;",
                "f(]"):
        with pytest.raises(AssertionError):
            _js_structure_check(bad)
    _js_structure_check((STATIC / "app.js").read_text())


def test_static_files_are_jax_after_the_word_list():
    """The port's files are JAX's with only :data:`WORDS` changed: each
    word of the list occurs in JAX's file and not in the port's, and the
    port's files hold no other TPU word."""
    names = sorted(p.name for p in JAX_STATIC.iterdir())
    assert sorted(p.name for p in STATIC.iterdir()) == names == sorted(WORDS)
    for name in names:
        jax, port = (JAX_STATIC / name).read_text(), \
            (STATIC / name).read_text()
        assert port == words(name, jax), name
        for old, new in WORDS[name]:
            assert old in jax and old not in port and new in port
    visible = re.compile(r"\bTPU\b|\bchips\b(?! *[\]:,.)?}\"']|_)")
    for name in names:
        text = (STATIC / name).read_text()
        assert not visible.findall(text), (name, visible.findall(text))


# ---- SPA shell -------------------------------------------------------

def test_index_serves_spa_and_sets_csrf_cookie(stack, histories):
    api, _ = stack
    app = dashboard_mod.create_app(api, secure_cookies=False)
    histories.append(app)
    resp = app.test_client(user=None).get("/")
    assert resp.status_code == 200
    assert resp.mimetype == "text/html"
    assert resp.headers["Content-Type"] == "text/html; charset=utf-8"
    assert b'src="/static/app.js"' in resp.get_data()
    cookie = resp.headers.get("Set-Cookie", "")
    assert CSRF_COOKIE in cookie


def test_static_assets_served_with_mimetypes(stack, histories):
    api, _ = stack
    app = dashboard_mod.create_app(api)
    histories.append(app)
    client = app.test_client(user=None)
    js = client.get("/static/app.js")
    assert js.mimetype in ("text/javascript", "application/javascript")
    assert js.headers["Content-Type"] == js.mimetype + "; charset=utf-8"
    css = client.get("/static/style.css")
    assert css.mimetype == "text/css"
    assert css.headers["Content-Type"] == "text/css; charset=utf-8"
    assert client.get("/static/nope.js").status_code == 404


def test_static_path_traversal_blocked(stack, histories):
    api, _ = stack
    app = dashboard_mod.create_app(api)
    histories.append(app)
    resp = app.test_client(user=None).get("/static/../../apiserver.py")
    assert resp.status_code == 404
    assert resp.json["log"] == "no static file ../../apiserver.py"


# ---- gateway ---------------------------------------------------------

def test_gateway_path_routes_every_webapp(stack, histories):
    api, _ = stack
    c = gateway_client(api, histories)
    assert json.loads(c.get("/jupyter/api/config").get_data())["config"]
    assert "tpus" in json.loads(c.get("/jupyter/api/tpus").get_data())
    assert "pvcs" in json.loads(
        c.get("/volumes/api/namespaces/team/pvcs").get_data())
    assert "tensorboards" in json.loads(
        c.get("/tensorboards/api/namespaces/team/tensorboards").get_data())
    assert "bindings" in json.loads(
        c.get("/kfam/kfam/v1/bindings?namespace=team").get_data())
    assert "namespaces" in json.loads(c.get("/api/namespaces").get_data())


def test_gateway_spawn_through_browser_contract(stack, histories):
    """The exact request sequence app.js makes to spawn a notebook."""
    api, mgr = stack
    c = gateway_client(api, histories)
    tpus = json.loads(c.get("/jupyter/api/tpus").get_data())["tpus"]
    accel = tpus[0]["acceleratorType"]
    body = {
        "name": "from-spa",
        "image": "ghcr.io/kubeflow-rm-tpu/jupyter-jax:latest",
        "imagePullPolicy": "IfNotPresent", "serverType": "jupyter",
        "cpu": "4", "memory": "16Gi",
        "tpu": {"acceleratorType": accel},
        "tolerationGroup": "none", "affinityConfig": "none",
        "configurations": [], "shm": True, "environment": {},
        "datavols": [],
    }
    resp = c.post("/jupyter/api/namespaces/team/notebooks",
                  data=json.dumps(body),
                  headers=[("Content-Type", "application/json")])
    assert resp.status_code == 200, resp.get_data()
    mgr.run_until_idle()
    nbs = json.loads(c.get(
        "/jupyter/api/namespaces/team/notebooks").get_data())["notebooks"]
    assert nbs[0]["status"]["phase"] == "ready"
    # per-ordinal logs through the gateway, as the detail view fetches
    logs = json.loads(c.get(
        "/jupyter/api/namespaces/team/notebooks/from-spa/pods/0/logs"
    ).get_data())["logs"]
    assert any("TPU_WORKER_ID=0" in line for line in logs)


def test_gateway_spawn_with_advanced_options(stack, histories):
    """The advanced form section's body shape: PodDefault
    configurations, data volumes (existing + new PVC), toleration
    group, env vars — each must land on the rendered pods."""
    api, mgr = stack
    # a PodDefault + an existing PVC to attach
    pd = make_object("kubeflow.org/v1alpha1", "PodDefault", "gcs-creds",
                     "team")
    pd["spec"] = {
        "desc": "GCS credentials",
        "selector": {"matchLabels": {"use-gcs-creds": "true"}},
        "env": [{"name": "GOOGLE_CLOUD_PROJECT", "value": "proj"}],
    }
    api.create(pd)
    pvc = make_object("v1", "PersistentVolumeClaim", "datasets", "team")
    pvc["spec"] = {"resources": {"requests": {"storage": "10Gi"}},
                   "accessModes": ["ReadWriteOnce"]}
    api.create(pvc)

    c = gateway_client(api, histories)
    pds = json.loads(c.get(
        "/jupyter/api/namespaces/team/poddefaults").get_data())["poddefaults"]
    label_key = list(pds[0]["label"])[0]
    body = {
        "name": "adv",
        "image": "ghcr.io/kubeflow-rm-tpu/jupyter-jax:latest",
        "imagePullPolicy": "IfNotPresent", "serverType": "jupyter",
        "cpu": "4", "memory": "16Gi",
        "tpu": {"acceleratorType": SLICE},
        "tolerationGroup": "tpu-preemptible", "affinityConfig": "none",
        "configurations": [label_key], "shm": True,
        "environment": {"HF_HOME": "/home/jovyan/.cache"},
        "datavols": [
            {"mount": "/data", "existingSource": {
                "persistentVolumeClaim": {"claimName": "datasets"}}},
            {"mount": "/scratch", "newPvc": {
                "metadata": {"name": "{notebook-name}-scratch"},
                "spec": {"resources": {"requests": {"storage": "5Gi"}},
                         "accessModes": ["ReadWriteOnce"]}}},
        ],
    }
    resp = c.post("/jupyter/api/namespaces/team/notebooks",
                  data=json.dumps(body),
                  headers=[("Content-Type", "application/json")])
    assert resp.status_code == 200, resp.get_data()
    mgr.run_until_idle()

    pods = [p for p in api.list("Pod", "team")
            if p["metadata"]["name"].startswith("adv-")]
    assert len(pods) == 2
    for pod in pods:
        env = {e["name"]: e.get("value")
               for cont in pod["spec"]["containers"]
               for e in cont.get("env", [])}
        assert env["HF_HOME"] == "/home/jovyan/.cache"
        assert env["GOOGLE_CLOUD_PROJECT"] == "proj"  # PodDefault merged
        mounts = {m["mountPath"] for cont in pod["spec"]["containers"]
                  for m in cont.get("volumeMounts", [])}
        assert {"/data", "/scratch"} <= mounts
        tol = deep_get(pod, "spec", "tolerations", default=[]) or []
        assert any(t.get("key") == "cloud.google.com/gke-preemptible"
                   for t in tol)
    assert api.try_get("PersistentVolumeClaim", "adv-scratch", "team")


def test_gateway_csrf_enforced(stack, histories):
    api, _ = stack
    gw = make_gateway(api)
    histories.append(gw.app)
    resp = Client(gw).post("/jupyter/api/namespaces/team/notebooks",
                           headers=[(USER_HEADER, USER_PREFIX + USER)])
    assert resp.status_code == 403  # no CSRF cookie/header pair


def test_gateway_dev_user_injects_identity(stack, histories):
    api, _ = stack
    gw = make_gateway(api, dev_user=USER, secure_cookies=False)
    histories.append(gw.app)
    client = Client(gw)
    data = json.loads(client.get("/jupyter/api/namespaces").get_data())
    assert data["user"] == USER
    # a client-supplied header cannot impersonate another user
    forged = client.get("/jupyter/api/namespaces",
                        headers=[(USER_HEADER, USER_PREFIX + "eve@x.y")])
    assert json.loads(forged.get_data())["user"] == USER


@pytest.mark.parametrize("path,script,app,rest", [
    ("/jupyter/api/tpus", "/jupyter", "/jupyter", "/api/tpus"),
    ("/jupyter", "/jupyter", "/jupyter", ""),
    ("/jupyter/", "/jupyter", "/jupyter", "/"),
    ("/kfam/kfam/v1/bindings", "/kfam", "/kfam", "/kfam/v1/bindings"),
    ("/jupyterx/a", "", "", "/jupyterx/a"),
    ("/api/namespaces", "", "", "/api/namespaces"),
    ("/", "", "", "/"),
    ("/a/b", "/a/b", "/a/b", ""),
    ("/a/b/c", "/a/b", "/a/b", "/c"),
    ("/a/c", "/a", "/a", "/c"),
])
def test_dispatcher_as_werkzeug_dispatches(path, script, app, rest):
    """The longest mount prefix wins and moves into ``SCRIPT_NAME``, as
    in werkzeug's ``DispatcherMiddleware``, which gives the same."""
    from werkzeug.middleware.dispatcher import DispatcherMiddleware

    def named(name):
        def wsgi(environ, start_response):
            return [name, environ["SCRIPT_NAME"], environ["PATH_INFO"]]
        return wsgi

    mounts = {m: named(m) for m in ("/jupyter", "/kfam", "/a", "/a/b")}
    got = []
    for disp in (Dispatcher(named(""), mounts),
                 DispatcherMiddleware(named(""), mounts)):
        got.append(disp({"PATH_INFO": path, "SCRIPT_NAME": "/gw"}, None))
    assert got[0] == got[1] == [app, "/gw" + script, rest]


# ---- JS <-> backend contract ----------------------------------------

def _routes_of(app):
    return {rule.rule for rule in app._rules}


def test_spa_urls_exist_in_backends(stack, histories):
    """Every literal API path referenced in app.js must match a route
    in the web app it targets (template params normalized)."""
    api, _ = stack
    from kubeflow_rm_tpu_torch.controlplane.webapps import (
        jupyter as jwa, kfam, tensorboards as twa, volumes as vwa,
    )
    dash = dashboard_mod.create_app(api)
    histories.append(dash)
    route_maps = {
        "/jupyter": _routes_of(jwa.create_app(api)),
        "/volumes": _routes_of(vwa.create_app(api)),
        "/tensorboards": _routes_of(twa.create_app(api)),
        "/kfam": _routes_of(kfam.create_app(api)),
        "": _routes_of(dash),
    }
    js = (STATIC / "app.js").read_text()
    called = re.findall(r'["`](/(?:jupyter|volumes|tensorboards|kfam|api)'
                        r'[^"`\s?]*)["`?]', js)
    assert called, "no API calls found in app.js — regex drift?"
    for url in called:
        prefix = ""
        for p in ("/jupyter", "/volumes", "/tensorboards", "/kfam"):
            if url.startswith(p):
                prefix, url = p, url[len(p):]
                break
        # normalize JS template holes (${...}) to a wildcard segment
        pattern = "^" + re.escape(url).replace(
            re.escape("${"), "X").replace(re.escape("}"), "X") + "$"
        pattern = re.sub(r"X[^/]*X", "[^/]+", pattern)
        routes = route_maps[prefix]
        normalized = {re.sub(r"<[^>]+>", "[^/]+", r) for r in routes}
        assert any(re.fullmatch(n, url) for n in normalized), (
            f"app.js calls {prefix}{url} but no backend route matches")


def test_route_maps_equal_jax(stack, histories):
    """Each app's rules are JAX's, so the SPA's calls reach the same
    routes in both packages."""
    from kubeflow_rm_tpu.controlplane import make_control_plane as jax_cp
    from tests.torch_cp_parity import cp_module

    japi, _ = jax_cp()
    api, _ = stack
    for name in ("jupyter", "volumes", "tensorboards", "kfam", "dashboard"):
        papp = cp_module("port", f"webapps.{name}").create_app(api)
        japp = cp_module("jax", f"webapps.{name}").create_app(japi)
        if name == "dashboard":
            histories.append(papp)
            japp.metrics_history.stop()
        assert _routes_of(papp) == {r.rule for r in japp._map.iter_rules()}


# ---- parity through each package's gateway --------------------------------

def _client(S, app):
    """A cookie-keeping test client of ``app`` on ``S``'s side."""
    if S.pkg == "jax":
        from werkzeug.test import Client as WClient
        return WClient(app)
    return Client(app)


def _request(S, client, method, url, body=None, headers=()):
    """(status, content type, body): JSON bodies decoded, any other the
    sha256 of its text after :data:`WORDS` on JAX's side."""
    hs = list(headers)
    kw = {}
    if body is not None:
        kw["data"] = json.dumps(body)
        hs.append(("Content-Type", "application/json"))
    resp = client.open(url, method=method, headers=hs, **kw)
    ctype = resp.headers["Content-Type"]
    raw = resp.get_data()
    if ctype == "application/json":
        return resp.status_code, ctype, json.loads(raw)
    text = raw.decode()
    if S.pkg == "jax":
        text = words(url.rsplit("/", 1)[-1] or "index.html", text)
    return resp.status_code, ctype, hashlib.sha256(text.encode()).hexdigest()


def _gateway_life(S):
    """The SPA's session through the gateway, as ``app.js`` drives it:
    the shell and its files, the workgroup, the spawner's config and
    types, a spawn, the listing and one ordinal's logs, each satellite
    app's listing, the refusals; then the same under ``dev_user``."""
    S.api.ensure_namespace("kubeflow")
    for i in range(2):
        S.node(f"n{i}", SLICE)
    gw = S.m("webapps.gateway").make_gateway(S.api, secure_cookies=False)
    dash = gw.app
    try:
        token = "spa-token"
        auth = [(USER_HEADER, USER_PREFIX + USER), (CSRF_HEADER, token)]
        shell = _client(S, gw)
        out = [_request(S, shell, "GET", "/"),
               _request(S, shell, "GET", "/static/app.js"),
               _request(S, shell, "GET", "/static/style.css"),
               _request(S, shell, "GET", "/static/nope.js"),
               _request(S, shell, "GET", "/static/../../apiserver.py"),
               _request(S, shell, "GET", "/static/")]
        c = _client(S, gw)
        if S.pkg == "jax":
            c.set_cookie(CSRF_COOKIE, token, path="/")
        else:
            c.set_cookie(CSRF_COOKIE, token)
        out += [_request(S, c, "POST", "/api/workgroup/create",
                         {"namespace": NS}, auth)]
        S.run()
        base = f"/jupyter/api/namespaces/{NS}/notebooks"
        named = [_request(S, c, "GET", "/api/workgroup/env-info", None,
                          auth),
                 _request(S, c, "GET", "/jupyter/api/config", None, auth),
                 _request(S, c, "GET", "/jupyter/api/tpus", None, auth)]
        S.named = [body for _, _, body in named]
        out += [(status, ctype, sorted(body)) for status, ctype, body in named]
        out += [
                _request(S, c, "POST", base, {
                    "name": "from-spa", "image": "img:latest",
                    "imagePullPolicy": "IfNotPresent",
                    "serverType": "jupyter", "cpu": "4", "memory": "16Gi",
                    "tpu": {"acceleratorType": S.slice(SLICE)},
                    "tolerationGroup": "none", "affinityConfig": "none",
                    "configurations": [], "shm": True, "environment": {},
                    "datavols": []}, auth)]
        S.run()
        out += [_request(S, c, "GET", base, None, auth),
                _request(S, c, "GET", f"{base}/from-spa/pods/0/logs", None,
                         auth),
                _request(S, c, "GET", f"/volumes/api/namespaces/{NS}/pvcs",
                         None, auth),
                _request(S, c, "GET",
                         f"/tensorboards/api/namespaces/{NS}/tensorboards",
                         None, auth),
                _request(S, c, "GET", f"/kfam/kfam/v1/bindings?namespace={NS}",
                         None, auth),
                _request(S, c, "GET", "/jupyter", None, auth),
                _request(S, c, "GET", "/jupyter/", None, auth),
                _request(S, c, "GET", "/jupyterx/api/tpus", None, auth),
                _request(S, c, "POST", base, {}, auth[:1]),
                _request(S, c, "GET", "/api/namespaces")]
        dev = S.m("webapps.gateway").make_gateway(
            S.api, dev_user=USER, secure_cookies=False)
        dash_dev = getattr(dev, "app", None)
        try:
            d = _client(S, dev)
            out += [_request(S, d, "GET", f"{base}/from-spa", None,
                             [(USER_HEADER, USER_PREFIX + "eve@x.y")]),
                    _request(S, d, "GET", "/api/workgroup/exists")]
        finally:
            # JAX's dev gateway hides its dashboard: its sampler thread
            # starts only on a history read, which this script makes not
            if dash_dev is not None:
                dash_dev.metrics_history.stop()
        return out
    finally:
        dash.metrics_history.stop()


def test_gateway_life_equals_jax(parity):
    """The named differences are the slice types a 4-card host offers
    (the env-info list and ``/api/tpus``: the port's host labels name a
    host's shape, so ``h100-80gb-4`` beside ``h100-80gb-2x4``) and the
    spawner config's types without a counterpart (held to JAX's in
    ``test_torch_webapps_jupyter.py``): those three bodies are compared
    by their keys, and their values below."""
    named = {}

    def script(S):
        out = _gateway_life(S)
        named[S.pkg] = S.named
        return out

    out, dump = run_full(parity, script, arms=("cached", "raw"))
    (pinfo, pcfg, ptpus), (jinfo, jcfg, jtpus) = named["port"], named["jax"]
    assert jinfo["tpuSliceTypes"] == ["v5p-16"]
    assert pinfo["tpuSliceTypes"] == ["h100-80gb-2x4", "h100-80gb-4"]
    assert dict(pinfo, tpuSliceTypes=None) == key_map(
        dict(jinfo, tpuSliceTypes=None))
    assert [t["acceleratorType"] for t in jtpus["tpus"]] == ["v5p-16"]
    assert ptpus["tpus"] == key_map(
        [{"acceleratorType": "h100-80gb-4", "chips": 4, "hosts": 1,
          "topology": "4"}] + jtpus["tpus"])
    assert pcfg["config"]["tpu"]["options"] == [
        "none", "h100-80gb-1", "h100-80gb-4", "h100-80gb-8",
        "h100-80gb-2x4"]
    assert [s for s, _, _ in out] == [200, 200, 200, 404, 404, 404, 200,
                                      200, 200, 200, 200, 200, 200, 200,
                                      200, 200, 404, 404, 404, 403, 401,
                                      200, 200]
    assert [t for _, t, _ in out[:3]] == [
        "text/html; charset=utf-8", "text/javascript; charset=utf-8",
        "text/css; charset=utf-8"]
    assert out[11][2]["notebooks"][0]["status"]["phase"] == "ready"
    assert out[21][2]["user"] == USER == out[22][2]["user"]
    assert [nb["metadata"]["name"] for nb in dump["Notebook"]] == [
        "from-spa"]


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
