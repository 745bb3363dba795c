"""The port's volumes and tensorboards web apps and its KFAM REST service
(``controlplane/webapps/{volumes,tensorboards,kfam}.py``) and the kit
under them (``core.py``, the standard-library WSGI surface of
``serving.py``), held to JAX's: every case of
``tests/test_satellite_webapps.py`` on the port's stack; for each app
the same requests against each package's app over each package's
``make_control_plane`` (the parity fixture), whose status codes, JSON
bodies and whole object graphs must be equal after the TPU→GPU key map;
the kit's router, envelopes and CSRF cookie against JAX's werkzeug app;
and every status the web apps answer through ``respond``.
"""

import json

import pytest

from kubeflow_rm_tpu_torch.controlplane import make_control_plane
from kubeflow_rm_tpu_torch.controlplane.api.meta import deep_get, make_object
from kubeflow_rm_tpu_torch.controlplane.webapps import (
    WebApp, kfam, tensorboards, volumes,
)

from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, NS, jax_switch_defaults, parity, run_full,
)

USER = "alice@corp.com"


def grant_admin(api, ns, user=USER, mk=make_object):
    rb = mk("rbac.authorization.k8s.io/v1", "RoleBinding",
            f"grant-{user.split('@')[0]}", ns)
    rb["roleRef"] = {"kind": "ClusterRole", "name": "kubeflow-admin"}
    rb["subjects"] = [{"kind": "User", "name": user}]
    api.create(rb)


@pytest.fixture
def stack():
    api, mgr = make_control_plane()
    api.ensure_namespace("team")
    grant_admin(api, "team")
    return api, mgr


def post_json(client, url, body):
    return client.post(url, data=json.dumps(body),
                       headers=[("Content-Type", "application/json")])


# ---- volumes (tests/test_satellite_webapps.py) -------------------------

def test_pvc_crud_and_viewer_flow(stack):
    api, mgr = stack
    app = volumes.create_app(api)
    client = app.test_client(user=USER)

    resp = post_json(client, "/api/namespaces/team/pvcs", {
        "pvc": {"metadata": {"name": "data"},
                "spec": {"accessModes": ["ReadWriteOnce"],
                         "resources": {"requests": {"storage": "5Gi"}}}}})
    assert resp.status_code == 200, resp.get_data()

    resp = post_json(client, "/api/namespaces/team/viewers/data", {})
    assert resp.status_code == 200
    mgr.run_until_idle()
    deploy = api.get("Deployment", "data-pvcviewer", "team")
    assert "filebrowser" in deep_get(deploy, "spec", "template", "spec",
                                     "containers", 0, "image")

    listing = json.loads(client.get(
        "/api/namespaces/team/pvcs").get_data())["pvcs"]
    assert listing[0]["pvc"]["metadata"]["name"] == "data"
    assert listing[0]["viewer"] is not None

    # a mounted PVC cannot be deleted
    pod = make_object("v1", "Pod", "user-pod", "team")
    pod["spec"] = {"containers": [{"name": "c", "image": "i"}],
                   "volumes": [{"name": "v", "persistentVolumeClaim":
                                {"claimName": "data"}}]}
    api.create(pod)
    resp = client.delete("/api/namespaces/team/pvcs/data")
    assert resp.status_code == 409
    api.delete("Pod", "user-pod", "team")
    resp = client.delete("/api/namespaces/team/pvcs/data")
    assert resp.status_code == 200
    assert api.try_get("PersistentVolumeClaim", "data", "team") is None
    assert api.try_get("PVCViewer", "data", "team") is None


# ---- tensorboards ----------------------------------------------------

def test_tensorboard_crud(stack):
    api, mgr = stack
    app = tensorboards.create_app(api)
    client = app.test_client(user=USER)

    resp = post_json(client, "/api/namespaces/team/tensorboards",
                     {"name": "tb", "logspath": "gs://bucket/logs"})
    assert resp.status_code == 200, resp.get_data()
    mgr.run_until_idle()
    listing = json.loads(client.get(
        "/api/namespaces/team/tensorboards").get_data())["tensorboards"]
    assert listing[0]["logspath"] == "gs://bucket/logs"
    assert listing[0]["status"]["phase"] == "ready"

    resp = post_json(client, "/api/namespaces/team/tensorboards",
                     {"name": "bad", "logspath": "/local/path"})
    assert resp.status_code == 400

    assert client.delete(
        "/api/namespaces/team/tensorboards/tb").status_code == 200
    assert api.try_get("Tensorboard", "tb", "team") is None


# ---- KFAM ------------------------------------------------------------

def test_kfam_contributor_binding_grants_access(stack):
    api, _ = stack
    app = kfam.create_app(api)
    client = app.test_client(user=USER)

    assert not api.access_review("bob@corp.com", "list", "notebooks",
                                 "team")
    resp = post_json(client, "/kfam/v1/bindings", {
        "user": {"kind": "User", "name": "bob@corp.com"},
        "referredNamespace": "team",
        "roleRef": {"kind": "ClusterRole", "name": "edit"}})
    assert resp.status_code == 200, resp.get_data()

    # the RoleBinding it wrote is live RBAC: bob can now act in team
    assert api.access_review("bob@corp.com", "list", "notebooks", "team")
    # and the istio AuthorizationPolicy admits bob's identity header
    ap = api.get("AuthorizationPolicy",
                 kfam.binding_name("bob@corp.com", "edit"), "team")
    when = deep_get(ap, "spec", "rules", 0, "when", 0)
    assert when["values"] == [":bob@corp.com"]

    listing = json.loads(client.get(
        "/kfam/v1/bindings?namespace=team").get_data())["bindings"]
    assert any(b["user"]["name"] == "bob@corp.com" for b in listing)

    resp = client.open("/kfam/v1/bindings", method="DELETE",
                       data=json.dumps({
                           "user": {"kind": "User",
                                    "name": "bob@corp.com"},
                           "referredNamespace": "team",
                           "roleRef": {"kind": "ClusterRole",
                                       "name": "edit"}}),
                       headers=[("Content-Type", "application/json")])
    assert resp.status_code == 200
    assert not api.access_review("bob@corp.com", "list", "notebooks",
                                 "team")

    # the reference KFAM's prometheus surface (monitoring.go:46-77):
    # per-action counters, scraped from this app's own /metrics
    text = client.get("/metrics").get_data(as_text=True)
    assert 'kfam_requests_total{action="create_binding",' \
           'result="success"}' in text
    assert 'kfam_requests_total{action="delete_binding",' \
           'result="success"}' in text


def test_kfam_bindings_listing_is_scoped_to_callers_namespaces(stack):
    """GET /kfam/v1/bindings must not enumerate every namespace's grants
    for any authenticated user."""
    api, _ = stack
    api.ensure_namespace("secret-team")
    grant_admin(api, "secret-team", "mallory@corp.com")
    app = kfam.create_app(api)

    # alice (admin only in "team") can't read secret-team's bindings
    client = app.test_client(user=USER)
    resp = client.get("/kfam/v1/bindings?namespace=secret-team")
    assert resp.status_code == 403
    # and the cluster-wide listing silently omits secret-team
    listing = json.loads(
        client.get("/kfam/v1/bindings").get_data())["bindings"]
    assert all(b["referredNamespace"] != "secret-team" for b in listing)

    # an anonymous caller gets 401 everywhere
    anon = app.test_client(user=None)
    assert anon.get(
        "/kfam/v1/bindings?namespace=team").status_code == 401


def test_kfam_profile_creation_requires_self_or_rbac(stack):
    """POST /kfam/v1/profiles with a foreign owner needs create-profiles
    RBAC; self-registration stays open."""
    from kubeflow_rm_tpu_torch.controlplane.api.profile import make_profile

    api, _ = stack
    app = kfam.create_app(api)
    client = app.test_client(user=USER)

    # foreign owner -> 403
    resp = post_json(client, "/kfam/v1/profiles", {
        "metadata": {"name": "evil"},
        "spec": {"owner": {"kind": "User", "name": "victim@corp.com"}}})
    assert resp.status_code == 403
    assert api.try_get("Profile", "evil") is None

    # self-registration -> 200 (dashboard workgroup flow)
    resp = post_json(client, "/kfam/v1/profiles", {
        "metadata": {"name": "alice-ns"},
        "spec": {"owner": {"kind": "User", "name": USER}}})
    assert resp.status_code == 200

    # GET profiles: alice sees her own, not others'
    api.create(make_profile("bobs", "bob@corp.com"))
    got = json.loads(client.get("/kfam/v1/profiles").get_data())
    names = {p["metadata"]["name"] for p in got["profiles"]}
    assert "alice-ns" in names and "bobs" not in names


def test_kfam_profile_lifecycle_and_clusteradmin(stack):
    api, mgr = stack
    app = kfam.create_app(api)
    client = app.test_client(user=USER)

    resp = post_json(client, "/kfam/v1/profiles", {
        "metadata": {"name": "alice"},
        "spec": {"owner": {"kind": "User", "name": USER}}})
    assert resp.status_code == 200
    mgr.enqueue_all()
    mgr.run_until_idle()
    assert api.get("Namespace", "alice")

    admin = json.loads(client.get(
        "/kfam/v1/role/clusteradmin").get_data())["clusteradmin"]
    assert admin is False
    crb = make_object("rbac.authorization.k8s.io/v1", "ClusterRoleBinding",
                      "alice-admin")
    crb["roleRef"] = {"kind": "ClusterRole", "name": "cluster-admin"}
    crb["subjects"] = [{"kind": "User", "name": USER}]
    api.create(crb)
    admin = json.loads(client.get(
        "/kfam/v1/role/clusteradmin").get_data())["clusteradmin"]
    assert admin is True

    # the owner may delete their own profile
    resp = client.delete("/kfam/v1/profiles/alice")
    assert resp.status_code == 200
    mgr.run_until_idle()
    assert api.try_get("Profile", "alice") is None


# ---- parity with JAX's apps ------------------------------------------

def _call(client, method, url, body=None):
    kw = {}
    if body is not None:
        kw = {"data": json.dumps(body),
              "headers": [("Content-Type", "application/json")]}
    resp = client.open(url, method=method, **kw)
    return resp.status_code, json.loads(resp.get_data())


def _setup(S):
    S.api.ensure_namespace(NS)
    grant_admin(S.api, NS, mk=S.m("api.meta").make_object)


def _volumes_life(S):
    _setup(S)
    c = S.m("webapps.volumes").create_app(S.api).test_client(user=USER)
    base = f"/api/namespaces/{NS}"
    pvc = {"metadata": {"name": "data"},
           "spec": {"accessModes": ["ReadWriteOnce"],
                    "resources": {"requests": {"storage": "5Gi"}}}}
    out = [_call(c, "POST", f"{base}/pvcs", {"pvc": pvc}),
           _call(c, "POST", f"{base}/pvcs", {"pvc": {"spec": {}}}),
           _call(c, "POST", f"{base}/pvcs", {"pvc": pvc}),
           _call(c, "POST", f"{base}/viewers/data", {}),
           _call(c, "POST", f"{base}/viewers/none", {})]
    S.run()
    out.append(_call(c, "GET", f"{base}/pvcs"))
    pod = S.m("api.meta").make_object("v1", "Pod", "user-pod", NS)
    pod["spec"] = {"containers": [{"name": "c", "image": "i"}],
                   "volumes": [{"name": "v", "persistentVolumeClaim":
                                {"claimName": "data"}}]}
    S.api.create(pod)
    out += [_call(c, "GET", f"{base}/pvcs"),
            _call(c, "DELETE", f"{base}/pvcs/data")]
    S.run()
    S.api.delete("Pod", "user-pod", NS)
    out += [_call(c, "DELETE", f"{base}/pvcs/data"),
            _call(c, "DELETE", f"{base}/viewers/data")]
    S.run()
    out.append(_call(c, "GET", f"{base}/pvcs"))
    return out


def _tensorboards_life(S):
    _setup(S)
    c = S.m("webapps.tensorboards").create_app(S.api).test_client(
        user=USER)
    base = f"/api/namespaces/{NS}/tensorboards"
    out = [_call(c, "POST", base, {"name": "tb",
                                   "logspath": "gs://bucket/logs"}),
           _call(c, "POST", base, {"name": "pv",
                                   "logspath": "pvc://claim/runs"}),
           _call(c, "POST", base, {"name": "bad", "logspath": "/local"}),
           _call(c, "POST", base, {"name": "nolog"})]
    S.run()
    out += [_call(c, "GET", base), _call(c, "DELETE", f"{base}/tb"),
            _call(c, "DELETE", f"{base}/tb")]
    S.run()
    out.append(_call(c, "GET", base))
    return out


def _kfam_life(S):
    _setup(S)
    S.api.ensure_namespace("secret-team")
    grant_admin(S.api, "secret-team", "mallory@corp.com",
                mk=S.m("api.meta").make_object)
    app = S.m("webapps.kfam").create_app(S.api)
    c = app.test_client(user=USER)
    binding = {"user": {"kind": "User", "name": "bob@corp.com"},
               "referredNamespace": NS,
               "roleRef": {"kind": "ClusterRole", "name": "edit"}}
    out = [_call(c, "POST", "/kfam/v1/bindings", binding),
           _call(c, "POST", "/kfam/v1/bindings",
                 dict(binding, roleRef={"name": "owner"})),
           _call(c, "POST", "/kfam/v1/bindings", {"user": {}}),
           _call(c, "GET", f"/kfam/v1/bindings?namespace={NS}"),
           _call(c, "GET", "/kfam/v1/bindings?namespace=secret-team"),
           _call(c, "GET", "/kfam/v1/bindings"),
           _call(c, "GET", "/kfam/v1/bindings?user=bob@corp.com&role=edit"),
           _call(c, "POST", "/kfam/v1/profiles", {
               "metadata": {"name": "evil"},
               "spec": {"owner": {"kind": "User",
                                  "name": "victim@corp.com"}}}),
           _call(c, "POST", "/kfam/v1/profiles", {
               "metadata": {"name": "alice"},
               "spec": {"owner": {"kind": "User", "name": USER}}}),
           _call(c, "POST", "/kfam/v1/profiles", {"metadata": {}})]
    S.run()
    out += [_call(c, "GET", "/kfam/v1/profiles"),
            _call(c, "GET", "/kfam/v1/role/clusteradmin"),
            _call(c, "GET", "/kfam/v1/role/clusteradmin?user=bob@corp.com"),
            _call(c, "DELETE", "/kfam/v1/bindings", binding),
            _call(c, "DELETE", "/kfam/v1/profiles/alice"),
            _call(app.test_client(user="bob@corp.com"), "DELETE",
                  "/kfam/v1/profiles/alice"),
            _call(app.test_client(user=None), "GET", "/kfam/v1/bindings")]
    S.run()
    return out


@pytest.mark.parametrize("script,codes", [
    # the PVC's delete takes its viewer along; bob may not delete the
    # profile alice's delete left finalizing
    (_volumes_life, [200, 400, 409, 200, 404, 200, 200, 409, 200, 404,
                     200]),
    (_tensorboards_life, [200, 200, 400, 400, 200, 200, 404, 200]),
    (_kfam_life, [200, 400, 400, 200, 403, 200, 200, 403, 200, 400, 200,
                  200, 200, 200, 200, 403, 401]),
], ids=["volumes", "tensorboards", "kfam"])
def test_app_life_equals_jax(parity, script, codes):
    out, _ = run_full(parity, script, arms=("cached", "raw"))
    assert [s for s, _ in out] == codes


def test_kfam_counter_in_jax_name():
    """``kfam_requests_total{action,result}`` in the port's registry, as
    JAX's ``controlplane/metrics.py:54-59`` declares it."""
    from kubeflow_rm_tpu.controlplane import metrics as jm
    from kubeflow_rm_tpu_torch.controlplane import metrics as pm

    j, p = jm.KFAM_REQUESTS_TOTAL, pm.KFAM_REQUESTS_TOTAL
    assert p.series_name() == "kfam_requests_total"
    assert j._name == "kfam_requests"   # prometheus_client drops _total
    assert p.labelnames == tuple(j._labelnames) == ("action", "result")
    assert p.documentation == j._documentation


# ---- the kit: router, envelopes, CSRF, statuses ------------------------

def _kit_app(pkg):
    from tests.torch_cp_parity import cp_module

    core = cp_module(pkg, "webapps.core")
    api = cp_module(pkg, "apiserver").APIServer()
    api.ensure_namespace("team")
    app = core.WebApp("kit", api, prefix="/kit")

    @app.route("/things/<name>", methods=("GET", "POST"))
    def thing(req, name):
        if req.method == "POST":
            return {"posted": name, "body": core.json_body(req)}
        return {"name": name, "q": req.args.get("q"),
                "first": req.args.get("k"), "blank": req.args.get("b")}

    @app.route("/raise/<what>")
    def boom(req, what):
        errs = cp_module(pkg, "apiserver")
        raise {"notfound": errs.NotFound("Thing team/x not found"),
               "exists": errs.AlreadyExists("Thing team/x exists"),
               "invalid": errs.Invalid("bad spec"),
               "denied": errs.AdmissionDenied("webhook said no"),
               "conflict": errs.Conflict("stale resourceVersion"),
               "other": RuntimeError("boom")}[what]

    @app.route("/tuple")
    def tup(req):
        return {"made": True}, 201

    @app.route("/authz")
    def authz(req):
        app.ensure_authorized(req, "list", "notebooks", "team")
        return {"ok": True}

    return app


KIT_REQUESTS = [
    ("GET", "/kit/things/a?q=1&k=x&k=y&b=", None),
    ("POST", "/kit/things/a", {"v": 1}),
    ("POST", "/kit/things/a", "not json"),
    ("GET", "/kit/things/a/b", None),
    ("DELETE", "/kit/things/a", None),
    ("GET", "/kit/nothing", None),
    ("GET", "/things/a", None),
    ("GET", "/kit/healthz", None),
    ("GET", "/kit/readyz", None),
    ("GET", "/kit/tuple", None),
    ("GET", "/kit/authz", None),
    ("HEAD", "/kit/things/a", None),
] + [("GET", f"/kit/raise/{w}", None) for w in (
    "notfound", "exists", "invalid", "denied", "conflict", "other")]


def test_kit_answers_as_jax_werkzeug_app():
    """The port's router, query strings, envelopes and exception mapping
    give JAX's werkzeug app's status codes and JSON bodies."""
    answers = {}
    for pkg in ("port", "jax"):
        client = _kit_app(pkg).test_client(user=USER)
        out = []
        for method, url, body in KIT_REQUESTS:
            data = body if isinstance(body, str) or body is None \
                else json.dumps(body)
            resp = client.open(url, method=method, data=data)
            raw = resp.get_data()
            out.append((resp.status_code, json.loads(raw) if raw else None))
        answers[pkg] = out
    assert answers["port"] == answers["jax"]
    assert [s for s, _ in answers["port"]] == [
        200, 200, 400, 404, 405, 404, 404, 200, 200, 201, 403, 200,
        404, 409, 422, 422, 500, 500]


def test_csrf_cookie_as_werkzeug_sets_it():
    from kubeflow_rm_tpu.controlplane.webapps import core as jax_core
    from kubeflow_rm_tpu_torch.controlplane.webapps import core as port_core
    from werkzeug.wrappers import Response as WResponse

    for secure, prefix in ((True, ""), (False, "/jupyter")):
        api = None
        japp = jax_core.WebApp("j", api, prefix=prefix,
                               secure_cookies=secure)
        papp = port_core.WebApp("p", api, prefix=prefix,
                                secure_cookies=secure)
        wr, pr = WResponse("{}"), port_core.Response("{}")
        japp.set_csrf_cookie(wr)
        papp.set_csrf_cookie(pr)
        jc = wr.headers["Set-Cookie"]
        pc = dict(pr.headers)["Set-Cookie"]
        # the token is random: compare the attributes
        assert jc.split(";", 1)[1] == pc.split(";", 1)[1]
        assert "HttpOnly" not in pc and "SameSite=Strict" in pc
        assert ("Secure" in pc) is secure
        assert f"Path={prefix or '/'}" in pc
        assert dict(pr.headers)["Cache-Control"] == \
            wr.headers["Cache-Control"]


def test_cookie_set_by_a_response_is_sent_back():
    """The test client keeps what a response sets, as werkzeug's does."""
    app = WebApp("p", None)

    @app.route("/index", no_auth=True)
    def index(req):
        from kubeflow_rm_tpu_torch.controlplane.webapps.core import Response
        resp = Response("{}")
        app.set_csrf_cookie(resp)
        return resp

    @app.route("/echo", methods=("POST",), no_auth=True)
    def echo(req):
        return {"cookie": req.cookies.get("XSRF-TOKEN")}

    client = app.test_client(user=None)
    client.get("/index")
    token = client._client.cookies["XSRF-TOKEN"]
    resp = client._client.post("/echo", headers=[("X-XSRF-TOKEN", token)])
    assert resp.status_code == 200 and resp.json["cookie"] == token


@pytest.mark.parametrize("status", [200, 400, 401, 403, 404, 405, 409, 422,
                                    429, 500, 503])
def test_respond_answers_every_web_app_status(status):
    from http import HTTPStatus

    from kubeflow_rm_tpu_torch.controlplane.webapps.serving import respond

    started = []
    body = respond(lambda s, h: started.append((s, h)), status, {"x": 1})
    assert started[0][0] == f"{status} {HTTPStatus(status).phrase}"
    assert b"".join(body) == b'{"x": 1}'


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
