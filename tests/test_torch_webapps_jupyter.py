"""The port's jupyter web app (``controlplane/webapps/jupyter.py``, the
card-slice spawner) and its kit (``core.py``) and status ladder
(``status.py``), held to JAX's: every case of
``tests/test_jupyter_webapp.py`` and the two web-app cases of
``tests/test_suspend.py`` on the port's stack; the same requests against
each package's app over each package's ``make_control_plane`` (the
parity fixture: the same ``FakeClock``, serial writes), whose status
codes, JSON bodies and whole object graphs must be equal after the
TPU→GPU key map; ``/api/config`` against JAX's
``load_spawner_config()``; and ``process_status`` over a table of
notebooks and events in both packages.

Slice types are the key map's: ``v5p-16`` → ``h100-80gb-2x4`` (two
4-card hosts), ``v5litepod-1`` → ``h100-80gb-1``, ``v5litepod-8`` →
``h100-80gb-8``. A case that needs a type no node offers uses
``h100-80gb-8`` where JAX's uses ``v5litepod-16`` (no counterpart).
"""

import json

import pytest

from kubeflow_rm_tpu_torch.controlplane import make_control_plane
from kubeflow_rm_tpu_torch.controlplane import suspend
from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    annotations_of, make_object,
)
from kubeflow_rm_tpu_torch.controlplane.controllers.statefulset import (
    make_gpu_node,
)
from kubeflow_rm_tpu_torch.controlplane.webapps import status as status_mod
from kubeflow_rm_tpu_torch.controlplane.webapps.core import CSRF_HEADER
from kubeflow_rm_tpu_torch.controlplane.webapps.jupyter import (
    DEFAULT_CONFIG, create_app, load_spawner_config,
)

from tests.cp_fixtures import FakeClock
from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, EXTRA_SLICES, NS, SLICE_MAP, jax_switch_defaults,
    key_map, parity, run_full,
)

USER = "alice@corp.com"
SLICE = "h100-80gb-2x4"


@pytest.fixture
def stack():
    api, mgr = make_control_plane()
    api.ensure_namespace("team")
    # alice is namespace admin (what the profile controller grants owners)
    rb = make_object("rbac.authorization.k8s.io/v1", "RoleBinding",
                     "ns-admin", "team")
    rb["roleRef"] = {"kind": "ClusterRole", "name": "kubeflow-admin"}
    rb["subjects"] = [{"kind": "User", "name": USER}]
    api.create(rb)
    for i in range(2):
        api.create(make_gpu_node(f"n{i}", SLICE))
    return api, mgr


@pytest.fixture
def app(stack):
    api, _ = stack
    return create_app(api)


def spawn_body(**over):
    body = {
        "name": "mynb",
        "image": "ghcr.io/kubeflow-rm-tpu/jupyter-jax:latest",
        "imagePullPolicy": "IfNotPresent",
        "serverType": "jupyter",
        "cpu": "4",
        "memory": "16Gi",
        "tpu": {"acceleratorType": SLICE},
        "tolerationGroup": "none",
        "affinityConfig": "none",
        "configurations": [],
        "shm": True,
        "environment": {},
        "datavols": [],
        "workspace": {"mount": "/home/jovyan",
                      "newPvc": {"metadata":
                                 {"name": "{notebook-name}-workspace"},
                                 "spec": {"resources":
                                          {"requests": {"storage": "5Gi"}},
                                          "accessModes": ["ReadWriteOnce"]}}},
    }
    body.update(over)
    return body


def post_json(client, url, body):
    return client.post(url, data=json.dumps(body),
                       headers=[("Content-Type", "application/json")])


# ---- pipeline (tests/test_jupyter_webapp.py) -------------------------

def test_no_user_header_is_unauthorized(app):
    resp = app.test_client(user=None).get("/api/config")
    assert resp.status_code == 401
    assert json.loads(resp.get_data())["success"] is False


def test_csrf_required_on_unsafe_methods(app):
    client = app.test_client(user=USER)
    # strip the CSRF header: double-submit must fail
    resp = client._client.post(
        "/api/namespaces/team/notebooks",
        data="{}", headers=[("kubeflow-userid", ":" + USER),
                            ("Content-Type", "application/json")])
    assert resp.status_code == 403
    assert "CSRF" in json.loads(resp.get_data())["log"]


def test_csrf_header_must_match_cookie(app):
    client = app.test_client(user=USER)
    resp = client.post("/api/namespaces/team/notebooks", data="{}",
                       headers=[(CSRF_HEADER, "wrong-token"),
                                ("Content-Type", "application/json")])
    assert resp.status_code == 403


def test_authz_forbids_non_member(app):
    client = app.test_client(user="mallory@corp.com")
    resp = post_json(client, "/api/namespaces/team/notebooks", spawn_body())
    assert resp.status_code == 403
    assert "not authorized" in json.loads(resp.get_data())["log"]


def test_healthz_needs_no_auth(app):
    resp = app.test_client(user=None).get("/healthz")
    assert resp.status_code == 200


# ---- spawn path ------------------------------------------------------

def test_post_spawns_tpu_notebook_end_to_end(stack, app):
    api, mgr = stack
    client = app.test_client(user=USER)
    resp = post_json(client, "/api/namespaces/team/notebooks", spawn_body())
    assert resp.status_code == 200, resp.get_data()

    nb = api.get(nb_api.KIND, "mynb", "team")
    assert nb["spec"]["tpu"] == {"acceleratorType": SLICE}
    ann = nb["metadata"]["annotations"]
    assert ann["notebooks.kubeflow.org/creator"] == USER
    # workspace PVC was created and mounted
    pvc = api.get("PersistentVolumeClaim", "mynb-workspace", "team")
    assert pvc["spec"]["resources"]["requests"]["storage"] == "5Gi"
    spec = nb["spec"]["template"]["spec"]
    assert {"mountPath": "/home/jovyan", "name": "mynb-workspace"} in \
        spec["containers"][0]["volumeMounts"]
    # shm volume present
    assert any(v["name"] == "dshm" for v in spec["volumes"])
    # cpu limitFactor 1.2 applied
    assert spec["containers"][0]["resources"]["limits"]["cpu"] == "4.8"

    # reconcile: the spawned CR becomes a ready 2-host slice
    mgr.run_until_idle()
    listing = json.loads(client.get(
        "/api/namespaces/team/notebooks").get_data())
    (entry,) = listing["notebooks"]
    assert entry["tpu"]["hosts"] == 2
    assert entry["status"]["phase"] == "ready"


def test_stop_and_restart_via_patch(stack, app):
    api, mgr = stack
    client = app.test_client(user=USER)
    post_json(client, "/api/namespaces/team/notebooks", spawn_body())
    mgr.run_until_idle()

    client.patch("/api/namespaces/team/notebooks/mynb",
                 data=json.dumps({"stopped": True}),
                 headers=[("Content-Type", "application/json")])
    mgr.run_until_idle()
    assert api.list("Pod", "team") == []
    entry = json.loads(client.get(
        "/api/namespaces/team/notebooks").get_data())["notebooks"][0]
    assert entry["status"]["phase"] == "stopped"

    client.patch("/api/namespaces/team/notebooks/mynb",
                 data=json.dumps({"stopped": False}),
                 headers=[("Content-Type", "application/json")])
    mgr.run_until_idle()
    assert len(api.list("Pod", "team")) == 2


def test_readonly_field_rejects_client_value(stack, tmp_path):
    api, _ = stack
    cfg = json.load(open(DEFAULT_CONFIG))
    cfg["spawnerFormDefaults"]["image"]["readOnly"] = True
    path = tmp_path / "spawner.json"
    path.write_text(json.dumps(cfg))
    app = create_app(api, config_path=str(path))
    client = app.test_client(user=USER)
    resp = post_json(client, "/api/namespaces/team/notebooks", spawn_body())
    assert resp.status_code == 400
    assert "readonly" in json.loads(resp.get_data())["log"]


def test_api_tpus_intersects_config_with_inventory(stack, app):
    # inventory has two 4-card hosts only; config offers more types. A
    # GPU node's labels name one host's shape, so the one-host type of
    # that shape (h100-80gb-4) is obtainable beside the two-host one
    # (JAX's TPU hosts carry their slice's topology: v5p-16 alone)
    client = app.test_client(user=USER)
    tpus = json.loads(client.get("/api/tpus").get_data())["tpus"]
    assert [t["acceleratorType"] for t in tpus] == ["h100-80gb-4", SLICE]
    assert tpus[1]["hosts"] == 2 and tpus[1]["chips"] == 8
    assert tpus[0]["hosts"] == 1 and tpus[0]["chips"] == 4


def test_unknown_accelerator_type_rejected(app):
    client = app.test_client(user=USER)
    resp = post_json(client, "/api/namespaces/team/notebooks",
                     spawn_body(tpu={"acceleratorType": "v99-8"}))
    assert resp.status_code in (400, 422)


def test_status_ladder_shows_waiting_then_warning(stack):
    api, mgr = stack
    app = create_app(api)
    client = app.test_client(user=USER)
    # ask for a slice type with no nodes: pods stay Pending ->
    # FailedScheduling warning surfaces in the status ladder
    resp = post_json(client, "/api/namespaces/team/notebooks",
                     spawn_body(tpu={"acceleratorType": "h100-80gb-8"}))
    assert resp.status_code == 200, resp.get_data()
    mgr.run_until_idle()
    entry = json.loads(client.get(
        "/api/namespaces/team/notebooks").get_data())["notebooks"][0]
    assert entry["status"]["phase"] == "warning"


def test_pods_and_per_ordinal_logs(stack, app):
    """Per-host slice debugging: list pods, then fetch one ordinal's
    container logs (ref jupyter backend get_pod_logs — per-ordinal here
    because a card slice runs `hosts` pods)."""
    api, mgr = stack
    client = app.test_client(user=USER)
    resp = post_json(client, "/api/namespaces/team/notebooks", spawn_body())
    assert resp.status_code == 200
    mgr.run_until_idle()

    pods = json.loads(client.get(
        "/api/namespaces/team/notebooks/mynb/pods").get_data())["pods"]
    assert [p["name"] for p in pods] == ["mynb-0", "mynb-1"]
    assert all(p["phase"] == "Running" for p in pods)

    logs = json.loads(client.get(
        "/api/namespaces/team/notebooks/mynb/pods/1/logs").get_data())
    joined = "\n".join(logs["logs"])
    assert "TPU_WORKER_ID=1" in joined
    assert "joining torch.distributed" in joined

    # tail
    tail = json.loads(client.get(
        "/api/namespaces/team/notebooks/mynb/pods/1/logs?tailLines=1"
    ).get_data())
    assert len(tail["logs"]) == 1
    # kube tailLines semantics: 0 -> nothing, garbage -> 400
    zero = json.loads(client.get(
        "/api/namespaces/team/notebooks/mynb/pods/1/logs?tailLines=0"
    ).get_data())
    assert zero["logs"] == []
    assert client.get(
        "/api/namespaces/team/notebooks/mynb/pods/1/logs?tailLines=abc"
    ).status_code == 400

    # unknown ordinal -> 404
    resp = client.get("/api/namespaces/team/notebooks/mynb/pods/9/logs")
    assert resp.status_code == 404

    # non-integer ordinal -> 400, not a pod-name join
    resp = client.get("/api/namespaces/team/notebooks/mynb/pods/x/logs")
    assert resp.status_code == 400

    # authz enforced
    resp = app.test_client(user="mallory@corp.com").get(
        "/api/namespaces/team/notebooks/mynb/pods/0/logs")
    assert resp.status_code == 403


def test_multislice_spawn_through_form(stack, app):
    """numSlices in the form body: the controller renders hosts x N
    pods and the webhook stamps the MEGASCALE rendezvous on each (the
    multislice path end-to-end through the web API)."""
    api, mgr = stack
    for i in range(2, 4):  # 2 more 4-card hosts: 2 slices x 2 hosts
        api.create(make_gpu_node(f"n{i}", SLICE))
    client = app.test_client(user=USER)
    resp = post_json(
        client, "/api/namespaces/team/notebooks",
        spawn_body(tpu={"acceleratorType": SLICE, "numSlices": 2}))
    assert resp.status_code == 200, resp.get_data()
    mgr.run_until_idle()

    pods = json.loads(client.get(
        "/api/namespaces/team/notebooks/mynb/pods").get_data())["pods"]
    assert len(pods) == 4  # 2 slices x 2 hosts
    raw = [p for p in api.list("Pod", "team")]
    for pod in raw:
        env = {e["name"]: e.get("value")
               for c in pod["spec"]["containers"]
               for e in c.get("env", [])}
        assert env["MEGASCALE_NUM_SLICES"] == "2"
        assert env["MEGASCALE_SLICE_ID"] in ("0", "1")

    # garbage numSlices -> 400
    resp = post_json(
        client, "/api/namespaces/team/notebooks",
        spawn_body(name="bad",
                   tpu={"acceleratorType": SLICE, "numSlices": 0}))
    assert resp.status_code == 400

    # unbounded numSlices -> 400 (one POST may not fan out an arbitrary
    # pod count; the cap is nb_api.MAX_SLICES, mirrored in the CRD)
    resp = post_json(
        client, "/api/namespaces/team/notebooks",
        spawn_body(name="bad2",
                   tpu={"acceleratorType": SLICE,
                        "numSlices": nb_api.MAX_SLICES + 1}))
    assert resp.status_code == 400


def test_pod_logs_require_notebook_ownership(stack, app):
    """A pod that merely shares the '<notebook>-<ordinal>' name shape but
    is not labelled as belonging to the notebook must not be readable
    through its logs endpoint."""
    api, mgr = stack
    client = app.test_client(user=USER)
    resp = post_json(client, "/api/namespaces/team/notebooks", spawn_body())
    assert resp.status_code == 200
    mgr.run_until_idle()

    # an unrelated pod squatting on the name "mynb-7"
    stray = make_object("v1", "Pod", "mynb-7", "team")
    stray["spec"] = {"containers": [{"name": "x", "image": "busybox"}]}
    api.create(stray)
    resp = client.get("/api/namespaces/team/notebooks/mynb/pods/7/logs")
    assert resp.status_code == 404


def test_group_two_spawn_uses_rstudio_image(stack, app):
    """serverType=group-two reads imageGroupTwo (the rstudio images)
    and gets the URI-rewrite annotation."""
    api, mgr = stack
    client = app.test_client(user=USER)
    body = spawn_body(name="rs", serverType="group-two")
    del body["image"]
    body["imageGroupTwo"] = "ghcr.io/kubeflow-rm-tpu/rstudio:latest"
    body["tpu"] = {"acceleratorType": "none"}
    resp = post_json(client, "/api/namespaces/team/notebooks", body)
    assert resp.status_code == 200, resp.get_data()
    nb = api.get(nb_api.KIND, "rs", "team")
    c0 = nb["spec"]["template"]["spec"]["containers"][0]
    assert c0["image"] == "ghcr.io/kubeflow-rm-tpu/rstudio:latest"
    ann = nb["metadata"]["annotations"]
    assert ann[nb_api.REWRITE_URI_ANNOTATION] == "/"
    assert ann[nb_api.SERVER_TYPE_ANNOTATION] == "group-two"


def test_poddefault_conflict_rejected_at_spawn(stack):
    """Selecting two PodDefaults whose merges collide 400s the spawn
    POST itself (dry-run admission — reference post.py:51-57 dry-run
    create), instead of a FailedCreate event minutes later."""
    api, mgr = stack
    for name, val in (("pd-a", "/a"), ("pd-b", "/b")):
        api.create({
            "apiVersion": "kubeflow.org/v1alpha1", "kind": "PodDefault",
            "metadata": {"name": name, "namespace": "team"},
            "spec": {"selector": {"matchLabels": {name: "true"}},
                     "desc": name,
                     "env": [{"name": "HF_HOME", "value": val}]},
        })
    app = create_app(api)
    client = app.test_client(user=USER)
    resp = post_json(client, "/api/namespaces/team/notebooks",
                     spawn_body(name="pd-clash",
                                configurations=["pd-a", "pd-b"]))
    assert resp.status_code == 400, resp.get_data()
    assert b"HF_HOME" in resp.get_data()
    assert api.try_get("Notebook", "pd-clash", "team") is None
    # a single (non-conflicting) selection still spawns
    resp = post_json(client, "/api/namespaces/team/notebooks",
                     spawn_body(name="pd-ok", configurations=["pd-a"]))
    assert resp.status_code == 200, resp.get_data()


# ---- the web-app cases of tests/test_suspend.py -----------------------

@pytest.fixture
def suspend_stack():
    """Two 4-card hosts = capacity for exactly one 2-host slice at a
    time, on the suspend stack."""
    suspend.set_state_store(suspend.InMemoryStateStore())
    suspend.set_oversubscribe(True)
    clock = FakeClock()
    api, mgr = make_control_plane(
        clock=clock, enable_suspend=True,
        suspend_config={"suspend_idle_minutes": 30.0,
                        "check_period_minutes": 1.0})
    api.ensure_namespace("u")
    for i in range(2):
        api.create(make_gpu_node(f"n{i}", SLICE))
    yield api, mgr, clock
    suspend.set_oversubscribe(True)


def _ready(api, name, ns="u"):
    return (api.get(nb_api.KIND, name, ns).get("status") or {}).get(
        "readyReplicas", 0)


def test_patch_suspended_and_status_ladder(suspend_stack):
    api, mgr, _clock = suspend_stack
    api.create(nb_api.make_notebook("nb", "u", accelerator_type=SLICE))
    mgr.run_until_idle()
    app = create_app(api, disable_auth=True)
    client = app.test_client()

    r = client.patch("/api/namespaces/u/notebooks/nb",
                     data=json.dumps({"suspended": True}),
                     headers=[("Content-Type", "application/json")])
    assert r.status_code == 200
    mgr.run_until_idle()
    nb = api.get(nb_api.KIND, "nb", "u")
    st = status_mod.process_status(nb, api.events_for(nb))
    assert st.phase == status_mod.PHASE_SUSPENDED
    assert "its GPU slice was released" in st.message

    r = client.patch("/api/namespaces/u/notebooks/nb",
                     data=json.dumps({"suspended": False}),
                     headers=[("Content-Type", "application/json")])
    assert r.status_code == 200
    mgr.run_until_idle()
    assert _ready(api, "nb") == 2


def test_readiness_longpoll_auto_resumes(suspend_stack):
    api, mgr, _clock = suspend_stack
    api.create(nb_api.make_notebook("nb", "u", accelerator_type=SLICE))
    mgr.run_until_idle()
    suspend.initiate_suspend(
        api, api.get(nb_api.KIND, "nb", "u"), reason="api")
    mgr.run_until_idle()
    assert api.list("Pod", "u") == []

    app = create_app(api, disable_auth=True)
    client = app.test_client()
    # the long-poll itself is the demand signal: it flips the notebook
    # back toward Running before blocking (timeoutSeconds=0 returns
    # immediately; the controllers run after)
    client.get("/api/namespaces/u/notebooks/nb/readiness?timeoutSeconds=0")
    mgr.run_until_idle()
    assert _ready(api, "nb") == 2

    # wake=false observes without resuming
    suspend.initiate_suspend(
        api, api.get(nb_api.KIND, "nb", "u"), reason="api")
    mgr.run_until_idle()
    client.get("/api/namespaces/u/notebooks/nb/readiness"
               "?timeoutSeconds=0&wake=false")
    mgr.run_until_idle()
    assert nb_api.SUSPEND_ANNOTATION in annotations_of(
        api.get(nb_api.KIND, "nb", "u"))


# ---- parity with JAX's app -------------------------------------------

def _call(client, method, url, body=None):
    """(status, JSON body) of one request through either package's
    test client."""
    kw = {}
    if body is not None:
        kw = {"data": json.dumps(body),
              "headers": [("Content-Type", "application/json")]}
    resp = client.open(url, method=method, **kw)
    return resp.status_code, json.loads(resp.get_data())


def _admin(S, user=USER):
    rb = S.m("api.meta").make_object("rbac.authorization.k8s.io/v1",
                                     "RoleBinding", "ns-admin", NS)
    rb["roleRef"] = {"kind": "ClusterRole", "name": "kubeflow-admin"}
    rb["subjects"] = [{"kind": "User", "name": user}]
    S.api.create(rb)


def _spawn_life(S):
    """A notebook's life through the spawner, on a one-card and an
    8-card host: the config's types offered, a spawn with its workspace
    PVC, the listing, the notebook, its readiness (already at its
    version, and from no baseline), events, pods and one ordinal's
    logs, a stop and a start, form errors, a delete and a 404."""
    S.api.ensure_namespace(NS)
    _admin(S)
    S.node("n0", "h100-80gb-1")
    S.node("n1", "h100-80gb-8")
    app = S.m("webapps.jupyter").create_app(S.api)
    c = app.test_client(user=USER)
    base = f"/api/namespaces/{NS}/notebooks"
    out = [_call(c, "GET", "/api/tpus"),
           _call(c, "GET", "/api/namespaces"),
           _call(c, "POST", base, spawn_body(
               tpu={"acceleratorType": S.slice("h100-80gb-1")}))]
    S.run()
    out += [_call(c, "GET", base), _call(c, "GET", f"{base}/mynb")]
    rv = S.api.get(S.nb_api.KIND, "mynb", NS)["metadata"]["resourceVersion"]
    out += [_call(c, "GET", f"{base}/mynb/readiness?timeoutSeconds=0"
                            f"&knownVersion={rv}"),
            _call(c, "GET", f"{base}/mynb/readiness?timeoutSeconds=0"),
            _call(c, "GET", f"{base}/mynb/events"),
            _call(c, "GET", f"{base}/mynb/pods"),
            _call(c, "GET", f"{base}/mynb/pods/0/logs"),
            _call(c, "GET", f"{base}/mynb/pods/0/logs?tailLines=1"),
            _call(c, "GET", f"/api/namespaces/{NS}/pvcs"),
            _call(c, "GET", f"/api/namespaces/{NS}/poddefaults"),
            _call(c, "PATCH", f"{base}/mynb", {"stopped": True})]
    S.run()
    out += [_call(c, "GET", base),
            _call(c, "PATCH", f"{base}/mynb", {"stopped": False})]
    S.run()
    out += [_call(c, "GET", base),
            _call(c, "POST", base, spawn_body(
                name="bad", tpu={"acceleratorType": S.slice("h100-80gb-8"),
                                 "numSlices": 0})),
            _call(c, "POST", base, spawn_body(name="cpu1", cpu="nan")),
            _call(c, "POST", base, {"image": "x"}),
            _call(c, "POST", base, spawn_body(
                name="w8", tpu={"acceleratorType": S.slice("h100-80gb-8")},
                workspace=None, tolerationGroup="no-such-group")),
            _call(c, "GET", f"{base}/mynb/pods/x/logs"),
            _call(c, "GET", f"{base}/nope/readiness?timeoutSeconds=0"),
            _call(c, "GET", "/no/such/route"),
            _call(c, "PUT", base),
            _call(c, "DELETE", f"{base}/mynb")]
    S.run()
    out += [_call(c, "GET", f"{base}/mynb"),
            _call(app.test_client(user="mallory@corp.com"), "GET", base),
            _call(app.test_client(user=None), "GET", base)]
    return out


def test_spawn_life_equals_jax(parity):
    out, dump = run_full(parity, _spawn_life, arms=("cached", "raw"))
    codes = [s for s, _ in out]
    # alice is an admin of the namespace, not of the cluster: listing
    # namespaces is refused
    assert codes == [200, 403, 200, 200, 200, 200, 200, 200, 200, 200,
                     200, 200, 200, 200, 200, 200, 200, 400, 400, 400,
                     400, 400, 404, 404, 405, 200, 404, 403, 401]
    assert [t["acceleratorType"] for t in out[0][1]["tpus"]] == [
        "h100-80gb-1", "h100-80gb-8"]
    assert out[5][1]["changed"] is False and out[6][1]["ready"] is True
    assert dump.get("Notebook", []) == []


def _suspend_life(S):
    """The PATCH arm of the lifecycle and the readiness long-poll's
    auto-resume (``wake=false`` observes without resuming)."""
    S.api.ensure_namespace(NS)
    for i in range(2):
        S.node(f"n{i}", SLICE)
    S.api.create(S.notebook("nb", SLICE))
    S.run()
    app = S.m("webapps.jupyter").create_app(S.api, disable_auth=True)
    c = app.test_client()
    base = f"/api/namespaces/{NS}/notebooks/nb"
    out = [_call(c, "PATCH", base, {"suspended": True})]
    S.run()
    out += [_call(c, "GET", base),
            _call(c, "PATCH", base, {"suspended": False})]
    S.run()
    out.append(_call(c, "GET", base))
    S.suspend.initiate_suspend(S.api, S.api.get(S.nb_api.KIND, "nb", NS),
                               reason="api")
    S.run()
    out.append(_call(c, "GET", f"{base}/readiness?timeoutSeconds=0"
                                "&wake=false"))
    S.run()
    out.append(_call(c, "GET", f"{base}/readiness?timeoutSeconds=0"))
    S.run()
    out.append(_call(c, "GET", base))
    return out


def test_suspend_life_equals_jax(parity):
    out, _ = run_full(parity, _suspend_life, arms=("cached", "raw"),
                      suspend={"suspend_idle_minutes": 30.0,
                               "check_period_minutes": 1.0})
    phases = [b["notebook"]["processed_status"]["phase"]
              for s, b in out if "notebook" in b]
    assert phases == ["suspended", "ready", "suspended", "waiting",
                      "ready"]


# ---- the spawner config ----------------------------------------------

#: JAX's configured slice types with no counterpart in the port's table
DROPPED = ("v5litepod-16", "v5p-32", "v6e-4", "v6e-8")


def test_api_config_equals_jax_spawner_config(stack, app):
    from kubeflow_rm_tpu.controlplane.webapps import jupyter as jax_jupyter

    both = {**SLICE_MAP, **EXTRA_SLICES}
    jax_cfg = jax_jupyter.load_spawner_config()
    jax_types = [o for o in jax_cfg["tpu"]["options"] if o != "none"]
    assert sorted(t for t in jax_types if t not in both) == sorted(DROPPED)
    want = key_map(jax_cfg)
    options = ["none"]
    for o in want["tpu"]["options"]:
        if o not in DROPPED and o not in options:
            options.append(o)   # v5litepod-4 and v5p-8 are both 4 cards
    want["tpu"]["options"] = options
    got = app.test_client(user=USER).get("/api/config").get_json()
    assert got["config"] == want == load_spawner_config()
    assert options == ["none", "h100-80gb-1", "h100-80gb-4", "h100-80gb-8",
                       "h100-80gb-2x4"]


# ---- the status ladder -----------------------------------------------

def _waiting(reason):
    return {"status": {"containerState": {"waiting": {"reason": reason}}}}


#: (case, acceleratorType (port's), annotations, patch, events)
LADDER = [
    ("ready", SLICE, {}, {"status": {"readyReplicas": 2}}, []),
    ("slice_starting", SLICE, {}, {"status": {"readyReplicas": 1}}, []),
    ("starting", "h100-80gb-1", {}, {}, []),
    ("cpu_only_ready", None, {}, {"status": {"readyReplicas": 1}}, []),
    ("terminating", SLICE, {},
     {"metadata": {"deletionTimestamp": "2026-01-01T00:00:00Z"}}, []),
    ("suspended", SLICE, {nb_api.SUSPEND_ANNOTATION: "t"}, {}, []),
    ("suspending", SLICE, {nb_api.SUSPEND_ANNOTATION: "t"},
     {"status": {"readyReplicas": 2}}, []),
    ("resuming", SLICE, {nb_api.RESUME_REQUESTED_ANNOTATION: "t"}, {}, []),
    ("stopped", SLICE, {nb_api.STOP_ANNOTATION: "t"}, {}, []),
    ("stopping", SLICE, {nb_api.STOP_ANNOTATION: "t"},
     {"status": {"readyReplicas": 1}}, []),
    ("pull_backoff", SLICE, {}, _waiting("ImagePullBackOff"), []),
    ("container_creating", SLICE, {}, _waiting("ContainerCreating"), []),
    ("warning_event", SLICE, {}, {}, [
        {"type": "Normal", "reason": "Scheduled", "message": "ok"},
        {"type": "Warning", "reason": "FailedScheduling",
         "message": "0/2 nodes are available"}]),
    ("warning_reason_only", SLICE, {}, {}, [
        {"type": "Warning", "reason": "BackOff"}]),
    ("multislice_partial", SLICE, {},
     {"spec": {"tpu": {"numSlices": 2}}, "status": {"readyReplicas": 2}},
     []),
]


def _merge(obj, patch):
    for k, v in patch.items():
        if isinstance(v, dict) and isinstance(obj.get(k), dict):
            _merge(obj[k], v)
        else:
            obj[k] = v


@pytest.mark.parametrize("case,acc,ann,patch,events", LADDER,
                         ids=[row[0] for row in LADDER])
def test_process_status_equals_jax(case, acc, ann, patch, events):
    from kubeflow_rm_tpu.controlplane.api import notebook as jax_nb
    from kubeflow_rm_tpu.controlplane.webapps import status as jax_status

    jax_acc = {v: k for k, v in SLICE_MAP.items()}
    results = []
    for nb_mod, st_mod, a in ((nb_api, status_mod, acc),
                              (jax_nb, jax_status, jax_acc.get(acc))):
        nb = nb_mod.make_notebook("nb", "u", accelerator_type=a,
                                  annotations=dict(ann))
        _merge(nb, json.loads(json.dumps(patch)))
        results.append(st_mod.process_status(nb, events).to_dict())
    port, jax = results
    assert port == key_map(jax)
    assert port["phase"] in (status_mod.PHASE_READY, status_mod.PHASE_WAITING,
                             status_mod.PHASE_WARNING,
                             status_mod.PHASE_TERMINATING,
                             status_mod.PHASE_STOPPED,
                             status_mod.PHASE_SUSPENDED)


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
