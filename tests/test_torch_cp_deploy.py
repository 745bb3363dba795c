"""The port's deployed layout (``controlplane/deploy``, slice 7e-2) held
to JAX's: every case of ``tests/test_deploy.py`` and the conversion
cases of ``tests/test_conversion.py`` that go through the webhook
server, the REST facade or the CRDs. Each case runs the same script on
both packages — an in-memory apiserver served over HTTP on 127.0.0.1
(``tests/torch_cp_parity.RestCluster``), the kube adapter, the admission
webhook server — and the port's result must equal JAX's after the
TPU→GPU key map (``key_map``; the manifests also after the module
rename, ``module_map``). The spawn across the REST boundary compares
the two clusters' whole object graphs, Events included.

``tests/test_deploy.py:68`` holds JAX's renderer to the checked-in
``manifests/``; the port checks in no rendered tree, so its case holds
the port's ``write_tree`` output to JAX's, file by file and object by
object (the port writes JSON, which JAX's ``yaml.safe_load`` reads).
Waits are on events or bounded polls, never on a fixed sleep.
"""

import base64
import copy
import json
import threading
import time
import urllib.error
import urllib.request

import pytest
import yaml

from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, NS, RestCluster, SLICE_MAP, canon, cp_module,
    drop_enums, jax_switch_defaults, key_map, module_map, parity,
    reset_uids,
)

PKGS = ("port", "jax")
#: the two-host slice each side's spawn uses (JAX's ``v5p-16``)
SLICE = {"port": "h100-80gb-2x4", "jax": "v5p-16"}


def _both(case, monkeypatch=None):
    """``case(pkg)`` on each package (uids reset before each when the
    ``parity`` fixture is given); the port's result must equal JAX's
    after the key map. Returns the port's."""
    outs = {}
    for pkg in PKGS:
        if monkeypatch is not None:
            reset_uids(monkeypatch)
        outs[pkg] = case(pkg)
    assert outs["port"] == key_map(outs["jax"])
    return outs["port"]


def _poll(fn, timeout=10.0):
    """Bounded poll: True as soon as ``fn()`` is, False at the deadline."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if fn():
            return True
        time.sleep(0.01)
    return False


def _post(url, body):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


# ---- CRDs --------------------------------------------------------------

def test_crds_cover_all_six_kinds_with_schemas():
    def case(pkg):
        crds = cp_module(pkg, "deploy.crds")
        objs = crds.all_crds()
        by_name = {c["metadata"]["name"]: c for c in objs}
        assert set(by_name) == {
            "notebooks.kubeflow.org", "tpujobs.kubeflow.org",
            "profiles.kubeflow.org", "poddefaults.kubeflow.org",
            "tensorboards.tensorboard.kubeflow.org",
            "pvcviewers.kubeflow.org"}
        for crd in objs:
            assert "openAPIV3Schema" in crd["spec"]["versions"][0]["schema"]
        assert by_name["profiles.kubeflow.org"]["spec"]["scope"] == \
            "Cluster"
        # the rendered stream reads back as the objects (the port's is
        # JSON, which JAX's YAML reader takes as it is)
        docs = list(yaml.safe_load_all(crds.render_yaml(objs)))
        assert docs == objs
        return drop_enums(objs)
    _both(case)


def test_notebook_crd_accelerator_enum_tracks_topology_table():
    """The enum is rendered live from each package's topology table: the
    port's is ``api/gpu.py``'s, on the Notebook's storage version and on
    a TPUJob role."""
    from kubeflow_rm_tpu_torch.controlplane.api import gpu

    crds = {c["metadata"]["name"]: c
            for c in cp_module("port", "deploy.crds").all_crds()}
    nb = [v for v in crds["notebooks.kubeflow.org"]["spec"]["versions"]
          if v["storage"]][0]["schema"]["openAPIV3Schema"]
    enum = nb["properties"]["spec"]["properties"]["tpu"]["properties"][
        "acceleratorType"]["enum"]
    assert enum == sorted(gpu.TOPOLOGIES)
    tj = crds["tpujobs.kubeflow.org"]["spec"]["versions"][-1]["schema"][
        "openAPIV3Schema"]["properties"]["spec"]["properties"]["roles"]
    assert tj["items"]["properties"]["tpu"]["properties"][
        "acceleratorType"]["enum"] == sorted(gpu.TOPOLOGIES)
    assert set(SLICE_MAP.values()) <= set(enum)


def test_write_tree_equals_jax(tmp_path):
    """The port's kustomize tree: JAX's files, each holding JAX's objects
    after the module rename and the key map (enums from each table)."""
    from kubeflow_rm_tpu.controlplane.deploy.manifests import (
        write_tree as jax_write_tree,
    )
    from kubeflow_rm_tpu_torch.controlplane.deploy.manifests import (
        write_tree,
    )

    pdir, jdir = tmp_path / "port", tmp_path / "jax"
    written = write_tree(str(pdir))
    jax_write_tree(str(jdir))
    port = {p.relative_to(pdir): p.read_text() for p in pdir.rglob("*")
            if p.is_file()}
    jax = {p.relative_to(jdir): p.read_text() for p in jdir.rglob("*")
           if p.is_file()}
    assert sorted(port) == sorted(jax)
    assert len(written) == len(port)
    for rel in port:
        # every document is JSON: the port writes no YAML syntax
        for doc in port[rel].split("---\n"):
            json.loads(doc)
        got = drop_enums(list(yaml.safe_load_all(port[rel])))
        want = drop_enums(module_map(list(yaml.safe_load_all(jax[rel]))))
        assert canon(got) == canon(want), rel
    manager = json.loads((pdir / "manager/manager.yaml").read_text())
    c = manager["spec"]["template"]["spec"]["containers"][0]
    assert c["command"] == ["python", "-m",
                            "kubeflow_rm_tpu_torch.controlplane",
                            "controller-manager"]
    assert c["livenessProbe"]["exec"]["command"][-1] == \
        "import kubeflow_rm_tpu_torch"


# ---- JSONPatch -----------------------------------------------------------

def _apply_patch(doc, ops):
    """Tiny RFC 6902 applier for test verification."""
    doc = copy.deepcopy(doc)
    for op in ops:
        parts = [p.replace("~1", "/").replace("~0", "~")
                 for p in op["path"].split("/")[1:]]
        target = doc
        for p in parts[:-1]:
            target = target[p]
        if op["op"] == "remove":
            del target[parts[-1]]
        else:
            target[parts[-1]] = op["value"]
    return doc


def test_json_patch_diff_and_apply():
    old = {"metadata": {"annotations": {"a": "1"}, "name": "x"},
           "spec": {"containers": [{"name": "c", "image": "i"}],
                    "keep": True, "drop": 1}}
    new = {"metadata": {"annotations": {"a": "1", "b": "2"},
                        "name": "x"},
           "spec": {"containers": [{"name": "c", "image": "i"},
                                   {"name": "s", "image": "j"}],
                    "keep": True}}
    pairs = [(old, new), ({"l": {"a/b": "x"}}, {"l": {"a/b": "y"}}),
             ({"m": {"t~x": 1, "u/v~w": [1]}}, {"m": {"u/v~w": [2]}}),
             ({"k": 1}, {"k": "1"}), (old, old)]

    def case(pkg):
        json_patch = cp_module(pkg, "deploy.webhook_server").json_patch
        out = []
        for a, b in pairs:
            ops = json_patch(a, b)
            assert _apply_patch(a, ops) == b
            out.append(ops)
        assert out[-1] == []
        return out
    ops = _both(case)
    # escaping: ``~`` as ``~0`` and ``/`` as ``~1`` (RFC 6901)
    assert {o["path"] for o in ops[2]} == {"/m/t~0x", "/m/u~1v~0w"}


# ---- the webhook server -------------------------------------------------

def _review(op, obj, old=None, uid="u1"):
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "operation": op, "object": obj,
                        **({"oldObject": old} if old else {})}}


def _webhook(pkg, case):
    """``case(url)`` against ``pkg``'s ``WebhookServer`` over
    ``make_admission_handler`` of a bare apiserver with namespace
    ``u``."""
    api = cp_module(pkg, "apiserver").APIServer()
    api.ensure_namespace("u")
    ws = cp_module(pkg, "deploy.webhook_server")
    server = ws.WebhookServer(ws.make_admission_handler(api), port=0)
    port = server.start()
    try:
        return case(f"http://127.0.0.1:{port}")
    finally:
        server.stop()


def _patched(body, obj):
    ops = json.loads(base64.b64decode(body["patch"]))
    return ops, _apply_patch(obj, ops)


def test_webhook_server_injects_lock_via_jsonpatch():
    def case(pkg):
        def run(url):
            nb = cp_module(pkg, "api.notebook").make_notebook("n", "u")
            body = _post(f"{url}/mutate-notebook",
                         _review("CREATE", nb))["response"]
            assert body["allowed"] and body["uid"] == "u1"
            ops, mutated = _patched(body, nb)
            assert mutated["metadata"]["annotations"][cp_module(
                pkg, "api.notebook").STOP_ANNOTATION] == \
                "reconciliation-lock"
            return ops
        return _webhook(pkg, run)
    _both(case)


def _raw_pod(pkg):
    nb_api = cp_module(pkg, "api.notebook")
    return {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {
            "name": "nb-0", "namespace": "u",
            "labels": {
                nb_api.NOTEBOOK_NAME_LABEL: "nb",
                nb_api.TPU_ACCELERATOR_LABEL: SLICE[pkg],
                "apps.kubernetes.io/pod-index": "0",
                "statefulset.kubernetes.io/pod-name": "nb-0",
            },
        },
        "spec": {"containers": [{"name": "nb", "image": "i"}],
                 "subdomain": "nb-workers"},
    }


def test_webhook_server_slice_injection_on_pods():
    """``/mutate-pod`` ends in each package's slice injector: the port's
    patch (the card resource, the selector, JAX's env names) equals
    JAX's after the key map."""
    def case(pkg):
        def run(url):
            pod = _raw_pod(pkg)
            body = _post(f"{url}/mutate-pod",
                         _review("CREATE", pod))["response"]
            assert body["allowed"], body
            ops, mutated = _patched(body, pod)
            env = {e["name"]: e.get("value")
                   for e in mutated["spec"]["containers"][0]["env"]}
            assert env["TPU_WORKER_ID"] == "0"
            assert "TPU_WORKER_HOSTNAMES" in env
            return ops
        return _webhook(pkg, run)
    _both(case)


def test_webhook_server_denies_running_restart():
    def case(pkg):
        def run(url):
            make = cp_module(pkg, "api.notebook").make_notebook
            old, new = make("n", "u"), make("n", "u", image="other:2")
            body = _post(f"{url}/mutate-notebook",
                         _review("UPDATE", new, old))["response"]
            assert body["allowed"] is False
            assert "restart" in body["status"]["message"]
            return body
        return _webhook(pkg, run)
    _both(case)


def test_webhook_server_health_and_unknown_paths():
    def case(pkg):
        def run(url):
            with urllib.request.urlopen(f"{url}/healthz") as resp:
                health = (resp.status, json.loads(resp.read()))
            codes = []
            for path in ("/mutate-nothing",):
                try:
                    _post(f"{url}{path}", _review("CREATE", {}))
                except urllib.error.HTTPError as e:
                    codes.append(e.code)
            return health, codes
        return _webhook(pkg, run)
    assert _both(case) == ((200, {"ok": True}), [404])


# ---- the kube adapter against the REST facade --------------------------

@pytest.fixture
def clusters():
    """Each package's cluster (namespace ``u``) and its kube adapter."""
    out = {}
    try:
        for pkg in PKGS:
            c = RestCluster(pkg)
            c.api.ensure_namespace("u")
            out[pkg] = (c, cp_module(pkg, "deploy.kubeclient")
                        .KubeAPIServer(c.url))
        yield out
    finally:
        for c, _ in out.values():
            c.close()


def _on_both(clusters, case, monkeypatch=None):
    return _both(lambda pkg: case(pkg, *clusters[pkg]), monkeypatch)


def test_no_virtual_node_fallback_against_kube_adapter(clusters):
    """Against the adapter an empty node list is a real "no nodes": a
    selector-less CPU pod stays Pending with FailedScheduling; the
    in-memory backend keeps the hermetic virtual node."""
    def case(pkg, c, kapi):
        stc = cp_module(pkg, "controllers.statefulset")
        out = []
        for backend, expect in ((kapi, "Pending"), (c.api, "Running")):
            name = f"cpu-{expect.lower()}"
            mgr = cp_module(pkg, "runtime").Manager(backend)
            mgr.add(stc.DeploymentController(auto_ready=True))
            deploy = cp_module(pkg, "api.meta").make_object(
                "apps/v1", "Deployment", name, "u")
            deploy["spec"] = {"replicas": 1, "template": {"spec": {
                "containers": [{"name": "web", "image": "dash:latest"}]}}}
            backend.create(deploy)
            mgr.enqueue_all()
            mgr.run_until_idle()
            pod = backend.get("Pod", f"{name}-0", "u")
            assert pod["status"]["phase"] == expect, backend
            reasons = sorted(e["reason"] for e in backend.events_for(pod))
            if expect == "Pending":
                assert "FailedScheduling" in reasons
            out.append((pod["status"]["phase"], reasons))
        return out
    _on_both(clusters, case)


def test_kubeclient_verb_surface_roundtrip(clusters, parity):
    def case(pkg, c, kapi):
        errors = cp_module(pkg, "apiserver")
        cm = cp_module(pkg, "api.meta").make_object("v1", "ConfigMap", "c",
                                                    "u")
        cm["data"] = {"k": "v"}
        created = kapi.create(cm)
        assert created["metadata"]["uid"]
        with pytest.raises(errors.AlreadyExists):
            kapi.create(cm)
        got = kapi.get("ConfigMap", "c", "u")
        assert got["data"] == {"k": "v"}
        assert kapi.try_get("ConfigMap", "nope", "u") is None
        got["data"]["k"] = "v2"
        updated = kapi.update(got)
        got["metadata"]["resourceVersion"] = "1"
        with pytest.raises(errors.Conflict):
            kapi.update(got)
        patched = kapi.patch("ConfigMap", "c", {"data": {"x": "y"}}, "u")
        assert patched["data"] == {"k": "v2", "x": "y"}
        listed = kapi.list("ConfigMap", "u")
        kapi.delete("ConfigMap", "c", "u")
        with pytest.raises(errors.NotFound):
            kapi.get("ConfigMap", "c", "u")
        for o in (created, updated, patched, *listed):
            o["metadata"].pop("creationTimestamp", None)
        return created, updated, patched, listed
    _on_both(clusters, case, parity)


def test_debug_writelog_and_traces_endpoints(clusters, parity):
    """``GET /debug/writelog`` serves the apiserver's write audit trail
    (each write's verb, kind, name, resourceVersion and writer identity)
    and ``GET /debug/traces`` the process's span collector — the server
    span of a request that carried a ``traceparent``, and a slow root
    trace from the slow store — with JAX's bodies (the wall-clock fields
    and the random span ids dropped)."""
    parent = "00-" + "a" * 32 + "-" + "b" * 16 + "-01"

    def case(pkg, c, _):
        tracing = cp_module(pkg, "tracing")
        kapi = cp_module(pkg, "deploy.kubeclient").KubeAPIServer(
            c.url, identity="writer-a")
        cm = cp_module(pkg, "api.meta").make_object("v1", "ConfigMap", "c",
                                                    "u")
        kapi.create(cm)
        kapi.patch("ConfigMap", "c", {"data": {"x": "y"}}, "u")
        kapi.delete("ConfigMap", "c", "u")
        with urllib.request.urlopen(f"{c.url}/debug/writelog",
                                    timeout=30) as r:
            writes = json.loads(r.read())["writes"]
        tracing.set_enabled(True)
        tracing.set_process("shard-0")
        tracing.collector().clear()
        try:
            req = urllib.request.Request(
                f"{c.url}/api/v1/namespaces/u/configmaps",
                headers={tracing.TRACE_HEADER: parent})
            with urllib.request.urlopen(req, timeout=30) as r:
                r.read()
            # a slow root: the slow store keeps its whole trace
            tracing.record_span("slow root", start=0.0, end=1.0)
            with urllib.request.urlopen(f"{c.url}/debug/traces",
                                        timeout=30) as r:
                traces = json.loads(r.read())
        finally:
            tracing.set_enabled(False)
            tracing.set_process("")
            tracing.collector().clear()
        for w in writes:
            assert w.pop("t") > 0
        for span in traces["spans"] + [
                d for t in traces["slow"] for d in t["spans"]]:
            assert span.pop("span_id") and span.pop("start") is not None
            span.pop("end"), span.pop("duration_ms")
        for t in traces["slow"]:
            assert t.pop("trace_id")
        for span in traces["spans"] + traces["slow"][0]["spans"]:
            if span["name"] == "slow root":
                span.pop("trace_id")
        traces["spans"].sort(key=lambda d: d["name"])
        return writes, traces

    writes, traces = _on_both(clusters, case, parity)
    assert [(w["verb"], w["kind"], w["name"], w["writer"])
            for w in writes][-3:] == [
        ("CREATE", "ConfigMap", "c", "writer-a"),
        ("UPDATE", "ConfigMap", "c", "writer-a"),
        ("DELETE", "ConfigMap", "c", "writer-a")]
    assert traces["process"] == "shard-0"
    server = [d for d in traces["spans"] if d["kind"] == "server"]
    assert [(d["name"], d["trace_id"], d["parent_id"]) for d in server] == [
        ("GET /api/v1/namespaces/u/configmaps", "a" * 32, "b" * 16)]
    (slow,) = traces["slow"]
    assert slow["duration_ms"] == 1000.0
    assert [d["name"] for d in slow["spans"]] == ["slow root"]


def test_kubeclient_status_subresource_and_events(clusters):
    def case(pkg, c, kapi):
        nb_api = cp_module(pkg, "api.notebook")
        c.api.register_validator(nb_api.KIND, nb_api.validate)
        nb = kapi.create(nb_api.make_notebook("n", "u"))
        nb["status"] = {"readyReplicas": 2}
        out = kapi.update_status(nb)
        assert out["status"]["readyReplicas"] == 2
        kapi.record_event(nb, "Warning", "TestReason", "boom")
        evs = kapi.events_for(nb)
        assert len(evs) == 1 and evs[0]["reason"] == "TestReason"
        return out["status"], [(e["type"], e["reason"], e["message"],
                                e["metadata"]["name"]) for e in evs]
    _on_both(clusters, case)


def test_kubeclient_subjectaccessreview(clusters):
    def case(pkg, c, kapi):
        rb = cp_module(pkg, "api.meta").make_object(
            "rbac.authorization.k8s.io/v1", "RoleBinding", "r", "u")
        rb["roleRef"] = {"kind": "ClusterRole", "name": "kubeflow-edit"}
        rb["subjects"] = [{"kind": "User", "name": "alice"}]
        kapi.create(rb)
        return [kapi.access_review("alice", "create", "notebooks", "u"),
                kapi.access_review("bob", "create", "notebooks", "u"),
                kapi.access_review(None, "get", "notebooks", "u")]
    assert _on_both(clusters, case) == [True, False, False]


def test_kubeclient_watch_streams_events(clusters):
    def case(pkg, c, kapi):
        seen, got = [], threading.Event()

        def watcher(etype, obj, old):
            seen.append((etype, obj["metadata"]["name"]))
            if obj["metadata"]["name"] == "w":
                got.set()

        kapi.add_watcher(watcher)
        stop = threading.Event()
        t = threading.Thread(target=kapi.watch_kind,
                             args=("ConfigMap", "u", stop, 10), daemon=True)
        t.start()
        try:
            # the stream is registered once the facade holds its queue
            assert _poll(lambda: len(c.rest._watch_queues) == 1)
            kapi.create(cp_module(pkg, "api.meta").make_object(
                "v1", "ConfigMap", "w", "u"))
            assert got.wait(10), seen
        finally:
            stop.set()
        return seen
    assert _on_both(clusters, case) == [("ADDED", "w")]


def test_make_cluster_manager_wires_jax_order():
    """The platform's controllers over the adapter, in JAX's order, with
    and without the culler and the suspend stack; the same kinds
    watched; the manager reads through the adapter's own store."""
    def case(pkg):
        m = cp_module(pkg, "")
        kapi = cp_module(pkg, "deploy.kubeclient").KubeAPIServer(
            "http://127.0.0.1:1")
        out = []
        for kw in ({}, {"enable_culling": False},
                   {"enable_suspend": True}):
            mgr = m.make_cluster_manager(kapi, **kw)
            assert mgr.api.store is kapi.cache
            out.append([type(c).__name__ for c in mgr.controllers])
        return out, list(m.WATCHED_KINDS)
    assert _both(case)[0][1][:2] == ["NotebookController",
                                     "TPUJobController"]


# ---- the spawn call stack across the process boundary ------------------

def _spawn_through_rest(pkg):
    """``tests/test_deploy.py:318``: the cluster (apiserver, admission,
    fake kubelet, two hosts of the two-host slice) over HTTP, the
    platform's controllers outside it through the kube adapter
    (``make_cluster_manager``). Returns the pods' env and the cluster's
    whole object graph."""
    from tests.cp_fixtures import FakeClock

    nb_api = cp_module(pkg, "api.notebook")
    clock = FakeClock()
    c = RestCluster(pkg, clock=clock, admission=True, kubelet=True)
    stc = cp_module(pkg, "controllers.statefulset")
    make_node = stc.make_tpu_node if pkg == "jax" else stc.make_gpu_node
    try:
        c.api.ensure_namespace("u")
        for i in range(2):
            c.api.create(make_node(f"n{i}", SLICE[pkg]))
        kapi = cp_module(pkg, "deploy.kubeclient").KubeAPIServer(
            c.url, clock=clock)
        mgr = cp_module(pkg, "").make_cluster_manager(
            kapi, enable_culling=False)
        kapi.create(nb_api.make_notebook("nb", "u",
                                         accelerator_type=SLICE[pkg]))
        for _ in range(20):
            mgr.enqueue_all()
            mgr.run_until_idle()
            c.kubelet.run_until_idle()
            nb = kapi.get(nb_api.KIND, "nb", "u")
            if (nb.get("status") or {}).get("readyReplicas") == 2:
                break
        else:
            raise AssertionError(f"never went ready: {nb.get('status')}")
        assert kapi.get("StatefulSet", "nb", "u")["spec"]["replicas"] == 2
        assert mgr.errors == []
        envs = {p["metadata"]["name"]: {
            e["name"]: e.get("value")
            for e in p["spec"]["containers"][0].get("env", [])}
            for p in kapi.list("Pod", "u")}
        c.api.drain_watchers()
        graph = {k: c.api.list(k) for k in sorted(c.api._by_kind)}
        return envs, graph
    finally:
        c.close()


def test_spawn_call_stack_through_rest_boundary(parity):
    """The deployed layout spawns the same slice in both packages: the
    same env on each host's pod, and the clusters' whole object graphs
    (uids, resourceVersions, Events) equal after the key map."""
    outs = {}
    for pkg in PKGS:
        reset_uids(parity)
        outs[pkg] = _spawn_through_rest(pkg)
    (penv, pgraph), (jenv, jgraph) = outs["port"], key_map(outs["jax"])
    assert penv == jenv
    assert penv["nb-0"]["TPU_WORKER_ID"] == "0"
    assert penv["nb-1"]["TPU_WORKER_ID"] == "1"
    assert sorted(pgraph) == sorted(jgraph)
    for kind in jgraph:
        assert canon(pgraph[kind]) == canon(jgraph[kind]), kind


# ---- the watch backlog: gap replay and 410 ------------------------------

def _stream(url):
    """The first event of a watch stream, or None at its end."""
    with urllib.request.urlopen(url, timeout=10) as resp:
        for line in resp:
            if line.strip():
                return json.loads(line)
    return None


def test_watch_replays_gap_events(clusters):
    """Events landing between a client's LIST and its watch registration
    are replayed from the rv backlog, not dropped."""
    def case(pkg, c, kapi):
        kapi.list("ConfigMap", "u")
        rv = c.api._rv
        c.api.create(cp_module(pkg, "api.meta").make_object(
            "v1", "ConfigMap", "gap", "u"))
        evt = _stream(f"{kapi.base_url}/api/v1/namespaces/u/configmaps"
                      f"?watch=true&resourceVersion={rv}&timeoutSeconds=2")
        return evt["type"], evt["object"]["metadata"]["name"]
    assert _on_both(clusters, case) == ("ADDED", "gap")


def test_watch_resumed_at_rv_zero_replays_the_gap():
    """C12: a server that has written nothing lists at rv 0, and an
    informer resumes its watch there. The port's facade replays what
    landed in between; JAX's reads rv 0 as no resume and drops it."""
    c = RestCluster("port")
    try:
        kapi = cp_module("port", "deploy.kubeclient").KubeAPIServer(c.url)
        _, rv = kapi._list_raw("Namespace", None)
        assert rv == "0"
        c.api.ensure_namespace("gap")
        evt = _stream(f"{c.url}/api/v1/namespaces?watch=true"
                      f"&resourceVersion={rv}&timeoutSeconds=2")
        assert (evt["type"], evt["object"]["metadata"]["name"]) == \
            ("ADDED", "gap")
    finally:
        c.close()


def test_watch_stale_rv_gets_410(clusters):
    """A resume below the backlog horizon gets an ERROR event with 410
    Gone, so the informer relists instead of missing events."""
    def case(pkg, c, kapi):
        with c.rest._watch_lock:
            c.rest._backlog_floor = 10_000
        evt = _stream(f"{kapi.base_url}/api/v1/namespaces/u/configmaps"
                      "?watch=true&resourceVersion=1&timeoutSeconds=2")
        return evt["type"], evt["object"]["code"], evt["object"]["reason"]
    assert _on_both(clusters, case) == ("ERROR", 410, "Expired")


def test_kubeclient_pod_logs(clusters):
    def case(pkg, c, kapi):
        pod = cp_module(pkg, "api.meta").make_object("v1", "Pod", "p-0",
                                                     "u")
        pod["spec"] = {"containers": [{"name": "c", "image": "i"}]}
        kapi.create(pod)
        c.api.append_pod_log("u", "p-0", "line one")
        c.api.append_pod_log("u", "p-0", "line two")
        out = [kapi.pod_logs("u", "p-0"),
               kapi.pod_logs("u", "p-0", tail_lines=1),
               kapi.pod_logs("u", "p-0", tail_lines=0)]
        with pytest.raises(Exception, match="tailLines"):
            kapi.pod_logs("u", "p-0", tail_lines=-1)
        with pytest.raises(cp_module(pkg, "apiserver").NotFound):
            kapi.pod_logs("u", "nope")
        return out
    assert _on_both(clusters, case) == [
        "line one\nline two\n", "line two\n", ""]


# ---- conversion through the webhook server, the facade and the CRD -----

def _v1_nb(pkg, **kw):
    return cp_module(pkg, "api.notebook").make_notebook(
        "conv", "ns", accelerator_type=SLICE[pkg], num_slices=2, **kw)


def test_convert_endpoint_on_webhook_server():
    """``POST /convert`` speaks ConversionReview over HTTP — what the
    CRD's ``strategy: Webhook`` clientConfig points at."""
    def case(pkg):
        def run(url):
            out = _post(f"{url}/convert", {"request": {
                "uid": "x", "desiredAPIVersion": "kubeflow.org/v1beta1",
                "objects": [_v1_nb(pkg)]}})
            assert out["kind"] == "ConversionReview"
            obj = out["response"]["convertedObjects"][0]
            assert obj["metadata"]["annotations"][cp_module(
                pkg, "api.conversion").TPU_ACCELERATOR_ANNOTATION] == \
                SLICE[pkg]
            return out
        return _webhook(pkg, run)
    _both(case)


def _facade_versions(pkg, ann_keys, version):
    """Create a Notebook through ``version``'s collection path (the
    slice in ``ann_keys``' annotations), read it back through every
    served version, list and merge-patch it in ``version``. Returns what
    each step saw."""
    acc_key, slices_key = ann_keys
    c = RestCluster(pkg)
    try:
        c.api.ensure_namespace("ns")
        sess = cp_module(pkg, "deploy.kubeclient").KubeAPIServer(
            c.url)._session
        base = f"{c.url}/apis/kubeflow.org"
        obj = {"apiVersion": f"kubeflow.org/{version}", "kind": "Notebook",
               "metadata": {"name": "legacy", "namespace": "ns",
                            "annotations": {acc_key: SLICE[pkg],
                                            slices_key: "2"}},
               "spec": {"template": {"spec": {"containers": [
                   {"name": "legacy", "image": "jupyter:latest"}]}}}}
        resp = sess.post(f"{base}/{version}/namespaces/ns/notebooks",
                         json=obj)
        assert resp.status_code == 201, resp.text
        created = resp.json()
        assert created["apiVersion"] == f"kubeflow.org/{version}"
        assert "tpu" not in created["spec"]
        stored = c.api.get("Notebook", "legacy", "ns")
        assert stored["spec"]["tpu"] == {"acceleratorType": SLICE[pkg],
                                         "numSlices": 2}
        assert acc_key not in (stored["metadata"].get("annotations") or {})
        views = {v: sess.get(f"{base}/{v}/namespaces/ns/notebooks/"
                             "legacy").json()
                 for v in ("v1", "v1beta1", "v1alpha1")}
        assert views["v1"]["spec"]["tpu"]["acceleratorType"] == SLICE[pkg]
        assert views[version]["metadata"]["annotations"][slices_key] == "2"
        lst = sess.get(f"{base}/{version}/namespaces/ns/notebooks").json()
        assert all("tpu" not in it["spec"] for it in lst["items"])
        resp = sess.patch(
            f"{base}/{version}/namespaces/ns/notebooks/legacy",
            json={"metadata": {"annotations": {slices_key: "4"}}},
            headers={"Content-Type": "application/merge-patch+json"})
        assert resp.status_code == 200, resp.text
        after = c.api.get("Notebook", "legacy", "ns")
        assert after["spec"]["tpu"]["numSlices"] == 4
        for o in (created, stored, *views.values(), *lst["items"],
                  after):
            o["metadata"].pop("creationTimestamp", None)
        return created, stored, views, lst, after
    finally:
        c.close()


def test_rest_facade_serves_both_versions_over_one_store(parity):
    """Create through the v1beta1 path (annotations), read it back as v1
    (``spec.tpu``) and v1beta1; a v1beta1 merge-patch lands in the
    stored v1 object."""
    def case(pkg):
        conv = cp_module(pkg, "api.conversion")
        return _facade_versions(pkg, (conv.TPU_ACCELERATOR_ANNOTATION,
                                      conv.TPU_NUM_SLICES_ANNOTATION),
                                "v1beta1")
    _both(case, parity)


def test_notebook_crd_declares_both_versions_and_conversion():
    def case(pkg):
        conv = cp_module(pkg, "api.conversion")
        crd = cp_module(pkg, "deploy.crds").notebook_crd()
        versions = {v["name"]: v for v in crd["spec"]["versions"]}
        assert set(versions) == set(conv.SERVED_VERSIONS)
        assert versions[conv.STORAGE_VERSION]["storage"] is True
        assert versions["v1beta1"]["storage"] is False
        assert versions["v1beta1"]["served"] is True
        beta = versions["v1beta1"]["schema"]["openAPIV3Schema"][
            "properties"]["spec"]["properties"]
        assert "tpu" not in beta
        assert crd["spec"]["conversion"]["strategy"] == "Webhook"
        assert crd["spec"]["conversion"]["webhook"]["clientConfig"][
            "service"]["path"] == "/convert"
        return drop_enums(crd)
    _both(case)


def test_rest_facade_serves_v1alpha1_over_one_store(parity):
    """Create through the oldest path (the bare ``kubeflow.org/tpu-*``
    keys); the stored hub object and the v1 view carry ``spec.tpu``."""
    def case(pkg):
        conv = cp_module(pkg, "api.conversion")
        return _facade_versions(
            pkg, (conv.LEGACY_TPU_ACCELERATOR_ANNOTATION,
                  conv.LEGACY_TPU_NUM_SLICES_ANNOTATION), "v1alpha1")
    _both(case, parity)


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
