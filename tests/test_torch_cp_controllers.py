"""Object-graph parity of the notebook platform's controllers beyond the
spawn path: the same script on JAX's ``make_control_plane()`` and on the
port's (the informer cache on, JAX's default; the culler on a fake clock
where a case culls), then every object of every kind on both servers —
Events included — compared after the key map
(``torch_cp_parity.key_map``).

- profiles (``controllers/profile.py``): with and without a card quota,
  the quota edited and removed, the quota refusing a slice, deletion
  through the finalizer;
- slice health (``controllers/slicehealth.py``): a single host's failed
  pod recycled, one failed pod of a 2 × 4 slice restarting every ordinal
  (``SliceRestart``, the Event's words mapped), a vanished ordinal, a
  stopped notebook left alone;
- culling (``controllers/culling.py``): idle culled at the same instant
  on both, a busy kernel kept, the exclude annotation, both endpoints
  unreachable, and the default probe against a stdlib HTTP server;
- TensorBoard and the PVC viewer: their Deployments and Services, the
  ReadWriteOnce node pinning;
- TPUJob (``controllers/tpujob.py``): two roles gang-bound, the phase
  ladder, a role's failure, delete; the suspend branch refused.

(Counterparts of ``tests/test_profile_controller.py``,
``test_slicehealth.py``, ``test_culling.py`` and ``test_tpujob.py``.)
"""

import importlib
import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import pytest

from kubeflow_rm_tpu_torch.controlplane import metrics as port_metrics

from tests.cp_fixtures import FakeClock
from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, NS, jax_switch_defaults, parity, reset_uids,
    run_full, stop_fanout,
)

CULL = {"cull_idle_minutes": 60.0, "check_period_minutes": 1.0}


def _events(dump, reason):
    return [e for e in dump.get("Event", []) if e["reason"] == reason]


def _pod_names(S):
    return sorted(p["metadata"]["name"] for p in S.api.list("Pod", NS))


# ---- profiles ----------------------------------------------------------

@pytest.mark.parametrize("quota", [False, True])
def test_profile_provisions_namespace_rbac_and_quota(parity, quota):
    def script(S):
        prof = S.m("api.profile")
        S.api.create(prof.make_profile(
            NS, "bob@corp.com",
            quota_hard={S.card_key: "8", "pods": "20"} if quota else None))
        S.mgr.enqueue_all()
        S.run()
        return S.api.try_get("ResourceQuota", prof.QUOTA_NAME, NS)

    rq, dump = run_full(parity, script)
    assert (rq is not None) == quota
    if quota:
        assert rq["spec"]["hard"] == {"nvidia.com/gpu": "8", "pods": "20"}
    (ns,) = dump["Namespace"]
    assert ns["metadata"]["annotations"] == {"owner": "bob@corp.com"}
    assert {r["metadata"]["name"] for r in dump["RoleBinding"]} == {
        "namespaceAdmin", "default-editor", "default-viewer"}
    assert [a["metadata"]["name"] for a in dump["AuthorizationPolicy"]] \
        == ["ns-owner-access-istio"]


def test_quota_edited_removed_and_profile_deleted(parity):
    def script(S):
        prof = S.m("api.profile")
        S.api.create(prof.make_profile(NS, "carol@corp.com",
                                       quota_hard={S.card_key: "4"}))
        S.mgr.enqueue_all()
        S.run()
        p = S.api.get("Profile", NS)
        p["spec"]["resourceQuotaSpec"] = {"hard": {S.card_key: "16"}}
        S.api.update(p)
        S.run()
        edited = S.api.get("ResourceQuota", prof.QUOTA_NAME, NS)["spec"]
        p = S.api.get("Profile", NS)
        del p["spec"]["resourceQuotaSpec"]
        S.api.update(p)
        S.run()
        removed = S.api.try_get("ResourceQuota", prof.QUOTA_NAME, NS)
        finalizers = S.api.get("Profile", NS)["metadata"]["finalizers"]
        S.api.delete("Profile", NS)
        S.run()
        return [edited, removed, finalizers,
                S.api.try_get("Profile", NS),
                S.api.try_get("Namespace", NS),
                S.api.list("ServiceAccount", NS)]

    (edited, removed, fin, prof, ns, sas), _ = run_full(parity, script)
    assert edited == {"hard": {"nvidia.com/gpu": "16"}}
    assert removed is None and fin == ["profile-finalizer"]
    assert prof is None and ns is None and sas == []


def test_quota_refuses_a_slice_over_the_namespace_budget(parity):
    """One card in the quota: a 1-card notebook binds, a second is
    refused whole (no pod) by the StatefulSet's pre-check, recorded as
    JAX records it (a ``SliceAdmissionFailed`` Event, which names no
    quota); a pod created past the pre-check is denied by the
    apiserver's quota admission, which names ``kf-resource-quota``."""
    def script(S):
        prof = S.m("api.profile")
        S.node("n0", "h100-80gb-1")
        S.node("n1", "h100-80gb-1")
        S.api.create(prof.make_profile(NS, "dave@corp.com",
                                       quota_hard={S.card_key: "1"}))
        S.mgr.enqueue_all()
        S.run()
        S.api.create(S.notebook("ft", "h100-80gb-1"))
        S.run()
        S.api.create(S.notebook("ft2", "h100-80gb-1"))
        S.run()
        sts = S.api.get("StatefulSet", "ft2", NS)
        direct = S.api.get("Pod", "ft-0", NS)
        direct["metadata"] = {"name": "direct", "namespace": NS}
        direct["spec"].pop("nodeName", None)
        direct.pop("status", None)
        try:
            S.api.create(direct)
            denied = None
        except S.m("apiserver").APIError as e:
            denied = str(e).split(":")[0]    # the rest names the resource
        return [_pod_names(S),
                [e["message"] for e in S.api.events_for(sts)
                 if e["reason"] == "SliceAdmissionFailed"], denied]

    (pods, msgs, denied), _ = run_full(parity, script)
    assert pods == ["ft-0"]
    assert msgs == ["namespace quota cannot admit all 1 hosts of the "
                    "slice; rejecting whole (slice admission is "
                    "all-or-nothing)"]
    assert denied == "exceeded quota kf-resource-quota"


# ---- slice health -------------------------------------------------------

def _fail(S, pod_name):
    pod = S.api.get("Pod", pod_name, NS)
    pod["status"] = {"phase": "Failed"}
    S.api.update_status(pod)


@pytest.mark.parametrize("case", ["single_host_failed", "slice_failed",
                                  "slice_vanished", "stopped"])
def test_slice_health(parity, case):
    def script(S):
        S.api.ensure_namespace(NS)
        acc = "h100-80gb-1" if case == "single_host_failed" \
            else "h100-80gb-2x4"
        hosts = S.topo(S.slice(acc)).hosts
        for i in range(hosts):
            S.node(f"n{i}", acc)
        S.api.create(S.notebook("nb", acc))
        S.run()
        before = {p["metadata"]["name"]: p["metadata"]["uid"]
                  for p in S.api.list("Pod", NS)}
        if case == "stopped":
            nb = S.api.get(S.nb_api.KIND, "nb", NS)
            nb["metadata"]["annotations"][S.nb_api.STOP_ANNOTATION] = "x"
            S.api.update(nb)
            S.run()
        if case == "slice_vanished":
            S.api.delete("Pod", "nb-1", NS)
        else:
            for name in ("nb-1" if hosts > 1 else "nb-0",):
                if S.api.try_get("Pod", name, NS) is not None:
                    _fail(S, name)
        S.run()
        after = {p["metadata"]["name"]: (p["metadata"]["uid"],
                                         p["status"].get("phase"))
                 for p in S.api.list("Pod", NS)}
        return [before, after]

    (before, after), dump = run_full(parity, script, global_lock=True)
    restarts = _events(dump, "SliceRestart")
    if case == "stopped":
        assert after == {} and restarts == []
        return
    assert set(after) == set(before)
    if case == "single_host_failed":
        assert after["nb-0"] == (after["nb-0"][0], "Running")
        assert after["nb-0"][0] != before["nb-0"] and restarts == []
        return
    # every ordinal restarted, not only the one that failed (under
    # serial writes both packages leave the new gang Pending: see
    # test_slice_restart_rebinds_under_parallel_writes)
    assert all(after[n][0] != before[n] for n in before)
    (ev,) = restarts
    assert ev["message"].startswith("GPU slice unhealthy (")
    assert ("1 failed pod(s)" in ev["message"]) == (case == "slice_failed")


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_slice_restart_rebinds_under_parallel_writes(parity, pkg):
    """With the child writes fanned out (each package's default), the
    restarted 2 × 4 slice binds again and runs. Under serial writes both
    packages leave it Pending (a reference behaviour of JAX's serial arm,
    which the parity cases above run and which the port reproduces)."""
    from kubeflow_rm_tpu.controlplane import runtime as jax_runtime
    from kubeflow_rm_tpu_torch.controlplane import runtime as port_runtime
    from tests.torch_cp_parity import Side

    parity.setattr(jax_runtime, "_serial_writes", False)
    parity.setattr(port_runtime, "_serial_writes", False)
    S = Side(pkg, full=True, cached=True)
    try:
        S.api.ensure_namespace(NS)
        for i in range(2):
            S.node(f"n{i}", "h100-80gb-2x4")
        S.api.create(S.notebook("nb", "h100-80gb-2x4"))
        S.run()
        before = {p["metadata"]["uid"] for p in S.api.list("Pod", NS)}
        _fail(S, "nb-1")
        S.run()
        pods = S.api.list("Pod", NS)
        assert [p["metadata"]["name"] for p in pods] == ["nb-0", "nb-1"]
        assert {p["metadata"]["uid"] for p in pods}.isdisjoint(before)
        assert [p["status"]["phase"] for p in pods] == ["Running"] * 2
    finally:
        S.close()


# ---- culling ------------------------------------------------------------

@pytest.mark.parametrize("case", ["idle", "busy", "exclude",
                                  "unreachable"])
def test_culling(parity, case):
    def script(S):
        S.api.ensure_namespace(NS)
        for i in range(2):
            S.node(f"n{i}", "h100-80gb-2x4")
        ann = ({S.nb_api.CULLING_EXCLUDE_ANNOTATION: "true"}
               if case == "exclude" else None)
        S.jupyter.activity()
        S.api.create(S.notebook("nb", "h100-80gb-2x4", annotations=ann))
        S.run()
        if case == "unreachable":
            S.jupyter.kernels = None
        S.clock.advance(minutes=45)
        if case == "busy":
            S.jupyter.activity(busy=True)
        S.run()
        S.clock.advance(minutes=16)
        S.run()
        nb = S.api.get(S.nb_api.KIND, "nb", NS)
        return [nb["metadata"]["annotations"], _pod_names(S)]

    before = port_metrics.NOTEBOOK_CULL_TOTAL.get()
    (ann, pods), dump = run_full(parity, script, culling=CULL)
    culled = case in ("idle", "unreachable")
    stop = "kubeflow-resource-stopped"
    assert (stop in ann) == culled
    assert pods == ([] if culled else ["nb-0", "nb-1"])
    assert len(_events(dump, "Culling")) == int(culled)
    assert port_metrics.NOTEBOOK_CULL_TOTAL.get() == before + int(culled)
    if culled:
        # the same instant on both: 61 minutes after the spawn
        assert ann[stop] == "2026-01-01T01:01:00+00:00"
    assert len(_events(dump, "CullingProbeFailed")) == int(
        case == "unreachable")


class _Jupyter(BaseHTTPRequestHandler):
    """Jupyter's ``/api/kernels`` and ``/api/terminals`` (terminals off:
    404, as a server with terminals disabled answers)."""
    kernels: list = []

    def do_GET(self):
        if self.path.endswith("/kernels"):
            body = json.dumps(self.kernels).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_error(404)

    def log_message(self, *args):
        pass


def test_default_probe_reads_a_live_server_as_jax_does():
    """``default_probe(base_url=)`` (the smoke's seam) against a stdlib
    HTTP server: the kernels answer survives a 404 on terminals, in both
    packages."""
    from kubeflow_rm_tpu.controlplane.controllers import culling as jcull
    from kubeflow_rm_tpu_torch.controlplane.controllers import (
        culling as pcull,
    )

    _Jupyter.kernels = [{"execution_state": "idle",
                         "last_activity": "2026-01-01T00:00:00+00:00"}]
    server = HTTPServer(("127.0.0.1", 0), _Jupyter)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/api"
        nb = {"metadata": {"name": "nb", "namespace": NS}}
        got = [mod.default_probe(nb, None, base_url=url)
               for mod in (pcull, jcull)]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
    assert got[0] == got[1] == {"kernels": _Jupyter.kernels}


# ---- TensorBoard and the PVC viewer -------------------------------------

def test_tensorboard_and_pvcviewer_render(parity):
    def script(S):
        tb = S.m("controllers.tensorboard")
        pv = S.m("controllers.pvcviewer")
        meta = S.m("api.meta")
        S.api.ensure_namespace(NS)
        S.node("n0", "h100-80gb-1")
        pvc = meta.make_object("v1", "PersistentVolumeClaim", "logs", NS,
                               spec={"accessModes": ["ReadWriteOnce"]})
        S.api.create(pvc)
        # a running notebook mounts the claim: RWO pins to its node
        S.api.create(S.notebook("nb", "h100-80gb-1", pod_spec_extra={
            "volumes": [{"name": "logs", "persistentVolumeClaim": {
                "claimName": "logs"}}]}))
        S.run()
        S.api.create(tb.make_tensorboard("tb-pvc", NS, "pvc://logs/run1"))
        S.api.create(tb.make_tensorboard("tb-gcs", NS, "gs://bucket/runs"))
        S.api.create(pv.make_pvcviewer("view", NS, "logs"))
        S.run()
        return {d["metadata"]["name"]: d["spec"]["template"]["spec"]
                for d in S.api.list("Deployment", NS)}

    specs, dump = run_full(parity, script)
    assert specs["tb-pvc"]["nodeName"] == "n0"
    assert specs["view-pvcviewer"]["nodeName"] == "n0"
    assert specs["tb-gcs"]["serviceAccountName"] == "default-editor"
    assert {t["metadata"]["name"]: t["status"]
            for t in dump["Tensorboard"]} == {
        "tb-gcs": {"readyReplicas": 1}, "tb-pvc": {"readyReplicas": 1}}
    assert dump["PVCViewer"][0]["status"] == {"ready": True}


# ---- TPUJob -------------------------------------------------------------

def _job(S, name="pr", actors=2):
    return S.tj_api.make_tpujob(name, NS, roles=[
        {"name": "learner", "replicas": 1,
         "tpu": {"acceleratorType": S.slice("h100-80gb-2x4")}},
        {"name": "actors", "replicas": actors, "cpu": "2"},
    ])


def test_tpujob_gang_phases_failure_and_delete(parity):
    reached = []
    parity.setattr("kubeflow_rm_tpu_torch.controlplane.suspend."
                   "kick_pending_pods",
                   lambda api, *, now: reached.append(now))

    def script(S):
        S.api.ensure_namespace(NS)
        for i in range(2):
            S.node(f"n{i}", "h100-80gb-2x4")
        S.api.create(_job(S))
        S.run()
        job = S.api.get(S.tj_api.KIND, "pr", NS)
        running = [job["status"], _pod_names(S)]
        _fail(S, "pr-actors-1")
        S.run()
        failed = S.api.get(S.tj_api.KIND, "pr", NS)["status"]["phase"]
        S.api.delete(S.tj_api.KIND, "pr", NS)
        S.run()
        return running + [failed, _pod_names(S),
                          sorted(s["metadata"]["name"] for s in
                                 S.api.list("StatefulSet", NS))]

    (status, pods, failed, left, sts), dump = run_full(parity, script)
    assert status["phase"] == "Running"
    assert status["roles"] == {"learner": {"ready": 2, "total": 2},
                               "actors": {"ready": 2, "total": 2}}
    assert pods == ["pr-actors-0", "pr-actors-1", "pr-learner-0",
                    "pr-learner-1"]
    assert failed == "Failed"
    assert left == [] and sts == []
    phases = [e["reason"] for e in dump["Event"]
              if e["involvedObject"]["kind"] == "TPUJob"
              and e["type"] == "Normal"]
    assert phases[0] in ("Pending", "Provisioning") and \
        phases[-2:] == ["Running", "Failed"]
    assert reached == []


def test_tpujob_learner_pods_get_the_card_env(parity):
    def script(S):
        S.api.ensure_namespace(NS)
        S.node("n0", "h100-80gb-1")
        S.api.create(S.tj_api.make_tpujob("one", NS, roles=[
            {"name": "worker", "replicas": 1,
             "tpu": {"acceleratorType": S.slice("h100-80gb-1")}}]))
        S.run()
        pod = S.api.get("Pod", "one-worker-0", NS)
        c0 = pod["spec"]["containers"][0]
        return [pod["spec"]["nodeName"], c0["resources"]["limits"],
                {e["name"]: e.get("value") for e in c0["env"]},
                S.api.get(S.tj_api.KIND, "one", NS)["status"]["phase"]]

    (node, limits, env, phase), _ = run_full(parity, script)
    assert node == "n0" and limits == {"nvidia.com/gpu": "1"}
    assert env["TPU_WORKER_ID"] == "0" and phase == "Running"


def test_tpujob_suspend_branch_is_refused(parity):
    """The whole-gang suspend's drain branch (once refused, ROADMAP slice
    7d) now ends in ``kick_pending_pods``: the job is stamped drained and
    every pod still waiting for cards gets the reschedule kick, so its
    owner retries the gang-bind — in the port as in JAX, on one
    script."""
    def run(pkg):
        root = "kubeflow_rm_tpu" if pkg == "jax" else "kubeflow_rm_tpu_torch"
        nb_api = importlib.import_module(f"{root}.controlplane.api.notebook")
        tj_api = importlib.import_module(f"{root}.controlplane.api.tpujob")
        srv = importlib.import_module(f"{root}.controlplane.apiserver")
        ctl = importlib.import_module(
            f"{root}.controlplane.controllers.tpujob")
        rt = importlib.import_module(f"{root}.controlplane.runtime")
        susp = importlib.import_module(f"{root}.controlplane.suspend")
        reset_uids(parity)
        api = srv.APIServer(FakeClock())
        api.register_validator(tj_api.KIND, tj_api.validate)
        try:
            api.ensure_namespace(NS)
            api.create(tj_api.make_tpujob("susp", NS, roles=[
                {"name": "actors", "replicas": 1, "cpu": "1"}],
                annotations={nb_api.SUSPEND_ANNOTATION: "now"}))
            api.create({"apiVersion": "v1", "kind": "Pod",
                        "metadata": {"name": "waiting", "namespace": NS},
                        "spec": {"containers": [{"name": "c"}]}})
            ctl.TPUJobController().reconcile(api, rt.Request(NS, "susp"))
            job = api.get(tj_api.KIND, "susp", NS)
            pod = api.get("Pod", "waiting", NS)
            return (nb_api.SUSPEND_DRAINED_ANNOTATION
                    in job["metadata"]["annotations"],
                    str(pod["metadata"]["annotations"][
                        susp._KICK_ANNOTATION]),
                    [e["reason"] for e in api.events_for(job)])
        finally:
            stop_fanout(api)

    port, jax = run("port"), run("jax")
    assert port == jax
    drained, kick, reasons = port
    assert drained and kick.startswith("2026-01-01") and "Suspended" in reasons


SERIES = ("NOTEBOOK_CULL_TOTAL", "PROFILE_CREATE_TOTAL",
          "CACHE_READS_TOTAL", "CACHE_SUPPRESSED_WRITES_TOTAL",
          "CACHE_CONFLICT_FASTPATH_TOTAL", "INFORMER_EVENTS_TOTAL",
          "INFORMER_LAST_EVENT_TIMESTAMP", "INFORMER_SYNCED_KINDS",
          "TPUJOB_PHASE_TRANSITIONS_TOTAL", "TPUJOB_RUNNING",
          "TPUJOB_READY_PODS")


@pytest.mark.parametrize("attr", SERIES)
def test_series_render_in_jax_names(attr):
    """Each series these controllers and the cache set scrapes under
    JAX's name, help text, type and labels."""
    import prometheus_client

    from kubeflow_rm_tpu.controlplane import metrics as jax_metrics

    jm, pm = getattr(jax_metrics, attr), getattr(port_metrics, attr)
    assert tuple(pm.labelnames) == tuple(jm._labelnames)
    jtext = prometheus_client.generate_latest(
        jax_metrics.REGISTRY).decode().splitlines()
    ptext = port_metrics.render().splitlines()
    name = pm.series_name()
    for tag in ("HELP", "TYPE"):
        want = [ln for ln in jtext if ln.startswith(f"# {tag} {name} ")]
        got = [ln for ln in ptext if ln.startswith(f"# {tag} {name} ")]
        assert got == want and len(got) == 1, (tag, got, want)


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
