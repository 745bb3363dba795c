"""Object-graph parity of the control plane's spawn path: the same script
of API calls on JAX's stack and on the port's, then every object of
every kind on both servers compared after the key map
(``torch_cp_parity.key_map``: ``google.com/tpu`` → ``nvidia.com/gpu``,
the GKE TPU node labels → the GPU ones, the TPU slice types → the
``h100-80gb-*`` ones). Names, labels, annotations, env, owner
references, uids, resourceVersions, Events and status are equal.

JAX runs each script twice: its manager on the raw API, and on its
informer cache (``Manager(CachedAPI(api))``, its default); both end
states must equal the port's ``cache=False`` run, so leaving the cache
to a later slice changes no object. (Counterparts of
``tests/test_notebook_controller.py``.)
"""

import json

import pytest

from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, NS, Side, canon, parity, jax_switch_defaults,
    key_map, reset_uids,
)

ARMS = ("raw", "cached")


def _inventory(S, acc="h100-80gb-2x4", n=4):
    """``n`` nodes of one host type. One type a case: the GPU vocabulary
    has one accelerator family and names a host's shape by its card
    count, so a single-host 4-card node matches a 2 × 4 slice's selector
    where JAX's v5p-8 host does not match v5p-16's topology — a mixed
    inventory may place differently, by design."""
    S.api.ensure_namespace(NS)
    for i in range(n):
        S.node(f"{acc}-{i}", acc)


def _spawn(S, nb):
    S.api.create(nb)
    S.run()


def run_parity(monkeypatch, script):
    """Run ``script(S)`` on the port's stack and on JAX's two arms, with
    the same uids, and assert each JAX end state maps onto the port's.
    Returns (port side's result, port dump). ``monkeypatch`` is the
    ``parity`` fixture's."""
    sides = []
    try:
        port = Side("port")
        sides.append(port)
        port_out = script(port)
        port_dump = port.dump()
        for arm in ARMS:
            reset_uids(monkeypatch)
            J = Side("jax", cached=arm == "cached")
            sides.append(J)
            jax_out = script(J)
            assert key_map(jax_out) == port_out, arm
            mapped = key_map(J.dump())
            assert sorted(mapped) == sorted(port_dump), arm
            for kind in port_dump:
                assert canon(mapped[kind]) == canon(port_dump[kind]), \
                    (arm, kind)
        return port_out, port_dump
    finally:
        for S in sides:
            S.close()


def _pods(S, name):
    return S.api.list("Pod", NS, {"matchLabels": {
        S.nb_api.NOTEBOOK_NAME_LABEL: name}})


def test_cpu_notebook(parity):
    def script(S):
        _inventory(S)
        _spawn(S, S.notebook("plain"))
        return [p["spec"]["nodeName"] for p in _pods(S, "plain")]

    nodes, dump = run_parity(parity, script)
    assert len(nodes) == 1
    (sts,) = dump["StatefulSet"]
    assert sts["spec"]["replicas"] == 1
    assert "nodeSelector" not in sts["spec"]["template"]["spec"]


@pytest.mark.parametrize("acc", ["h100-80gb-1", "h100-80gb-4",
                                 "h100-80gb-8"])
def test_one_host_slice(parity, acc):
    def script(S):
        _inventory(S, acc, 2)
        _spawn(S, S.notebook("nb", acc))
        return [(p["spec"]["nodeName"], p["status"]["phase"])
                for p in _pods(S, "nb")]

    placed, dump = run_parity(parity, script)
    assert len(placed) == 1 and placed[0][1] == "Running"
    (sts,) = dump["StatefulSet"]
    tmpl = sts["spec"]["template"]["spec"]
    cards = acc.rsplit("-", 1)[1]
    assert tmpl["containers"][0]["resources"]["limits"] == {
        "nvidia.com/gpu": cards}
    # single-host slices select on the accelerator alone
    assert tmpl["nodeSelector"] == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
    (nb,) = dump["Notebook"]
    assert nb["status"]["readyReplicas"] == 1


def test_multihost_slice(parity):
    def script(S):
        _inventory(S)
        _spawn(S, S.notebook("big", "h100-80gb-2x4"))
        return sorted(p["spec"]["nodeName"] for p in _pods(S, "big"))

    nodes, dump = run_parity(parity, script)
    assert len(set(nodes)) == 2
    (sts,) = [s for s in dump["StatefulSet"]
              if s["metadata"]["name"] == "big"]
    assert sts["spec"]["replicas"] == 2
    assert sts["spec"]["podManagementPolicy"] == "Parallel"
    assert sts["spec"]["template"]["spec"]["nodeSelector"] == {
        "cloud.google.com/gke-accelerator": "nvidia-h100-80gb",
        "nvidia.com/gpu.count": "4"}
    pod1 = next(p for p in dump["Pod"] if p["metadata"]["name"] == "big-1")
    env = {e["name"]: e["value"] for e in pod1["spec"]["containers"][0]["env"]}
    assert env["TPU_WORKER_ID"] == "1"
    assert env["TPU_ACCELERATOR_TYPE"] == "h100-80gb-2x4"
    assert env["TPU_TOPOLOGY"] == "4"
    assert env["TPU_WORKER_HOSTNAMES"] == (
        "big-0.big-workers.user1.svc.cluster.local,"
        "big-1.big-workers.user1.svc.cluster.local")


def test_multislice_notebook(parity):
    def script(S):
        _inventory(S)
        _spawn(S, S.notebook("ms", "h100-80gb-2x4", num_slices=2))
        return [p["metadata"]["name"] for p in _pods(S, "ms")]

    names, dump = run_parity(parity, script)
    assert names == ["ms-0", "ms-1", "ms-2", "ms-3"]
    envs = {p["metadata"]["name"]: {e["name"]: e["value"] for e in
                                    p["spec"]["containers"][0]["env"]}
            for p in dump["Pod"]}
    assert envs["ms-3"]["MEGASCALE_NUM_SLICES"] == "2"
    assert envs["ms-3"]["MEGASCALE_SLICE_ID"] == "1"
    assert envs["ms-3"]["TPU_WORKER_ID"] == "1"
    assert envs["ms-3"]["MEGASCALE_COORDINATOR_ADDRESS"] == \
        "ms-0.ms-workers.user1.svc.cluster.local"


def test_stop_zero_replicas_restart(parity):
    def script(S):
        _inventory(S, "h100-80gb-8", 1)
        _spawn(S, S.notebook("s", "h100-80gb-8"))
        nb = S.api.get(S.nb_api.KIND, "s", NS)
        nb["metadata"].setdefault("annotations", {})[
            S.nb_api.STOP_ANNOTATION] = "2026-07-29T00:00:00"
        S.api.update(nb)
        S.run()
        stopped = (S.api.get("StatefulSet", "s", NS)["spec"]["replicas"],
                   len(_pods(S, "s")))
        nb = S.api.get(S.nb_api.KIND, "s", NS)
        del nb["metadata"]["annotations"][S.nb_api.STOP_ANNOTATION]
        S.api.update(nb)
        S.run()
        return [stopped, len(_pods(S, "s"))]

    (stopped, restarted), dump = run_parity(parity, script)
    assert stopped == (0, 0) and restarted == 1
    (nb,) = dump["Notebook"]
    assert nb["status"]["restartEpoch"] == 1


def test_unschedulable_slice_event_on_notebook(parity):
    def script(S):
        _inventory(S, n=1)        # one host of a two-host slice
        _spawn(S, S.notebook("land", "h100-80gb-2x4"))
        return [(e["reason"], e["message"])
                for e in S.api.events_for(S.api.get(S.nb_api.KIND, "land",
                                                    NS))]

    events, dump = run_parity(parity, script)
    assert ("FailedScheduling", "[pod land-0] no node matches TPU "
            "nodeSelector with free nvidia.com/gpu capacity") in events
    assert all(p["status"]["phase"] == "Pending" for p in dump["Pod"])


def test_unknown_accelerator_rejected(parity):
    def script(S):
        _inventory(S)
        with pytest.raises(Exception) as e:
            S.api.create(S.nb_api.make_notebook(
                "bad", NS, accelerator_type="v99-frobnitz"))
        return type(e.value).__name__

    err, dump = run_parity(parity, script)
    assert err == "Invalid"
    assert "Notebook" not in dump


def test_delete_collects_children(parity):
    def script(S):
        _inventory(S, "h100-80gb-8", 1)
        _spawn(S, S.notebook("gone", "h100-80gb-8"))
        before = sorted(S.api._by_kind)
        S.api.delete(S.nb_api.KIND, "gone", NS)
        S.run()
        return [before, [k for k in ("StatefulSet", "Service", "Pod",
                                     "VirtualService")
                         if S.api.list(k, NS)]]

    (before, left), dump = run_parity(parity, script)
    assert {"StatefulSet", "Service", "Pod", "VirtualService"} <= set(before)
    assert left == []


@pytest.mark.parametrize("annotated", [True, False])
def test_virtualservice(parity, annotated):
    def script(S):
        _inventory(S)
        ann = {S.nb_api.REWRITE_URI_ANNOTATION: "/custom",
               S.nb_api.HEADERS_ANNOTATION: json.dumps(
                   {"X-RStudio-Root-Path": "/notebook/user1/nb/"})}
        _spawn(S, S.notebook("nb", "h100-80gb-2x4",
                             annotations=ann if annotated else None))
        return S.api.get("VirtualService", "notebook-user1-nb", NS)["spec"]

    spec, _ = run_parity(parity, script)
    (route,) = spec["http"]
    assert route["rewrite"] == {"uri": "/custom" if annotated else "/"}
    assert ("headers" in route) == annotated


def test_priced_declaration_per_pod_share(parity):
    """The predicted annotations (what the pricer stamps) fan out onto
    each host pod as its share."""
    from kubeflow_rm_tpu_torch.controlplane.api import gpu

    def script(S):
        _inventory(S)
        _spawn(S, S.notebook("priced", "h100-80gb-2x4", annotations={
            gpu.PREDICTED_HBM_ANNOTATION: "61.25",
            gpu.PREDICTED_FLOPS_ANNOTATION: "1.5e+15"}))
        return [p["metadata"]["annotations"] for p in _pods(S, "priced")]

    anns, _ = run_parity(parity, script)
    assert anns == [{gpu.PREDICTED_HBM_ANNOTATION: "30.6250",
                     gpu.PREDICTED_FLOPS_ANNOTATION: "7.5e+14"}] * 2


def test_gang_statefulsets(parity):
    """Two hand-made role StatefulSets of one gang: the first role's
    binds the whole gang (card pods and CPU actors) in one assume
    transaction, and the webhook injects the role env."""

    def sts(S, role, replicas, template_spec, roles, acc=None):
        labels = {"statefulset": f"job-{role}",
                  S.tj_api.JOB_NAME_LABEL: "job",
                  S.tj_api.JOB_ROLE_LABEL: role}
        if acc:
            labels[S.nb_api.TPU_ACCELERATOR_LABEL] = acc
        return {"apiVersion": "apps/v1", "kind": "StatefulSet",
                "metadata": {"name": f"job-{role}", "namespace": NS},
                "spec": {"replicas": replicas,
                         "serviceName": f"job-{role}",
                         "selector": {"matchLabels": {
                             "statefulset": f"job-{role}"}},
                         "template": {"metadata": {
                             "labels": labels,
                             "annotations": {
                                 S.tj_api.JOB_ROLES_ANNOTATION: roles}},
                             "spec": template_spec}}}

    def script(S):
        _inventory(S)
        acc = S.slice("h100-80gb-2x4")
        topo = S.topo(acc)
        roles = json.dumps([
            {"name": "learner", "pods": 2, "service": "job-learner",
             "tpu": acc},
            {"name": "actors", "pods": 3, "service": "job-actors",
             "tpu": None}], separators=(",", ":"))
        learner = {"containers": [{"name": "l", "image": "img",
                                   "resources": {"limits": {
                                       S.card_key: "4"}}}],
                   "nodeSelector": S.make_node("x", acc)["metadata"][
                       "labels"]}
        actor = {"containers": [{"name": "a", "image": "img",
                                 "resources": {"requests": {"cpu": "2"}}}]}
        assert topo.hosts == 2
        S.api.create(sts(S, "learner", 2, learner, roles, acc))
        S.api.create(sts(S, "actors", 3, actor, roles))
        S.run()
        return sorted((p["metadata"]["name"], p["spec"].get("nodeName"),
                       p["status"]["phase"])
                      for p in S.api.list("Pod", NS))

    pods, dump = run_parity(parity, script)
    assert len(pods) == 5 and all(ph == "Running" for _, _, ph in pods)
    envs = {p["metadata"]["name"]: {e["name"]: e["value"] for e in
                                    p["spec"]["containers"][0]["env"]}
            for p in dump["Pod"]}
    assert envs["job-actors-2"]["TPU_JOB_ROLE"] == "actors"
    assert envs["job-actors-2"]["TPU_JOB_LEARNER_ADDRESS"] == \
        "job-learner-0.job-learner.user1.svc.cluster.local"
    assert "TPU_WORKER_ID" not in envs["job-actors-2"]
    assert envs["job-learner-1"]["TPU_WORKER_ID"] == "1"


def test_legacy_scan_arm(parity):
    """The pre-cache scheduling arm (``set_legacy_scan(True)`` on both
    sides): a full Pod scan under one bind lock per reconcile places the
    same pods and writes the same objects."""
    from kubeflow_rm_tpu.controlplane import scheduler as jax_sched
    from kubeflow_rm_tpu_torch.controlplane import scheduler as port_sched

    parity.setattr(jax_sched, "_legacy_scan", True)
    parity.setattr(port_sched, "_legacy_scan", True)

    def script(S):
        _inventory(S, n=3)
        _spawn(S, S.notebook("a", "h100-80gb-2x4"))
        _spawn(S, S.notebook("b", "h100-80gb-2x4"))
        return sorted((p["metadata"]["name"], p["spec"].get("nodeName"),
                       p["status"]["phase"]) for p in S.api.list("Pod", NS))

    pods, _ = run_parity(parity, script)
    assert [ph for _, _, ph in pods] == ["Running"] * 3 + ["Pending"]


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
