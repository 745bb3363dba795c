"""Apiserver parity: one scripted sequence of verbs on JAX's in-memory
apiserver and on the port's, in both locking arms. Every return value,
every raised exception (type and message), the ordered watch events a
watcher saw (whole objects) and the write log's verbs are equal.
(Counterpart of ``tests/test_apiserver.py``.)"""

import pytest

from kubeflow_rm_tpu.controlplane import apiserver as jax_apiserver
from kubeflow_rm_tpu_torch.controlplane import apiserver as port_apiserver
from tests.cp_fixtures import FakeClock
from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, canon, parity, jax_switch_defaults, reset_uids,
    stop_fanout,
)


def _cm(name, ns="a", labels=None, data=None, **meta):
    obj = {"apiVersion": "v1", "kind": "ConfigMap",
           "metadata": {"name": name, "namespace": ns, **meta}}
    if labels:
        obj["metadata"]["labels"] = labels
    if data is not None:
        obj["data"] = data
    return obj


def _pod(name, ns="a", cpu="1", owner=None):
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": name, "namespace": ns},
           "spec": {"containers": [{"name": "c", "image": "i",
                                    "resources": {"requests": {
                                        "cpu": cpu}}}]}}
    if owner is not None:
        pod["metadata"]["ownerReferences"] = [owner]
    return pod


def _validate_cm(obj):
    if (obj.get("data") or {}).get("bad"):
        raise ValueError("data.bad is not allowed")


def _stamp_first(op, obj, old):
    obj["metadata"].setdefault("annotations", {})["order"] = "first"
    return obj


def _stamp_second(op, obj, old):
    ann = obj["metadata"]["annotations"]
    ann["order"] = ann["order"] + ",second"
    ann["op"] = op
    return obj


def _deny_named(pkg):
    denied = (jax_apiserver if pkg == "jax" else port_apiserver
              ).AdmissionDenied

    def fn(op, obj, old):
        if obj["metadata"]["name"] == "denied":
            raise denied("denied by policy")
        return None
    return fn


def script(pkg: str, global_lock: bool) -> tuple[list, list, list]:
    """The verbs; returns (results, watch events, write-log verbs)."""
    mod = jax_apiserver if pkg == "jax" else port_apiserver
    api = mod.APIServer(FakeClock(), global_lock=global_lock)
    events = []
    api.add_watcher(lambda e, o, old: events.append((e, o, old)),
                    name="probe")
    api.register_validator("ConfigMap", _validate_cm)
    api.register_admission("Pod", _stamp_first)
    api.register_admission("*", _deny_named(pkg))
    api.register_admission("Po*", _stamp_second)
    out = []

    def do(fn, *args, **kw):
        try:
            out.append(("ok", fn(*args, **kw)))
        except mod.APIError as e:
            out.append((type(e).__name__, str(e)))

    try:
        do(api.ensure_namespace, "a")
        do(api.ensure_namespace, "a")
        do(api.ensure_namespace, "b")
        do(api.create, _cm("x", labels={"app": "web", "tier": "fe"},
                           data={"k": "v"}))
        do(api.create, _cm("y", labels={"app": "db"}))
        do(api.create, _cm("z", ns="b", labels={"app": "web"}))
        do(api.create, _cm("x"))                       # AlreadyExists
        do(api.create, _cm("q", ns="nope"))            # NotFound ns
        do(api.create, {"apiVersion": "v1", "kind": "ConfigMap",
                        "metadata": {"name": "nons"}})  # Invalid
        do(api.create, _cm("v", data={"bad": "1"}))    # validator
        do(api.create, {"apiVersion": "v1", "kind": "Node",
                        "metadata": {"name": "n0", "namespace": "a"}})
        do(api.get, "ConfigMap", "x", "a")
        do(api.get, "ConfigMap", "missing", "a")
        do(api.try_get, "ConfigMap", "missing", "a")
        do(api.list, "ConfigMap")
        do(api.list, "ConfigMap", "a")
        do(api.list, "ConfigMap", None, {"matchLabels": {"app": "web"}})
        for op in ("In", "NotIn", "Exists", "DoesNotExist"):
            do(api.list, "ConfigMap", None, {"matchExpressions": [
                {"key": "tier", "operator": op, "values": ["fe"]}]})
        x = api.get("ConfigMap", "x", "a")
        stale = dict(x, metadata=dict(x["metadata"]))
        x["data"] = {"k": "v2"}
        do(api.update, x)
        stale["data"] = {"k": "v3"}
        do(api.update, stale)                          # Conflict
        no_rv = api.get("ConfigMap", "y", "a")
        del no_rv["metadata"]["resourceVersion"]
        no_rv["data"] = {"free": "write"}
        do(api.update, no_rv)
        do(api.patch, "ConfigMap", "x", {"data": {"k": None, "n": "1"},
                                         "metadata": {"labels": {
                                             "tier": None}}}, "a")
        do(api.patch, "ConfigMap", "gone", {"data": {}}, "a")
        # status subresource
        do(api.create, _cm("st"))
        st = api.get("ConfigMap", "st", "a")
        st["status"] = {"phase": "Ready"}
        st["data"] = {"ignored": "yes"}
        do(api.update_status, st)
        # finalizers
        do(api.create, _cm("fin", finalizers=["kubeflow.org/x"]))
        do(api.delete, "ConfigMap", "fin", "a")
        do(api.get, "ConfigMap", "fin", "a")
        fin = api.get("ConfigMap", "fin", "a")
        fin["metadata"]["finalizers"] = []
        do(api.update, fin)
        do(api.get, "ConfigMap", "fin", "a")
        # ownerReference garbage collection, two levels deep
        owner = api.create(_cm("owner"))
        ref = {"apiVersion": "v1", "kind": "ConfigMap", "name": "owner",
               "uid": owner["metadata"]["uid"], "controller": True}
        child = api.create(dict(_cm("child"), metadata={
            "name": "child", "namespace": "a", "ownerReferences": [ref]}))
        cref = {"apiVersion": "v1", "kind": "ConfigMap", "name": "child",
                "uid": child["metadata"]["uid"], "controller": True}
        do(api.create, _pod("grandchild", owner=cref))
        do(api.delete, "ConfigMap", "owner", "a")
        do(api.list, "ConfigMap", "a")
        do(api.list, "Pod", "a")
        # admission order and denial
        do(api.create, _pod("p0"))
        do(api.create, _pod("denied"))
        # quota
        do(api.create, {"apiVersion": "v1", "kind": "ResourceQuota",
                        "metadata": {"name": "q", "namespace": "a"},
                        "spec": {"hard": {"pods": "2",
                                          "requests.cpu": "3"}}})
        do(api.create, _pod("p1", cpu="1500m"))
        do(api.create, _pod("p2"))                     # pods quota
        do(api.create_many, [_pod("m0", ns="b"), _pod("denied", ns="b"),
                             _pod("m0", ns="b"), _pod("m1", ns="b")])
        # events and pod logs
        p0 = api.get("Pod", "p0", "a")
        do(api.record_event, p0, "Warning", "Probe", "a message")
        do(api.events_for, p0)
        api.append_pod_log("a", "p0", "line one")
        api.append_pod_log("a", "p0", "line two")
        do(api.pod_logs, "a", "p0", 1)
        do(api.pod_logs, "a", "missing")
        do(api.delete, "Pod", "missing", "a")
        # namespace deletion drains it
        do(api.delete, "Namespace", "b")
        do(api.list, "ConfigMap", "b")
        do(api.list, "Pod")
        assert api.drain_watchers()
        writes = [(w["seq"], w["rv"], w["verb"], w["kind"], w["namespace"],
                   w["name"]) for w in api.write_log]
        return out, events, writes
    finally:
        stop_fanout(api)


@pytest.mark.parametrize("global_lock", [False, True],
                         ids=["sharded", "global-lock"])
def test_verbs_events_and_errors_match(parity, global_lock):
    port = script("port", global_lock)
    reset_uids(parity)
    jax = script("jax", global_lock)
    for i, (p, j) in enumerate(zip(port[0], jax[0])):
        assert canon(p) == canon(j), (i, p, j)
    assert len(port[0]) == len(jax[0])
    assert canon(port[1]) == canon(jax[1])
    assert port[2] == jax[2]
    kinds = [r[0] for r in port[0]]
    for err in ("AlreadyExists", "NotFound", "Invalid", "Conflict",
                "AdmissionDenied"):
        assert err in kinds, err
    # the admission chain ran in registration order on the pod
    p0 = next(v for k, v in port[0] if k == "ok" and isinstance(v, dict)
              and v["metadata"]["name"] == "p0")
    assert p0["metadata"]["annotations"] == {"order": "first,second",
                                             "op": "CREATE"}


def test_refused_arms_name_their_slice(tmp_path):
    """No arm refuses any more: ``shard=`` (7e-2) names the shard as
    JAX's does (``test_torch_cp_shard.py`` routes over two), and
    ``wal_dir`` (7e-1) recovers the store and the resourceVersion
    (``test_torch_cp_wal.py`` holds it to JAX's log byte for byte)."""
    sharded = port_apiserver.APIServer(shard="shard-0")
    assert sharded.shard == jax_apiserver.APIServer(shard="shard-0").shard
    api = port_apiserver.APIServer(wal_dir=str(tmp_path))
    api.ensure_namespace("d")
    rv = api._rv
    api.close_persistence()
    again = port_apiserver.APIServer(wal_dir=str(tmp_path))
    try:
        assert again.try_get("Namespace", "d") is not None
        assert again._rv == rv
    finally:
        again.close_persistence()


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
