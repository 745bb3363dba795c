"""The port's informer cache (``controlplane/cache``) against JAX's.

- The ``ObjectStore`` and ``CachedAPI`` cases of ``tests/test_cache.py``
  (index invariants, cluster scope, selectors, rv monotonicity and
  delete tombstones, the relist merge, sync gating, read-your-writes,
  no-op suppression, the conflict fast path, the fall-through), each
  parametrised over both packages. The kube adapter's cases (its watch,
  the 410 relist, the steady state over the adapter) are in
  ``test_torch_cp_adapter.py``.
- The spawn path's scripts and a 20-notebook spawn on each package's
  ``make_control_plane()``: the port's cached graph equals JAX's cached
  graph and the port's raw (``cache=False``) graph, Events included.
- The steady-state contract: once converged, a resync of every
  controller issues zero writes, in both packages.
"""

import importlib
import threading

import pytest

from tests.cp_fixtures import FakeClock
from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, NS, Side, jax_switch_defaults, parity, run_full,
    stop_fanout,
)

ROOTS = {"jax": "kubeflow_rm_tpu", "port": "kubeflow_rm_tpu_torch"}
pkgs = pytest.mark.parametrize("pkg", list(ROOTS))


def _mod(pkg, name):
    return importlib.import_module(f"{ROOTS[pkg]}.controlplane.{name}")


def _counted(pkg, name, **labels):
    """A metric's value in ``pkg`` (JAX: its registry's sample)."""
    if pkg == "jax":
        return _mod(pkg, "metrics").registry_value(name, labels) or 0
    metric = getattr(_mod(pkg, "metrics"),
                     name.upper().removesuffix("_TOTAL") + "_TOTAL")
    return metric.get(**labels)


def obj(pkg, kind, name, ns="u", rv=1, labels=None, owners=None):
    o = _mod(pkg, "api.meta").make_object("v1", kind, name, ns)
    o["metadata"]["resourceVersion"] = str(rv)
    if labels:
        o["metadata"]["labels"] = dict(labels)
    if owners:
        o["metadata"]["ownerReferences"] = [
            {"uid": u, "kind": "Notebook", "name": "x"} for u in owners]
    return o


# ---- ObjectStore: index invariants -------------------------------------

@pkgs
def test_store_indices_track_add_update_delete(pkg):
    s = _mod(pkg, "cache").ObjectStore()
    s.apply("ADDED", obj(pkg, "Pod", "a", labels={"app": "x"},
                         owners=["uid-1"]))
    s.apply("ADDED", obj(pkg, "Pod", "b", ns="v", labels={"app": "x"}))
    assert [o["metadata"]["name"] for o in s.list_refs("Pod", "u")] \
        == ["a"]
    assert len(s.list_refs("Pod", None, {"app": "x"})) == 2
    assert [o["metadata"]["name"] for o in s.owned_by("uid-1")] == ["a"]
    s.apply("MODIFIED", obj(pkg, "Pod", "a", rv=2, labels={"app": "y"},
                            owners=["uid-2"]))
    assert s.list_refs("Pod", "u", {"app": "x"}) == []
    assert len(s.list_refs("Pod", "u", {"app": "y"})) == 1
    assert s.owned_by("uid-1") == []
    assert len(s.owned_by("uid-2")) == 1
    s.apply("DELETED", obj(pkg, "Pod", "a", rv=3))
    assert s.get_ref("Pod", "a", "u") is None
    assert s.list_refs("Pod", "u") == []
    assert s.owned_by("uid-2") == []
    assert len(s.list_refs("Pod", "v")) == 1


@pkgs
def test_store_cluster_scoped_kinds_key_under_none(pkg):
    s = _mod(pkg, "cache").ObjectStore()
    p = obj(pkg, "Profile", "team", ns=None)
    p["metadata"].pop("namespace", None)
    s.apply("ADDED", p)
    assert s.get_ref("Profile", "team", "anything") is p
    assert s.get_ref("Profile", "team", None) is p


@pkgs
def test_store_label_selector_expressions(pkg):
    s = _mod(pkg, "cache").ObjectStore()
    s.apply("ADDED", obj(pkg, "Pod", "a", labels={"app": "x",
                                                  "tier": "web"}))
    s.apply("ADDED", obj(pkg, "Pod", "b", labels={"app": "x"}))
    s.apply("ADDED", obj(pkg, "Pod", "c", labels={"app": "z",
                                                  "tier": "db"}))

    def names(sel):
        return [o["metadata"]["name"] for o in s.list_refs("Pod", "u", sel)]

    assert names({"matchExpressions": [
        {"key": "tier", "operator": "Exists"}]}) == ["a", "c"]
    assert names({"matchExpressions": [
        {"key": "tier", "operator": "DoesNotExist"}]}) == ["b"]
    assert names({"matchExpressions": [
        {"key": "app", "operator": "In", "values": ["x"]}]}) == ["a", "b"]
    assert names({"matchExpressions": [
        {"key": "app", "operator": "NotIn", "values": ["x"]}]}) == ["c"]
    assert names({"matchLabels": {"app": "x"},
                  "matchExpressions": [
                      {"key": "tier", "operator": "Exists"}]}) == ["a"]
    assert names({"app": "z"}) == ["c"]


@pkgs
def test_store_rv_monotonicity_and_delete_tombstones(pkg):
    s = _mod(pkg, "cache").ObjectStore()
    rv_of = _mod(pkg, "cache.store").rv_of
    s.apply("ADDED", obj(pkg, "Pod", "a", rv=5))
    s.apply("MODIFIED", obj(pkg, "Pod", "a", rv=3, labels={"stale": "y"}))
    assert "labels" not in s.get_ref("Pod", "a", "u")["metadata"]
    s.apply("DELETED", obj(pkg, "Pod", "a", rv=6))
    s.apply("MODIFIED", obj(pkg, "Pod", "a", rv=6))
    assert s.get_ref("Pod", "a", "u") is None
    s.apply("ADDED", obj(pkg, "Pod", "a", rv=9))
    assert rv_of(s.get_ref("Pod", "a", "u")) == 9


@pkgs
def test_store_replace_merges_against_racing_events(pkg):
    s = _mod(pkg, "cache").ObjectStore()
    rv_of = _mod(pkg, "cache.store").rv_of
    s.apply("ADDED", obj(pkg, "Pod", "newer", rv=20))
    s.apply("ADDED", obj(pkg, "Pod", "dead", rv=4))
    s.apply("DELETED", obj(pkg, "Pod", "dead", rv=6))
    s.replace("Pod", [obj(pkg, "Pod", "newer", rv=10),
                      obj(pkg, "Pod", "dead", rv=5),
                      obj(pkg, "Pod", "fresh", rv=8)])
    assert s.is_synced("Pod")
    assert rv_of(s.get_ref("Pod", "newer", "u")) == 20
    assert s.get_ref("Pod", "dead", "u") is None
    assert rv_of(s.get_ref("Pod", "fresh", "u")) == 8


@pkgs
def test_store_wait_for_sync_blocks_and_wakes(pkg):
    """A waiter parks until both kinds sync; the gate opens only once
    the waiter is known to wait (no clock read)."""
    s = _mod(pkg, "cache").ObjectStore()
    assert s.wait_for_sync(["Pod"], timeout=0) is False
    woke, parked = [], threading.Event()
    real_wait = s._cond.wait

    def wait(timeout=None):
        parked.set()
        return real_wait(timeout)

    s._cond.wait = wait
    t = threading.Thread(target=lambda: woke.append(
        s.wait_for_sync(["Pod", "Node"], timeout=60)))
    t.start()
    assert parked.wait(60)
    s.replace("Pod", [])
    s.mark_synced("Node")
    t.join(60)
    assert woke == [True]
    s.unsync("Node")
    assert s.is_synced("Node") is False


def _incarnation(pkg, rv, uid, phase):
    o = obj(pkg, "Pod", "ft-0", rv=rv)
    o["metadata"]["uid"] = uid
    o["status"] = {"phase": phase}
    return o


@pkgs
def test_store_keeps_a_recreated_pod_past_a_lagging_delete(pkg):
    """C11: a failed pod deleted through the cache and re-created (its
    create and status folded in by the writes) before the watch delivers
    the old incarnation's events. The port's store keeps the live pod;
    JAX's drops it and shadows its events, so a reader (the culler, the
    StatefulSet controller) sees a running pod as missing."""
    s = _mod(pkg, "cache").ObjectStore()
    s.apply("ADDED", _incarnation(pkg, 5, "old", "Running"))
    s.apply("MODIFIED", _incarnation(pkg, 6, "old", "Failed"))
    s.discard("Pod", "ft-0", "u")                     # CachedAPI.delete
    s.apply("ADDED", _incarnation(pkg, 8, "new", "Pending"))  # folds
    s.apply("MODIFIED", _incarnation(pkg, 9, "new", "Running"))
    # the watch stream catches up, in the server's order
    s.apply("MODIFIED", _incarnation(pkg, 6, "old", "Failed"))
    s.apply("DELETED", _incarnation(pkg, 6, "old", "Failed"))
    s.apply("ADDED", _incarnation(pkg, 8, "new", "Pending"))
    s.apply("MODIFIED", _incarnation(pkg, 9, "new", "Running"))
    live = s.get_ref("Pod", "ft-0", "u")
    if pkg == "port":
        assert (live["metadata"]["uid"], live["status"]["phase"]) == (
            "new", "Running")
    else:
        assert live is None      # the reference's behaviour (ROADMAP §C)
    # a delete of the live incarnation still removes it, in both
    s.apply("DELETED", _incarnation(pkg, 10, "new", "Running"))
    assert s.get_ref("Pod", "ft-0", "u") is None


# ---- CachedAPI over the in-memory backend ------------------------------

@pytest.fixture(params=list(ROOTS))
def capi(request):
    pkg = request.param
    api = _mod(pkg, "apiserver").APIServer()
    api.ensure_namespace("u")
    yield pkg, api, _mod(pkg, "cache").CachedAPI(api)
    stop_fanout(api)


def _cm(pkg, data):
    cm = _mod(pkg, "api.meta").make_object("v1", "ConfigMap", "cm", "u")
    cm["data"] = dict(data)
    return cm


def test_cached_read_your_writes(capi):
    pkg, api, c = capi
    c.create(_cm(pkg, {"k": "1"}))
    got = c.get("ConfigMap", "cm", "u")
    assert got["data"] == {"k": "1"}
    got["data"]["k"] = "2"
    c.update(got)
    assert c.get("ConfigMap", "cm", "u")["data"]["k"] == "2"
    c.patch("ConfigMap", "cm", {"data": {"j": "3"}}, "u")
    assert c.get("ConfigMap", "cm", "u")["data"] == {"k": "2", "j": "3"}
    c.get("ConfigMap", "cm", "u")["data"]["k"] = "HACKED"
    assert c.get("ConfigMap", "cm", "u")["data"]["k"] == "2"
    assert c.scan("ConfigMap", "u")[0] is c.scan("ConfigMap", "u")[0]
    c.delete("ConfigMap", "cm", "u")
    assert c.try_get("ConfigMap", "cm", "u") is None


def test_noop_writes_suppressed(capi):
    pkg, api, c = capi
    rv_of = _mod(pkg, "cache.store").rv_of
    c.create(_cm(pkg, {"k": "1"}))
    cur = c.get("ConfigMap", "cm", "u")
    writes_before = len(api.write_log)
    verbs = ("update", "update_status", "patch")
    sup_before = {v: _counted(pkg, "cache_suppressed_writes_total", verb=v)
                  for v in verbs}

    out = c.update(c.get("ConfigMap", "cm", "u"))
    assert rv_of(out) == rv_of(cur)
    same = c.get("ConfigMap", "cm", "u")
    same["metadata"]["resourceVersion"] = "999999"
    c.update(same)
    c.update_status(c.get("ConfigMap", "cm", "u"))
    c.patch("ConfigMap", "cm", {"data": {"k": "1"}}, "u")

    assert len(api.write_log) == writes_before
    assert {v: _counted(pkg, "cache_suppressed_writes_total", verb=v)
            - sup_before[v] for v in verbs} == {
        "update": 2, "update_status": 1, "patch": 1}
    changed = c.get("ConfigMap", "cm", "u")
    changed["data"]["k"] = "2"
    c.update(changed)
    assert len(api.write_log) == writes_before + 1


def test_conflict_fastpath_rebases_disjoint_edits(capi):
    pkg, api, c = capi
    c.create(_cm(pkg, {"a": "1", "b": "1"}))
    stale = c.get("ConfigMap", "cm", "u")
    theirs = c.get("ConfigMap", "cm", "u")
    theirs["data"]["b"] = "2"
    c.update(theirs)
    before = _counted(pkg, "cache_conflict_fastpath_total",
                      result="rebased")
    stale["data"]["a"] = "9"
    out = c.update(stale)
    assert out["data"] == {"a": "9", "b": "2"}
    assert _counted(pkg, "cache_conflict_fastpath_total",
                    result="rebased") == before + 1


def test_conflict_fastpath_clash_reraises(capi):
    pkg, api, c = capi
    c.create(_cm(pkg, {"a": "1"}))
    stale = c.get("ConfigMap", "cm", "u")
    theirs = c.get("ConfigMap", "cm", "u")
    theirs["data"]["a"] = "2"
    c.update(theirs)
    stale["data"]["a"] = "9"
    with pytest.raises(_mod(pkg, "apiserver").Conflict):
        c.update(stale)
    assert c.get("ConfigMap", "cm", "u")["data"]["a"] == "2"


def test_conflict_noop_returns_latest(capi):
    pkg, api, c = capi
    rv_of = _mod(pkg, "cache.store").rv_of
    c.create(_cm(pkg, {"a": "1"}))
    stale = c.get("ConfigMap", "cm", "u")
    theirs = c.get("ConfigMap", "cm", "u")
    theirs["data"]["a"] = "2"
    latest = c.update(theirs)
    stale["data"]["a"] = "2"
    assert rv_of(c.update(stale)) == rv_of(latest)


def test_cache_miss_falls_through(capi):
    pkg, api, c = capi
    with pytest.raises(_mod(pkg, "apiserver").NotFound):
        c.get("ConfigMap", "ghost", "u")
    assert c.try_get("ConfigMap", "ghost", "u") is None
    assert c.list("ConfigMap", "u") == []


def test_informer_series_move(capi):
    """The informer's and the cache's series move as JAX's do: a primed
    kind counts as synced, a folded watch event per kind, a hit read."""
    pkg, api, c = capi
    hits = _counted(pkg, "cache_reads_total", verb="get", result="hit")
    events = _counted(pkg, "informer_events_total", kind="ConfigMap")
    c.create(_cm(pkg, {"k": "1"}))
    c.get("ConfigMap", "cm", "u")
    api.drain_watchers()
    assert _counted(pkg, "cache_reads_total", verb="get",
                    result="hit") == hits + 1
    assert _counted(pkg, "informer_events_total",
                    kind="ConfigMap") >= events + 1


# ---- the spawn path on the cache -------------------------------------

def _spawn_scripts():
    def one_host(S):
        S.api.ensure_namespace(NS)
        S.node("n0", "h100-80gb-8")
        S.api.create(S.notebook("nb", "h100-80gb-8"))
        S.run()

    def multislice(S):
        S.api.ensure_namespace(NS)
        for i in range(4):
            S.node(f"n{i}", "h100-80gb-2x4")
        S.api.create(S.notebook("ms", "h100-80gb-2x4", num_slices=2))
        S.run()

    def stop_restart_delete(S):
        S.api.ensure_namespace(NS)
        for i in range(2):
            S.node(f"n{i}", "h100-80gb-2x4")
        S.api.create(S.notebook("nb", "h100-80gb-2x4"))
        S.run()
        for stop in (True, False):
            nb = S.api.get(S.nb_api.KIND, "nb", NS)
            ann = nb["metadata"]["annotations"]
            if stop:
                ann[S.nb_api.STOP_ANNOTATION] = "now"
            else:
                ann.pop(S.nb_api.STOP_ANNOTATION)
            S.api.update(nb)
            S.run()
        S.api.delete(S.nb_api.KIND, "nb", NS)
        S.run()

    def unschedulable(S):
        S.api.ensure_namespace(NS)
        S.node("n0", "h100-80gb-1")
        S.api.create(S.notebook("big", "h100-80gb-8"))
        S.run()

    def twenty(S):
        S.api.ensure_namespace(NS)
        for i in range(20):
            S.node(f"n{i:02d}", "h100-80gb-1")
        for i in range(20):
            S.api.create(S.notebook(f"nb{i:02d}", "h100-80gb-1"))
        S.run()

    return {f.__name__: f for f in (one_host, multislice,
                                    stop_restart_delete, unschedulable,
                                    twenty)}


SCRIPTS = _spawn_scripts()


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_spawn_graphs_equal_on_the_cache(parity, name):
    """The port's cached graph equals JAX's cached graph, and the
    port's raw graph equals both."""
    def script(S):
        SCRIPTS[name](S)
        return sorted(p["metadata"]["name"] for p in S.api.list("Pod", NS))

    pods, _ = run_full(parity, script, arms=("cached", "raw"))
    if name == "twenty":
        assert pods == [f"nb{i:02d}-0" for i in range(20)]


@pytest.mark.parametrize("pkg", list(ROOTS))
def test_steady_state_reconcile_issues_zero_writes(parity, pkg):
    """Once a Notebook has converged, a resync of every controller reads
    from the informer store and no-op suppression swallows every
    rewrite: no write reaches the server."""
    S = Side(pkg, full=True, cached=True)
    try:
        for i in range(2):
            S.node(f"n{i}", "h100-80gb-2x4")
        S.api.create(S.m("api.profile").make_profile(NS, "u@example.com"))
        S.mgr.enqueue_all()
        S.run()
        S.api.create(S.notebook("nb", "h100-80gb-2x4"))
        S.run()
        assert S.api.get(S.nb_api.KIND, "nb", NS)["status"][
            "readyReplicas"] == 2
        writes_before = len(S.api.write_log)
        S.mgr.enqueue_all()
        assert S.run() > 0
        assert list(S.api.write_log)[writes_before:] == []
    finally:
        S.close()


def test_make_control_plane_wires_jax_order():
    """Defaults: validators, the admission chain and the controllers in
    JAX's order, the manager on the informer cache; culling adds the
    culler; ``enable_suspend`` adds the suspend and failover controllers
    after it, in JAX's order."""
    from kubeflow_rm_tpu.controlplane import make_control_plane as jmake
    from kubeflow_rm_tpu_torch.controlplane import (
        make_control_plane as pmake,
    )

    names = {}
    for pkg, make in (("jax", jmake), ("port", pmake)):
        api, mgr = make(FakeClock(), enable_culling=True,
                        culler_config={"probe_fn": lambda nb, pod: None},
                        enable_suspend=True)
        try:
            names[pkg] = dict(
                cache=type(mgr.api).__name__,
                validators=sorted(api._validators),
                admission=[(k, type(h).__name__)
                           for k, h in api._admission],
                controllers=[type(c).__name__ for c in mgr.controllers])
        finally:
            stop_fanout(api)
    jax_names = names["jax"]
    jax_names["admission"] = [
        (k, "GpuInjectWebhook" if n == "TpuInjectWebhook" else n)
        for k, n in jax_names["admission"]]
    assert names["port"] == jax_names
    assert names["port"]["cache"] == "CachedAPI"
    assert [n for k, n in names["port"]["admission"]] == [
        "NotebookWebhook", "AdmissionPricer", "AdmissionPricer",
        "PodDefaultWebhook", "GpuInjectWebhook"]
    assert names["port"]["controllers"][-3:] == [
        "CullingController", "SuspendController",
        "ReplicaFailoverController"]


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
