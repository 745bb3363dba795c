"""The control plane under lock-order analysis: the port's hierarchy
table ranks every lock family its control plane makes, at JAX's levels
(``analysis/hierarchy.py``), and the spawn path (``cache=False``) and
the whole default stack (the informer cache, every webhook and
controller, the culler) run a notebook's life with no cycle, no rank
inversion and no downhill or unranked edge — in the port as in JAX,
whose own checker runs on the same script beside it.

Before the repair the port's table named only the serving, pricer,
probe, build and metrics families, so ``check_edges`` reported every
control-plane lock of the spawn as unregistered. The analyser is reset
and turned off in ``finally``.
"""

import threading
import time

import pytest

from kubeflow_rm_tpu.analysis import hierarchy as jhier
from kubeflow_rm_tpu.analysis import lockgraph as jlg
from kubeflow_rm_tpu_torch.analysis import lockgraph as tlg

from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, NS, Side, cp_module, jax_switch_defaults, parity,
    reset_uids, stop_fanout,
)

#: every lock family the port's control plane makes (``make_lock`` /
#: ``make_rlock`` / ``make_condition`` labels under ``controlplane/``)
CONTROL_PLANE_FAMILIES = (
    "apiserver.global", "scheduler.registry", "scheduler.relist",
    "scheduler.nodes_map", "scheduler.node", "scheduler.pods_map",
    "apiserver.kind", "apiserver.kind_locks_map", "apiserver.event_seq",
    "apiserver.write_log", "apiserver.pod_logs", "apiserver.rv",
    "apiserver.admission_pool", "apiserver.watch_channel", "chaos.plan",
    "runtime.queue", "runtime.child_pool", "workqueue", "informer.prime",
    "cache.store",
    # suspend/resume and harvest (7d), the WAL and leases (7e-1)
    "suspend.store_registry", "suspend.store", "harvest.controller",
    "leases.elector", "persistence.snapshot_guard", "wal.cv",
    # the kube adapter, its router and the REST facade (7e-2)
    "kubeclient.conn_pool", "kubeclient.events_seen",
    "kubeclient.router_listed", "restserver.watch_registry",
    "restserver.conns",
    # the shard processes (7e-3): the handoff coordinator and the
    # supervisor's membership map
    "shard.elastic", "shard.watchdog",
    # the observability loop (7f-1): the SLO engine, the TSDB and the
    # flight recorder
    "obs.engine", "obs.tsdb", "obs.flight",
    # the web apps (7f-2a): the readiness hub's key registry and its
    # per-notebook condvars, the jupyter app's lazy hub
    "readiness.registry", "readiness.key", "jupyter.hub_registry",
    # the dashboard (7f-2b): its metrics history's lazy sampler start and
    # its ring
    "metrics_service.sampler_thread", "metrics_service.sampler",
)


def test_every_control_plane_family_is_ranked_at_jax_level():
    import pathlib
    import re

    import kubeflow_rm_tpu_torch.controlplane as cp

    made = set()
    for path in pathlib.Path(cp.__file__).parent.rglob("*.py"):
        made |= set(re.findall(
            r'make_(?:r?lock|condition)\(\s*"([^"]+)"', path.read_text()))
    # ranked before the control plane came: the seams' and the fleet's
    seams = {"metrics.family", "metrics.series", "obs.bridges",
             "serving.fleet", "serving.gateway", "serving.store",
             "tracing.collector", "kubeclient.token_bucket"}
    assert made - seams == set(CONTROL_PLANE_FAMILIES)
    for name in made:
        assert name in tlg.LOCK_HIERARCHY, name
    for name in CONTROL_PLANE_FAMILIES:
        assert tlg.LOCK_HIERARCHY[name] == jhier.LOCK_HIERARCHY[name], name


def _life(S, full: bool) -> None:
    """A notebook's life: spawn on a 4-card node, then (the full stack)
    a profile with a card quota, a PodDefault, an idle cull, a restart
    after a failed pod; then stop and delete."""
    S.api.ensure_namespace(NS)
    S.node("n0", "h100-80gb-4")
    if full:
        prof = S.m("api.profile")
        S.api.create(prof.make_profile(NS, "a@example.com",
                                       quota_hard={S.card_key: "4"}))
        S.api.create(S.m("api.poddefault").make_poddefault(
            "env", NS, selector={"matchLabels": {"pd": "on"}},
            env=[{"name": "KFRM_PODDEFAULT", "value": "1"}]))
        S.run()
    S.api.create(S.notebook("nb", "h100-80gb-4", labels={"pd": "on"}))
    S.run()
    if full:
        pod = S.api.get("Pod", "nb-0", NS)
        pod["status"] = {"phase": "Failed"}
        S.api.update_status(pod)
        S.run()
        S.jupyter.activity()
        S.run()
        S.clock.advance(minutes=11)
        S.run()
    nb = S.api.get(S.nb_api.KIND, "nb", NS)
    nb["metadata"]["annotations"][S.nb_api.STOP_ANNOTATION] = "now"
    S.api.update(nb)
    S.run()
    S.api.delete(S.nb_api.KIND, "nb", NS)
    S.run()


@pytest.mark.parametrize("arm", ["spawn_7a", "full_defaults"])
def test_control_plane_lock_order_is_clean(parity, arm):
    full = arm == "full_defaults"
    culling = {"cull_idle_minutes": 10, "check_period_minutes": 1}
    reports = {}
    for pkg, lg in (("port", tlg), ("jax", jlg)):
        reset_uids(parity)
        lg.set_enabled(True)
        lg.reset()
        S = None
        try:
            S = Side(pkg, full=True, cached=full,
                     culling=culling if full else None)
            _life(S, full)
            S.api.drain_watchers()
            reports[pkg] = lg.report()
        finally:
            if S is not None:
                S.close()
            lg.reset()
            lg.set_enabled(False)
    port, jax = reports["port"], reports["jax"]
    assert port["edges"], "the analysis saw no lock order"
    assert tlg.check_edges(port["edges"]) == []
    assert jhier.check_edges(jax["edges"]) == []
    for rep in (port, jax):
        assert rep["cycles"] == []
        assert rep["order_violations"] == []
    # families whose locks this test makes (the metric series' locks may
    # predate the analysis, made raw by an earlier test in the process,
    # so edges into them are not required)
    names = {e["from"] for e in port["edges"]} | {
        e["to"] for e in port["edges"]}
    assert {"apiserver.kind", "apiserver.watch_channel",
            "scheduler.pods_map"} <= names
    if full:
        assert {"informer.prime", "cache.store"} <= names


class _StubFleet:
    """The harvest controller's view of a serving fleet, without models:
    always under pressure, replicas added and removed by name."""
    roles = None

    def __init__(self):
        self.gateways = {}

    def snapshot(self):
        return {"replicas": {"base": {"queue_depth": 9, "state": "ready",
                                      "role": None}}}

    def add_replica(self, name, gw, role=None):
        self.gateways[name] = gw

    def remove_replica(self, name, grace_s=0.0):
        del self.gateways[name]


def _slice_7d_7e1(S, tmp_path) -> None:
    """Preemption, resume and failover (the suspend store guards), a
    harvest grant and its reclaim (the lease table), a WAL-backed
    apiserver's writes and snapshot, and election rounds."""
    S.api.ensure_namespace(NS)
    for i in range(2):
        S.node(f"n{i}", "h100-80gb-2x4")
    S.api.create(S.notebook("low", "h100-80gb-2x4", priority_class="low"))
    S.run()
    S.api.create(S.notebook("high", "h100-80gb-2x4",
                            priority_class="high"))
    S.run()
    S.suspend.initiate_suspend(S.api, S.api.get(S.nb_api.KIND, "high", NS),
                               reason="api")
    S.run()
    ctl = S.m("harvest").ChipHarvestController(
        S.api, _StubFleet(), gateway_factory=lambda name: object(),
        sustain=1)
    try:
        assert ctl.tick() == "grant"     # both are parked and drained
        ns, name = ctl.leases()[0]["donor"].split("/")
        S.suspend.request_resume(S.api, S.api.get(S.nb_api.KIND, name, ns))
        assert ctl.tick() == "reclaim"
        S.run()
    finally:
        ctl.close()
    api = S.m("apiserver").APIServer(wal_dir=str(tmp_path / S.pkg))
    api.ensure_namespace(NS)
    api.create(S.notebook("w", None))
    assert api.snapshot_now()
    el = S.m("ha").LeaderElector(api, "probe", namespace=NS)
    el._set_leader(el.try_acquire_or_renew(), api.clock())
    assert el.is_leader
    api.close_persistence()
    stop_fanout(api)


def test_suspend_harvest_wal_and_lease_lock_order_is_clean(parity, tmp_path):
    """The six families of slices 7d and 7e-1 (the suspend store
    registry and its ranked per-notebook guards, the harvest lease
    table, the elector, the snapshot guard and the WAL's condvar) are
    taken on the script above with no cycle, no rank inversion and no
    downhill or unranked edge — in the port as in JAX."""
    reports = {}
    for pkg, lg in (("port", tlg), ("jax", jlg)):
        reset_uids(parity)
        lg.set_enabled(True)
        lg.reset()
        S = None
        try:
            S = Side(pkg, full=True, cached=True,
                     suspend={"check_period_minutes": 1.0})
            # the registry's lock is made at import, before the analyser
            # was on: a fresh one (and registry) for this test
            parity.setattr(S.suspend, "_store_locks_guard",
                           lg.make_lock("suspend.store_registry"))
            parity.setattr(S.suspend, "_store_locks", {})
            _slice_7d_7e1(S, tmp_path)
            S.api.drain_watchers()
            reports[pkg] = lg.report()
        finally:
            if S is not None:
                S.close()
            lg.reset()
            lg.set_enabled(False)
    port, jax = reports["port"], reports["jax"]
    assert tlg.check_edges(port["edges"]) == []
    assert jhier.check_edges(jax["edges"]) == []
    for rep in (port, jax):
        assert rep["cycles"] == [] and rep["order_violations"] == []
    new = {"suspend.store_registry", "suspend.store", "harvest.controller",
           "leases.elector", "persistence.snapshot_guard", "wal.cv"}
    assert new <= set(port["locks"]) and new <= set(jax["locks"])


def _spawn_through_router(pkg) -> None:
    """The deployed layout at its smallest: two shards (each an
    apiserver with the cluster's admission and kubelet behind its REST
    facade), the platform's manager over the router with three informer
    watches, one notebook spawned to Ready and an Event recorded."""
    import threading
    import time

    from tests.torch_cp_parity import RestCluster, cp_module

    shards = {n: RestCluster(pkg, shard=n, admission=True, kubelet=True)
              for n in ("shard-0", "shard-1")}
    stop, threads = threading.Event(), []
    try:
        for c in shards.values():
            c.api.ensure_namespace("default")  # a resume point past rv 0
        router = cp_module(pkg, "deploy.kubeclient").ShardedKubeAPIServer(
            {n: c.url for n, c in shards.items()})
        mgr = cp_module(pkg, "").make_cluster_manager(
            router, enable_culling=False)
        kinds = ("Notebook", "StatefulSet", "Pod")
        for kind in kinds:
            threads.append(threading.Thread(
                target=router.watch_kind, args=(kind, None, stop, 30),
                daemon=True))
            threads[-1].start()
        assert router.wait_for_sync(kinds, timeout=30)
        owner = shards[router.shard_of("Pod", None, NS)]
        stc = cp_module(pkg, "controllers.statefulset")
        make_node = stc.make_tpu_node if pkg == "jax" else stc.make_gpu_node
        owner.api.create(make_node("n0", "v5p-8" if pkg == "jax"
                                   else "h100-80gb-4"))
        router.ensure_namespace(NS)
        nb = router.create(cp_module(pkg, "api.notebook").make_notebook(
            "nb", NS, accelerator_type="v5p-8" if pkg == "jax"
            else "h100-80gb-4"))
        router.record_event(nb, "Normal", "Probe", "through the router")
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            mgr.enqueue_all()
            mgr.run_until_idle()
            owner.kubelet.run_until_idle()
            got = owner.api.get("Notebook", "nb", NS)
            if (got.get("status") or {}).get("readyReplicas") == 1:
                break
        else:
            raise AssertionError(f"never Ready: {got.get('status')}")
        assert mgr.errors == []
    finally:
        stop.set()
        for c in shards.values():
            c.close()
        for t in threads:
            t.join(30)


def test_deployed_layout_lock_order_is_clean():
    """The five families of slice 7e-2 (the adapter's connection pool
    and Event counter, the router's listed-shards map, the facade's
    watch registry and socket set) are taken on a spawn through the
    router with no cycle, no rank inversion and no downhill or unranked
    edge in the port; JAX's one downhill edge is C13's."""
    reports = {}
    for pkg, lg in (("port", tlg), ("jax", jlg)):
        lg.set_enabled(True)
        lg.reset()
        try:
            _spawn_through_router(pkg)
            reports[pkg] = lg.report()
        finally:
            lg.reset()
            lg.set_enabled(False)
    port, jax = reports["port"], reports["jax"]
    assert tlg.check_edges(port["edges"]) == []
    # JAX's router marks a kind synced in its store (260) while it holds
    # the listed-shards map (340); the port marks it after (C13)
    assert jhier.check_edges(jax["edges"]) == [
        "downhill acquisition kubeclient.router_listed (level 340) -> "
        "cache.store (level 260): violates the canonical order"]
    for rep in (port, jax):
        assert rep["cycles"] == [] and rep["order_violations"] == []
    new = {"kubeclient.conn_pool", "kubeclient.events_seen",
           "kubeclient.router_listed", "restserver.watch_registry",
           "restserver.conns"}
    assert new <= set(port["locks"]) and new <= set(jax["locks"])


class _ThreadShard:
    """A shard worker's stand-in for the lock-order script: the shard's
    apiserver (WAL-backed) behind its facade on the runner's port, booted
    on a thread of its own as a worker boots in a process of its own, so
    nothing it locks nests under the supervisor's lock. ``terminate``
    stops it as SIGTERM stops a worker."""

    def __init__(self, pkg, cfg):
        from tests.torch_cp_parity import cp_module

        self.pid = None
        self.exitcode = None
        self.api = cp_module(pkg, "apiserver").APIServer(
            shard=cfg["name"], wal_dir=cfg["wal_dir"], wal_fsync=False)
        self.rest = cp_module(pkg, "deploy.restserver").RestServer(
            self.api, port=cfg["port"])
        self._alive = True
        self._boot = threading.Thread(target=self.rest.start, daemon=True)
        self._boot.start()

    def is_alive(self):
        return self._alive

    def terminate(self):
        # the shutdown runs in the shard, as SIGTERM's handler runs in
        # the worker: on a thread of its own
        def shut():
            self._boot.join(30)
            self.rest.stop()
            self.api.close_persistence()
            stop_fanout(self.api)
        t = threading.Thread(target=shut, daemon=True)
        t.start()
        t.join(60)
        self._alive, self.exitcode = False, 0

    kill = terminate

    def join(self, timeout=None):
        pass


def _split_and_merge(pkg, base_dir) -> None:
    """Each package's own ``ShardRunner`` (its spawn a thread-booted
    shard) under its ``ElasticShardManager``: 8 namespaces seeded
    through the router, a split that admits shard-2, a merge that
    retires it."""
    from tests.torch_cp_parity import cp_module

    runner = cp_module(pkg, "shard.runner").ShardRunner(
        2, base_dir=base_dir, supervise=False)
    runner._spawn = lambda name: runner._procs.__setitem__(
        name, _ThreadShard(pkg, runner._cfgs[name]))
    try:
        runner.start(timeout=30)
        router = cp_module(pkg, "deploy.kubeclient").ShardedKubeAPIServer(
            runner.urls, retry_window_s=10.0)
        elastic = cp_module(pkg, "shard.elastic").ElasticShardManager(
            runner, router)
        for i in range(8):
            router.ensure_namespace(f"lk-{i}")
            router.create({"apiVersion": "v1", "kind": "Pod",
                           "metadata": {"name": "p", "namespace": f"lk-{i}"},
                           "spec": {"containers": [{"name": "c",
                                                    "image": "img"}]}})
        assert elastic.split() == "shard-2"
        assert elastic.merge() == "shard-2"
        for i in range(8):
            assert router.get("Pod", "p", f"lk-{i}")
    finally:
        runner.stop()


def test_split_and_merge_lock_order_is_clean(tmp_path):
    """The two families of slice 7e-3 — the handoff coordinator's lock
    (280), held across the whole split and merge while it routes into
    the kube client (310+) and the supervisor (370), and the
    supervisor's membership map — are taken with no cycle, no rank
    inversion and no downhill or unranked edge, in the port as in JAX."""
    reports = {}
    for pkg, lg in (("port", tlg), ("jax", jlg)):
        lg.set_enabled(True)
        lg.reset()
        try:
            _split_and_merge(pkg, str(tmp_path / pkg))
            reports[pkg] = lg.report()
        finally:
            lg.reset()
            lg.set_enabled(False)
    port, jax = reports["port"], reports["jax"]
    assert tlg.check_edges(port["edges"]) == []
    assert jhier.check_edges(jax["edges"]) == []
    for rep in (port, jax):
        assert rep["cycles"] == [] and rep["order_violations"] == []
        assert {"shard.elastic", "shard.watchdog"} <= set(rep["locks"])
        # the coordinator's lock is held over the supervisor's (add_shard
        # and remove_shard inside the split and the merge)
        assert {"from": "shard.elastic", "to": "shard.watchdog"} in [
            {k: e[k] for k in ("from", "to")} for e in rep["edges"]]


def test_observer_lock_order_is_clean():
    """The observability loop's three families (the SLO engine 470, the
    TSDB 480, the flight recorder 490) across a tick whose critical
    transition auto-triggers a bundle, an explicit trigger and a shard's
    death: no cycle, no rank inversion, no downhill or unranked edge, in
    the port as in JAX."""
    reports = {}
    for pkg, lg in (("port", tlg), ("jax", jlg)):
        slo = cp_module(pkg, "obs.slo")
        lg.set_enabled(True)
        lg.reset()
        try:
            o = cp_module(pkg, "obs").Observer(
                interval_s=1.0, liveness=lambda: {"shard-0": True},
                slos=[slo.GaugeSLO(
                    name="frag", metric="obs_lock_frag", threshold=1.0,
                    windows=(slo.Window(60.0, 10.0, 1.0, "critical"),))])
            o.flight.min_interval_s = 0.0
            now = time.time()
            for t in range(0, 101, 5):
                o.tsdb.ingest(now - 100.0 + t, "obs_lock_frag", {},
                              "gauge", 2.0)
            fired = o.tick(now=now)
            assert [tr["to"] for tr in fired] == ["critical"]
            assert o.flight.trigger("explicit") is not None
            assert o.on_shard_death("shard-0", -9) is not None
            assert [b["trigger"]["reason"] for b in o.flight.bundles()] \
                == ["alert_critical", "explicit", "shard_death"]
            reports[pkg] = lg.report()
        finally:
            lg.reset()
            lg.set_enabled(False)
    port, jax = reports["port"], reports["jax"]
    assert tlg.check_edges(port["edges"]) == []
    assert jhier.check_edges(jax["edges"]) == []
    for rep in (port, jax):
        assert rep["cycles"] == [] and rep["order_violations"] == []
        assert {"obs.engine", "obs.tsdb", "obs.flight"} <= set(rep["locks"])
    for name in ("obs.engine", "obs.tsdb", "obs.flight"):
        assert tlg.LOCK_HIERARCHY[name] == jhier.LOCK_HIERARCHY[name]
    assert [tlg.LOCK_HIERARCHY[n] for n in (
        "obs.engine", "obs.tsdb", "obs.flight")] == [470, 480, 490]


def test_readiness_wake_lock_order_is_clean():
    """The web apps' three families (the hub's registry 410, its
    per-notebook condvars 420, the jupyter app's lazy hub 430): a
    readiness long-poll parked through the jupyter app and woken by the
    watch event of a status write shows no cycle, no rank inversion and
    no downhill or unranked edge, in the port as in JAX."""
    import json
    import threading

    reports, woke = {}, {}
    for pkg, lg in (("port", tlg), ("jax", jlg)):
        lg.set_enabled(True)
        lg.reset()
        api = None
        try:
            api = cp_module(pkg, "apiserver").APIServer()
            api.ensure_namespace(NS)
            nb = api.create(cp_module(pkg, "api.notebook").make_notebook(
                "nb", NS))
            rv = nb["metadata"]["resourceVersion"]
            client = cp_module(pkg, "webapps.jupyter").create_app(
                api, disable_auth=True).test_client()
            got = {}

            def poll():
                resp = client.get(
                    f"/api/namespaces/{NS}/notebooks/nb/readiness"
                    f"?timeoutSeconds=20&knownVersion={rv}")
                got.update(json.loads(resp.get_data()))

            t = threading.Thread(target=poll)
            t.start()
            waiters = cp_module(pkg, "metrics")
            deadline = time.monotonic() + 10
            while waiters.registry_value("readiness_waiters") < 1:
                assert time.monotonic() < deadline, "the poll never parked"
                time.sleep(0.005)
            nb["status"] = {"readyReplicas": 1}
            api.update_status(nb)
            t.join(timeout=10)
            assert not t.is_alive()
            woke[pkg] = (got["changed"], got["ready"])
            api.drain_watchers()
            reports[pkg] = lg.report()
        finally:
            if api is not None:
                stop_fanout(api)
            lg.reset()
            lg.set_enabled(False)
    assert woke == {"port": (True, True), "jax": (True, True)}
    port, jax = reports["port"], reports["jax"]
    assert tlg.check_edges(port["edges"]) == []
    assert jhier.check_edges(jax["edges"]) == []
    families = ("readiness.registry", "readiness.key", "jupyter.hub_registry")
    for rep in (port, jax):
        assert rep["cycles"] == [] and rep["order_violations"] == []
        assert set(families) <= set(rep["locks"])
        # a waiter's registration takes its key's condvar under the
        # registry
        assert {"from": "readiness.registry", "to": "readiness.key"} in [
            {k: e[k] for k in ("from", "to")} for e in rep["edges"]]
    assert [tlg.LOCK_HIERARCHY[n] for n in families] == [
        jhier.LOCK_HIERARCHY[n] for n in families] == [410, 420, 430]


def test_metrics_history_lock_order_is_clean():
    """The dashboard's two families (the history's lazy sampler start
    450, its ring 460): a dashboard made over each package's apiserver,
    read through ``/api/metrics/history`` (the seed sample, the sampler
    thread's lazy start, a fresh sample) while its sampler ticks, shows
    no cycle, no rank inversion and no downhill or unranked edge, in the
    port as in JAX."""
    import json

    families = ("metrics_service.sampler_thread", "metrics_service.sampler")
    reports = {}
    for pkg, lg in (("port", tlg), ("jax", jlg)):
        lg.set_enabled(True)
        lg.reset()
        app = None
        try:
            api = cp_module(pkg, "apiserver").APIServer()
            app = cp_module(pkg, "webapps.dashboard").create_app(
                api, history_interval_s=0.05)
            client = app.test_client(user="a@example.com")
            for _ in range(3):
                resp = client.get("/api/metrics/history")
                assert resp.status_code == 200
                assert json.loads(resp.get_data())["series"]
                time.sleep(0.1)
            app.metrics_history.stop()
            reports[pkg] = lg.report()
        finally:
            if app is not None:
                app.metrics_history.stop()
            lg.reset()
            lg.set_enabled(False)
    port, jax = reports["port"], reports["jax"]
    assert tlg.check_edges(port["edges"]) == []
    assert jhier.check_edges(jax["edges"]) == []
    for rep in (port, jax):
        assert rep["cycles"] == [] and rep["order_violations"] == []
        assert set(families) <= set(rep["locks"])
    assert [tlg.LOCK_HIERARCHY[n] for n in families] == [
        jhier.LOCK_HIERARCHY[n] for n in families] == [450, 460]


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
    assert not tlg.enabled() and not jlg.enabled()
