"""Replicated notebook kernels and live migration in the port (slice 7d),
held to JAX on one script: the nine cases of ``tests/test_replication.py``
— standby rendering, warm-standby promotion by demand-resume, the
migration verb with node exclusion, fragmentation-triggered compaction,
and checkpoint integrity under a forced suspend/promote race. Each
scripted case runs on each package's own
``make_control_plane(enable_suspend=True)``; results and whole object
graphs must equal JAX's after the TPU→GPU key map. The race case is a
race: which racer wins is the scheduler's choice, so each package is
held to the same invariants on its own.
"""

import json
import threading

import pytest

from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    annotations_of, deep_get,
)

from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, NS, Side, jax_switch_defaults, parity, reset_uids,
    run_full,
)

SUSPEND = {"check_period_minutes": 1.0}
SLICE = "h100-80gb-2x4"


def _stack(S, nodes=2, slice_type=SLICE):
    S.api.ensure_namespace(NS)
    for i in range(nodes):
        S.node(f"n{i}", slice_type)


def _gang_pods(S, name):
    return [p for p in S.api.list("Pod", NS)
            if (p["metadata"].get("labels") or {}).get(
                S.nb_api.NOTEBOOK_NAME_LABEL) == name]


def _fail_pod(S, name):
    pod = S.api.get("Pod", name, NS)
    pod["status"]["phase"] = "Failed"
    pod["status"]["conditions"] = [{"type": "Ready", "status": "False"}]
    S.api.update_status(pod)


def _ann(S, name):
    return dict(annotations_of(S.api.get(S.nb_api.KIND, name, NS)))


def _full(parity, script, **kw):
    kw.setdefault("arms", ("cached", "raw"))
    return run_full(parity, script, suspend=SUSPEND, **kw)


# ---- rendering -------------------------------------------------------

def test_standby_statefulset_rendering(parity):
    def script(S):
        nbc = S.m("controllers.notebook")
        _stack(S)
        S.api.create(S.notebook("kern", SLICE, replicas=3))
        S.run()
        sts = S.api.get("StatefulSet", "kern", NS)
        standby = S.api.get("StatefulSet", nbc.standby_name("kern"), NS)
        nb = S.api.get(S.nb_api.KIND, "kern", NS)
        return dict(replicas=sts["spec"]["replicas"],
                    standby=standby["spec"]["replicas"],
                    tmpl=standby["spec"]["template"],
                    label=nbc.STANDBY_LABEL,
                    ann=dict(annotations_of(nb)), status=nb["status"])

    out, _ = _full(parity, script)
    assert out["replicas"] == 2 and out["standby"] == 2
    tmpl = out["tmpl"]
    assert nb_api.NOTEBOOK_NAME_LABEL not in tmpl["metadata"]["labels"]
    assert tmpl["metadata"]["labels"][out["label"]] == "kern"
    assert "nodeSelector" not in tmpl["spec"]
    limits = deep_get(tmpl, "spec", "containers", 0, "resources",
                      "limits", default={}) or {}
    assert "nvidia.com/gpu" not in limits
    ann = out["ann"]
    assert ann[nb_api.ACTIVE_REPLICA_ANNOTATION] == "0"
    assert json.loads(ann[nb_api.REPLICA_STATES_ANNOTATION]) == {
        "0": "active", "1": "standby", "2": "standby"}
    assert out["status"]["activeReplica"] == "0"
    assert out["status"]["replicaStates"]["1"] == "standby"


def test_scale_back_to_one_retires_standbys(parity):
    def script(S):
        nbc = S.m("controllers.notebook")
        _stack(S)
        S.api.create(S.notebook("kern", SLICE, replicas=2))
        S.run()
        had = S.api.try_get("StatefulSet", nbc.standby_name("kern"),
                            NS) is not None
        nb = S.api.get(S.nb_api.KIND, "kern", NS)
        nb["spec"]["replicas"] = 1
        S.api.update(nb)
        S.run()
        return [had, S.api.try_get("StatefulSet", nbc.standby_name("kern"),
                                   NS), _ann(S, "kern")]

    (had, gone, ann), _ = _full(parity, script)
    assert had and gone is None
    assert nb_api.REPLICA_STATES_ANNOTATION not in ann
    assert nb_api.ACTIVE_REPLICA_ANNOTATION not in ann


# ---- failover --------------------------------------------------------

def test_active_death_promotes_standby(parity):
    def script(S):
        m = S.m("metrics")
        _stack(S)
        nb = S.notebook("kern", SLICE, replicas=2)
        nb["metadata"]["annotations"] = {
            S.nb_api.TRAINING_STEP_ANNOTATION: "7"}
        S.api.create(nb)
        S.run()
        warm = _ann(S, "kern")[S.nb_api.WARM_CHECKPOINT_ANNOTATION]
        before = m.registry_value("notebook_failover_total")
        _fail_pod(S, "kern-0")
        S.run()
        nb = S.api.get(S.nb_api.KIND, "kern", NS)
        pods = _gang_pods(S, "kern")
        return dict(
            warm=warm, ann=dict(annotations_of(nb)),
            ready=nb["status"]["readyReplicas"],
            phases=[deep_get(p, "status", "phase") for p in pods],
            failovers=m.registry_value("notebook_failover_total") - before,
            reasons=[e["reason"] for e in S.api.events_for(nb)])

    out, _ = _full(parity, script)
    assert json.loads(out["warm"]) == {"step": 7}
    ann = out["ann"]
    assert ann[nb_api.ACTIVE_REPLICA_ANNOTATION] == "1"
    assert json.loads(ann[nb_api.REPLICA_STATES_ANNOTATION]) == {
        "0": "standby", "1": "active"}
    assert ann[nb_api.RESTORED_STEP_ANNOTATION] == "7"
    assert nb_api.RESUME_REQUESTED_ANNOTATION not in ann
    assert nb_api.FAILOVER_T0_ANNOTATION not in ann
    assert out["ready"] == 2 and out["phases"] == ["Running", "Running"]
    assert out["failovers"] == 1.0
    assert {"FailingOver", "FailedOver"} <= set(out["reasons"])
    assert "SliceRestart" not in out["reasons"]


def test_repeated_failover_rotates_through_standbys(parity):
    def script(S):
        _stack(S)
        S.api.create(S.notebook("kern", SLICE, replicas=3))
        S.run()
        _fail_pod(S, "kern-0")
        S.run()
        first = _ann(S, "kern")[S.nb_api.ACTIVE_REPLICA_ANNOTATION]
        _fail_pod(S, "kern-1")
        S.run()
        ann = _ann(S, "kern")
        return [first, ann[S.nb_api.ACTIVE_REPLICA_ANNOTATION],
                sorted(json.loads(
                    ann[S.nb_api.REPLICA_STATES_ANNOTATION]).values())]

    out, _ = _full(parity, script)
    assert out == ["1", "0", ["active", "standby", "standby"]]


# ---- live migration --------------------------------------------------

def test_explicit_migration_rebinds_on_different_nodes(parity):
    def script(S):
        m = S.m("metrics")
        _stack(S, nodes=4)
        S.api.create(S.notebook("mig", SLICE))
        S.run()
        old = sorted({deep_get(p, "spec", "nodeName")
                      for p in _gang_pods(S, "mig")})
        before = m.registry_value("notebook_migration_total",
                                  {"trigger": "api"})
        S.suspend.initiate_migration(S.api,
                                     S.api.get(S.nb_api.KIND, "mig", NS))
        S.run()
        nb = S.api.get(S.nb_api.KIND, "mig", NS)
        pods = _gang_pods(S, "mig")
        return dict(
            old=old, ann=dict(annotations_of(nb)),
            new=sorted({deep_get(p, "spec", "nodeName") for p in pods}),
            phases=[deep_get(p, "status", "phase") for p in pods],
            ready=nb["status"]["readyReplicas"],
            reasons=[e["reason"] for e in S.api.events_for(nb)],
            migrations=m.registry_value(
                "notebook_migration_total", {"trigger": "api"}) - before)

    out, _ = _full(parity, script)
    for key in (nb_api.MIGRATE_REQUESTED_ANNOTATION,
                nb_api.MIGRATE_EXCLUDE_ANNOTATION,
                nb_api.SUSPEND_ANNOTATION,
                nb_api.RESUME_REQUESTED_ANNOTATION):
        assert key not in out["ann"]
    assert len(out["old"]) == 2 and len(out["new"]) == 2
    assert set(out["new"]).isdisjoint(out["old"])
    assert out["phases"] == ["Running", "Running"] and out["ready"] == 2
    assert {"Migrating", "Migrated"} <= set(out["reasons"])
    assert out["migrations"] == 1.0


def test_migration_refused_mid_lifecycle(parity):
    def script(S):
        _stack(S)
        S.api.create(S.notebook("busy", SLICE))
        S.run()
        S.suspend.initiate_suspend(
            S.api, S.api.get(S.nb_api.KIND, "busy", NS), reason="api")
        live = S.suspend.initiate_migration(
            S.api, S.api.get(S.nb_api.KIND, "busy", NS))
        return dict(annotations_of(live))

    ann, _ = _full(parity, script)
    assert nb_api.MIGRATE_REQUESTED_ANNOTATION not in ann


def test_gang_bind_honors_exclude_nodes(parity):
    def script(S):
        _stack(S, nodes=3, slice_type="h100-80gb-4")
        S.api.create(S.notebook("pin", "h100-80gb-4"))
        S.run()
        sched = S.m("scheduler").cache_for(S.api)
        pod = {"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": "probe-0", "namespace": NS},
               "spec": {"containers": [{"name": "c", "resources": {
                   "limits": {S.card_key: "4"}}}]}}
        free = [n for n, (f, _) in sorted(sched.free_by_node().items())
                if f >= 4]
        plan = sched.gang_bind([pod], allow_virtual=False,
                               exclude_nodes=set(free[:1]))
        sched.forget((NS, "probe-0"))
        none = sched.gang_bind([pod], allow_virtual=False,
                               exclude_nodes=set(free))
        return [free, plan[(NS, "probe-0")], none]

    (free, placed, none), _ = _full(parity, script)
    assert len(free) == 2 and placed == free[1] and none is None


def test_fragmentation_triggered_compaction_admits_waiter(parity):
    """Free cards ≥ the waiter's need but stranded across nodes: static
    placement rejects the 4-card gang, the compaction autopilot migrates
    a 1-card kernel, and the waiter admits. Three 4-card hosts (JAX:
    ``v5litepod-4``) and 1-card kernels (``v5litepod-1``)."""
    def script(S):
        one, four = (("v5litepod-1", "v5litepod-4") if S.pkg == "jax"
                     else ("h100-80gb-1", "h100-80gb-4"))
        m = S.m("metrics")
        S.api.ensure_namespace(NS)
        for i in range(3):
            S.api.create(S.make_node(f"m{i}", four))
        parity.setattr(S.suspend, "_auto_migration", True)

        def make(name, acc):
            S.api.create(S.nb_api.make_notebook(name, NS,
                                                accelerator_type=acc))
            S.run()

        for i in range(4):
            make(f"s{i}", one)
        make("big1", four)
        for i in (4, 5):
            make(f"s{i}", one)
        for victim in ("s0", "s4"):
            S.suspend.initiate_suspend(
                S.api, S.api.get(S.nb_api.KIND, victim, NS), reason="api")
        S.run()
        sched = S.m("scheduler").cache_for(S.api)
        stranded = sorted(f for f, _ in sched.free_by_node().values())
        before = m.registry_value("notebook_migration_total",
                                  {"trigger": "fragmentation"})
        make("waiter", four)
        S.clock.advance(minutes=2)
        S.run()
        waiter = _gang_pods(S, "waiter")
        return dict(
            stranded=stranded,
            migrations=m.registry_value(
                "notebook_migration_total",
                {"trigger": "fragmentation"}) - before,
            waiter=[deep_get(p, "status", "phase") for p in waiter],
            running=sum(deep_get(p, "status", "phase") == "Running"
                        for p in S.api.list("Pod", NS)),
            migrated=sum(e["reason"] == "Migrated"
                         for n in ("s1", "s2", "s3", "s5")
                         for e in S.api.events_for(
                             S.api.get(S.nb_api.KIND, n, NS))))

    out, _ = _full(parity, script)
    assert out["stranded"] == [0.0, 1.0, 3.0]
    assert out["migrations"] == 1.0
    assert out["waiter"] == ["Running"]
    assert out["running"] == 6 and out["migrated"] == 1


# ---- checkpoint integrity under a forced suspend/promote race --------

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_concurrent_suspend_and_promote_keep_checkpoint_integrity(
        parity, pkg):
    reset_uids(parity)
    S = Side(pkg, full=True, cached=True, suspend=SUSPEND)
    try:
        barrier = threading.Barrier(2)

        class BarrierStore(S.suspend.InMemoryStateStore):
            def snapshot(self, notebook):
                try:
                    barrier.wait(timeout=5)
                except threading.BrokenBarrierError:
                    pass  # second pass: the other racer already finished
                return super().snapshot(notebook)

        store = BarrierStore()
        S.close()
        reset_uids(parity)
        S = Side(pkg, full=True, cached=True,
                 suspend=dict(SUSPEND, store=store))
        _stack(S)
        nb = S.notebook("race", SLICE, replicas=2)
        nb["metadata"]["annotations"] = {
            S.nb_api.TRAINING_STEP_ANNOTATION: "99"}
        S.api.create(nb)
        S.run()

        def strip(o):
            annotations_of(o).pop(S.nb_api.WARM_CHECKPOINT_ANNOTATION, None)
            return True
        S.suspend._update_retrying(
            S.api, S.api.get(S.nb_api.KIND, "race", NS), strip)
        _fail_pod(S, "race-0")
        ctrl = S.suspend.ReplicaFailoverController(store=store)
        Request = S.m("runtime").Request
        errors = []

        def suspender():
            try:
                S.suspend.initiate_suspend(
                    S.api, S.api.get(S.nb_api.KIND, "race", NS),
                    reason="idle", store=store)
            except Exception as e:  # noqa: BLE001 - collected for assert
                errors.append(e)

        def promoter():
            try:
                ctrl.reconcile(S.api, Request(NS, "race"))
            except Exception as e:  # noqa: BLE001 - collected for assert
                errors.append(e)

        ts = [threading.Thread(target=f) for f in (suspender, promoter)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts) and not errors
        ann = _ann(S, "race")
        won_suspend = S.nb_api.SUSPEND_ANNOTATION in ann
        won_promote = S.nb_api.RESUME_REQUESTED_ANNOTATION in ann
        assert won_suspend != won_promote
        assert json.loads(ann[S.nb_api.SUSPEND_CHECKPOINT_ANNOTATION]) == {
            "step": 99}
        S.run()
        if won_promote:
            S.clock.advance(minutes=2)
            S.run()
            final = _ann(S, "race")
            assert final[S.nb_api.RESTORED_STEP_ANNOTATION] == "99"
            states = json.loads(final[S.nb_api.REPLICA_STATES_ANNOTATION])
            assert "promoting" not in states.values()
    finally:
        S.close()


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
