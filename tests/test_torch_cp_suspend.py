"""Suspend/resume and priority preemption in the port (slice 7d), held to
JAX's ``controlplane/suspend.py`` on one script: the mirrors of
``tests/test_suspend.py`` (all but its two web-app cases, which
``tests/test_torch_webapps_jupyter.py`` holds), the checkpoint fault of ``test_chaos.py`` and the whole-gang
TPUJob suspend of ``test_tpujob.py``. Each script runs on each
package's own ``make_control_plane(enable_suspend=True)`` on the
oversubscribe-on arm (JAX's default), on the informer cache and on the
raw arm; the results, the metric deltas and the whole object graphs,
Events included, must equal JAX's after the TPU→GPU key map.

Nodes: two ``h100-80gb-2x4`` hosts (JAX: ``v5p-16``) = one 2-host
slice's cards, as in JAX's fixture.
"""

import json

import pytest

from kubeflow_rm_tpu.controlplane.api import notebook as jax_nb
from kubeflow_rm_tpu_torch.controlplane import metrics as port_metrics
from kubeflow_rm_tpu_torch.controlplane import suspend as port_suspend
from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import annotations_of

from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, NS, jax_switch_defaults, parity, run_full,
)

SUSPEND = {"suspend_idle_minutes": 30.0, "check_period_minutes": 1.0}
SLICE = "h100-80gb-2x4"
ARMS = ("cached", "raw")


def _stack(S, nodes=2):
    S.api.ensure_namespace(NS)
    for i in range(nodes):
        S.node(f"n{i}", SLICE)


def _ready(S, name):
    return (S.api.get(S.nb_api.KIND, name, NS).get("status") or {}).get(
        "readyReplicas", 0)


def _ann(S, name):
    return dict(annotations_of(S.api.get(S.nb_api.KIND, name, NS)))


def _reasons(S, obj):
    return [e["reason"] for e in S.api.events_for(obj)]


def _full(parity, script, **kw):
    kw.setdefault("arms", ARMS)
    return run_full(parity, script, suspend=kw.pop("suspend", SUSPEND),
                    **kw)


# ---- idle suspension -------------------------------------------------

def test_idle_notebook_suspends_and_releases_cards(parity):
    def script(S):
        _stack(S)
        nb = S.notebook("idle", SLICE)
        nb["metadata"]["annotations"] = {
            S.nb_api.TRAINING_STEP_ANNOTATION: "7"}
        S.api.create(nb)
        S.run()
        pods = len(S.api.list("Pod", NS))
        S.clock.advance(minutes=31)
        S.run()
        nb = S.api.get(S.nb_api.KIND, "idle", NS)
        stats = S.m("scheduler").cache_for(S.api).stats()
        return dict(
            pods_before=pods, ann=dict(annotations_of(nb)),
            pods=S.api.list("Pod", NS),
            replicas=S.api.get("StatefulSet", "idle", NS)["spec"][
                "replicas"],
            phase=nb["status"]["phase"],
            free=stats["free_chips"], gang=stats["largest_free_gang"],
            frag=stats["fragmentation"])

    out, _ = _full(parity, script)
    ann = out["ann"]
    assert out["pods_before"] == 2
    assert nb_api.SUSPEND_ANNOTATION in ann
    assert ann[nb_api.SUSPEND_REASON_ANNOTATION] == "idle"
    assert nb_api.SUSPEND_DRAINED_ANNOTATION in ann
    assert json.loads(ann[nb_api.SUSPEND_CHECKPOINT_ANNOTATION]) == {
        "step": 7}
    assert out["pods"] == [] and out["replicas"] == 0
    assert out["phase"] == nb_api.SUSPENDED_PHASE
    assert (out["free"], out["gang"], out["frag"]) == (8.0, 8.0, 0.0)


def test_resume_restores_checkpointed_step(parity):
    def script(S):
        _stack(S)
        nb = S.notebook("nb", SLICE)
        nb["metadata"]["annotations"] = {
            S.nb_api.TRAINING_STEP_ANNOTATION: "42"}
        S.api.create(nb)
        S.run()
        S.clock.advance(minutes=31)
        S.run()
        drained = S.api.list("Pod", NS)
        S.suspend.request_resume(S.api, S.api.get(S.nb_api.KIND, "nb", NS))
        S.run()
        nb = S.api.get(S.nb_api.KIND, "nb", NS)
        return dict(drained=drained, ready=_ready(S, "nb"),
                    ann=dict(annotations_of(nb)), reasons=_reasons(S, nb))

    out, _ = _full(parity, script)
    ann = out["ann"]
    assert out["drained"] == [] and out["ready"] == 2
    assert ann[nb_api.RESTORED_STEP_ANNOTATION] == "42"
    for key in (nb_api.SUSPEND_ANNOTATION, nb_api.RESUME_REQUESTED_ANNOTATION,
                nb_api.SUSPEND_CHECKPOINT_ANNOTATION):
        assert key not in ann
    assert "Resumed" in out["reasons"]


def test_pinned_notebook_never_idle_suspended(parity):
    def script(S):
        _stack(S)
        S.api.create(S.notebook(
            "pinned", SLICE,
            annotations={S.nb_api.PIN_ANNOTATION: "true"}))
        S.run()
        S.clock.advance(minutes=120)
        S.run()
        return [_ann(S, "pinned"), len(S.api.list("Pod", NS))]

    (ann, pods), _ = _full(parity, script)
    assert nb_api.SUSPEND_ANNOTATION not in ann and pods == 2


@pytest.mark.parametrize("case", ["idle", "preemption"])
def test_no_oversubscribe_arm_disables(parity, case):
    """``set_oversubscribe(False)``: neither idle suspension nor
    preemption (the switch is put back by the fixture)."""
    def script(S):
        _stack(S)
        S.suspend.set_oversubscribe(False)
        if case == "idle":
            S.api.create(S.notebook("nb", SLICE))
            S.run()
            S.clock.advance(minutes=120)
            S.run()
            return [_ann(S, "nb"), len(S.api.list("Pod", NS))]
        S.api.create(S.notebook("low", SLICE, priority_class="low"))
        S.run()
        S.api.create(S.notebook("high", SLICE, priority_class="high"))
        S.run()
        return [_ready(S, "low"), _ready(S, "high")]

    out, _ = _full(parity, script)
    if case == "idle":
        assert nb_api.SUSPEND_ANNOTATION not in out[0] and out[1] == 2
    else:
        assert out == [2, 0]


def test_resumed_notebook_gets_fresh_idle_window(parity):
    def script(S):
        _stack(S)
        S.api.create(S.notebook("nb", SLICE))
        S.run()
        S.clock.advance(minutes=31)
        S.run()
        parked = S.nb_api.SUSPEND_ANNOTATION in _ann(S, "nb")
        S.suspend.request_resume(S.api, S.api.get(S.nb_api.KIND, "nb", NS))
        S.run()
        ready = _ready(S, "nb")
        S.clock.advance(minutes=20)
        S.run()
        return [parked, ready,
                S.nb_api.SUSPEND_ANNOTATION in _ann(S, "nb"),
                _ready(S, "nb")]

    out, _ = _full(parity, script)
    assert out == [True, 2, False, 2]


# ---- preemption ------------------------------------------------------

def test_higher_priority_gang_displaces_one_victim(parity):
    def script(S):
        _stack(S)
        S.api.create(S.notebook("low", SLICE, priority_class="low"))
        S.run()
        low_ready = _ready(S, "low")
        before = S.m("metrics").registry_value("notebook_preempt_total")
        S.api.create(S.notebook("high", SLICE, priority_class="high"))
        S.run()
        return dict(
            low_ready=low_ready, ann=_ann(S, "low"),
            high=_ready(S, "high"),
            pods=sorted(p["metadata"]["name"]
                        for p in S.api.list("Pod", NS)),
            sts_reasons=_reasons(S, S.api.get("StatefulSet", "high", NS)),
            preempted=S.m("metrics").registry_value(
                "notebook_preempt_total") - before)

    out, _ = _full(parity, script)
    assert out["low_ready"] == 2
    assert out["ann"][nb_api.SUSPEND_REASON_ANNOTATION] == "preempted"
    assert nb_api.SUSPEND_DRAINED_ANNOTATION in out["ann"]
    assert out["high"] == 2 and out["pods"] == ["high-0", "high-1"]
    assert "Preempted" in out["sts_reasons"]
    assert out["preempted"] == 1.0


def test_pinned_victim_never_selected(parity):
    def script(S):
        _stack(S)
        S.api.create(S.notebook(
            "pinned-low", SLICE, priority_class="low",
            annotations={S.nb_api.PIN_ANNOTATION: "true"}))
        S.run()
        S.api.create(S.notebook("high", SLICE, priority_class="high"))
        S.run()
        return [_ready(S, "pinned-low"), _ready(S, "high"),
                S.nb_api.SUSPEND_ANNOTATION in _ann(S, "pinned-low")]

    out, _ = _full(parity, script)
    assert out == [2, 0, False]


def test_equal_priority_never_preempts(parity):
    def script(S):
        _stack(S)
        S.api.create(S.notebook("first", SLICE))
        S.run()
        S.api.create(S.notebook("second", SLICE))
        S.run()
        return [_ready(S, "first"), _ready(S, "second")]

    out, _ = _full(parity, script)
    assert out == [2, 0]


def test_preempted_victim_regangs_when_capacity_frees(parity):
    def script(S):
        _stack(S)
        S.api.create(S.notebook("low", SLICE, priority_class="low"))
        S.run()
        S.api.create(S.notebook("high", SLICE, priority_class="high"))
        S.run()
        seen = [_ready(S, "high")]
        S.suspend.request_resume(S.api,
                                 S.api.get(S.nb_api.KIND, "low", NS))
        S.run()
        seen += [_ready(S, "low"), _ready(S, "high")]
        S.suspend.initiate_suspend(
            S.api, S.api.get(S.nb_api.KIND, "high", NS), reason="api")
        S.run()
        seen += [_ready(S, "low"),
                 S.api.get(S.nb_api.KIND, "high", NS)["status"]["phase"]]
        return seen

    out, _ = _full(parity, script)
    assert out == [2, 0, 2, 2, nb_api.SUSPENDED_PHASE]


# ---- priority API ----------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_priority_resolution_and_validation(pkg):
    api = nb_api if pkg == "port" else jax_nb
    nb = api.make_notebook("a", "u", priority_class="high")
    assert api.priority_of(nb) == api.PRIORITY_CLASSES["high"]
    nb["spec"]["priority"] = 5
    assert api.priority_of(nb) == 5
    assert api.priority_of(api.make_notebook("b", "u")) == \
        api.DEFAULT_PRIORITY
    with pytest.raises(ValueError):
        api.validate(api.make_notebook("c", "u", priority_class="platinum"))
    bad = api.make_notebook("d", "u")
    bad["spec"]["priority"] = "urgent"
    with pytest.raises(ValueError):
        api.validate(bad)
    assert nb_api.PRIORITY_CLASSES == jax_nb.PRIORITY_CLASSES
    assert nb_api.DEFAULT_PRIORITY == jax_nb.DEFAULT_PRIORITY


# ---- state stores ----------------------------------------------------

class FakeManager:
    def __init__(self):
        self.step = 1234
        self.waited = False

    def wait(self):
        self.waited = True

    def latest_step(self):
        return self.step


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_checkpointer_state_store_bridges_latest_step(pkg):
    if pkg == "port":
        mod, make = port_suspend, nb_api.make_notebook
    else:
        from kubeflow_rm_tpu.controlplane import suspend as mod
        make = jax_nb.make_notebook
    mgr = FakeManager()
    store = mod.CheckpointerStateStore(lambda ns, name: mgr)
    nb = make("nb", "u")
    token = store.snapshot(nb)
    assert token == {"step": 1234} and mgr.waited
    assert store.restore(nb, token) == {"step": 1234}
    mgr.step = 1000
    out = store.restore(nb, token)
    assert out == {"step": 1000, "degraded_from": 1234}


def test_checkpointer_state_store_over_the_port_checkpointer(tmp_path):
    """The store over the port's own ``training/checkpoint.Checkpointer``
    (what the smoke's arm C wires): the token is the last step saved to
    disk, and a restore that finds an older step reports it."""
    import torch

    from kubeflow_rm_tpu_torch.training.checkpoint import Checkpointer

    ckpt = Checkpointer(str(tmp_path), max_to_keep=3)
    store = port_suspend.CheckpointerStateStore(lambda ns, name: ckpt)
    nb = nb_api.make_notebook("nb", "u")
    assert store.snapshot(nb) == {"step": 0}
    assert ckpt.save({"step": 2, "w": torch.zeros(2)})
    token = store.snapshot(nb)
    assert token == {"step": 2}
    assert store.restore(nb, token) == {"step": 2}
    assert store.restore(nb, {"step": 3}) == {"step": 2, "degraded_from": 3}
    ckpt.close()


def test_suspend_metrics_observed(parity):
    def script(S):
        m = S.m("metrics")

        def rv(name, **labels):
            return m.registry_value(name, labels or None)

        base = [rv("notebook_suspend_total", reason="idle"),
                rv("suspend_resume_phase_seconds_count", phase="drain"),
                rv("suspend_resume_phase_seconds_count", phase="rebind"),
                rv("suspend_resume_phase_seconds_count", phase="restore"),
                rv("notebook_resume_total")]
        _stack(S)
        S.api.create(S.notebook("nb", SLICE))
        S.run()
        S.clock.advance(minutes=31)
        S.run()
        mid = [rv("notebook_suspend_total", reason="idle"),
               rv("suspend_resume_phase_seconds_count", phase="drain")]
        S.suspend.request_resume(S.api, S.api.get(S.nb_api.KIND, "nb", NS))
        S.run()
        end = [rv("suspend_resume_phase_seconds_count", phase="rebind"),
               rv("suspend_resume_phase_seconds_count", phase="restore"),
               rv("notebook_resume_total")]
        return [a - b for a, b in zip(mid + end, base)]

    out, _ = _full(parity, script, arms=("cached",))
    assert out == [1.0, 1.0, 1.0, 1.0, 1.0]


SERIES = ("NOTEBOOK_SUSPEND_TOTAL", "NOTEBOOK_RESUME_TOTAL",
          "NOTEBOOK_PREEMPT_TOTAL", "SUSPEND_RESUME_SECONDS",
          "NOTEBOOK_MIGRATION_TOTAL", "NOTEBOOK_FAILOVER_TOTAL",
          "NOTEBOOK_FAILOVER_SECONDS", "HARVEST_GRANTS_TOTAL",
          "HARVEST_RECLAIMS_TOTAL", "HARVEST_RECLAIM_SECONDS",
          "WAL_FSYNC_SECONDS", "WAL_BYTES_TOTAL",
          "SNAPSHOT_DURATION_SECONDS", "LEADER_IS_LEADER")


@pytest.mark.parametrize("attr", SERIES)
def test_series_render_in_jax_names(attr):
    """Each family this slice sets scrapes under JAX's name, help text,
    type and labels."""
    import prometheus_client

    from kubeflow_rm_tpu.controlplane import metrics as jax_metrics

    jm, pm = getattr(jax_metrics, attr), getattr(port_metrics, attr)
    assert tuple(pm.labelnames) == tuple(jm._labelnames)
    if pm.labelnames:
        # a labelled family scrapes its HELP/TYPE once it has a series
        labels = {n: "probe" for n in pm.labelnames}
        jm.labels(**labels)
        pm.labels(**labels)
    jtext = prometheus_client.generate_latest(
        jax_metrics.REGISTRY).decode().splitlines()
    ptext = port_metrics.render().splitlines()
    name = pm.series_name()
    for tag in ("HELP", "TYPE"):
        want = [ln for ln in jtext if ln.startswith(f"# {tag} {name} ")]
        got = [ln for ln in ptext if ln.startswith(f"# {tag} {name} ")]
        assert got == want and len(got) == 1, (tag, got, want)


# ---- a checkpoint fault delays the suspend, loses nothing ---------------

def test_checkpoint_fault_delays_but_does_not_lose_suspend(parity):
    """``test_chaos.py``'s case: the first snapshot write fails (seeded
    plan), the reconcile retries, and the token still records step 42."""
    def script(S):
        chaos = S.m("chaos")
        _stack(S)
        nb = S.notebook("ckpt", SLICE)
        nb["metadata"]["annotations"] = {
            S.nb_api.TRAINING_STEP_ANNOTATION: "42"}
        S.api.create(nb)
        S.run()
        chaos.install(chaos.FaultPlan(6, [
            chaos.FaultSpec("checkpoint_fail", rate=1.0, limit=1)]))
        try:
            S.clock.advance(minutes=31)
            S.run()
        finally:
            plan = chaos.uninstall()
        S.clock.advance(minutes=2)
        S.run()
        return [plan.counts["checkpoint_fail"], _ann(S, "ckpt")]

    (faults, ann), _ = _full(parity, script)
    assert faults == 1
    assert nb_api.SUSPEND_ANNOTATION in ann
    assert json.loads(ann[nb_api.SUSPEND_CHECKPOINT_ANNOTATION]) == {
        "step": 42}


# ---- a TPUJob's whole-gang suspend/resume (test_tpujob.py) -----------

def _podracer(S, name="pr", *, learner_slices=1):
    return S.tj_api.make_tpujob(name, NS, roles=[
        {"name": "learner", "replicas": learner_slices,
         "tpu": {"acceleratorType": S.slice(SLICE)}},
        {"name": "actors", "replicas": 4, "cpu": "2"},
    ])


def _job(S, name="pr"):
    return S.api.get(S.tj_api.KIND, name, NS)


def _job_pods(S, name="pr"):
    return S.api.list("Pod", NS,
                      {"matchLabels": {S.tj_api.JOB_NAME_LABEL: name}})


def _gang_stack(S):
    _stack(S, nodes=4)


@pytest.mark.parametrize("case", ["park", "resume", "bare_stamp",
                                  "contention"])
def test_tpujob_whole_gang_suspend(parity, case):
    """The four whole-gang cases of ``test_tpujob.py``: suspend parks
    every role and frees cards and cpu (a second whole-fleet gang binds
    at once); resume brings every role back at once; a bare
    resume-requested stamp unparks the gang; a resume while another gang
    holds the cards leaves the job wholly parked."""
    def script(S):
        _gang_stack(S)
        S.api.create(_podracer(S, learner_slices=1 if case == "bare_stamp"
                               else 2))
        S.run()
        out = {"phase0": _job(S)["status"]["phase"]}
        S.suspend.initiate_suspend(S.api, _job(S), reason="manual")
        S.run()
        job = _job(S)
        out.update(drained=S.nb_api.SUSPEND_DRAINED_ANNOTATION
                   in annotations_of(job),
                   parked=job["status"]["phase"], pods=len(_job_pods(S)))
        if case == "park":
            out["replicas"] = [S.api.get("StatefulSet", f"pr-{r}", NS)[
                "spec"]["replicas"] for r in ("learner", "actors")]
            out["reasons"] = _reasons(S, job)
            S.api.create(_podracer(S, "pr2", learner_slices=2))
            S.run()
            out["second"] = _job(S, "pr2")["status"]["phase"]
        elif case == "resume":
            S.suspend.request_resume(S.api, _job(S))
            S.run()
            job = _job(S)
            out.update(status=job["status"], ann=dict(annotations_of(job)),
                       reasons=_reasons(S, job))
        elif case == "bare_stamp":
            job["metadata"]["annotations"][
                S.nb_api.RESUME_REQUESTED_ANNOTATION] = \
                S.api.clock().isoformat()
            S.api.update(job)
            S.run()
            job = _job(S)
            out.update(phase=job["status"]["phase"],
                       ann=dict(annotations_of(job)))
        else:
            S.api.create(_podracer(S, "squatter", learner_slices=2))
            S.run()
            out["squatter"] = _job(S, "squatter")["status"]["phase"]
            S.suspend.request_resume(S.api, _job(S))
            S.run()
            out.update(bound=[p["spec"].get("nodeName")
                              for p in _job_pods(S)],
                       phase=_job(S)["status"]["phase"],
                       squatter_ready=_job(S, "squatter")["status"][
                           "readyPods"])
        return out

    out, _ = _full(parity, script)
    from kubeflow_rm_tpu_torch.controlplane.api import tpujob as tj_api
    assert out["phase0"] == tj_api.RUNNING_PHASE
    assert out["drained"] and out["parked"] == tj_api.SUSPENDED_PHASE
    assert out["pods"] == 0
    if case == "park":
        assert out["replicas"] == [0, 0] and "Suspended" in out["reasons"]
        assert out["second"] == tj_api.RUNNING_PHASE
    elif case == "resume":
        st, ann = out["status"], out["ann"]
        assert st["phase"] == tj_api.RUNNING_PHASE
        assert st["readyPods"] == st["totalPods"] == 8
        assert st["roles"] == {"learner": {"ready": 4, "total": 4},
                               "actors": {"ready": 4, "total": 4}}
        for key in (nb_api.SUSPEND_ANNOTATION,
                    nb_api.RESUME_REQUESTED_ANNOTATION,
                    nb_api.SUSPEND_DRAINED_ANNOTATION,
                    nb_api.SUSPEND_CHECKPOINT_ANNOTATION):
            assert key not in ann
        assert "Resumed" in out["reasons"]
    elif case == "bare_stamp":
        assert out["phase"] == tj_api.RUNNING_PHASE
        assert nb_api.SUSPEND_ANNOTATION not in out["ann"]
        assert nb_api.RESUME_REQUESTED_ANNOTATION not in out["ann"]
    else:
        assert out["squatter"] == tj_api.RUNNING_PHASE
        assert all(not n for n in out["bound"])
        assert out["phase"] != tj_api.RUNNING_PHASE
        assert out["squatter_ready"] == 8


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
