"""Card harvesting in the port (``controlplane/harvest.py``, slice 7d),
held to JAX's on one script: the five cases of ``tests/test_harvest.py``
on each package's own ``make_control_plane(enable_suspend=True)``, with
each package's serving fleet of tiny Llamas on the same numpy-seeded
weights (float32, ``tests/torch_fleet_helpers.py``).

Compared for equality: the controller's decisions, the lease table, the
scheduler's charges, fleet states, every token (also against each
package's solo ``generate_fused``), the metric deltas, and the whole
object graphs, Events included, after the TPU→GPU key map. The one
wall-clock number in a graph — the reclaim's milliseconds in a
``HarvestReturned`` Event — is blanked before the graphs are compared.

No case waits on the wall clock: the notebooks idle on each side's
``FakeClock``, and the killed replica is held mid-decode by a
``StepGate`` (it steps an exact number of times, then parks), not by
sleeps.
"""

import importlib
import re

import pytest

from kubeflow_rm_tpu_torch.controlplane import harvest as port_harvest
from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api

from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, NS, jax_switch_defaults, parity, run_full,
)
from torch_fleet_helpers import (
    StepGate, both_models, join_all, solo_jax, solo_torch, start_all,
)

SUSPEND = {"suspend_idle_minutes": 30.0, "check_period_minutes": 1.0}
SLICE = "h100-80gb-2x4"


@pytest.fixture(scope="module")
def model():
    return both_models()


def _root(S):
    return "kubeflow_rm_tpu" if S.pkg == "jax" else "kubeflow_rm_tpu_torch"


def _gateway(S, model):
    jcfg, jparams, tcfg, tparams = model
    gen = importlib.import_module(f"{_root(S)}.models.generate")
    params, cfg = (jparams, jcfg) if S.pkg == "jax" else (tparams, tcfg)
    eng = gen.ContinuousBatchingEngine(params, cfg, slots=2, slot_len=32,
                                       block_size=4)
    return S.m("webapps.serving").ServingGateway(eng, admission=False)


def _fleet(S, model, names, roles=None):
    return S.m("serving_fleet").ServingFleet(
        {n: _gateway(S, model) for n in names}, roles=roles)


def _controller(S, fleet, model, **kw):
    kw.setdefault("idle_minutes", 15.0)
    kw.setdefault("pressure_depth", 0.0)   # always under pressure
    kw.setdefault("sustain", 1)
    return S.m("harvest").ChipHarvestController(
        S.api, fleet, gateway_factory=lambda name: _gateway(S, model), **kw)


def _solo(S, model, prompt, budget):
    jcfg, jparams, tcfg, tparams = model
    if S.pkg == "jax":
        return solo_jax(jparams, jcfg, prompt, budget, 32)
    return solo_torch(tparams, tcfg, prompt, budget, 32)


def _stack(S):
    S.api.ensure_namespace(NS)
    for i in range(2):
        S.node(f"n{i}", SLICE)


def _donor(S, step=None, **kw):
    nb = S.notebook("donor", SLICE, **kw)
    if step is not None:
        nb["metadata"].setdefault("annotations", {})[
            S.nb_api.TRAINING_STEP_ANNOTATION] = step
    S.api.create(nb)
    S.run()


def _ann(S, name="donor"):
    return dict(S.api.get(S.nb_api.KIND, name, NS)["metadata"].get(
        "annotations") or {})


def _sched(S):
    return S.m("scheduler").cache_for(S.api)


def _free(S):
    return _sched(S).stats()["free_chips"]


def _no_overcommit(S):
    sched = _sched(S)
    with sched._nlock:
        nodes = list(sched._nodes.values())
    for node in nodes:
        with node.lock:
            assert node.used <= node.capacity + 1e-9, node.name


def _ready(S, name="donor"):
    return (S.api.get(S.nb_api.KIND, name, NS).get("status") or {}).get(
        "readyReplicas")


def _rv(S, name, **labels):
    return S.m("metrics").registry_value(name, labels or None)


def _blank_reclaim_ms(dump):
    for ev in dump.get("Event", []):
        ev["message"] = re.sub(r"slice in [0-9.]+ms", "slice in <t>ms",
                               ev["message"])
    return dump


def _full(parity, script):
    return run_full(parity, script, suspend=SUSPEND,
                    normalize=_blank_reclaim_ms)


# ---- grant / reclaim round trip --------------------------------------

def test_tick_harvests_idle_notebook_and_reclaims_on_resume(parity, model):
    def script(S):
        _stack(S)
        _donor(S, "42")
        out = {"free0": _free(S)}
        fleet = _fleet(S, model, ["base"])
        ctl = _controller(S, fleet, model)
        grants = _rv(S, "harvest_grants_total")
        try:
            S.clock.advance(minutes=16)
            out["t1"] = ctl.tick()
            out["reason"] = _ann(S)[S.nb_api.SUSPEND_REASON_ANNOTATION]
            S.run()
            out["t2"] = ctl.tick()
            sched = _sched(S)
            out.update(harvested=sched.harvested_chips(), free=_free(S),
                       states=fleet.states(), leases=ctl.leases(),
                       grants=_rv(S, "harvest_grants_total") - grants)
            _no_overcommit(S)
            p = [5, 9, 2, 7, 1]
            tokens, _ = fleet.submit_and_wait("t", list(p),
                                              max_new_tokens=6)
            out["tokens"] = tokens
            out["solo"] = _solo(S, model, p, 6)
            S.suspend.request_resume(S.api,
                                     S.api.get(S.nb_api.KIND, "donor", NS))
            out["t3"] = ctl.tick()
            out.update(harvested_after=sched.harvested_chips(),
                       replicas=sorted(fleet.gateways))
            S.run()
            _no_overcommit(S)
            nb = S.api.get(S.nb_api.KIND, "donor", NS)
            out.update(ready=_ready(S), ann=_ann(S),
                       reasons=[e["reason"] for e in S.api.events_for(nb)])
        finally:
            ctl.close()
            fleet.close()
        return out

    out, _ = _full(parity, script)
    assert out["free0"] == 0.0
    assert (out["t1"], out["t2"], out["t3"]) == ("suspend", "grant",
                                                 "reclaim")
    assert out["reason"] == port_harvest.HARVEST_REASON
    assert out["harvested"] == 8.0 and out["free"] == 0.0
    assert out["states"] == {"base": "ready", "harvest-1": "ready"}
    assert out["grants"] == 1.0
    assert out["tokens"] == out["solo"]
    assert out["harvested_after"] == 0.0 and out["replicas"] == ["base"]
    assert out["ready"] == 2
    assert out["ann"][nb_api.RESTORED_STEP_ANNOTATION] == "42"
    assert {"Harvested", "HarvestReturned"} <= set(out["reasons"])


def test_failed_bind_reclaims_synchronously_within_failover_slo(
        parity, model):
    """A resuming gang that cannot bind reclaims the lease inside the
    same reconcile (no tick), attributed to the resume."""
    def script(S):
        _stack(S)
        _donor(S, "1337")
        S.clock.advance(minutes=31)         # the idle suspender parks it
        S.run()
        out = {"drained": S.nb_api.SUSPEND_DRAINED_ANNOTATION in _ann(S)}
        fleet = _fleet(S, model, ["base"])
        ctl = _controller(S, fleet, model)
        try:
            out["t1"] = ctl.tick()
            out["harvested"] = _sched(S).harvested_chips()
            base_sum = _rv(S, "harvest_reclaim_seconds_sum")
            resumes = _rv(S, "harvest_reclaims_total", trigger="resume")
            S.suspend.request_resume(S.api,
                                     S.api.get(S.nb_api.KIND, "donor", NS))
            S.run()                         # NO tick: try_preempt reclaims
            _no_overcommit(S)
            out.update(ready=_ready(S),
                       restored=_ann(S)[S.nb_api.RESTORED_STEP_ANNOTATION],
                       harvested_after=_sched(S).harvested_chips(),
                       replicas=sorted(fleet.gateways),
                       resumes=_rv(S, "harvest_reclaims_total",
                                   trigger="resume") - resumes)
            spent = _rv(S, "harvest_reclaim_seconds_sum") - base_sum
            assert 0.0 <= spent <= S.m("harvest").FAILOVER_SLO_S
        finally:
            ctl.close()
            fleet.close()
        return out

    out, _ = _full(parity, script)
    assert out == {"drained": True, "t1": "grant", "harvested": 8.0,
                   "ready": 2, "restored": "1337", "harvested_after": 0.0,
                   "replicas": ["base"], "resumes": 1.0}


# ---- donor eligibility -----------------------------------------------

def test_pinned_and_excluded_notebooks_are_never_harvested(parity, model):
    def script(S):
        _stack(S)
        _donor(S, annotations={S.nb_api.PIN_ANNOTATION: "true"})
        fleet = _fleet(S, model, ["base"])
        ctl = _controller(S, fleet, model)
        ticks = []
        try:
            S.clock.advance(minutes=120)
            for _ in range(4):
                ticks.append(ctl.tick())
                S.run()
            pinned = (S.nb_api.SUSPEND_ANNOTATION in _ann(S),
                      ctl.lease_count(), _sched(S).harvested_chips())
            nb = S.api.get(S.nb_api.KIND, "donor", NS)
            ann = nb["metadata"]["annotations"]
            ann.pop(S.nb_api.PIN_ANNOTATION)
            ann[S.nb_api.CULLING_EXCLUDE_ANNOTATION] = "true"
            S.api.update(nb)
            ticks.append(ctl.tick())
            excluded = _ann(S).get(S.nb_api.SUSPEND_REASON_ANNOTATION)
        finally:
            ctl.close()
            fleet.close()
        return [ticks, pinned, excluded]

    (ticks, pinned, excluded), _ = _full(parity, script)
    assert set(ticks) <= {"hold", "give_back"}
    assert pinned == (False, 0, 0.0)
    assert excluded != port_harvest.HARVEST_REASON


def test_sustained_calm_gives_the_lease_back(parity, model):
    def script(S):
        _stack(S)
        _donor(S)
        S.clock.advance(minutes=31)
        S.run()                             # the idle suspender parks it
        fleet = _fleet(S, model, ["base"])
        ctl = _controller(S, fleet, model, give_back_after=2)
        gives = _rv(S, "harvest_reclaims_total", trigger="idle_giveback")
        try:
            ticks = [ctl.tick()]
            ctl.pressure_depth = 1e9
            ticks += [ctl.tick(), ctl.tick()]
            return [ticks, ctl.lease_count(), _sched(S).harvested_chips(),
                    _rv(S, "harvest_reclaims_total",
                        trigger="idle_giveback") - gives,
                    S.nb_api.SUSPEND_ANNOTATION in _ann(S)]
        finally:
            ctl.close()
            fleet.close()

    out, _ = _full(parity, script)
    assert out == [["grant", "hold", "give_back"], 0, 0.0, 1.0, True]


# ---- a SIGKILLed harvested replica --------------------------------------

def test_sigkilled_harvested_replica_keeps_prefixes_and_returns_cards(
        parity, model):
    """Kill the harvested replica mid-decode (the seeded chaos plan names
    it): its in-flight requests migrate to the other decode replica and
    finish exactly, the fleet's block store keeps the published prefix,
    and the donor's resume gets its cards back with the step restored.
    The decode replica ``d0`` is held with a standing queue so depth
    routing lands the fleet's requests on the borrowed replica, which
    is held after three steps for the kill."""
    def script(S):
        chaos = S.m("chaos")
        paging = importlib.import_module(f"{_root(S)}.models.paging")
        _stack(S)
        _donor(S, "7")
        S.clock.advance(minutes=31)
        S.run()
        fleet = _fleet(S, model, ["pf", "d0"],
                       roles={"pf": "prefill", "d0": "decode"})
        ctl = _controller(S, fleet, model)
        out = {}
        try:
            out["t1"] = ctl.tick()
            out["role"] = fleet.roles["harvest-1"]
            p = [5, 9, 2, 7, 1, 1, 3]
            out["tokens"], _ = fleet.submit_and_wait("t", list(p),
                                                     max_new_tokens=6)
            chains = fleet.store.stats()["chains"]
            out["chains"] = chains
            d0 = fleet.gateways["d0"]
            g0 = StepGate(d0)
            blockers = [d0.try_submit("blk", [91 + i, 2],
                                      max_new_tokens=24)[0]
                        for i in range(6)]
            hv = fleet.gateways["harvest-1"]
            gh = StepGate(hv)
            prompts = [[i + 1, 7, 3] for i in range(2)]
            results = [None] * len(prompts)

            def go(i):
                results[i] = fleet.submit_and_wait(
                    "t", list(prompts[i]), max_new_tokens=24)

            threads = start_all([lambda i=i: go(i)
                                 for i in range(len(prompts))])
            try:
                gh.submitted(len(prompts))
                gh.allow(3)
                chaos.install(chaos.FaultPlan(0, [chaos.FaultSpec(
                    "replica_kill", rate=1.0, limit=1)]))
                victim = chaos.replica_kill_victim(["harvest-1"])
                gh.act_while_held(lambda: fleet.kill(victim))
            finally:
                gh.let_go()
                g0.let_go()
                join_all(threads)
            out["victim"] = victim
            out["blockers"] = [len(d0.wait(b, timeout_s=120))
                               for b in blockers]
            out["migrated"] = [(r[0], r[1]["replicas"]) for r in results]
            out["solos"] = [_solo(S, model, q, 24) for q in prompts]
            out["store_kept"] = fleet.store.lookup(
                paging.prefix_keys(p, 4)) is not None
            out["again"], _ = fleet.submit_and_wait("t", list(p),
                                                    max_new_tokens=6)
            out["chains_after"] = fleet.store.stats()["chains"] >= chains
            out["solo"] = _solo(S, model, p, 6)
            S.suspend.request_resume(S.api,
                                     S.api.get(S.nb_api.KIND, "donor", NS))
            S.run()
            _no_overcommit(S)
            out.update(ready=_ready(S),
                       restored=_ann(S)[S.nb_api.RESTORED_STEP_ANNOTATION],
                       harvested=_sched(S).harvested_chips(),
                       replicas=sorted(fleet.gateways),
                       kills=chaos.uninstall().counts["replica_kill"])
        finally:
            chaos.uninstall()
            ctl.close()
            fleet.close()
        return out

    out, _ = _full(parity, script)
    assert out["t1"] == "grant" and out["role"] == "decode"
    assert out["tokens"] == out["solo"] == out["again"]
    assert out["chains"] >= 1 and out["chains_after"]
    assert out["victim"] == "harvest-1"
    assert out["blockers"] == [24] * 6
    for (tokens, path), solo in zip(out["migrated"], out["solos"]):
        assert tokens == solo and path == ["harvest-1", "d0"]
    assert out["store_kept"]
    assert out["ready"] == 2 and out["restored"] == "7"
    assert out["harvested"] == 0.0 and out["replicas"] == ["d0", "pf"]
    assert out["kills"] == 1


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
