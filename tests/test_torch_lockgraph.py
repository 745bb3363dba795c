"""The port's lock factory and lock-order analysis
(``kubeflow_rm_tpu_torch/analysis/lockgraph.py``) against JAX's.

The analyser's scenarios run in both packages and give the same report
(edges, cycles, order violations, blocking calls); the port's hierarchy
table orders its lock families as JAX's does; and the serving fleet,
built with the analysis on, goes through a kill → migrate and a
promote-on-evict in both packages with no cycle, no rank inversion, no
downhill edge and no blocking call under a lock, and with the same edge
set. The analyser is reset in ``finally``. No test reads a clock: a
condition wait is shown to release its lock by taking the lock while the
waiter is parked.
"""

import importlib
import json
import os
import threading
import time

import pytest

from kubeflow_rm_tpu.analysis import hierarchy as jhier
from kubeflow_rm_tpu.analysis import lockgraph as jlg
from kubeflow_rm_tpu.controlplane import serving_fleet as jfleet
from kubeflow_rm_tpu.controlplane.webapps import serving as jserving
from kubeflow_rm_tpu_torch.analysis import lockgraph as tlg
from kubeflow_rm_tpu_torch.controlplane import serving_fleet as tfleet
from kubeflow_rm_tpu_torch.controlplane.webapps import serving as tserving

from torch_fleet_helpers import (
    JOIN_S, StepGate, both_models, join_all, solo_torch,
    start_all,
)

jgen = importlib.import_module("kubeflow_rm_tpu.models.generate")
tgen = importlib.import_module("kubeflow_rm_tpu_torch.models.generate")

LG = {"jax": jlg, "torch": tlg}
lgs = pytest.mark.parametrize("pkg", list(LG))


def _on(lg):
    lg.set_enabled(True)
    lg.reset()


def _off(lg):
    lg.reset()
    lg.set_enabled(False)


def test_off_path_returns_raw_primitives():
    assert not tlg.enabled()
    assert type(tlg.make_lock("t.off")) is type(threading.Lock())
    assert type(tlg.make_rlock("t.off")) is type(threading.RLock())
    assert isinstance(tlg.make_condition("t.off"), threading.Condition)


def test_probes_install_and_uninstall():
    orig_sleep, orig_fsync = time.sleep, os.fsync
    tlg.set_enabled(True)
    try:
        assert time.sleep is not orig_sleep and os.fsync is not orig_fsync
    finally:
        tlg.set_enabled(False)
    assert time.sleep is orig_sleep and os.fsync is orig_fsync


def _scenarios(lg):
    """The analyser's cases, in order, on one package's factory."""
    a, b = lg.make_lock("t.A"), lg.make_lock("t.B")
    with a:
        with b:
            pass
    with b:
        with a:                          # B → A: a cycle with A → B
            pass
    hi = lg.make_lock("t.node", rank="node-b")
    lo = lg.make_lock("t.node", rank="node-a")
    with hi:                             # descending rank: a violation
        with lo:
            pass
    ranked = [lg.make_lock("t.sorted", rank=f"n{i}") for i in range(3)]
    for lk in ranked:                    # ascending: clean
        lk.acquire()
    for lk in reversed(ranked):
        lk.release()
    r = lg.make_rlock("t.re")
    with r:
        with r:                          # reentry: no self edge
            pass
    hot = lg.make_lock("t.hot")
    with hot:
        time.sleep(0)                    # probed: blocking under a lock
    time.sleep(0)                        # outside: not recorded
    rep = lg.report()
    return {
        "edges": rep["edges"],
        "cycles": [(c["locks"], sorted((e["from"], e["to"])
                                       for e in c["edges"]),
                    all(e["held_stack"] and e["acquired_stack"]
                        for e in c["edges"])) for c in rep["cycles"]],
        "violations": [(v["group"], v["held_rank"], v["acquired_rank"],
                        v["count"]) for v in rep["order_violations"]],
        "blocking": [(x["op"], x["held"], x["count"])
                     for x in rep["blocking_under_lock"]],
        "acquires": {n: s["acquires"] for n, s in rep["locks"].items()},
        "ranked": {n: s["ranked_group"] for n, s in rep["locks"].items()},
        "enabled": rep["enabled"],
    }


def test_analysis_reports_equal_jax():
    got = {}
    for pkg, lg in LG.items():
        _on(lg)
        try:
            got[pkg] = _scenarios(lg)
        finally:
            _off(lg)
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t["cycles"] == [(["t.A", "t.B"],
                            [("t.A", "t.B"), ("t.B", "t.A")], True)]
    assert t["violations"] == [("t.node", "node-b", "node-a", 1)]
    assert t["blocking"] == [("time.sleep", ["t.hot"], 1)]
    assert t["acquires"]["t.re"] == 1 and t["ranked"]["t.sorted"]


@lgs
def test_condition_wait_releases_its_lock(pkg):
    lg = LG[pkg]
    _on(lg)
    try:
        cv = lg.make_condition("t.cv")
        parked, woke = threading.Event(), threading.Event()
        flag = []

        def waiter():
            with cv:
                parked.set()
                assert cv.wait_for(lambda: flag, JOIN_S)
            woke.set()

        t = threading.Thread(target=waiter)
        t.start()
        assert parked.wait(JOIN_S)
        with cv:                         # taken while the waiter waits
            flag.append(1)
            cv.notify_all()
        assert woke.wait(JOIN_S)
        t.join(JOIN_S)
        rep = lg.report()
        assert rep["edges"] == [] and rep["cycles"] == []
        # two hold segments of the waiter (before and after its wait)
        # and one of the notifier
        assert rep["locks"]["t.cv"]["held_ms"]["samples"] == 3
    finally:
        _off(lg)


def test_dump_roundtrip(tmp_path):
    _on(tlg)
    try:
        a, b = tlg.make_lock("t.A"), tlg.make_lock("t.B")
        with a:
            with b:
                pass
        out = tmp_path / "lockgraph.json"
        rep = tlg.dump(str(out))
        payload = json.loads(out.read_text())
        assert payload == json.loads(json.dumps(rep, sort_keys=True))
        assert payload["enabled"] is True
        assert {"locks", "edges", "cycles", "order_violations",
                "blocking_under_lock"} <= set(payload)
    finally:
        _off(tlg)


def test_hierarchy_orders_the_serving_locks_as_jax():
    for name in ("serving.fleet", "serving.gateway", "serving.store",
                 "kubeclient.token_bucket", "tracing.collector"):
        assert tlg.LOCK_HIERARCHY[name] == jhier.LOCK_HIERARCHY[name]
    edges = [{"from": "serving.gateway", "to": "serving.store"},
             {"from": "serving.fleet", "to": "serving.gateway"}]
    assert tlg.check_edges(edges) == jhier.check_edges(edges) == []
    down = [{"from": "serving.store", "to": "serving.gateway"}]
    assert tlg.check_edges(down) == jhier.check_edges(down)
    assert "downhill" in tlg.check_edges(down)[0]
    assert tlg.check_edges([{"from": "x.y", "to": "serving.store"}]) == \
        ["unregistered lock in hierarchy: x.y"]


# -- the serving fleet under the analyser ---------------------------------

PROMPT = [7, 3, 9, 1, 4, 4, 2, 8, 5, 6, 1, 2, 9, 9, 3, 1, 0, 2, 4, 6,
          11, 12, 13]
POLICY = dict(qps=1e9, burst=10**6, tokens_per_s=1e9, token_burst=10**7,
              slo_p95_ms=1e9)


@pytest.fixture(scope="module")
def model():
    return both_models()


def _fleet_under_analysis(model, pkg):
    """A disaggregated fleet (one prefill, two decode replicas, the first
    decode pool small enough to churn) built with the analysis on: the
    prefill tier dies, a request's prefix lives in dc0's pool, twelve
    unrelated requests evict it into the store (promote-on-evict inside
    an engine step, under dc0's gateway lock), then dc0 is killed with a
    request in flight (held by a step gate), which migrates."""
    jcfg, jparams, tcfg, tparams = model
    gen, params, cfg = ((jgen, jparams, jcfg) if pkg == "jax"
                        else (tgen, tparams, tcfg))
    serving, fleet_mod = ((jserving, jfleet) if pkg == "jax"
                          else (tserving, tfleet))
    lg = LG[pkg]
    _on(lg)
    fleet = None
    try:
        gws = {n: serving.ServingGateway(
            gen.ContinuousBatchingEngine(
                params, cfg, slots=2, slot_len=64, block_size=8,
                num_blocks=34 if n == "dc0" else None),
            default_policy=serving.TenantPolicy(**POLICY))
            for n in ("pf0", "dc0", "dc1")}
        fleet = fleet_mod.ServingFleet(gws, roles={
            "pf0": "prefill", "dc0": "decode", "dc1": "decode"})
        fleet.kill("pf0")
        first = fleet.submit_and_wait("t", PROMPT, max_new_tokens=8)
        for i in range(12):
            fleet.submit_and_wait("t", [30 + i, 31 + i, 32 + i] * 8,
                                  max_new_tokens=4)
        gate = StepGate(gws["dc0"])
        results = []
        threads = start_all([lambda: results.append(fleet.submit_and_wait(
            "t", PROMPT, max_new_tokens=8))])
        try:
            gate.submitted(1)    # both decode queues empty: dc0 first
            gate.allow(2)
            gate.act_while_held(lambda: fleet.kill("dc0"))
        finally:
            gate.let_go()
            join_all(threads)
        rep = lg.report()
        # the step gate's own condition (the smoke's test hook, taken
        # inside a step under the gateway's lock) is not the fleet's
        rep["edges"] = [e for e in rep["edges"]
                        if "chip_smoke.step_gate" not in (e["from"],
                                                          e["to"])]
        return (first, results, fleet.migrations, fleet.store.stats(),
                rep)
    finally:
        if fleet is not None:
            fleet.close()
        _off(lg)


def test_fleet_kill_and_promotion_keep_the_lock_order(model):
    got = {pkg: _fleet_under_analysis(model, pkg) for pkg in LG}
    tfirst, tres, tmig, tstore, trep = got["torch"]
    jfirst, jres, jmig, jstore, jrep = got["jax"]
    assert (tfirst, tres, tmig, tstore) == (jfirst, jres, jmig, jstore)
    want = solo_torch(model[3], model[2], PROMPT, 8, 64)
    assert tfirst[0] == want and all(r[0] == want for r in tres)
    assert tmig == 1 and tstore["promoted"] > 0
    for rep in (trep, jrep):
        assert rep["cycles"] == [] and rep["order_violations"] == []
    assert trep["blocking_under_lock"] == []
    assert tlg.check_edges(trep["edges"]) == []
    edges = {(e["from"], e["to"]) for e in trep["edges"]}
    assert ("serving.gateway", "serving.store") in edges
    # the port's metric series are its own (factory-made) locks, taken
    # under the serving locks (uphill, as check_edges says); JAX's are
    # prometheus_client's, outside the analysis
    assert {e for e in edges if not e[1].startswith("metrics.")} == \
        {(e["from"], e["to"]) for e in jrep["edges"]}
    assert {"serving.fleet", "serving.gateway", "serving.store"} <= \
        set(trep["locks"])
