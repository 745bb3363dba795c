"""Port parity for the serving fleet (``controlplane/serving_fleet``): the
eleven scenarios of JAX's ``tests/test_serving_fleet.py``, each run in
both packages on the same numpy-seeded tiny Llama (float32, weights
carried over with ``from_numpy_params``).

Tolerance: none. Replica owners, tokens (also against the port's solo
``generate_fused``), migrations, replica paths, fleet states, and the
``/healthz``, ``/api/fleet`` and ``/generate`` status codes and JSON
bodies are compared for equality.

No scenario depends on wall time. A replica is drained, killed or
removed while its requests are mid-flight by holding its engine with a
``StepGate`` (``tests/torch_fleet_helpers.py``): the replica takes an
exact number of steps after every request was admitted, then its engine
parks until the test has acted. Every thread is joined with a bound,
and every fleet is closed in ``finally``.
"""

import importlib

import pytest

from kubeflow_rm_tpu.controlplane import serving_fleet as jfleet
from kubeflow_rm_tpu.controlplane.webapps import serving as jserving
from kubeflow_rm_tpu_torch.controlplane import serving_fleet as tfleet
from kubeflow_rm_tpu_torch.controlplane.shard import ring as tring
from kubeflow_rm_tpu_torch.controlplane.webapps import serving as tserving

from torch_fleet_helpers import (
    JOIN_S, StepGate, both_models, join_all, solo_jax,
    solo_torch, start_all, wsgi_json,
)

jgen = importlib.import_module("kubeflow_rm_tpu.models.generate")
tgen = importlib.import_module("kubeflow_rm_tpu_torch.models.generate")
jring = importlib.import_module("kubeflow_rm_tpu.controlplane.shard.ring")

PKGS = ("jax", "torch")
SERVING = {"jax": jserving, "torch": tserving}
FLEET = {"jax": jfleet, "torch": tfleet}


@pytest.fixture(scope="module")
def model():
    return both_models()


def _gateway(model, pkg, **kw):
    jcfg, jparams, tcfg, tparams = model
    gen, params, cfg = ((jgen, jparams, jcfg) if pkg == "jax"
                        else (tgen, tparams, tcfg))
    eng = gen.ContinuousBatchingEngine(params, cfg, slots=2, slot_len=32,
                                       block_size=4)
    kw.setdefault("admission", False)
    return SERVING[pkg].ServingGateway(eng, **kw)


def _fleet(model, pkg, n=3, **kw):
    return FLEET[pkg].ServingFleet(
        {f"r{i}": _gateway(model, pkg) for i in range(n)}, **kw)


def _cfg(model, pkg):
    return model[0] if pkg == "jax" else model[2]


def _solo(model, pkg, prompt, budget):
    jcfg, jparams, tcfg, tparams = model
    if pkg == "jax":
        return solo_jax(jparams, jcfg, prompt, budget, 32)
    return solo_torch(tparams, tcfg, prompt, budget, 32)


def _both(model, scenario, **kw):
    """``scenario(fleet, pkg)`` on each package's fleet (closed after)."""
    out = {}
    for pkg in PKGS:
        fleet = _fleet(model, pkg, **kw)
        try:
            out[pkg] = scenario(fleet, pkg)
        finally:
            fleet.close()
    return out


def test_ring_owners_equal_jax():
    members = ["r0", "r1", "r2"]
    keys = [f"p:{i:032x}" for i in range(200)] + ["s:sess-a", "", None]
    for vnodes in (1, 16, 64):
        j = jring.HashRing(members, vnodes=vnodes)
        t = tring.HashRing(members, vnodes=vnodes)
        assert [t.shard_for(k) for k in keys] == \
            [j.shard_for(k) for k in keys]
        assert [t.hash_owner(k) for k in keys] == \
            [j.hash_owner(k) for k in keys]
        for jn, tn in ((j.with_member("r9"), t.with_member("r9")),
                       (j.without_member("r1"), t.without_member("r1"))):
            assert tn.members == jn.members
            assert [tn.shard_for(k) for k in keys] == \
                [jn.shard_for(k) for k in keys]
    with pytest.raises(ValueError):
        tring.HashRing([])
    with pytest.raises(ValueError):
        tring.HashRing(["a"]).with_member("a")
    with pytest.raises(ValueError):
        tring.HashRing(["a"]).without_member("a")


def test_affinity_and_session_stickiness(model):
    def run(fleet, pkg):
        p = [5, 9, 2, 7, 1]
        ka = fleet.affinity_key(p, "sess-a")
        assert ka == fleet.affinity_key([1], "sess-a")
        assert ka != fleet.affinity_key(p)
        return ([fleet.route(p), fleet.route(p + [8, 8, 8]),
                 fleet.route([1], "sess-a"), fleet.route(p, "sess-a")],
                [fleet.route([i * 3 + 1, i * 5 + 2, 7]) for i in range(16)],
                ka, fleet.affinity_key(p))

    got = _both(model, run)
    assert got["torch"] == got["jax"]
    same, spread, _, _ = got["torch"]
    assert same[0] == same[1] and same[2] == same[3]
    assert len(set(spread)) > 1


def test_fleet_request_is_exact_and_prefix_cached(model):
    def run(fleet, pkg):
        p = [5, 9, 2, 7, 1, 1, 3]
        got = [fleet.submit_and_wait("t", list(p), max_new_tokens=6)
               for _ in range(3)]    # repeats land on one replica's cache
        owner = fleet.route(p)
        st = fleet.gateways[owner].engine.stats()
        return got, owner, st["prefix_hit_tokens"], st["prompt_tokens"]

    got = _both(model, run)
    assert got["torch"] == got["jax"]
    results, owner, hits, _ = got["torch"]
    want = _solo(model, "torch", [5, 9, 2, 7, 1, 1, 3], 6)
    assert all(r == (want, {"replicas": [owner], "migrations": 0})
               for r in results)
    assert hits > 0


def test_drain_sheds_new_work_and_healthz_flips(model):
    out = {}
    for pkg in PKGS:
        gw = _gateway(model, pkg)
        app = SERVING[pkg].make_serving_app(gw, _cfg(model, pkg))
        try:
            before = wsgi_json(app, "GET", "/healthz")
            gw.start_drain()
            out[pkg] = (before, wsgi_json(app, "GET", "/healthz"),
                        gw.try_submit("t", [1, 2, 3], max_new_tokens=2),
                        wsgi_json(app, "POST", "/generate",
                                  {"prompt": [1, 2, 3]}))
        finally:
            gw.close()
    assert out["torch"] == out["jax"]
    assert out["torch"] == (
        (200, {"ok": True, "state": "ready"}),
        (503, {"ok": False, "state": "draining"}), (None, "draining"),
        (503, {"error": "shed", "reason": "draining"}))


def test_drain_evicts_queued_and_fleet_migrates(model):
    """Queued (not yet slotted) requests on a draining replica raise
    ReplicaUnavailable from wait(); through the fleet they resume
    elsewhere with exact tokens; slotted ones finish where they are."""

    def run(fleet, pkg):
        victim = fleet.route([5, 9, 2])
        gw = fleet.gateways[victim]
        gate = StepGate(gw)
        holders = [gw.try_submit("t", [7, 3, 1 + i], max_new_tokens=20)[0]
                   for i in range(2)]
        gate.allow(1)          # one step: both holders take the slots
        assert gw.engine.active_slots == 2
        queued, _ = gw.try_submit("t", [5, 9, 2], max_new_tokens=4)
        assert queued is not None and gw.engine.queue_depth == 1
        fleet.drain(victim)
        with pytest.raises(SERVING[pkg].ReplicaUnavailable) as e:
            gw.wait(queued, timeout_s=JOIN_S)
        gate.let_go()
        held = [gw.wait(h, timeout_s=JOIN_S) for h in holders]
        tokens, info = fleet.submit_and_wait("t", [5, 9, 2],
                                             max_new_tokens=4)
        return (victim, e.value.tokens_so_far, held, tokens, info,
                fleet.states())

    got = _both(model, run, n=2)
    assert got["torch"] == got["jax"]
    victim, so_far, held, tokens, info, states = got["torch"]
    assert so_far == [] and [len(h) for h in held] == [20, 20]
    assert held == [_solo(model, "torch", [7, 3, 1 + i], 20)
                    for i in range(2)]
    assert tokens == _solo(model, "torch", [5, 9, 2], 4)
    assert states[victim] == "draining"
    assert info["replicas"] and info["replicas"][0] != victim


def _in_flight(fleet, prompt, budget, n, steps, action):
    """``n`` concurrent requests of ``prompt`` through the fleet; their
    owner is held until all ``n`` were admitted, then takes ``steps``
    steps, then ``action(victim)`` runs while it is held. Returns the
    victim and every request's (tokens, info)."""
    victim = fleet.route(prompt)
    gate = StepGate(fleet.gateways[victim])
    results = [None] * n

    def go(i):
        results[i] = fleet.submit_and_wait("t", list(prompt),
                                           max_new_tokens=budget)

    threads = start_all([lambda i=i: go(i) for i in range(n)])
    try:
        gate.submitted(n)
        gate.allow(steps)
        gate.act_while_held(lambda: action(victim))
    finally:
        gate.let_go()
        join_all(threads)
    return victim, results


def test_kill_migrates_in_flight_to_exact_completion(model):
    """Kill the replica holding live requests (two slotted, three queued,
    after 3 steps): every one migrates once and produces the tokens an
    uninterrupted run gives."""
    p = [5, 9, 2, 7, 1, 1, 3]

    def run(fleet, pkg):
        victim, results = _in_flight(fleet, p, 24, 5, 3, fleet.kill)
        return victim, results, fleet.migrations, fleet.states()

    got = _both(model, run)
    assert got["torch"] == got["jax"]
    victim, results, migrations, states = got["torch"]
    want = _solo(model, "torch", p, 24)
    for tokens, info in results:
        assert tokens == want and info["migrations"] == 1
        assert info["replicas"][0] == victim
    assert migrations == 5 and states[victim] == "dead"


def test_kill_resume_overflow_restarts_from_original_prompt(model):
    """A resume prompt (the original plus the tokens so far) rounds the
    prefill bucket past slot_len where the original fit: bucket(16) + 16
    == slot_len, so a resume after 3 tokens needs bucket 32 and cannot
    fit. The fleet restarts from the original prompt (greedy decode
    gives the same tokens) instead of failing the request."""
    p = [1 + (i % 9) for i in range(16)]

    def run(fleet, pkg):
        victim, results = _in_flight(fleet, p, 16, 1, 3, fleet.kill)
        return victim, results, fleet.migrations

    got = _both(model, run, n=2)
    assert got["torch"] == got["jax"]
    _, [(tokens, info)], migrations = got["torch"]
    assert tokens == _solo(model, "torch", p, 16)
    assert info["migrations"] == 1 and migrations == 1


def test_submit_reroutes_when_routed_replica_is_removed(model):
    """A request that routed to a replica an instant before
    ``remove_replica`` rebuilt the topology re-resolves the ring after
    the rebuild: it never submits to, or fails on, the removed one."""
    p = [5, 9, 2, 7, 1]

    def run(fleet, pkg):
        victim = fleet.route(p)
        orig_route, removed = fleet.route, {}

        def racing_route(*a, **kw):
            name = orig_route(*a, **kw)
            if not removed and name == victim:
                fleet.remove_replica(victim)
                removed["done"] = True
            return name

        fleet.route = racing_route
        tokens, info = fleet.submit_and_wait("t", list(p), max_new_tokens=6)
        return (victim, bool(removed), tokens, info,
                sorted(fleet.gateways))

    got = _both(model, run, n=2)
    assert got["torch"] == got["jax"]
    victim, removed, tokens, info, names = got["torch"]
    assert removed and tokens == _solo(model, "torch", p, 6)
    assert victim not in info["replicas"] and victim not in names


def test_remove_replica_mid_flight_migrates_exactly(model):
    """Live shrink while the victim holds in-flight work: queued and
    active requests all migrate and complete exactly; the victim is gone
    afterwards."""
    p = [5, 9, 2, 7, 1, 1, 3]

    def run(fleet, pkg):
        victim, results = _in_flight(fleet, p, 24, 4, 2,
                                     fleet.remove_replica)
        return victim, results, fleet.states(), fleet.migrations

    got = _both(model, run, n=2)
    assert got["torch"] == got["jax"]
    victim, results, states, migrations = got["torch"]
    want = _solo(model, "torch", p, 24)
    assert all(tokens == want for tokens, _ in results)
    assert victim not in states and len(states) == 1 and migrations == 4


def test_add_replica_joins_ring_and_serves(model):
    def run(fleet, pkg):
        with pytest.raises(ValueError):
            fleet.remove_replica("r0")   # never below one replica
        fleet.add_replica("r9", _gateway(model, pkg))
        with pytest.raises(ValueError):
            fleet.add_replica("r9", None)   # a name already in the fleet
        with pytest.raises(ValueError):
            fleet.add_replica("r8", None, role="decode")  # not disagg
        states = fleet.states()
        fleet.drain("r0")
        return states, fleet.submit_and_wait("t", [5, 9, 2],
                                             max_new_tokens=4)

    got = _both(model, run, n=1)
    assert got["torch"] == got["jax"]
    states, (tokens, info) = got["torch"]
    assert states == {"r0": "ready", "r9": "ready"}
    assert tokens == _solo(model, "torch", [5, 9, 2], 4)
    assert info["replicas"] == ["r9"]


def test_no_ready_replica_sheds(model):
    def run(fleet, pkg):
        fleet.drain("r0")
        with pytest.raises(FLEET[pkg].NoReadyReplica):
            fleet.route([1, 2, 3])
        return fleet.submit_and_wait("t", [1, 2, 3], max_new_tokens=2)

    got = _both(model, run, n=1)
    assert got["torch"] == got["jax"] == (
        None, {"replicas": [], "reason": "no_replica"})


def test_fleet_app_surface(model):
    p = [5, 9, 2]

    def run(fleet, pkg):
        app = FLEET[pkg].make_fleet_app(fleet, _cfg(model, pkg))
        out = [wsgi_json(app, "GET", "/healthz"),
               wsgi_json(app, "POST", "/generate",
                         {"prompt": p, "max_new_tokens": 4,
                          "session": "s1", "slo_class": "batch"}),
               wsgi_json(app, "POST", "/generate", {"prompt": "nope"})[0],
               wsgi_json(app, "POST", "/generate",
                         {"prompt": p, "slo_class": "gold"})[0],
               wsgi_json(app, "POST", "/generate",
                         {"prompt": p, "session": 7})[0],
               wsgi_json(app, "POST", "/replicas/r0/drain"),
               wsgi_json(app, "POST", "/replicas/zz/drain")[0],
               wsgi_json(app, "GET", "/api/store"),
               wsgi_json(app, "GET", "/api/store/chain/00")[0]]
        snap = wsgi_json(app, "GET", "/api/fleet")
        out.append((snap[0], {n: r["state"]
                              for n, r in snap[1]["replicas"].items()},
                    snap[1]["migrations"], snap[1]["roles"],
                    snap[1]["store"], snap[1]["prefix_tokens"]))
        out.append(wsgi_json(app, "GET", "/healthz"))
        out.append(wsgi_json(app, "POST", "/generate",
                             {"prompt": p, "max_new_tokens": 4}))
        fleet.drain("r1")
        out.append(wsgi_json(app, "GET", "/healthz"))
        out.append(wsgi_json(app, "POST", "/generate", {"prompt": p}))
        return out

    got = _both(model, run, n=2)
    assert got["torch"] == got["jax"]
    t = got["torch"]
    want = _solo(model, "torch", p, 4)
    assert t[0] == (200, {"ok": True, "ready": 2,
                          "replicas": {"r0": "ready", "r1": "ready"}})
    assert t[1][0] == 200 and t[1][1]["tokens"] == want
    assert t[2:5] == [400, 400, 400]
    assert t[5] == (200, {"draining": "r0"}) and t[6] == 404
    assert t[7] == (200, {"enabled": False}) and t[8] == 404
    assert t[9][1] == {"r0": "draining", "r1": "ready"}
    assert t[10][1]["ready"] == 1
    assert t[11] == (200, {"tokens": want, "replicas": ["r1"],
                           "migrations": 0})
    assert t[12][0] == 503
    assert t[13] == (503, {"error": "shed", "reason": "no_replica"})


def test_spill_to_the_shallowest_replica(model):
    """A deep owner queue spills new work to a strictly shallower ready
    replica, and only then."""

    def run(fleet, pkg):
        p = [5, 9, 2, 7]
        owner = fleet.route(p)
        gate = StepGate(fleet.gateways[owner])
        for i in range(3):
            fleet.gateways[owner].try_submit("t", [7, 3, i + 1],
                                             max_new_tokens=2)
        gate.submitted(3)
        spilled = fleet.route(p)
        fleet.spill_depth = 4
        kept = fleet.route(p)
        gate.let_go()
        return owner, spilled, kept, fleet.spills

    got = _both(model, run, spill_depth=2)
    assert got["torch"] == got["jax"]
    owner, spilled, kept, spills = got["torch"]
    assert spilled != owner and kept == owner and spills == 1
