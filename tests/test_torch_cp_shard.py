"""The port's shard ring (``controlplane/shard/ring.py``) and its router
(``deploy/kubeclient.ShardedKubeAPIServer``), held to JAX's: every case
of ``tests/test_shard.py``. The ring cases run each package's ring on
the same keys, and the port's routing, moves, pins and weights must be
JAX's exactly (the points are byte-equal). The router cases build two
shards per package (``APIServer(shard=)`` behind its REST facade) and
run the same script through each package's router: partitioning by
namespace, cluster-scoped routing by name, broadcast kinds, the merged
cluster-wide list, watch aggregation over both shards, and the retry
with remap through a shard's restart. A restart is brought on by the
router's first failed attempt (an event), not by a fixed sleep.
"""

import threading
import time

import pytest

from tests.torch_cp_parity import RestCluster, cp_module

PKGS = ("port", "jax")
pkgs = pytest.mark.parametrize("pkg", PKGS)
KEYS = [f"ns-{i}" for i in range(2000)]


def _ring(pkg):
    return cp_module(pkg, "shard.ring").HashRing


def _both(case):
    """``case(HashRing)`` on each package's ring; equal results."""
    port, jax = case(_ring("port")), case(_ring("jax"))
    assert port == jax
    return port


# ---- the ring -------------------------------------------------------------

def test_ring_is_deterministic_across_instances_and_packages():
    def case(HashRing):
        a = HashRing(["s0", "s1", "s2"])
        b = HashRing(["s2", "s0", "s1"])  # member order must not matter
        assert [a.shard_for(k) for k in KEYS[:200]] == \
            [b.shard_for(k) for k in KEYS[:200]]
        return [a.shard_for(k) for k in KEYS], a._points
    _both(case)


def test_ring_balance_within_tolerance():
    def case(HashRing):
        spread = HashRing([f"s{i}" for i in range(4)]).spread(KEYS)
        sizes = sorted(len(v) for v in spread.values())
        assert sizes[0] > 0 and sizes[-1] < 2 * (len(KEYS) / 4)
        return spread
    _both(case)


def test_ring_remap_is_minimal_on_resize():
    def case(HashRing):
        before = HashRing(["s0", "s1", "s2"])
        after = HashRing(["s0", "s1", "s2", "s3"])
        moved = before.moved_keys(after, KEYS[:1000])
        assert len(moved) < 500
        return moved
    _both(case)


def test_ring_with_member_moves_only_new_owners_keys():
    def case(HashRing):
        before = HashRing(["s0", "s1", "s2"])
        after = before.with_member("s3")
        fresh = HashRing(["s0", "s1", "s2", "s3"])
        keys = KEYS[:1000]
        moved = before.moved_keys(after, keys)
        assert moved and len(moved) < 500
        for key in keys:
            assert after.shard_for(key) == fresh.shard_for(key)
            if key in moved:
                old, new = moved[key]
                assert new == "s3" and old != "s3"
        return moved
    _both(case)


def test_ring_without_member_moves_only_departing_keys():
    def case(HashRing):
        before = HashRing(["s0", "s1", "s2", "s3"])
        after = before.without_member("s3")
        keys = KEYS[:1000]
        moved = before.moved_keys(after, keys)
        for key in keys:
            assert (key in moved) == (before.shard_for(key) == "s3")
        grown = after.with_member("s3")
        assert [grown.shard_for(k) for k in keys] == \
            [before.shard_for(k) for k in keys]
        return moved
    _both(case)


def test_ring_membership_derivation_validates():
    def case(HashRing):
        ring = HashRing(["s0", "s1"])
        for bad in (lambda: ring.with_member("s0"),
                    lambda: ring.without_member("nope"),
                    lambda: HashRing(["s0"]).without_member("s0"),
                    lambda: HashRing([])):
            with pytest.raises(ValueError):
                bad()
        ring.with_member("s2")
        ring.without_member("s1")
        return ring.members
    assert _both(case) == ["s0", "s1"]


def test_ring_pins_override_hash_and_die_with_their_target():
    def case(HashRing):
        ring = HashRing(["s0", "s1", "s2"])
        key = next(k for k in KEYS if ring.shard_for(k) == "s0")
        pinned = ring.with_pin(key, "s2")
        assert (pinned.shard_for(key), pinned.hash_owner(key)) == \
            ("s2", "s0")
        assert ring.moved_keys(pinned, KEYS[:100]) == {key: ("s0", "s2")}
        after = pinned.without_member("s2")
        assert key not in after.pins
        assert after.shard_for(key) == after.hash_owner(key)
        with pytest.raises(ValueError):
            pinned.without_member("s2", drop_pins=False)
        with pytest.raises(ValueError):
            ring.with_pin(key, "not-a-member")
        assert pinned.without_pin(key).pins == {}
        return key, after.shard_for(key)
    _both(case)


def test_ring_weights_shift_ownership_proportionally():
    def case(HashRing):
        flat = HashRing(["s0", "s1", "s2"], vnodes=64)
        heavy = flat.with_weight("s0", 192)
        assert (heavy.weight_of("s0"), heavy.weight_of("s1")) == (192, 64)
        counts = {m: len(ks) for m, ks in heavy.spread(KEYS).items()}
        assert counts["s0"] / len(KEYS) == pytest.approx(192 / 320,
                                                         abs=0.08)
        assert counts["s1"] / len(KEYS) == pytest.approx(64 / 320,
                                                         abs=0.08)
        fresh = HashRing(["s0", "s1", "s2"], vnodes=64,
                         weights={"s0": 192})
        assert [heavy.shard_for(k) for k in KEYS[:500]] == \
            [fresh.shard_for(k) for k in KEYS[:500]]
        return counts
    _both(case)


def test_ring_with_weight_moves_only_the_reweighted_members_keys():
    def case(HashRing):
        base = HashRing(["s0", "s1", "s2"], vnodes=64)
        up = base.with_weight("s0", 128)
        moved = base.moved_keys(up, KEYS)
        assert moved and len(moved) < 0.4 * len(KEYS)
        assert all(new == "s0" != old for old, new in moved.values())
        down = up.with_weight("s0", 64)
        assert [down.shard_for(k) for k in KEYS] == \
            [base.shard_for(k) for k in KEYS]
        back = up.moved_keys(down, KEYS)
        assert all(old == "s0" != new for old, new in back.values())
        return moved, back
    _both(case)


def test_ring_weights_survive_derivations_and_validate():
    def case(HashRing):
        ring = HashRing(["s0", "s1"], vnodes=32).with_weight("s0", 96)
        grown = ring.with_member("s2")
        shrunk = grown.without_member("s0")
        pinned = ring.with_pin("ns-w", "s1")
        for bad in (lambda: ring.with_weight("nope", 8),
                    lambda: ring.with_weight("s0", 0),
                    lambda: HashRing(["s0"], weights={"s0": -1})):
            with pytest.raises(ValueError):
                bad()
        return (grown.weight_of("s0"), grown.weight_of("s2"),
                shrunk.weights, pinned.weight_of("s0"),
                pinned.without_pin("ns-w").weight_of("s0"),
                HashRing(["s0", "s1"], vnodes=32).weights,
                ring.weight_of("s0"))
    assert _both(case) == (96, 32, {}, 96, 96, {}, 96)


# ---- the router over two shards -------------------------------------------

class _Stack:
    """Two shards of one package, each an ``APIServer(shard=)`` behind
    its REST facade, and that package's router over them."""

    def __init__(self, pkg, **router_kw):
        self.pkg = pkg
        self.kc = cp_module(pkg, "deploy.kubeclient")
        self.shards = {name: RestCluster(pkg, shard=name)
                       for name in ("shard-0", "shard-1")}
        self.urls = {n: c.url for n, c in self.shards.items()}
        self.router = self.kc.ShardedKubeAPIServer(self.urls, **router_kw)

    def api(self, shard):
        return self.shards[shard].api

    def ns_per_shard(self, prefix):
        """One namespace owned by each shard: {shard: namespace}."""
        out, i = {}, 0
        while len(out) < 2:
            ns = f"{prefix}-{i}"
            i += 1
            out.setdefault(self.router.shard_of("Pod", None, ns), ns)
        return out

    def close(self):
        for c in self.shards.values():
            c.close()


@pytest.fixture
def stack(request):
    s = _Stack(request.node.callspec.params["pkg"])
    yield s
    s.close()


def _pod(name, ns):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"containers": [{"name": "c", "image": "img"}]}}


def test_router_shards_label_their_series_and_ring_gauge():
    """``APIServer(shard=)`` names its shard; each package's router sets
    its ring-size gauge under the process's shard label."""
    s = {pkg: _Stack(pkg) for pkg in PKGS}
    try:
        for pkg, st in s.items():
            assert st.api("shard-1").shard == "shard-1"
            assert st.router.ring.members == ["shard-0", "shard-1"]
        port_metrics = cp_module("port", "metrics")
        assert port_metrics.SHARD_RING_MEMBERS.get(
            shard=port_metrics.shard_label()) == 2
        assert cp_module("jax", "metrics").registry_value(
            "shard_ring_members") >= 2
        assert s["port"].router.shard_of("Pod", None, "x") == \
            s["jax"].router.shard_of("Pod", None, "x")
    finally:
        for st in s.values():
            st.close()


@pkgs
def test_router_partitions_by_namespace(pkg, stack):
    router = stack.router
    for shard, ns in stack.ns_per_shard("ns").items():
        router.ensure_namespace(ns)
        router.create(_pod("p0", ns))
        # the object lives ONLY on its ring owner
        for name in stack.shards:
            assert (stack.api(name).try_get("Pod", "p0", ns) is not None) \
                == (name == shard)
        assert router.get("Pod", "p0", ns)["metadata"]["namespace"] == ns


@pkgs
def test_router_cluster_scoped_routes_by_name(pkg, stack):
    router = stack.router
    router.create({"apiVersion": "v1", "kind": "Node",
                   "metadata": {"name": "node-a", "labels": {}},
                   "status": {"allocatable": {}, "capacity": {}}})
    owner = router.shard_of("Node", "node-a", None)
    for name in stack.shards:
        assert (stack.api(name).try_get("Node", "node-a") is not None) == \
            (name == owner)
    assert router.get("Node", "node-a")["metadata"]["name"] == "node-a"


@pkgs
def test_router_broadcast_kinds_replicate_everywhere(pkg, stack):
    router = stack.router
    assert stack.kc.BROADCAST_KINDS == frozenset(
        {"ClusterRole", "ClusterRoleBinding", "CustomResourceDefinition"})
    router.create({"apiVersion": "rbac.authorization.k8s.io/v1",
                   "kind": "ClusterRole", "metadata": {"name": "admin-all"},
                   "rules": []})
    for name in stack.shards:
        assert stack.api(name).try_get("ClusterRole", "admin-all")
    assert len(router.list("ClusterRole")) == 1  # replicas dedup to one
    router.delete("ClusterRole", "admin-all")
    for name in stack.shards:
        assert stack.api(name).try_get("ClusterRole", "admin-all") is None


@pkgs
def test_router_cluster_wide_list_merges_shards(pkg, stack):
    router = stack.router
    names, seen, i = [], set(), 0
    while len(seen) < 2 or len(names) < 4:
        ns = f"m-{i}"
        i += 1
        seen.add(router.shard_of("Pod", None, ns))
        router.ensure_namespace(ns)
        router.create(_pod("p", ns))
        names.append(ns)
    assert [p["metadata"]["namespace"] for p in router.list("Pod")] == \
        sorted(names)


@pkgs
def test_router_watch_aggregates_both_shards(pkg, stack):
    router = stack.router
    want = {("ADDED", ns) for ns in stack.ns_per_shard("w").values()}
    events, got = [], threading.Event()

    def watcher(et, obj, old=None):
        events.append((et, obj["metadata"]["namespace"]))
        if want <= set(events):
            got.set()

    router.add_watcher(watcher, name="t")
    # a write on each shard first: a shard that has written nothing
    # lists at rv 0, which JAX's facade does not resume from (C12)
    for _, ns in want:
        router.ensure_namespace(ns)
    stop = threading.Event()
    t = threading.Thread(target=router.watch_kind,
                         args=("Pod", None, stop, 30), daemon=True)
    t.start()
    try:
        assert router.wait_for_sync(["Pod"], timeout=10)
        for _, ns in want:
            router.create(_pod("p0", ns))
        assert got.wait(10), events
        # the merged informer store now serves the synced kind
        for _, ns in want:
            assert router.get("Pod", "p0", ns)["metadata"]["namespace"] == ns
    finally:
        stop.set()
        # the stopped facades sever their streams, so every per-shard
        # loop sees ``stop`` at once rather than at the stream's timeout
        stack.close()
    t.join(30)
    assert not t.is_alive()


def _restart_on_first_failure(stack, monkeypatch, victim, before=None):
    """Stop ``victim``'s facade now; restart it (same store, same port)
    on a thread once the router has seen its first transient failure.
    ``before()`` runs while the shard is down. Returns the thread."""
    failed = threading.Event()
    is_transient = stack.kc._is_transient

    def spy(e):
        failed.set()
        return is_transient(e)

    monkeypatch.setattr(stack.kc, "_is_transient", spy)
    shard = stack.shards[victim]
    shard.rest.stop()
    if before is not None:
        before()

    def revive():
        assert failed.wait(30)
        shard.rest = cp_module(stack.pkg, "deploy.restserver").RestServer(
            shard.api, port=shard.port)
        shard.rest.start()

    t = threading.Thread(target=revive, daemon=True)
    t.start()
    return t


@pkgs
def test_router_retries_through_shard_restart(pkg, stack, monkeypatch):
    """Retry with remap: a write to a restarting shard (refused
    connections) retries until the shard is back at its ring position."""
    stack.router.retry_window_s = 30.0
    ns = "restart-ns"
    victim = stack.router.shard_of("Pod", None, ns)
    stack.router.ensure_namespace(ns)
    t = _restart_on_first_failure(stack, monkeypatch, victim)
    out = stack.router.create(_pod("p0", ns))  # blocks and retries
    t.join(30)
    assert out["metadata"]["name"] == "p0"
    assert stack.api(victim).try_get("Pod", "p0", ns) is not None


@pkgs
def test_router_retried_create_absorbs_lost_reply_conflict(pkg, stack,
                                                            monkeypatch):
    """The shard commits a create and dies before replying: the router's
    retry meets AlreadyExists and resolves to the committed object. A
    first-attempt conflict (no transport retry) stays an error."""
    stack.router.retry_window_s = 30.0
    ns = "lost-reply-ns"
    victim = stack.router.shard_of("Pod", None, ns)
    stack.router.ensure_namespace(ns)
    committed = stack.api(victim).create(_pod("p0", ns))
    t = _restart_on_first_failure(stack, monkeypatch, victim)
    out = stack.router.create(_pod("p0", ns))
    t.join(30)
    assert out["metadata"]["uid"] == committed["metadata"]["uid"]
    with pytest.raises(cp_module(pkg, "apiserver").AlreadyExists):
        stack.router.create(_pod("p0", ns))


@pkgs
def test_router_errors_are_not_retried_as_transient(pkg, stack):
    t0 = time.monotonic()
    with pytest.raises(cp_module(pkg, "apiserver").NotFound):
        stack.router.get("Pod", "nope", "empty-ns")
    assert time.monotonic() - t0 < 2.0  # no retry-window stall
