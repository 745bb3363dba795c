"""The port's elastic shard layer (``controlplane/shard/elastic.py``,
``runner.py``) and the router's elastic surface (``fence``, ``unfence``,
``set_topology``), held to JAX's: every case of ``tests/test_elastic.py``
in both packages, and a cross-shard notebook migration
(``migrate_notebook``), which that file leaves out.

Each fleet case runs one script on each package's in-thread fleet — one
WAL-backed ``APIServer(shard=)`` behind a ``RestServer`` per shard, the
surface ``ShardRunner`` offers the coordinator (``urls``, ``wal_dir``,
``add_shard``, ``remove_shard``, ``kill``, where a kill restarts the
shard in place from its WAL at the same port) — and the script's
answers and every shard's whole object graph must be equal after the
TPU→GPU key map. Both packages hand out the same uids and
resourceVersions for the same sequential script (a frozen clock, the
uid counters reset); the one script with a concurrent writer compares
its graphs without uids and resourceVersions, which the thread
interleaving numbers. The autoscaler cases run each package's policy on
the same fakes and compare the decisions; the watchdog cases run each
package's runner on fake processes.
"""

import functools
import os
import threading
import time
from types import SimpleNamespace

import pytest

from tests.cp_fixtures import FakeClock
from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, canon, cp_module, jax_switch_defaults, key_map,
    parity, reset_uids, stop_fanout,
)

PKGS = ("port", "jax")
pkgs = pytest.mark.parametrize("pkg", PKGS)


class _Fleet:
    """One package's in-thread ``ShardRunner`` stand-in: a fixed port and
    WAL directory per shard; ``kill`` restarts the shard from its WAL at
    the same port (what the real watchdog does, minus the process
    boundary)."""

    def __init__(self, pkg: str, base_dir: str, n: int = 2):
        self.pkg, self.base = pkg, base_dir
        self.m = functools.partial(cp_module, pkg)
        self.clock = FakeClock()
        self.apis: dict = {}
        self.rests: dict = {}
        self._urls: dict[str, str] = {}
        self._dead: list = []
        self._next = n
        for i in range(n):
            self._boot(f"shard-{i}")

    def _boot(self, name: str, port: int = 0) -> str:
        wal = self.wal_dir(name)
        os.makedirs(wal, exist_ok=True)
        api = self.m("apiserver").APIServer(
            self.clock, shard=name, wal_dir=wal, wal_fsync=False)
        rest = self.m("deploy.restserver").RestServer(api, port=port)
        rest.start()
        self.apis[name], self.rests[name] = api, rest
        self._urls[name] = rest.url
        return name

    @property
    def urls(self) -> dict[str, str]:
        return dict(self._urls)

    def wal_dir(self, name: str) -> str:
        return os.path.join(self.base, "wal", name)

    def add_shard(self, name=None, timeout: float = 60.0) -> str:
        name = name or f"shard-{self._next}"
        self._next += 1
        return self._boot(name)

    def remove_shard(self, name: str, timeout: float = 30.0) -> None:
        self.rests.pop(name).stop()
        api = self.apis.pop(name)
        api.close_persistence()
        self._dead.append(api)
        self._urls.pop(name)

    def kill(self, name: str) -> int:
        port = int(self._urls[name].rsplit(":", 1)[1])
        self.rests[name].stop()  # no WAL close: a SIGKILL never flushes
        self._dead.append(self.apis[name])
        self._boot(name, port=port)
        return port

    # ---- the harness --------------------------------------------------
    def router(self, **kw):
        return self.m("deploy.kubeclient").ShardedKubeAPIServer(
            self.urls, **kw)

    def elastic(self, router, **kw):
        return self.m("shard.elastic").ElasticShardManager(
            self, router, **kw)

    def graphs(self, strip_ids: bool = False) -> dict:
        """Every shard's whole object graph, as its server lists it."""
        out = {}
        for name, api in sorted(self.apis.items()):
            api.drain_watchers()
            graph = {k: api.list(k) for k in sorted(api._by_kind)
                     if api.list(k)}
            # an Event the kube client records carries the client's
            # wall clock, not the fleet's frozen one
            for ev in graph.get("Event", []):
                for key in ("firstTimestamp", "lastTimestamp"):
                    if key in ev:
                        ev[key] = "(wall clock)"
            if strip_ids:
                graph = _strip_ids(graph)
            out[name] = graph
        return out

    def close(self) -> None:
        for rest in self.rests.values():
            rest.stop()
        for api in list(self.apis.values()) + self._dead:
            try:
                api.close_persistence()
            except Exception:  # noqa: BLE001 - a killed shard's log
                pass           # may already be closed
            stop_fanout(api)


def _strip_ids(obj):
    if isinstance(obj, dict):
        return {k: _strip_ids(v) for k, v in obj.items()
                if k not in ("uid", "resourceVersion")}
    if isinstance(obj, list):
        return [_strip_ids(v) for v in obj]
    return obj


def _both(monkeypatch, tmp_path, script, *, strip_ids=False):
    """``script(fleet)`` on each package's two-shard fleet with the same
    uids; the answers and every shard's graph equal after the key map.
    Returns the port's answer."""
    outs = {}
    for pkg in PKGS:
        reset_uids(monkeypatch)
        fleet = _Fleet(pkg, str(tmp_path / pkg))
        try:
            out = script(fleet)
            graphs = fleet.graphs(strip_ids)
        finally:
            fleet.close()
        if pkg == "jax":
            out, graphs = key_map(out), key_map(graphs)
        outs[pkg] = (out, graphs)
    (port_out, port_graphs), (jax_out, jax_graphs) = outs["port"], outs["jax"]
    assert port_out == jax_out
    assert sorted(port_graphs) == sorted(jax_graphs)
    for shard in jax_graphs:
        assert canon(port_graphs[shard]) == canon(jax_graphs[shard]), shard
    return port_out


def _pod(name: str, ns: str) -> dict:
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"containers": [{"name": "c", "image": "img"}]}}


def _seed(router, n_ns: int = 12, pods_per: int = 3) -> list[str]:
    spaces = [f"el-{i}" for i in range(n_ns)]
    for ns in spaces:
        router.ensure_namespace(ns)
        for j in range(pods_per):
            router.create(_pod(f"p-{j}", ns))
    return spaces


def _audit(router, fleet, spaces, pods_per: int = 3) -> dict:
    """Zero-loss + placement invariant: every object reads back through
    the router AND physically lives on (only) its ring owner. Returns
    the placement {namespace: owner}."""
    placed = {}
    for ns in spaces:
        owner = placed[ns] = router.shard_of("Pod", None, ns)
        for j in range(pods_per):
            assert router.get("Pod", f"p-{j}", ns) is not None
            assert fleet.apis[owner].try_get("Pod", f"p-{j}", ns) \
                is not None, (ns, owner)
            for other, api in fleet.apis.items():
                if other != owner:
                    assert api.try_get("Pod", f"p-{j}", ns) is None, \
                        (ns, other)
    return placed


# ---- split -----------------------------------------------------------------

def test_split_hands_off_range_with_zero_loss(parity, tmp_path):
    def script(fleet):
        router = fleet.router()
        elastic = fleet.elastic(router)
        spaces = _seed(router)
        before = dict(router.ring.spread(spaces))
        new = elastic.split()
        assert new in router.ring.members and len(router.ring) == 3
        # the new member actually took a slice of the keyspace
        moved = [ns for ns in spaces
                 if router.shard_of("Pod", None, ns) == new]
        assert moved, before
        placed = _audit(router, fleet, spaces)
        # unmoved namespaces never left their shard
        ring0 = fleet.m("shard.ring").HashRing(["shard-0", "shard-1"])
        for ns in spaces:
            if ns not in moved:
                assert ring0.shard_for(ns) == router.shard_of("Pod", None,
                                                              ns)
        stats = {k: v for k, v in elastic.events[-1].items() if k != "t"}
        return new, moved, placed, stats
    _both(parity, tmp_path, script)


def test_split_replicates_broadcast_kinds_to_new_shard(parity, tmp_path):
    def script(fleet):
        router = fleet.router()
        elastic = fleet.elastic(router)
        router.create({"apiVersion": "rbac.authorization.k8s.io/v1",
                       "kind": "ClusterRole",
                       "metadata": {"name": "admin-all"}, "rules": []})
        new = elastic.split()
        assert fleet.apis[new].try_get("ClusterRole", "admin-all") \
            is not None
        assert len(router.list("ClusterRole")) == 1
        return new
    assert _both(parity, tmp_path, script) == "shard-2"


def test_writes_during_split_are_never_lost(parity, tmp_path):
    """A writer creates 80 pods in moving and staying namespaces while
    the split runs; every acked write reads back through the router and
    from its current owner. The interleaving of the writer's creates
    with the handoff's copies numbers uids and resourceVersions, so the
    graphs are compared without them."""
    def script(fleet):
        router = fleet.router(retry_window_s=10.0)
        elastic = fleet.elastic(router)
        spaces = _seed(router, n_ns=8, pods_per=1)
        written: list[tuple] = []
        started = threading.Event()

        def writer():
            for i in range(80):
                ns = spaces[i % len(spaces)]
                router.create(_pod(f"w-{i}", ns))
                written.append((ns, f"w-{i}"))
                started.set()
                time.sleep(0.005)

        t = threading.Thread(target=writer, daemon=True)
        t.start()
        try:
            assert started.wait(10)
            elastic.split()
        finally:
            t.join(30)
        assert not t.is_alive()
        # every acked write — before, during, or after the flip — reads
        # back through the router AND from its current ring owner
        assert len(written) == 80
        for ns, name in written:
            assert router.get("Pod", name, ns) is not None
            owner = router.shard_of("Pod", None, ns)
            assert fleet.apis[owner].try_get("Pod", name, ns) is not None
        return sorted(written), _audit(router, fleet, spaces, pods_per=1)
    _both(parity, tmp_path, script, strip_ids=True)


def test_split_survives_donor_sigkill_mid_handoff(parity, tmp_path):
    """The ``shard_split`` chaos arm: the donor dies between the bulk
    copy and the tail chase; recovery (respawn + WAL replay + more
    tail passes) must still deliver zero loss."""
    def script(fleet):
        chaos = fleet.m("chaos")
        router = fleet.router(retry_window_s=10.0)
        elastic = fleet.elastic(router)
        spaces = _seed(router)
        plan = chaos.FaultPlan(1234, [
            chaos.FaultSpec("shard_split", rate=1.0, limit=1)])
        chaos.install(plan)
        try:
            elastic.split()
        finally:
            chaos.uninstall()
        assert plan.counts.get("shard_split") == 1, plan.summary()
        return _audit(router, fleet, spaces), dict(plan.counts)
    _both(parity, tmp_path, script)


# ---- merge -----------------------------------------------------------------

def test_merge_retires_youngest_and_keeps_everything(parity, tmp_path):
    def script(fleet):
        router = fleet.router()
        elastic = fleet.elastic(router)
        spaces = _seed(router)
        grown = elastic.split()
        _audit(router, fleet, spaces)
        victim = elastic.merge()
        assert victim == grown  # scale-down unwinds scale-up
        assert victim not in router.ring.members
        assert victim not in fleet.apis  # process actually retired
        return victim, _audit(router, fleet, spaces), \
            [e["op"] for e in elastic.events]
    _both(parity, tmp_path, script)


def test_merge_below_min_refuses(parity, tmp_path):
    def script(fleet):
        router = fleet.router()
        elastic = fleet.elastic(router)
        first = elastic.merge()
        with pytest.raises(ValueError):
            elastic.merge()
        return first, router.ring.members
    assert _both(parity, tmp_path, script) == ("shard-1", ["shard-0"])


# ---- pinned migration --------------------------------------------------------

def test_migrate_namespace_pins_and_moves(parity, tmp_path):
    def script(fleet):
        router = fleet.router()
        elastic = fleet.elastic(router)
        ns = "pinned-ns"
        router.ensure_namespace(ns)
        router.create(_pod("p-0", ns))
        home = router.shard_of("Pod", None, ns)
        target = next(m for m in router.ring.members if m != home)
        assert elastic.migrate_namespace(ns, target) is True
        assert router.shard_of("Pod", None, ns) == target
        assert router.ring.pins.get(ns) == target
        assert fleet.apis[target].try_get("Pod", "p-0", ns) is not None
        assert fleet.apis[home].try_get("Pod", "p-0", ns) is None
        # idempotent: already there
        assert elastic.migrate_namespace(ns, target) is False
        # routing for OTHER keys is untouched by the pin
        assert router.ring.hash_owner(ns) == home
        return home, target, dict(router.ring.pins)
    _both(parity, tmp_path, script)


def test_migrate_notebook_moves_its_namespace_then_requests_migration(
        parity, tmp_path):
    """Cross-shard live migration rides the handoff: the notebook's
    namespace is pinned to the target and handed over, then
    ``suspend.initiate_migration`` runs THROUGH the router, so the
    migrate request and its Event land on the target shard."""
    def script(fleet):
        router = fleet.router(retry_window_s=10.0, clock=fleet.clock)
        elastic = fleet.elastic(router)
        nb_api = fleet.m("api.notebook")
        ns = "mover"
        router.ensure_namespace(ns)
        router.create(nb_api.make_notebook("nb", ns))
        home = router.shard_of("Notebook", "nb", ns)
        target = next(m for m in router.ring.members if m != home)
        assert elastic.migrate_notebook(ns, "nb", target) is True
        moved = fleet.apis[target].get("Notebook", "nb", ns)
        assert fleet.apis[home].try_get("Notebook", "nb", ns) is None
        ann = moved["metadata"]["annotations"]
        assert nb_api.MIGRATE_REQUESTED_ANNOTATION in ann
        reasons = [e["reason"] for e in fleet.apis[target].list("Event", ns)]
        assert "Migrating" in reasons
        return home, target, sorted(ann), reasons
    _both(parity, tmp_path, script)


@pkgs
def test_partition_key_mirrors_router_rule(pkg):
    elastic = cp_module(pkg, "shard.elastic")
    assert elastic.partition_key("Pod", "p", "ns1") == "ns1"
    assert elastic.LOCAL_KINDS == frozenset({"Lease"})
    assert elastic._KIND_ORDER == cp_module(
        "jax", "shard.elastic")._KIND_ORDER


# ---- range tombstones (donor-crash fencing) ------------------------------------

def test_donor_crash_after_flip_cannot_resurrect_moved_range(parity,
                                                             tmp_path):
    """The FLIP..CLEANUP crash window: ownership has transferred but
    the donor's WAL still holds the moved range. A donor that dies
    there and respawns from its WAL must NOT bring the moved objects
    back to life — the range tombstone set at FLIP purges them during
    recovery."""
    def script(fleet):
        router = fleet.router(retry_window_s=10.0)
        elastic = fleet.elastic(router)
        spaces = _seed(router)
        old_ring = fleet.m("shard.ring").HashRing(["shard-0", "shard-1"])

        # crash the coordinator at CLEANUP: FLIP (and the tombstone
        # write) already happened, donor copies of the moved range remain
        def crash(donor, live):
            raise RuntimeError("donor unreachable during cleanup")
        elastic._cleanup_donor = crash
        with pytest.raises(RuntimeError):
            elastic.split()
        del elastic._cleanup_donor

        new = next(m for m in router.ring.members
                   if m not in old_ring.members)
        moved = {ns: old_ring.shard_for(ns) for ns in spaces
                 if router.shard_of("Pod", None, ns) == new}
        assert moved  # the split did take a slice
        purged = {}
        for donor in sorted(set(moved.values())):
            # the stone is durably set (cleanup never ran to lift it) ...
            assert fleet.apis[donor].range_tombstones()
            # ... and survives a SIGKILL + WAL respawn: recovery purges
            # the moved range instead of resurrecting it
            fleet.kill(donor)
            purged[donor] = fleet.apis[donor].tombstone_purged
            assert purged[donor] > 0
        for ns, donor in moved.items():
            for j in range(3):
                assert fleet.apis[donor].try_get("Pod", f"p-{j}", ns) \
                    is None, (ns, donor)
        return moved, purged, _audit(router, fleet, spaces)
    _both(parity, tmp_path, script)


def test_handoff_into_tombstoned_range_lifts_the_stone(parity, tmp_path):
    """A range that once left a shard can come BACK (pinned migration,
    weight change). The recipient must lift its stale stone before
    adopting, or its next respawn would purge live data."""
    def script(fleet):
        router = fleet.router(retry_window_s=10.0)
        elastic = fleet.elastic(router)
        ns = "boomerang"
        router.ensure_namespace(ns)
        router.create(_pod("p-0", ns))
        home = router.shard_of("Pod", None, ns)
        target = next(m for m in router.ring.members if m != home)
        # stale stone, as if ns left `target` in an earlier rebalance
        # whose cleanup crashed before lifting it
        fleet.apis[target].set_range_tombstone([ns])
        assert elastic.migrate_namespace(ns, target) is True
        assert ns not in fleet.apis[target].range_tombstones()
        # the adopted range survives the recipient's own respawn
        fleet.kill(target)
        assert fleet.apis[target].try_get("Pod", "p-0", ns) is not None
        assert router.get("Pod", "p-0", ns) is not None
        pk = fleet.m("shard.elastic").partition_key
        assert pk("Profile", "alice", None) == "alice"
        assert pk("Namespace", "alice", None) == "alice"
        return home, target
    _both(parity, tmp_path, script)


# ---- autoscaler policy (fakes: policy only, no fleet) ------------------------

class _FakeTSDB:
    def __init__(self):
        self.depth: dict[str, float] = {}
        #: (instance, namespace) -> per-namespace queue depth
        self.ns_depth: dict[tuple, float] = {}
        self.scrapes: dict[str, str] = {}

    def latest(self, name, labels=None):
        labels = labels or {}
        if name == "workqueue_namespace_depth":
            return self.ns_depth.get(
                (labels.get("instance"), labels.get("namespace")))
        return self.depth.get(labels.get("instance"))

    def label_values(self, name, key):
        return sorted({ns for _, ns in self.ns_depth})

    def add_scrape(self, name, url):
        self.scrapes[name] = url

    def remove_scrape(self, name):
        self.scrapes.pop(name, None)


class _FakeEngine:
    def __init__(self):
        self.states: dict[str, str] = {}

    def state_of(self, name):
        return self.states[name]  # KeyError for unknown, like the real


class _FakeElastic:
    def __init__(self, HashRing, n=2):
        self.router = SimpleNamespace(
            ring=HashRing([f"shard-{i}" for i in range(n)]))
        self.calls: list[str] = []
        self._next = n

    def split(self, name=None, *, weight=None, dedicate=None):
        self.calls.append(f"carve:{dedicate}" if dedicate else "split")
        name = f"shard-{self._next}"
        self._next += 1
        ring = self.router.ring.with_member(name)
        if weight is not None:
            ring = ring.with_weight(name, weight)
        if dedicate is not None:
            ring = ring.with_pin(dedicate, name)
        self.router.ring = ring
        return name

    def merge(self):
        self.calls.append("merge")
        victim = self.router.ring.members[-1]
        self.router.ring = self.router.ring.without_member(victim)
        return victim


def _scalers(n=2, **kw):
    """Each package's autoscaler over its own fakes: {pkg: (scaler,
    fake elastic, fake observer)}."""
    kw.setdefault("sustain", 3)
    kw.setdefault("cooldown_s", 0.0)
    out = {}
    for pkg in PKGS:
        fake = _FakeElastic(cp_module(pkg, "shard.ring").HashRing, n)
        obs = SimpleNamespace(tsdb=_FakeTSDB(), engine=_FakeEngine())
        out[pkg] = (cp_module(pkg, "shard.elastic").ShardAutoscaler(
            fake, obs, **kw), fake, obs)
    return out


def _policy(case, **kw):
    """``case(scaler, fake, obs)`` on each package's autoscaler; the
    answers, the calls and the decision logs equal."""
    got = {}
    for pkg, (scaler, fake, obs) in _scalers(**kw).items():
        out = case(scaler, fake, obs)
        got[pkg] = (out, fake.calls, scaler.decisions,
                    fake.router.ring.members)
    assert got["port"] == got["jax"]
    return got["port"]


def test_autoscaler_splits_on_sustained_depth():
    def case(scaler, fake, obs):
        for s in fake.router.ring.members:
            obs.tsdb.depth[s] = 50.0
        out = [scaler.tick(i) for i in range(3)]
        assert out == ["hold", "hold", "split"]
        assert fake.calls == ["split"]
        return out
    _policy(case)


def test_autoscaler_one_spike_does_not_split():
    def case(scaler, fake, obs):
        obs.tsdb.depth = {s: 50.0 for s in fake.router.ring.members}
        scaler.tick(0)
        obs.tsdb.depth = {s: 3.0 for s in fake.router.ring.members}
        out = [scaler.tick(i) for i in range(1, 6)]
        assert fake.calls == []
        return out
    _policy(case)


def test_autoscaler_merges_on_sustained_idle_to_min():
    def case(scaler, fake, obs):
        obs.tsdb.depth = {s: 0.0 for s in fake.router.ring.members}
        decisions = [scaler.tick(i) for i in range(8)]
        assert "merge" in decisions
        assert len(fake.router.ring) == 2  # floor: min_shards
        assert fake.calls.count("merge") == 1
        return decisions
    _policy(case, n=3)


def test_autoscaler_slo_burn_counts_as_pressure():
    """Critical burn + a sub-split-threshold queue still splits; critical
    burn over an EMPTY queue is window residue from drained traffic and
    must not hold capacity up."""
    def burning(scaler, fake, obs):
        obs.engine.states["provision-p50"] = "critical"
        obs.tsdb.depth = {s: 3.0 for s in fake.router.ring.members}
        for i in range(3):
            scaler.tick(i)
        assert fake.calls == ["split"]

    def stale(scaler, fake, obs):
        obs.engine.states["provision-p50"] = "critical"
        obs.tsdb.depth = {s: 0.0 for s in fake.router.ring.members}
        for i in range(3):
            scaler.tick(i)
        assert fake.calls == ["merge"]  # stale burn does not pin 3 wide
    _policy(burning)
    _policy(stale, n=3)


def test_autoscaler_carves_hot_namespace_onto_dedicated_shard():
    """One tenant drowning one shard gets a CARVE, not an even split;
    the pin then disqualifies the namespace from a second carve while
    continued pressure falls through to the ordinary split."""
    def case(scaler, fake, obs):
        ring0 = fake.router.ring
        home = ring0.shard_for("hotspot")
        obs.tsdb.depth = {s: (40.0 if s == home else 2.0)
                          for s in ring0.members}
        obs.tsdb.ns_depth = {(home, "hotspot"): 36.0,
                             (home, "quiet"): 4.0}
        first = [scaler.tick(i) for i in range(3)]
        assert first == ["hold", "hold", "carve"]
        assert fake.calls == ["carve:hotspot"]
        ring = fake.router.ring
        carved = next(m for m in ring.members if m not in ring0.members)
        assert ring.pins["hotspot"] == carved
        assert ring.weight_of(carved) == 1  # ~no hash range: dedicated
        obs.tsdb.depth[carved] = 40.0
        obs.tsdb.ns_depth = {(carved, "hotspot"): 40.0}
        # clear of the action cooldown; a fixed base keeps the two
        # packages' decision logs comparable
        base = time.monotonic() + 10.0
        for i in range(6):
            scaler.tick(base + i)
        assert [c for c in fake.calls if c.startswith("carve")] == \
            ["carve:hotspot"]
        assert "split" in fake.calls
        for d in scaler.decisions[3:]:
            d["t"] = round(d["t"] - base, 3)
        return home, carved
    _policy(case)


def test_autoscaler_respects_cooldown_and_max():
    def case(scaler, fake, obs):
        obs.tsdb.depth = {s: 50.0 for s in fake.router.ring.members}
        decisions = [scaler.tick(i) for i in range(8)]
        assert decisions.count("split") == 1  # cooldown holds the second
        assert "cooldown" in decisions
        assert len(fake.router.ring) == 3
        return decisions
    _policy(case, max_shards=3, cooldown_s=3600.0)


class _Expositions:
    """A stdlib HTTP server answering ``GET /<shard>/metrics`` with a
    scripted exposition per shard: the ``/metrics`` of each shard that a
    real ``Observer``'s TSDB federates."""

    def __init__(self):
        import http.server

        self.text: dict[str, str] = {}
        owner = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                shard = self.path.strip("/").split("/")[0]
                body = owner.text.get(shard)
                if body is None:
                    self.send_response(503)
                    self.end_headers()
                    return
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                      Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_port}"

    def set(self, shard, depth, ns_depth=None):
        lines = ["# TYPE workqueue_depth gauge",
                 f'workqueue_depth{{name="notebook"}} {depth}',
                 "# TYPE workqueue_namespace_depth gauge"]
        for ns, v in (ns_depth or {}).items():
            lines.append(f'workqueue_namespace_depth{{name="notebook",'
                         f'namespace="{ns}"}} {v}')
        self.text[shard] = "\n".join(lines) + "\n"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)


class _ObservedElastic(_FakeElastic):
    """The policy fake, wired to a real observer as the real manager is:
    a split adds the new shard's scrape, a merge removes the victim's."""

    def __init__(self, HashRing, n, observer, expo):
        super().__init__(HashRing, n)
        self.observer, self.expo = observer, expo

    def split(self, name=None, *, weight=None, dedicate=None):
        new = super().split(name, weight=weight, dedicate=dedicate)
        self.expo.set(new, 0.0)
        self.observer.tsdb.add_scrape(new, f"{self.expo.base}/{new}")
        return new

    def merge(self):
        victim = super().merge()
        self.observer.tsdb.remove_scrape(victim)
        return victim


_EMPTY_REGISTRY = {"port": list, "jax": lambda: __import__(
    "prometheus_client").CollectorRegistry()}


def _observed(script, n):
    """``script(scaler, fake, observer, expo, tick)`` on each package's
    autoscaler over a real ``Observer`` (JAX's default SLOs, an empty
    local registry) whose TSDB federates each shard's scripted
    exposition; ``tick()`` samples and evaluates once, then ticks the
    autoscaler, on a shared frozen clock. The decisions, the calls, the
    ring and the federated series must be equal."""
    got = {}
    for pkg in PKGS:
        expo = _Expositions()
        try:
            for i in range(n):
                expo.set(f"shard-{i}", 0.0)
            observer = cp_module(pkg, "obs").Observer(
                interval_s=1.0, registry=_EMPTY_REGISTRY[pkg](),
                shard_urls={f"shard-{i}": f"{expo.base}/shard-{i}"
                            for i in range(n)})
            fake = _ObservedElastic(cp_module(pkg, "shard.ring").HashRing,
                                    n, observer, expo)
            scaler = cp_module(pkg, "shard.elastic").ShardAutoscaler(
                fake, observer, sustain=3, cooldown_s=0.0)
            clock = iter(range(1000, 2000))
            # the autoscaler times its cooldown on the monotonic clock:
            # its ticks run past the current reading
            base = time.monotonic() + 10.0

            def tick():
                now = float(next(clock))
                observer.tick(now=now)
                return scaler.tick(base + now)

            out = script(scaler, fake, observer, expo, tick)
            for d in scaler.decisions:
                d["t"] = round(d["t"] - base, 3)
            series = sorted(
                (s["labels"]["instance"], s["labels"].get("namespace", ""),
                 s["points"])
                for name in ("workqueue_depth", "workqueue_namespace_depth")
                for s in observer.tsdb.range(name, window_s=1e6,
                                             now=3000.0))
            got[pkg] = (out, fake.calls, scaler.decisions,
                        fake.router.ring.members, series,
                        observer.tsdb.scrape_errors)
        finally:
            expo.close()
    assert got["port"] == got["jax"]
    return got["port"]


def test_autoscaler_over_a_real_observer_merges_on_federated_idle():
    """Three idle shards federated through the TSDB: ``sustain`` idle
    ticks merge back to ``min_shards`` (the youngest retired, its scrape
    removed); a split and a carve never happen."""
    def script(scaler, fake, observer, expo, tick):
        decisions = [tick() for _ in range(6)]
        assert decisions == ["hold", "hold", "merge", "hold", "hold",
                             "hold"]
        assert fake.calls == ["merge"]
        return decisions

    decisions, calls, log, members, series, errors = _observed(script, 3)
    assert members == ["shard-0", "shard-1"] and errors == 0
    assert [d["mean_depth"] for d in log] == [0.0] * 6
    # shard-2's series stop at the merge: no scrape after its removal
    last = {inst: pts[-1][0] for inst, ns, pts in series if not ns}
    assert last["shard-2"] == 1002.0 and last["shard-0"] == 1005.0


def test_autoscaler_over_a_real_observer_splits_then_carves():
    """Federated depth on every shard splits after ``sustain`` ticks (the
    new shard's scrape added); one namespace dominating a deep shard then
    carves it a dedicated shard."""
    def script(scaler, fake, observer, expo, tick):
        for s in ("shard-0", "shard-1"):
            expo.set(s, 50.0)
        first = [tick() for _ in range(3)]
        assert first == ["hold", "hold", "split"]
        ring = fake.router.ring
        home = ring.shard_for("hotspot")
        for s in ring.members:
            expo.set(s, 40.0 if s == home else 2.0,
                     {"hotspot": 36.0, "quiet": 4.0} if s == home else None)
        second = [tick() for _ in range(3)]
        assert second[-1] == "carve"
        assert fake.calls == ["split", "carve:hotspot"]
        return first + second

    decisions, calls, log, members, series, errors = _observed(script, 2)
    assert members == ["shard-0", "shard-1", "shard-2", "shard-3"]
    assert log[2]["mean_depth"] == 50.0 and errors == 0


# ---- watchdog interplay (the intentional-shutdown handshake) -----------------

class _FakeProc:
    def __init__(self):
        self.alive = True
        self.exitcode = None
        self.pid = None

    def is_alive(self):
        return self.alive

    def terminate(self):
        self.alive, self.exitcode = False, -15

    def kill(self):
        self.alive, self.exitcode = False, -9

    def join(self, timeout=None):
        pass


@pkgs
def test_deliberate_remove_is_not_a_death(pkg, monkeypatch):
    """A merge's ``remove_shard`` must not increment
    ``shard_deaths_total``, and the watchdog must not respawn the
    retired shard — while a REAL death on another shard still gets
    counted and respawned by the same loop."""
    registry_value = cp_module(pkg, "metrics").registry_value
    runner = cp_module(pkg, "shard.runner").ShardRunner(
        2, wal=False, supervise=False)
    respawned: list[str] = []
    monkeypatch.setattr(runner, "_spawn",
                        lambda name: respawned.append(name))
    procs = {n: _FakeProc() for n in ("shard-0", "shard-1")}
    runner._procs.update(procs)

    deaths_before = {
        n: registry_value("shard_deaths_total", {"shard": n}) or 0.0
        for n in procs}
    wd = threading.Thread(target=runner._watchdog, daemon=True)
    wd.start()
    try:
        runner.remove_shard("shard-1")
        time.sleep(0.6)  # several watchdog ticks
        assert respawned == []
        assert (registry_value("shard_deaths_total",
                               {"shard": "shard-1"}) or 0.0) == \
            deaths_before["shard-1"]
        assert "shard-1" not in runner.names
        assert runner.wal_dir("shard-1") is None  # retired cfg kept

        # a genuine death on the survivor IS a death
        procs["shard-0"].alive, procs["shard-0"].exitcode = False, -9
        deadline = time.monotonic() + 5
        while "shard-0" not in respawned and \
                time.monotonic() < deadline:
            time.sleep(0.05)
        assert respawned == ["shard-0"]
        assert registry_value("shard_deaths_total",
                              {"shard": "shard-0"}) == \
            deaths_before["shard-0"] + 1
    finally:
        runner._stopping = True
        wd.join(timeout=5)


@pkgs
def test_retired_names_are_never_reused(pkg):
    runner = cp_module(pkg, "shard.runner").ShardRunner(
        2, wal=False, supervise=False)
    runner._procs["shard-1"] = _FakeProc()
    runner.remove_shard("shard-1")
    with pytest.raises(ValueError, match="never reused"):
        runner.add_shard("shard-1")


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed (the
    chaos plan uninstalled in both packages)."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
    assert cp_module("port", "chaos").active() is None
