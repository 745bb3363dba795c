"""Leader election in the port (``controlplane/ha/leases.py``, slice
7e-1), held to JAX's on the same scripts: the lease cases of
``tests/test_ha.py`` — acquire, renew, no steal of a fresh lease, steal
of an expired one, the resourceVersion fence, graceful release, the
missing namespace, the gauge and callbacks, a two-elector failover —
and the manager's standby gate (``run_forever(elector=)``). Every case
runs on each package; where a case leaves a Lease object, the two
packages' Leases must be equal.

No case reads the wall clock: expiry runs on a ``FakeClock``, and the
threaded cases wait on events (a callback fired, an election round
counted, a StatefulSet written), never on sleeps.
"""

import copy
import importlib
import threading

import pytest

from tests.cp_fixtures import FakeClock
from tests.torch_cp_parity import stop_fanout

PKGS = ("port", "jax")
WAIT_S = 60.0


def _mod(pkg, name):
    root = "kubeflow_rm_tpu" if pkg == "jax" else "kubeflow_rm_tpu_torch"
    return importlib.import_module(
        f"{root}.controlplane" + (f".{name}" if name else ""))


@pytest.fixture(params=PKGS)
def lease_api(request):
    pkg = request.param
    clock = FakeClock()
    api = _mod(pkg, "apiserver").APIServer(clock=clock)
    api.ensure_namespace("kubeflow")
    yield pkg, api, clock
    stop_fanout(api)


def elector(pkg, api, identity, **kw):
    kw.setdefault("lease_duration_s", 15.0)
    kw.setdefault("retry_period_s", 2.0)
    return _mod(pkg, "ha").LeaderElector(api, identity, **kw)


def _lease(api, name="kubeflow-rm-tpu-controller-manager", ns="kubeflow"):
    lease = copy.deepcopy(api.get("Lease", name, ns))
    for key in ("uid", "creationTimestamp"):
        lease["metadata"].pop(key, None)
    return lease


def _both(script):
    """``script(pkg, api, clock)`` on each package; returns the port's
    result after checking it equals JAX's."""
    out = {}
    for pkg in PKGS:
        api = _mod(pkg, "apiserver").APIServer(clock=FakeClock())
        api.ensure_namespace("kubeflow")
        try:
            out[pkg] = script(pkg, api, api.clock)
        finally:
            stop_fanout(api)
    assert out["port"] == out["jax"]
    return out["port"]


def test_make_lease_and_constants_equal_jax():
    clock = FakeClock()
    port, jax = _mod("port", "ha.leases"), _mod("jax", "ha.leases")
    assert port.make_lease("l", "ns", "me", 15.0, clock()) == \
        jax.make_lease("l", "ns", "me", 15.0, clock())
    assert (port.DEFAULT_LEASE_NAME, port.LEASE_API_VERSION) == (
        jax.DEFAULT_LEASE_NAME, jax.LEASE_API_VERSION)


def test_elector_acquires_fresh_lease(lease_api):
    pkg, api, clock = lease_api
    a = elector(pkg, api, "mgr-a")
    assert a.try_acquire_or_renew() is True
    lease = api.get("Lease", a.lease_name, "kubeflow")
    assert lease["spec"]["holderIdentity"] == "mgr-a"
    assert lease["spec"]["leaseDurationSeconds"] == 15


def test_elector_renews_own_lease(lease_api):
    pkg, api, clock = lease_api
    a = elector(pkg, api, "mgr-a")
    a.try_acquire_or_renew()
    first = api.get("Lease", a.lease_name, "kubeflow")["spec"]["renewTime"]
    clock.advance(seconds=5)
    assert a.try_acquire_or_renew() is True
    assert api.get("Lease", a.lease_name,
                   "kubeflow")["spec"]["renewTime"] > first


def test_standby_cannot_steal_fresh_lease(lease_api):
    pkg, api, clock = lease_api
    a, b = elector(pkg, api, "mgr-a"), elector(pkg, api, "mgr-b")
    a.try_acquire_or_renew()
    clock.advance(seconds=10)
    assert b.try_acquire_or_renew() is False
    assert api.get("Lease", a.lease_name,
                   "kubeflow")["spec"]["holderIdentity"] == "mgr-a"


def test_standby_steals_expired_lease_as_jax_does():
    def script(pkg, api, clock):
        a, b = elector(pkg, api, "mgr-a"), elector(pkg, api, "mgr-b")
        rounds = [a.try_acquire_or_renew()]
        clock.advance(seconds=16)
        rounds += [b.try_acquire_or_renew(), a.try_acquire_or_renew()]
        return rounds, _lease(api)

    rounds, lease = _both(script)
    assert rounds == [True, True, False]
    assert lease["spec"]["holderIdentity"] == "mgr-b"
    assert lease["spec"]["leaseTransitions"] == 1


def test_steal_is_fenced_by_resource_version(lease_api):
    """Two candidates racing one expired lease: the slower CAS loses
    with a Conflict instead of clobbering the new holder."""
    pkg, api, clock = lease_api
    Conflict = _mod(pkg, "apiserver").Conflict
    a, b = elector(pkg, api, "mgr-a"), elector(pkg, api, "mgr-b")
    a.try_acquire_or_renew()
    clock.advance(seconds=20)
    stale = api.get("Lease", b.lease_name, "kubeflow")

    class StaleReader:
        def __getattr__(self, name):
            return getattr(api, name)

        def try_get(self, *a_, **k):
            return copy.deepcopy(stale)

    b.api = StaleReader()
    assert a.try_acquire_or_renew() is True
    assert b.try_acquire_or_renew() is False
    assert api.get("Lease", b.lease_name,
                   "kubeflow")["spec"]["holderIdentity"] == "mgr-a"
    with pytest.raises(Conflict):
        api.update(stale)


def test_release_hands_over_immediately_as_jax_does():
    def script(pkg, api, clock):
        a, b = elector(pkg, api, "mgr-a"), elector(pkg, api, "mgr-b")
        a.try_acquire_or_renew()
        a.release()
        clock.advance(seconds=1)
        return b.try_acquire_or_renew(), _lease(api)

    ok, lease = _both(script)
    assert ok and lease["spec"]["holderIdentity"] == "mgr-b"


def test_elector_creates_missing_namespace(lease_api):
    pkg, api, _ = lease_api
    a = elector(pkg, api, "mgr-a", namespace="brand-new")
    assert a.try_acquire_or_renew() is False
    assert a.try_acquire_or_renew() is True


def test_leader_gauge_and_callbacks(lease_api):
    pkg, api, clock = lease_api
    metrics = _mod(pkg, "metrics")
    a = elector(pkg, api, f"gauge-probe-{pkg}")
    events = []
    a.on_started_leading.append(lambda: events.append("up"))
    a.on_stopped_leading.append(lambda: events.append("down"))
    a._set_leader(a.try_acquire_or_renew(), clock())
    assert events == ["up"]
    assert metrics.registry_value(
        "leader_is_leader", {"identity": f"gauge-probe-{pkg}"}) == 1.0
    a._set_leader(False, clock())
    assert events == ["up", "down"]
    assert metrics.registry_value(
        "leader_is_leader", {"identity": f"gauge-probe-{pkg}"}) == 0.0


class _Rounds:
    """Counts an elector's election rounds and lets a test wait for more."""

    def __init__(self, el):
        self.n = 0
        self._cv = threading.Condition()
        self._round = el.try_acquire_or_renew
        el.try_acquire_or_renew = self

    def __call__(self):
        try:
            return self._round()
        finally:
            with self._cv:
                self.n += 1
                self._cv.notify_all()

    def wait_more(self, k):
        with self._cv:
            target = self.n + k
            assert self._cv.wait_for(lambda: self.n >= target, WAIT_S)


def test_two_elector_threads_fail_over(lease_api):
    """Both loops on threads: the standby stands by while the leader
    renews; the leader stops without release (a crash), the lease
    expires on the fake clock, and the standby's next round takes it."""
    pkg, api, clock = lease_api
    kw = dict(lease_duration_s=0.4, renew_deadline_s=0.3,
              retry_period_s=0.01)
    a = elector(pkg, api, "mgr-a", **kw)
    b = elector(pkg, api, "mgr-b", **kw)
    up = {n: threading.Event() for n in "ab"}
    a.on_started_leading.append(up["a"].set)
    b.on_started_leading.append(up["b"].set)
    rounds_b = _Rounds(b)
    stop_a, stop_b = threading.Event(), threading.Event()
    ta = threading.Thread(target=a.run, args=(stop_a,), daemon=True)
    tb = threading.Thread(target=b.run, args=(stop_b,), daemon=True)
    ta.start()
    try:
        assert up["a"].wait(WAIT_S) and a.is_leader
        tb.start()
        rounds_b.wait_more(3)
        assert not b.is_leader               # standby while a holds it
        stop_a.set()                         # crash-style: no release
        ta.join(WAIT_S)
        assert not ta.is_alive()
        clock.advance(seconds=1)             # past leaseDurationSeconds
        assert up["b"].wait(WAIT_S) and b.is_leader
        assert _lease(api)["spec"]["holderIdentity"] == "mgr-b"
    finally:
        stop_a.set()
        stop_b.set()
        ta.join(WAIT_S)
        tb.join(WAIT_S)


@pytest.mark.parametrize("pkg", PKGS)
def test_run_forever_standby_does_not_reconcile(pkg):
    """A manager whose elector is not the leader reconciles nothing: the
    notebook's create wakes its loop, which looks at the elector and
    stands by; on promotion it resyncs its queues and converges."""
    api, mgr = _mod(pkg, "").make_control_plane()
    api.ensure_namespace("user1")
    make_notebook = _mod(pkg, "api.notebook").make_notebook
    written = threading.Event()
    api.add_watcher(
        lambda et, obj, old=None: obj.get("kind") == "StatefulSet"
        and written.set(), name="probe")

    class FakeElector:
        identity = "fake"

        def __init__(self):
            self.leader = False
            self.looks = 0
            self.cv = threading.Condition()
            self.on_started_leading, self.on_stopped_leading = [], []

        @property
        def is_leader(self):
            with self.cv:
                self.looks += 1
                self.cv.notify_all()
            return self.leader

        def looked(self, k):
            with self.cv:
                target = self.looks + k
                assert self.cv.wait_for(lambda: self.looks >= target,
                                        WAIT_S)

        def run(self, stop):
            stop.wait()

    el, stop = FakeElector(), threading.Event()
    t = threading.Thread(target=mgr.run_forever,
                         kwargs=dict(stop=stop, poll_interval_s=0.02,
                                     elector=el), daemon=True)
    t.start()
    try:
        el.looked(1)
        api.create(make_notebook("gated", "user1"))
        el.looked(3)                 # the loop saw the create, stood by
        api.drain_watchers()
        assert not written.is_set()
        assert api.try_get("StatefulSet", "gated", "user1") is None
        el.leader = True
        for cb in el.on_started_leading:
            cb()
        assert written.wait(WAIT_S)
        assert api.try_get("StatefulSet", "gated", "user1") is not None
    finally:
        stop.set()
        t.join(WAIT_S)
        stop_fanout(api)
    assert not t.is_alive()
