"""The port's readiness hub (``controlplane/webapps/readiness.py``) on the
cases of ``tests/test_readiness.py``: watch-latency wakeups, slow-client
isolation, per-key wakeups, no lost wakeup and the TOO_OLD wake-all, with
the waiter gauge back at zero.

Each case runs on each package's hub over two backends: the in-memory
apiserver's asynchronous fan-out (``add_watcher`` on the server) and the
kube adapter's watch thread (``deploy/kubeclient.KubeAPIServer`` over
the package's REST facade on 127.0.0.1, one ``watch_kind`` thread for
Notebooks), the port's hub on the port's adapter where JAX's runs on
JAX's. Writes go through the backend the hub watches. The timing bounds
are JAX's.
"""

import functools
import threading
import time

import pytest

from tests.torch_cp_parity import RestCluster, cp_module

CASES = [("port", "memory"), ("port", "adapter"), ("jax", "memory"),
         ("jax", "adapter")]
#: a one-host slice of four cards (JAX's ``v5p-8``)
SLICE = {"port": "h100-80gb-4", "jax": "v5p-8"}


class Backend:
    """A package's hub over one backend; ``api`` is what the hub watches
    and every write goes through, :meth:`drain` waits until the hub has
    been handed every event written so far."""

    def __init__(self, pkg: str, kind: str):
        self.pkg = pkg
        self.m = functools.partial(cp_module, pkg)
        self.cluster = self.stop = self.thread = None
        if kind == "memory":
            self.api = self.m("apiserver").APIServer()
            self.server = self.api
        else:
            self.cluster = RestCluster(pkg)
            self.server = self.cluster.api
            # a write before the watch starts (JAX's facade reads a
            # resume at rv 0 as none, C12)
            self.server.ensure_namespace("d")
            self.api = self.m("deploy.kubeclient").KubeAPIServer(
                self.cluster.url)
            self.stop = threading.Event()
            self.thread = threading.Thread(
                target=self.api.watch_kind,
                args=("Notebook", None, self.stop, 30), daemon=True)
            self.thread.start()
            assert self.api.wait_for_sync(["Notebook"], timeout=30)
        self.hub = self.m("webapps.readiness").ReadinessHub(self.api)
        # delivered after the hub's watcher: what it has seen, the hub has
        self.seen: dict = {}
        if self.cluster is not None:
            self.api.add_watcher(self._record)

    def _record(self, etype, obj, old=None):
        md = obj.get("metadata") or {}
        self.seen[md.get("name")] = md.get("resourceVersion")

    def drain(self) -> None:
        if self.cluster is None:
            self.api.drain_watchers()
            return
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if all(self.seen.get(o["metadata"]["name"]) ==
                   o["metadata"]["resourceVersion"]
                   for o in self.server.list("Notebook")):
                return
            time.sleep(0.005)
        raise AssertionError("the hub's watch did not catch up")

    def make(self, name: str) -> dict:
        self.api.ensure_namespace("d")
        nb = self.m("api.notebook")
        return self.api.create(nb.make_notebook(
            name, "d", accelerator_type=SLICE[self.pkg]))

    def waiters(self) -> float:
        return self.m("metrics").registry_value("readiness_waiters")

    def close(self) -> None:
        if self.cluster is not None:
            self.stop.set()
            self.cluster.close()
            self.thread.join(timeout=30)
        from tests.torch_cp_parity import stop_fanout
        stop_fanout(self.server)


@pytest.fixture(params=CASES, ids=["-".join(c) for c in CASES])
def be(request):
    b = Backend(*request.param)
    try:
        yield b
    finally:
        b.close()


def _rv(obj) -> str:
    return str(obj["metadata"]["resourceVersion"])


def _guard_tick(be) -> float:
    return be.m("webapps.readiness")._GUARD_TICK_S


def test_waiter_wakes_at_watch_latency_not_poll_tick(be):
    """A blocked readiness wait must observe a status write at watch
    latency — far below both the old 50ms poll tick's worst case and
    the hub's 1s guard tick (which would mask a lost wakeup)."""
    api, hub = be.api, be.hub
    nb = be.make("nb")
    baseline = _rv(nb)
    got: dict = {}

    def waiter():
        def fetch():
            return api.try_get("Notebook", "nb", "d")

        def moved(obj):
            return obj is not None and _rv(obj) != baseline

        got["obj"], got["changed"] = hub.wait("d", "nb", 10.0, fetch, moved)
        got["t"] = time.monotonic()

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)  # let the waiter park on the condition
    nb["status"] = {"readyReplicas": 2}
    api.update_status(nb)
    t_write = time.monotonic()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert got["changed"] is True
    dt = got["t"] - t_write
    assert dt < 0.5 * _guard_tick(be), \
        f"wakeup took {dt:.3f}s — guard tick, not the watch, woke it"


def test_slow_waiter_does_not_stall_writers_and_drains(be):
    """A parked (slow/disconnected) long-poll must not back-pressure
    the write path: 20 rapid writes complete while a waiter is blocked
    on a notebook that never becomes ready, and when that waiter's
    timeout lapses the readiness_waiters gauge returns to zero."""
    api, hub = be.api, be.hub
    be.make("stuck")
    waiters_before = be.waiters()

    def fetch():
        return api.try_get("Notebook", "stuck", "d")

    results: dict = {}

    def parked():
        results["r"] = hub.wait("d", "stuck", 1.5, fetch, lambda o: False)

    t = threading.Thread(target=parked)
    t.start()
    time.sleep(0.05)
    assert be.waiters() == waiters_before + 1

    t0 = time.monotonic()
    for i in range(20):
        be.make(f"burst-{i}")
    write_s = time.monotonic() - t0
    assert write_s < 1.0, f"20 writes took {write_s:.3f}s with a waiter parked"

    t.join(timeout=5.0)
    assert not t.is_alive()
    obj, changed = results["r"]
    assert changed is False and obj is not None
    assert be.waiters() == waiters_before


def test_sibling_events_do_not_wake_unrelated_waiters(be):
    """Wakeups are keyed by (namespace, name): a storm of OTHER
    notebooks' events must not thundering-herd a parked waiter into
    re-fetching its own object over and over."""
    api, hub = be.api, be.hub
    be.make("stuck")
    fetches = []

    def fetch():
        fetches.append(1)
        return api.try_get("Notebook", "stuck", "d")

    def parked():
        hub.wait("d", "stuck", 0.8, fetch, lambda o: False)

    t = threading.Thread(target=parked)
    t.start()
    time.sleep(0.05)
    before = len(fetches)
    for i in range(30):
        be.make(f"sibling-{i}")
    be.drain()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert len(fetches) - before <= 2, \
        f"{len(fetches) - before} refetches caused by sibling events"


def test_event_during_fetch_is_not_lost(be):
    """The no-lost-wakeup property: a write landing between the
    waiter's fetch and its wait must bump the sequence snapshot and
    short-circuit the sleep — asserted by injecting the write from
    inside the fetch callback itself."""
    api, hub = be.api, be.hub
    nb = be.make("nb")
    baseline = _rv(nb)
    fired = threading.Event()

    def fetch():
        obj = api.try_get("Notebook", "nb", "d")
        if not fired.is_set():
            fired.set()
            # the racing write: lands AFTER this fetch's snapshot view
            nb["status"] = {"readyReplicas": 1}
            api.update_status(nb)
            be.drain()
        return obj

    def moved(obj):
        return obj is not None and _rv(obj) != baseline

    t0 = time.monotonic()
    obj, changed = hub.wait("d", "nb", 10.0, fetch, moved)
    dt = time.monotonic() - t0
    assert changed is True
    assert dt < 0.5 * _guard_tick(be), \
        f"lost wakeup: took {dt:.3f}s (guard tick recovered it)"


def test_too_old_overflow_wakes_all_waiters(be):
    """A fanout overflow (TOO_OLD) means state is unknown: every
    parked waiter must wake and re-evaluate its predicate promptly,
    not ride out the guard tick."""
    api, hub = be.api, be.hub
    be.make("nb")
    results = []

    def parked():
        seen = []

        def moved(obj):
            seen.append(1)
            return len(seen) > 1  # first check parks, re-check passes

        results.append(hub.wait("d", "nb", 10.0,
                                lambda: api.try_get("Notebook", "nb", "d"),
                                moved))

    t = threading.Thread(target=parked)
    t.start()
    time.sleep(0.05)
    t0 = time.monotonic()
    hub._on_event("TOO_OLD", {})
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert time.monotonic() - t0 < 0.5 * _guard_tick(be)
    assert results[0][1] is True


def test_hub_metrics_carry_jax_names_and_buckets():
    """The hub's two series in the port's registry under JAX's names,
    help texts and buckets (JAX: ``controlplane/metrics.py:237-249``)."""
    import math

    from kubeflow_rm_tpu.controlplane import metrics as jm
    from kubeflow_rm_tpu_torch.controlplane import metrics as pm

    jh, ph = jm.READINESS_WAKE_TO_OBSERVE_SECONDS, \
        pm.READINESS_WAKE_TO_OBSERVE_SECONDS
    assert ph.name == jh._name == "readiness_wake_to_observe_seconds"
    assert ph.documentation == jh._documentation
    assert list(ph.bounds) == [b for b in jh._upper_bounds]
    assert ph.bounds[-1] == math.inf
    jg, pg = jm.READINESS_WAITERS, pm.READINESS_WAITERS
    assert pg.name == jg._name == "readiness_waiters"
    assert pg.documentation == jg._documentation
    assert pg.kind == jg._type == "gauge"
