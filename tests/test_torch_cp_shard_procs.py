"""The port's shard processes on the CPU: ``ShardRunner`` with real
spawned workers (``shard/worker.shard_worker_main``), each the whole
shard stack in a process of its own — the apiserver on its WAL, the
cluster's admission, the fake kubelet, the REST facade on a fixed port
and the platform's manager under a leader election over a loopback
client. JAX tests its runner only inside its conformance harness; these
cases hold the port's on their own: every worker answers ``/healthz``
and holds its shard's lease, a create through the router lands on its
ring owner, a SIGKILLed shard comes back at the same port from its WAL
with the same uids and resourceVersions and no second pod, a split
admits a fresh process and a merge retires it with nothing lost, and
``stop()`` leaves no worker alive. Each test has its own time limit and
stops its runner in ``finally``.
"""

import contextlib
import os
import signal
import threading
import time
import urllib.request

import pytest

from kubeflow_rm_tpu_torch.controlplane import chaos, metrics
from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.controllers.statefulset import (
    make_gpu_node,
)
from kubeflow_rm_tpu_torch.controlplane.deploy.kubeclient import (
    KubeAPIServer,
    ShardedKubeAPIServer,
)
from kubeflow_rm_tpu_torch.controlplane.shard import worker
from kubeflow_rm_tpu_torch.controlplane.shard.elastic import (
    ElasticShardManager,
)
from kubeflow_rm_tpu_torch.controlplane.shard.runner import ShardRunner

ACC = "h100-80gb-1"


@contextlib.contextmanager
def time_limit(seconds: float):
    """Fail the test (through every ``finally`` it is in) once it has run
    ``seconds``."""
    def expire(signum, frame):
        raise TimeoutError(f"the test ran past its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    # a zombie still answers signal 0 until its parent reaps it
    with open(f"/proc/{pid}/stat") as f:
        return f.read().split(") ", 1)[1].startswith("Z")


@contextlib.contextmanager
def running(tmp_path, n=2, limit=120, tracing=False):
    """A started ``ShardRunner(n)``, stopped in ``finally``; every pid it
    ever had is dead afterwards."""
    with time_limit(limit):
        runner = ShardRunner(n, base_dir=str(tmp_path), manager_workers=2,
                             tracing=tracing)
        seen: set[int] = set()
        try:
            runner.start(timeout=90)
            seen |= set(runner.pids().values())
            yield runner, seen
        finally:
            seen |= set(runner.pids().values())
            runner.stop()
        assert all(_gone(pid) for pid in seen), \
            {p: _gone(p) for p in seen}


def _client(runner, shard):
    return KubeAPIServer(runner.urls[shard], cache_reads=False)


def _pod(name: str, ns: str) -> dict:
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"containers": [{"name": "c", "image": "img"}]}}


def _poll(fn, timeout_s: float, what: str):
    deadline = time.monotonic() + timeout_s
    while True:
        out = fn()
        if out:
            return out
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.05)


def test_workers_answer_healthz_hold_lease_and_log(tmp_path):
    """Each worker serves ``/healthz`` on its fixed port, its manager
    holds the shard's own lease (``controlplane-manager-<shard>``, holder
    ``<shard>-<pid>``), and its apiserver writes its WAL directory."""
    with running(tmp_path) as (runner, _):
        pids = runner.pids()
        assert sorted(pids) == ["shard-0", "shard-1"]
        for name, url in runner.urls.items():
            with urllib.request.urlopen(url + "/healthz", timeout=5) as r:
                assert r.status == 200 and r.read() == b"ok"

            def held(name=name):
                lease = _client(runner, name).try_get(
                    "Lease", f"controlplane-manager-{name}", "kubeflow")
                return lease and lease["spec"].get("holderIdentity") \
                    == f"{name}-{pids[name]}"
            _poll(held, 30, f"{name}'s lease")
            assert os.listdir(runner.wal_dir(name))
        assert worker.LEASE_DURATION_S == 3.0


def test_create_through_router_lands_on_its_owner(tmp_path):
    with running(tmp_path) as (runner, _):
        router = ShardedKubeAPIServer(runner.urls, retry_window_s=20)
        spaces = {}
        i = 0
        while len(spaces) < 2:
            ns = f"own-{i}"
            i += 1
            spaces.setdefault(router.shard_of("Pod", None, ns), ns)
        for owner, ns in spaces.items():
            router.ensure_namespace(ns)
            router.create(_pod("p0", ns))
            for shard in runner.names:
                got = _client(runner, shard).try_get("Pod", "p0", ns)
                assert (got is not None) == (shard == owner), (shard, ns)


def _spawn_on(runner, router, owner: str):
    """A namespace and a one-card node on ``owner``, and the notebook
    ``ft`` spawned there to Ready. Returns the namespace."""
    ns = next(f"nb-{i}" for i in range(100)
              if router.shard_of("Pod", None, f"nb-{i}") == owner)
    node = next(f"gpu-{i}" for i in range(100)
                if router.shard_of("Node", f"gpu-{i}", None) == owner)
    router.ensure_namespace(ns)
    router.create(make_gpu_node(node, ACC))
    router.create(nb_api.make_notebook("ft", ns, accelerator_type=ACC))
    cli = _client(runner, owner)
    _poll(lambda: (cli.get(nb_api.KIND, "ft", ns).get("status") or {})
          .get("readyReplicas") == 1, 60, "ft Ready")
    return ns


def test_kill_respawns_in_place_from_the_wal(tmp_path):
    """SIGKILL the notebook's shard: the watchdog respawns it at the same
    port from its WAL; the Notebook, StatefulSet and Pod come back with
    their uids and resourceVersions, no second pod is made, the death is
    counted, and the new process mints no uid its store already holds
    (C16)."""
    with running(tmp_path) as (runner, seen):
        router = ShardedKubeAPIServer(runner.urls, retry_window_s=20)
        owner = "shard-0"
        ns = _spawn_on(runner, router, owner)
        cli = _client(runner, owner)
        keys = ((nb_api.KIND, "ft"), ("StatefulSet", "ft"), ("Pod", "ft-0"))
        before = {k: cli.get(k, n, ns)["metadata"] for k, n in keys}
        held = {o["metadata"]["uid"] for kind in ("Namespace", "Node")
                for o in cli.list(kind)} | {
            o["metadata"]["uid"] for kind in ("Notebook", "StatefulSet",
                                              "Pod", "Service")
            for o in cli.list(kind, ns)}
        deaths = metrics.SHARD_DEATHS_TOTAL.get(shard=owner)
        port, pid = runner.urls[owner], runner.pids()[owner]
        runner.kill(owner)
        _poll(lambda: runner.pids()[owner] != pid, 10, "the respawn")
        seen.add(runner.pids()[owner])
        runner.wait_ready(60, names=[owner])
        assert runner.urls[owner] == port
        assert metrics.SHARD_DEATHS_TOTAL.get(shard=owner) == deaths + 1
        cli = _client(runner, owner)
        # the new manager takes the dead holder's lease once it expires
        _poll(lambda: (cli.try_get("Lease", f"controlplane-manager-{owner}",
                                   "kubeflow") or {}).get("spec", {}).get(
            "holderIdentity") == f"{owner}-{runner.pids()[owner]}",
            30, "the lease taken over")
        time.sleep(1.0)  # the manager's first resync over the store
        after = {k: cli.get(k, n, ns)["metadata"] for k, n in keys}
        for k in before:
            assert (after[k]["uid"], after[k]["resourceVersion"]) == \
                (before[k]["uid"], before[k]["resourceVersion"]), k
        pods = [p["metadata"]["uid"] for p in cli.list("Pod", ns)]
        assert pods == [before["Pod"]["uid"]]
        # host code only: a shard that has spawned, bound and recovered a
        # notebook has not loaded torch, so it can make no CUDA context
        for name, wpid in runner.pids().items():
            with open(f"/proc/{wpid}/maps") as f:
                assert "libtorch" not in f.read(), name
        made = router.create({"apiVersion": "v1", "kind": "ConfigMap",
                              "metadata": {"name": "after", "namespace": ns},
                              "data": {}})
        assert made["metadata"]["uid"] not in held


def _audit(runner, router, spaces, pods_per=2):
    """Every seeded pod reads back through the router and lives on its
    ring owner only (each shard read through its own client)."""
    clients = {s: _client(runner, s) for s in runner.names}
    for ns in spaces:
        owner = router.shard_of("Pod", None, ns)
        for j in range(pods_per):
            assert router.get("Pod", f"p-{j}", ns)
            for shard, cli in clients.items():
                got = cli.try_get("Pod", f"p-{j}", ns)
                assert (got is not None) == (shard == owner), (ns, shard)


def test_split_then_merge_moves_ranges_with_nothing_lost(tmp_path):
    """A split admits ``shard-2`` as a fresh process and hands it its
    range; a merge hands the range back and retires the process through
    the intentional-shutdown handshake (no death counted)."""
    with running(tmp_path) as (runner, seen):
        router = ShardedKubeAPIServer(runner.urls, retry_window_s=20)
        elastic = ElasticShardManager(runner, router)
        spaces = [f"sp-{i}" for i in range(8)]
        for ns in spaces:
            router.ensure_namespace(ns)
            for j in range(2):
                router.create(_pod(f"p-{j}", ns))
        assert elastic.split() == "shard-2"
        seen.add(runner.pids()["shard-2"])
        assert any(router.shard_of("Pod", None, ns) == "shard-2"
                   for ns in spaces)
        _audit(runner, router, spaces)
        deaths = metrics.SHARD_DEATHS_TOTAL.get(shard="shard-2")
        pid = runner.pids()["shard-2"]
        assert elastic.merge() == "shard-2"
        assert router.ring.members == ["shard-0", "shard-1"]
        assert runner.names == ["shard-0", "shard-1"]
        assert _gone(pid)
        _audit(runner, router, spaces)
        time.sleep(0.5)  # watchdog ticks: the exit is not a death
        assert metrics.SHARD_DEATHS_TOTAL.get(shard="shard-2") == deaths
        assert [e["op"] for e in elastic.events] == ["split", "merge"]


def test_stop_leaves_no_worker_alive(tmp_path):
    """``stop()`` after a respawn: neither the first nor the respawned
    process of any shard outlives it."""
    with running(tmp_path) as (runner, seen):
        pid = runner.pids()["shard-1"]
        runner.kill("shard-1")
        _poll(lambda: runner.pids()["shard-1"] != pid, 10, "the respawn")
        seen.add(runner.pids()["shard-1"])
        runner.wait_ready(60, names=["shard-1"])
    assert len(seen) == 3


def test_traced_workers_export_spans_and_a_kill_records_a_bundle(tmp_path):
    """Traced workers: a create made under a span of this process opens a
    server span in the owning shard, which ``/debug/traces`` serves under
    the shard's name as the child of this process's span. An
    ``Observer`` over the workers (``shard_urls``, ``liveness``, the
    watchdog's ``on_death``) federates every shard's ``/metrics`` under
    its ``instance``, and a SIGKILL records one ``shard_death`` bundle
    naming the shard and its exit code, whose slow traces merge this
    process's span with the shard's."""
    import json

    from kubeflow_rm_tpu_torch.controlplane import obs, tracing

    with running(tmp_path, tracing=True) as (runner, seen):
        router = ShardedKubeAPIServer(runner.urls, retry_window_s=20)
        observer = obs.Observer(
            interval_s=1.0, shard_urls=runner.urls,
            liveness=runner.liveness,
            run_meta=obs.build_run_meta("shard_procs", {"shards": 2}))
        runner.set_on_death(observer.on_shard_death)
        ns = "traced"
        owner = router.shard_of("Pod", None, ns)
        router.ensure_namespace(ns)
        tracing.set_enabled(True)
        tracing.set_process("coordinator")
        tracing.collector().clear()
        try:
            with tracing.start_span("test.create") as root:
                router.create(_pod("p0", ns))
                time.sleep(tracing.collector().slow_threshold_s)
            with urllib.request.urlopen(runner.urls[owner] + "/debug/traces",
                                        timeout=10) as r:
                body = json.loads(r.read())
            assert body["process"] == owner
            mine = [d for d in body["spans"]
                    if d["trace_id"] == root.trace_id]
            assert any(d["kind"] == "server"
                       and d["parent_id"] == root.span_id
                       and d["name"].startswith("POST ") for d in mine)
            assert body["slow"] == []   # the trace's root lives here

            # no tick before the death: the death's own tick is the
            # first sample, so shard-deaths cannot go critical and spend
            # the rate limit on an alert bundle first
            victim = "shard-1"
            pid = runner.pids()[victim]
            runner.kill(victim)
            _poll(lambda: [b for b in observer.flight.bundles()
                           if b["trigger"]["reason"] == "shard_death"],
                  30, "the shard_death bundle")
            seen.add(runner.pids()[victim])
            runner.wait_ready(60, names=[victim])
        finally:
            tracing.set_enabled(False)
            tracing.set_process("")
            tracing.collector().clear()
        (bundle,) = observer.flight.bundles()
        assert bundle["trigger"]["detail"] == {"shard": victim,
                                               "exitcode": -9}
        assert pid != runner.pids()[victim]
        assert {"metrics", "alerts", "slow_traces", "shard_liveness",
                "lockgraph", "run_meta"} <= set(bundle)
        # the survivor's series; the victim was down when it was scraped
        assert "shard-0" in {s["labels"].get("instance")
                             for s in bundle["metrics"]}
        assert bundle["shard_liveness"]["shard-0"] is True
        observer.tick()
        assert sorted(observer.tsdb.label_values(
            "workqueue_depth", "instance")) == ["shard-0", "shard-1"]
        (slow,) = [t for t in bundle["slow_traces"]
                   if t["trace_id"] == root.trace_id]
        assert "coordinator" in slow["processes"]
        assert owner in slow["processes"] or owner == victim
        assert sum(h["self_ms"] for h in slow["critical_path"]) == \
            pytest.approx(slow["duration_ms"], abs=1.0)
        assert observer.alerts()["flight"]["triggered_total"] == 1


class _FakeProc:
    def __init__(self, alive=True):
        self.alive, self.exitcode, self.pid = alive, None, None

    def is_alive(self):
        return self.alive

    def terminate(self):
        self.alive, self.exitcode = False, -15

    kill = terminate

    def join(self, timeout=None):
        pass


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_stop_waits_out_a_respawn_in_flight(pkg):
    """C15: the watchdog has begun respawning a dead shard when ``stop()``
    is called. The port's ``stop`` takes the watchdog's lock, so the new
    process is in its sweep and is stopped; JAX's sets its flag bare and
    returns at once, and the respawn lands after it, alive."""
    from tests.torch_cp_parity import cp_module

    with time_limit(60):
        runner = cp_module(pkg, "shard.runner").ShardRunner(
            1, wal=False, supervise=False)
        entered, go, born = threading.Event(), threading.Event(), []

        def spawn(name):
            entered.set()
            assert go.wait(30)
            born.append(_FakeProc())
            runner._procs[name] = born[-1]

        runner._spawn = spawn
        runner._procs["shard-0"] = _FakeProc(alive=False)
        wd = threading.Thread(target=runner._watchdog, daemon=True)
        wd.start()
        assert entered.wait(10)
        stopper = threading.Thread(target=runner.stop, daemon=True)
        stopper.start()
        stopper.join(2.0)  # JAX's returns here; the port's waits
        go.set()
        stopper.join(30)
        wd.join(30)
        assert not stopper.is_alive() and not wd.is_alive()
        assert len(born) == 1
        assert born[0].is_alive() == (pkg == "jax")


def test_zz_no_chaos_plan_left():
    assert chaos.active() is None
