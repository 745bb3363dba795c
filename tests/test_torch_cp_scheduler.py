"""Scheduler-cache and work-queue parity: the same node inventory and pod
stream through JAX's ``SchedulerCache`` and the port's give the same
binds, the same per-node usage, the same ``stats()`` and the same
gauges; the same adds, requeue-afters and failures through both
``WorkQueue``s hand items out in the same order with the same delays.
Each scenario is written once over a side (its resource key: JAX's
``google.com/tpu``, the port's ``nvidia.com/gpu``) and its trace
compared. (Counterparts of ``tests/test_scheduler.py``.)"""

import random

import pytest

from kubeflow_rm_tpu.controlplane import metrics as jax_metrics
from kubeflow_rm_tpu.controlplane import scheduler as jax_sched
from kubeflow_rm_tpu.controlplane.api import tpu as tpu_api
from kubeflow_rm_tpu.controlplane.apiserver import APIServer as JaxAPI
from kubeflow_rm_tpu.controlplane.ha import workqueue as jax_wq
from kubeflow_rm_tpu_torch.controlplane import metrics as port_metrics
from kubeflow_rm_tpu_torch.controlplane import scheduler as port_sched
from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer as PortAPI
from kubeflow_rm_tpu_torch.controlplane.ha import workqueue as port_wq
from tests.torch_cp_parity import (
    DEFAULT_SWITCHES, jax_switch_defaults, parity, stop_fanout,
)

GAUGES = ("SCHEDULER_FREE_CHIPS", "SCHEDULER_LARGEST_FREE_GANG",
          "SCHEDULER_FRAGMENTATION", "SCHEDULER_FREE_HBM_GIB",
          "SCHEDULER_ASSUMED_PODS")


class S:
    """One side: its cache module, apiserver, resource keys, gauges."""

    def __init__(self, pkg):
        jax = pkg == "jax"
        self.mod = jax_sched if jax else port_sched
        self.api = (JaxAPI if jax else PortAPI)()
        self.api.ensure_namespace("d")
        self.card = (tpu_api.GOOGLE_TPU_RESOURCE if jax
                     else gpu_api.NVIDIA_GPU_RESOURCE)
        self.mem = (tpu_api.GOOGLE_TPU_HBM_RESOURCE if jax
                    else gpu_api.NVIDIA_GPU_MEMORY_RESOURCE)
        self.ann = tpu_api.PREDICTED_HBM_ANNOTATION
        self.metrics = jax_metrics if jax else port_metrics
        self.cache = self.mod.SchedulerCache(self.api)
        self.trace = []

    def node(self, name, chips, cpu=0, hbm=0, labels=None, create=True):
        alloc = {self.card: str(chips)}
        if cpu:
            alloc["cpu"] = str(cpu)
        if hbm:
            alloc[self.mem] = str(hbm)
        node = {"apiVersion": "v1", "kind": "Node",
                "metadata": {"name": name, "labels": labels or {}},
                "status": {"allocatable": alloc, "capacity": alloc}}
        return self.api.create(node) if create else node

    def pod(self, name, chips=0, node=None, cpu=None, phase=None, rv=None,
            selector=None, hbm_gb=None, flops=None):
        req = {}
        if chips:
            req[self.card] = str(chips)
        if cpu:
            req["cpu"] = cpu
        pod = {"apiVersion": "v1", "kind": "Pod",
               "metadata": {"name": name, "namespace": "d"},
               "spec": {"containers": [{"name": "c", "resources": {
                   "requests": req}}]}}
        ann = {}
        if hbm_gb is not None:
            ann[self.ann] = str(hbm_gb)
        if flops is not None:
            ann[tpu_api.PREDICTED_FLOPS_ANNOTATION] = str(flops)
        if ann:
            pod["metadata"]["annotations"] = ann
        if node:
            pod["spec"]["nodeName"] = node
        if selector:
            pod["spec"]["nodeSelector"] = selector
        if phase:
            pod["status"] = {"phase": phase}
        if rv is not None:
            pod["metadata"]["resourceVersion"] = str(rv)
        return pod

    def gauges(self):
        out = {}
        for g in GAUGES:
            m = getattr(self.metrics, g)
            out[g] = (self.metrics.REGISTRY.get_sample_value(m._name)
                      if self.metrics is jax_metrics else m.get())
        return out

    def see(self, *nodes):
        """Record usage of ``nodes``, ``stats()`` and the gauges."""
        stats = self.cache.stats()
        self.trace.append(([self.cache.node_used(n) for n in nodes],
                           [self.cache.node_cpu_used(n) for n in nodes],
                           stats, self.gauges(),
                           self.cache.hbm_by_node()))


def incremental_events(x):
    x.node("n0", 8)
    x.cache.rebuild(x.api)
    pod = x.api.create(x.pod("p0", 4, node="n0"))
    x.cache.observe("ADDED", pod)
    x.see("n0")
    x.cache.observe("DELETED", pod)
    x.see("n0")


def terminal_phase_releases(x):
    x.node("n0", 8)
    x.cache.rebuild(x.api)
    pod = x.api.create(x.pod("p0", 4, node="n0"))
    x.cache.observe("ADDED", pod)
    pod["status"] = {"phase": "Failed"}
    x.cache.observe("MODIFIED", x.api.update_status(pod))
    x.see("n0")
    x.cache.rebuild(x.api)
    x.see("n0")


def stale_event_guard(x):
    x.node("n0", 8)
    x.cache.rebuild(x.api)
    x.cache.observe("ADDED", x.pod("p0", 4, node="n0", rv=7))
    x.cache.observe("MODIFIED", x.pod("p0", 4, rv=3))
    x.see("n0")


def too_old_relist(x):
    x.node("n0", 8)
    x.node("n1", 8)
    x.cache.rebuild(x.api)
    x.api.create(x.pod("p0", 4, node="n0"))
    x.api.create(x.pod("p1", 8, node="n1"))
    x.api.create(x.pod("gone", 4, node="n0", phase="Failed"))
    x.cache.observe("TOO_OLD", {})
    x.see("n0", "n1")
    x.trace.append(x.cache.gang_bind([x.pod("p2", 4)], allow_virtual=False))
    x.see("n0", "n1")


def assume_confirm_forget_release(x):
    x.node("n0", 8)
    x.node("n1", 8)
    x.cache.rebuild(x.api)
    x.trace.append(x.cache.gang_bind([x.pod("p0", 8)], allow_virtual=False))
    x.cache.rebuild(x.api)                   # the assumed bind survives
    x.see("n0", "n1")
    x.trace.append(x.cache.gang_bind([x.pod("p1", 4)], allow_virtual=False))
    x.cache.confirm(("d", "p1"), 9)
    x.cache.observe("MODIFIED", x.pod("p1", 4, rv=5))       # older: no-op
    x.cache.observe("MODIFIED", x.pod("p1", 4, node="n1", rv=9))
    x.see("n0", "n1")
    x.cache.forget(("d", "p0"))
    x.see("n0", "n1")
    x.cache.release(("d", "p1"))
    x.see("n0", "n1")


def gang_all_or_nothing(x):
    x.node("n0", 8)
    x.cache.rebuild(x.api)
    x.trace.append(x.cache.gang_bind([x.pod("g0", 8), x.pod("g1", 4)],
                                     allow_virtual=False))
    x.see("n0")


def best_fit_fragmentation(x):
    for i, chips in enumerate((8, 8, 8, 4)):
        x.node(f"n{i}", chips, labels={"pool": "a" if i < 2 else "b"})
    x.cache.rebuild(x.api)
    x.see("n0", "n1", "n2", "n3")
    for i, need in enumerate((4, 2, 2, 8, 1)):
        x.trace.append(x.cache.gang_bind([x.pod(f"p{i}", need)],
                                         allow_virtual=False))
        x.see("n0", "n1", "n2", "n3")
    x.trace.append(x.cache.gang_bind(
        [x.pod("s0", 4, selector={"pool": "b"}),
         x.pod("s1", 4, selector={"pool": "b"})], allow_virtual=False))
    x.trace.append(x.cache.gang_bind([x.pod("v", 0)], allow_virtual=True))
    x.trace.append(x.cache.gang_bind([x.pod("w", 8)], allow_virtual=True,
                                     exclude_nodes={"n0", "n1", "n2"}))
    x.see("n0", "n1", "n2", "n3")


def mixed_resources(x):
    x.node("gpu0", 8, cpu=8)
    x.node("cpu0", 0, cpu=16)
    x.cache.rebuild(x.api)
    x.trace.append(x.cache.gang_bind(
        [x.pod("actor-0", cpu="6"), x.pod("actor-1", cpu="6"),
         x.pod("actor-2", cpu="6"), x.pod("learner-0", 8, cpu="500m")],
        allow_virtual=False))
    x.see("gpu0", "cpu0")
    # a partial fit on either axis rolls back both
    x.trace.append(x.cache.gang_bind(
        [x.pod("a-0", cpu="8"), x.pod("l-0", 4)], allow_virtual=False))
    x.see("gpu0", "cpu0")


def hbm_packing(x):
    x.node("n0", 4, hbm=320)
    x.node("n1", 4, hbm=320)
    x.cache.rebuild(x.api)
    pods = [x.pod(f"d{i}", 4, hbm_gb=60, flops=1e15 * (i + 1))
            for i in range(6)]
    for p in pods:
        x.trace.append(x.cache.gang_bind([p], allow_virtual=False))
        x.see("n0", "n1")
    x.trace.append(x.cache.gang_bind([x.pod("undeclared", 4)],
                                     allow_virtual=False))
    x.see("n0", "n1")


SCENARIOS = [incremental_events, terminal_phase_releases, stale_event_guard,
             too_old_relist, assume_confirm_forget_release,
             gang_all_or_nothing, best_fit_fragmentation, mixed_resources,
             hbm_packing]


@pytest.mark.parametrize("packing", [False, True], ids=["chips", "hbm"])
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_scheduler_cache_parity(parity, scenario, packing):
    parity.setattr(jax_sched, "_hbm_packing", packing)
    parity.setattr(port_sched, "_hbm_packing", packing)
    sides = [S("port"), S("jax")]
    try:
        for x in sides:
            scenario(x)
        assert sides[0].trace == sides[1].trace
        assert sides[0].trace
    finally:
        for x in sides:
            stop_fanout(x.api)


def test_hbm_packing_overcommits_chips_not_memory(parity):
    """The packing arm: declared pods share chips up to the overcommit
    bound while the memory axis stays within capacity."""
    parity.setattr(port_sched, "_hbm_packing", True)
    x = S("port")
    try:
        hbm_packing(x)
        used, _, stats, _, hbm = x.trace[-1]
        assert max(used) > 4
        assert all(u <= c + 1e-4 for u, c in hbm.values())
    finally:
        stop_fanout(x.api)


def test_cache_for_registers_one_cache_per_backend(parity):
    for mod, api_cls in ((port_sched, PortAPI), (jax_sched, JaxAPI)):
        api = api_cls()
        try:
            assert mod.cache_for(api) is mod.cache_for(api)
        finally:
            stop_fanout(api)


# ---- the work queue --------------------------------------------------

def queue_script(mod, metrics):
    t = [0.0]
    terminal = []
    q = mod.WorkQueue(
        "parity-q", clock=lambda: t[0],
        backoff=mod.ExponentialBackoff(rng=random.Random(7)),
        conflict_backoff=mod.ExponentialBackoff(
            base_delay_s=0.002, max_delay_s=0.1, rng=random.Random(8)),
        max_retries=2, max_conflict_retries=3, max_concurrent=2,
        on_terminal=terminal.append)
    out = []

    def gauge(series, **labels):
        m = getattr(metrics, series)
        if metrics is jax_metrics:
            return metrics.REGISTRY.get_sample_value(m._name, labels)
        return m.get(**labels)

    def snap(tag):
        out.append((tag, q.depth(), q.snapshot(), q.next_due(),
                    gauge("WORKQUEUE_DEPTH", name="parity-q"),
                    gauge("WORKQUEUE_NAMESPACE_DEPTH", name="parity-q",
                          namespace="ns1")))

    class Req(tuple):
        namespace = property(lambda self: self[0])

    a, b, c, d = (Req(("ns1", n)) for n in "abcd")
    for item in (b, a, c, a, d):
        q.add(item)
    snap("added")
    got = q.pop_ready()
    snap(("popped", tuple(got)))
    q.add(got[0])                       # re-added while processing: dirty
    out.append(("done", q.done(got[0]), q.done(got[1])))
    snap("after-done")
    # each backoff delay, seen through next_due: the requeue is handed
    # out (a deterministic drain promotes it) before the next failure
    for item, conflict, tries in ((c, False, 3), (d, True, 4)):
        for _ in range(tries):
            ok = q.add_rate_limited(item, conflict=conflict)
            out.append(("rl", item, ok, q.next_due()))
            out.append(("drain", [(x, q.done(x))
                                  for x in q.pop_ready(ignore_backoff=True)]))
    out.append(("terminal", list(terminal)))
    q.add_after(Req(("ns2", "later")), 5.0)
    q.add_rate_limited(a)
    snap("limited")
    out.append(("ready-backoff", tuple(q.pop_ready(ignore_backoff=True))))
    t[0] = 6.0
    out.append(("ready-time", tuple(q.pop_ready(limit=1))))
    q.forget(c)
    snap("end")
    return out


def test_workqueue_parity():
    port = queue_script(port_wq, port_metrics)
    jax = queue_script(jax_wq, jax_metrics)
    assert port == jax
    assert ("terminal", [("ns1", "c"), ("ns1", "d")]) in port


def test_zz_jax_switches_hold_defaults():
    """Run last in this file: no test above left a switch changed."""
    assert jax_switch_defaults() == DEFAULT_SWITCHES
