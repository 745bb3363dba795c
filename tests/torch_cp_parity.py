"""Helpers of the control-plane parity tests: the same stack built from
each package's public classes (the spawn path alone, or — the ``full``
arm — each package's own ``make_control_plane`` with the same clock and
culling probe), one script of API calls run on both, the whole object
graph dumped from each server, and the fixed TPU→GPU key map that is
the only intended difference between them.

Both sides run JAX's default arm, oversubscription on (idle suspension,
preemption and active defragmentation live), and both write children
serially (``runtime.set_serial_writes(True)``): the parallel fan-out
hands out uids and resourceVersions in thread order, so only the serial
arm is comparable byte for byte. Every switch and the uid
counters are set through ``monkeypatch``-style restores, and every
watch-fanout thread a stack started is joined before the test ends.
"""

from __future__ import annotations

import functools
import importlib
import itertools
import json
import secrets

import pytest

from kubeflow_rm_tpu.controlplane import apiserver as jax_apiserver
from kubeflow_rm_tpu.controlplane import runtime as jax_runtime
from kubeflow_rm_tpu.controlplane import scheduler as jax_scheduler
from kubeflow_rm_tpu.controlplane import suspend as jax_suspend
from kubeflow_rm_tpu.controlplane.api import meta as jax_meta
from kubeflow_rm_tpu.controlplane.api import tpu as tpu_api
from kubeflow_rm_tpu_torch.controlplane import apiserver as port_apiserver
from kubeflow_rm_tpu_torch.controlplane import runtime as port_runtime
from kubeflow_rm_tpu_torch.controlplane import scheduler as port_scheduler
from kubeflow_rm_tpu_torch.controlplane import suspend as port_suspend
from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api
from kubeflow_rm_tpu_torch.controlplane.api import meta as port_meta

from tests.cp_fixtures import FakeClock

NS = "user1"

# ---- the key map ------------------------------------------------------

#: slice types: JAX's → the port's, same card count per host and hosts
SLICE_MAP = {
    "v5litepod-1": "h100-80gb-1",
    "v5p-8": "h100-80gb-4",
    "v5litepod-8": "h100-80gb-8",
    "v5p-16": "h100-80gb-2x4",
}
#: resource and node-label keys
KEY_MAP = {
    tpu_api.GOOGLE_TPU_RESOURCE: gpu_api.NVIDIA_GPU_RESOURCE,
    tpu_api.GOOGLE_TPU_HBM_RESOURCE: gpu_api.NVIDIA_GPU_MEMORY_RESOURCE,
    tpu_api.NODE_LABEL_ACCELERATOR: gpu_api.NODE_LABEL_ACCELERATOR,
    tpu_api.NODE_LABEL_TOPOLOGY: gpu_api.NODE_LABEL_TOPOLOGY,
}


#: slice types mapped one way only (JAX's → the port's) beside
#: :data:`SLICE_MAP`: a v5e host of 4 chips, on which a ``v5litepod-1``
#: fits as a ``h100-80gb-1`` fits on a 4-card host (the compaction case)
EXTRA_SLICES = {"v5litepod-4": "h100-80gb-4"}


def _value_maps() -> tuple[dict, dict]:
    """(exact string values, memory quantities by host): the slice
    types, the GKE accelerator and topology label values, and each
    host's memory quantity."""
    both = {**SLICE_MAP, **EXTRA_SLICES}
    values, memory = dict(both), {}
    for jname, pname in both.items():
        j, p = tpu_api.lookup(jname), gpu_api.lookup(pname)
        assert (j.chips, j.hosts) == (p.cards, p.hosts), (jname, pname)
        values[j.gke_accelerator] = p.gke_accelerator
        values.setdefault(j.topology, p.topology)
        assert values[j.topology] == p.topology
        assert memory.setdefault(str(j.hbm_gib_per_host),
                                 str(p.hbm_gib_per_host)) == str(
                                     p.hbm_gib_per_host), jname
    return values, memory


VALUE_MAP, MEMORY_MAP = _value_maps()


#: Event, status and log text: JAX's words → the port's
TEXT_MAP = {
    f"free {tpu_api.GOOGLE_TPU_RESOURCE} ":
        f"free {gpu_api.NVIDIA_GPU_RESOURCE} ",
    "TPU slice unhealthy (": "GPU slice unhealthy (",
    # the status ladder's suspended message (webapps/status.py)
    "its TPU slice was released.": "its GPU slice was released.",
    # the fake kubelet's boot transcript (a pod's logs)
    " joining jax.distributed": " joining torch.distributed",
}


def _slice_policy(np_obj: dict) -> None:
    """A multi-host slice's NetworkPolicy as the port renders it: JAX's
    opens the TPU's ICI/``jax.distributed`` ports (8471, 8476) between
    the slice's pods; the port's admits them on every port (NCCL's are
    ephemeral), so its rule has no ``ports`` list."""
    for rule in (np_obj.get("spec") or {}).get("ingress") or []:
        rule.pop("ports", None)


def key_map(obj):
    """A JAX object (or dump) as the port renders it: resource and label
    keys, slice-type/label values, the memory quantity under the memory
    key, the words of Event messages (:data:`TEXT_MAP`) and a slice's
    NetworkPolicy (:func:`_slice_policy`)."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            nk = KEY_MAP.get(k, k)
            if k == tpu_api.GOOGLE_TPU_HBM_RESOURCE and isinstance(v, str):
                out[nk] = MEMORY_MAP[v]
            else:
                out[nk] = key_map(v)
        if out.get("kind") == "NetworkPolicy" and str(
                (out.get("metadata") or {}).get("name", "")).endswith(
                    "-slice-np"):
            _slice_policy(out)
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(key_map(v) for v in obj)
    if isinstance(obj, str):
        if obj in VALUE_MAP:
            return VALUE_MAP[obj]
        if obj[:1] in ("[", "{"):
            # a JSON-valued annotation (a gang's roles): mapped inside,
            # written back in the controllers' compact form
            try:
                parsed = json.loads(obj)
            except ValueError:
                parsed = None
            if parsed is not None and key_map(parsed) != parsed:
                return json.dumps(key_map(parsed), separators=(",", ":"))
        for old, new in TEXT_MAP.items():
            obj = obj.replace(old, new)
        return obj
    return obj


# ---- the two stacks -------------------------------------------------


class FakeJupyter:
    """The culler's injectable ``/api/kernels`` probe (one a side, on
    that side's clock); ``kernels = None`` plays both endpoints
    unreachable."""

    def __init__(self, clock):
        self.clock = clock
        self.kernels = []

    def activity(self, when=None, busy=False):
        ts = (when or self.clock()).isoformat()
        self.kernels = [{"execution_state": "busy" if busy else "idle",
                         "last_activity": ts}]

    def __call__(self, notebook, pod0):
        if self.kernels is None:
            return None
        return {"kernels": list(self.kernels), "terminals": []}


class Side:
    """One package's stack plus the names a script needs. The default is
    the spawn path alone (no pricer: JAX's walks no 7B on jax 0.9, so
    neither side wires one). ``full=True`` is each package's own
    ``make_control_plane(clock, cache=cached)`` — every webhook and
    controller, the pricer inert without a declared workload — and
    ``culling`` (the culler's settings) adds the culler with this
    side's :class:`FakeJupyter` as its probe; ``suspend`` (the suspend
    controller's settings) adds the suspend/resume and failover
    controllers (``enable_suspend=True``), each side on a fresh
    in-memory state store unless the settings name a ``store``.
    ``cached`` puts the manager on the informer cache (JAX's
    ``Manager(CachedAPI(api))`` on the spawn path)."""

    def __init__(self, pkg: str, *, cached: bool = False,
                 global_lock: bool = False, auto_ready: bool = True,
                 full: bool = False, culling: dict | None = None,
                 suspend: dict | None = None):
        self.pkg = pkg
        self.root = ("kubeflow_rm_tpu" if pkg == "jax"
                     else "kubeflow_rm_tpu_torch")
        self.clock = FakeClock()
        self.jupyter = FakeJupyter(self.clock)
        if pkg == "jax":
            from kubeflow_rm_tpu.controlplane.api import notebook as nb
            from kubeflow_rm_tpu.controlplane.api import tpujob as tj
            from kubeflow_rm_tpu.controlplane.apiserver import APIServer
            from kubeflow_rm_tpu.controlplane.controllers import (
                notebook as nbc,
            )
            from kubeflow_rm_tpu.controlplane.controllers import (
                statefulset as stc,
            )
            from kubeflow_rm_tpu.controlplane.runtime import Manager
            from kubeflow_rm_tpu.controlplane.webhook.tpu_inject import (
                TpuInjectWebhook as Inject,
            )
            self.make_node = stc.make_tpu_node
            self.acc = {v: k for k, v in SLICE_MAP.items()}
            self.topo = tpu_api.lookup
            self.card_key = tpu_api.GOOGLE_TPU_RESOURCE
        else:
            from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb
            from kubeflow_rm_tpu_torch.controlplane.api import tpujob as tj
            from kubeflow_rm_tpu_torch.controlplane.apiserver import (
                APIServer,
            )
            from kubeflow_rm_tpu_torch.controlplane.controllers import (
                notebook as nbc,
            )
            from kubeflow_rm_tpu_torch.controlplane.controllers import (
                statefulset as stc,
            )
            from kubeflow_rm_tpu_torch.controlplane.runtime import Manager
            from kubeflow_rm_tpu_torch.controlplane.webhook.gpu_inject import (
                GpuInjectWebhook as Inject,
            )
            self.make_node = stc.make_gpu_node
            self.acc = {v: v for v in SLICE_MAP.values()}
            self.topo = gpu_api.lookup
            self.card_key = gpu_api.NVIDIA_GPU_RESOURCE
        self.nb_api, self.tj_api = nb, tj
        self.suspend = self.m("suspend")
        if full:
            if suspend is not None:
                self.suspend.set_state_store(
                    self.suspend.InMemoryStateStore())
            make = self.m("").make_control_plane
            self.api, self.mgr = make(
                self.clock, auto_ready=auto_ready, cache=cached,
                global_lock=global_lock,
                enable_culling=culling is not None,
                culler_config=culling and dict(culling,
                                               probe_fn=self.jupyter),
                enable_suspend=suspend is not None,
                suspend_config=suspend)
            return
        self.api = APIServer(self.clock, global_lock=global_lock)
        self.api.register_validator(nb.KIND, nb.validate)
        self.api.register_validator(tj.KIND, tj.validate)
        Inject(self.api).register()
        if cached:
            from kubeflow_rm_tpu.controlplane.cache import CachedAPI
            self.mgr = Manager(CachedAPI(self.api))
        else:
            self.mgr = Manager(self.api)
        self.mgr.add(nbc.NotebookController())
        self.mgr.add(stc.StatefulSetController(auto_ready=auto_ready))
        self.mgr.add(stc.DeploymentController(auto_ready=auto_ready))

    def m(self, name: str):
        """This side's ``controlplane`` module ``name`` (dotted, e.g.
        ``"api.profile"``; ``""`` for the package)."""
        return importlib.import_module(
            f"{self.root}.controlplane" + (f".{name}" if name else ""))

    def slice(self, port_type: str) -> str:
        """This side's name of a slice type (given by its port name)."""
        return self.acc[port_type]

    def node(self, name: str, port_type: str) -> dict:
        return self.api.create(self.make_node(name, self.slice(port_type)))

    def notebook(self, name: str, port_type: str | None = None, **kw):
        return self.nb_api.make_notebook(
            name, NS, accelerator_type=port_type and self.slice(port_type),
            **kw)

    def run(self) -> int:
        return self.mgr.run_until_idle()

    def dump(self) -> dict:
        """Every object of every kind, as the server lists them."""
        self.api.drain_watchers()
        kinds = sorted(set(self.api._by_kind))
        return {k: self.api.list(k) for k in kinds}

    def close(self) -> None:
        stop_fanout(self.api)


def stop_fanout(api) -> None:
    """Join every watch-fanout thread of ``api`` (each exits at once
    when its idle wait is set to zero and it is woken)."""
    for ch in list(getattr(api, "_channels", ())):
        ch.IDLE_EXIT_S = 0.0
        with ch._cond:
            thread = ch._thread
            ch._cond.notify_all()
        if thread is not None:
            thread.join(timeout=30)
            assert not thread.is_alive(), f"fanout thread {ch.name} lives"


def isolate(monkeypatch) -> None:
    """Fresh uid counters on both sides (both servers hand out the same
    uids for the same script), both sides on the oversubscribe-on arm
    with a fresh in-memory state store each, serial child writes on
    both sides, and a fixed OAuth cookie secret (the auth companion
    draws one from ``secrets``); every change undone at teardown."""
    monkeypatch.setattr(jax_meta, "_uid_counter", itertools.count(1))
    monkeypatch.setattr(port_meta, "_uid_counter", itertools.count(1))
    monkeypatch.setattr(jax_suspend, "_oversubscribe", True)
    monkeypatch.setattr(port_suspend, "_oversubscribe", True)
    monkeypatch.setattr(jax_suspend, "_state_store",
                        jax_suspend.InMemoryStateStore())
    monkeypatch.setattr(port_suspend, "_state_store",
                        port_suspend.InMemoryStateStore())
    monkeypatch.setattr(jax_runtime, "_serial_writes", True)
    monkeypatch.setattr(port_runtime, "_serial_writes", True)
    monkeypatch.setattr(secrets, "token_urlsafe",
                        lambda nbytes=None: "cookie-secret")


@pytest.fixture
def parity(monkeypatch):
    """:func:`isolate`, and each package's lazily built thread pools
    (bulk admission, child fan-out) private to the test: any the test
    built are shut down, and the process's own put back, at teardown."""
    isolate(monkeypatch)
    pools = ((jax_apiserver, "_admission_pool"),
             (port_apiserver, "_admission_pool"),
             (jax_runtime, "_child_pool"), (port_runtime, "_child_pool"))
    for mod, attr in pools:
        monkeypatch.setattr(mod, attr, None)
    yield monkeypatch
    for mod, attr in pools:
        pool = getattr(mod, attr)
        if pool is not None:
            pool.shutdown(wait=True)


def reset_uids(monkeypatch) -> None:
    """Both uid counters back to 1 (before the next side's script)."""
    monkeypatch.setattr(jax_meta, "_uid_counter", itertools.count(1))
    monkeypatch.setattr(port_meta, "_uid_counter", itertools.count(1))


def jax_switch_defaults() -> dict:
    """JAX's process-wide switches, which no port test may leave
    changed."""
    from kubeflow_rm_tpu.controlplane import chaos, tracing
    return {
        "oversubscribe": jax_suspend.oversubscribe(),
        "hbm_packing": jax_scheduler.hbm_packing(),
        "legacy_scan": jax_scheduler.legacy_scan(),
        "serial_writes": jax_runtime.serial_writes(),
        "chaos_plan": chaos.active(),
        "tracing": tracing.enabled(),
        "port_oversubscribe": port_suspend.oversubscribe(),
        "port_hbm_packing": port_scheduler.hbm_packing(),
        "port_legacy_scan": port_scheduler.legacy_scan(),
        "port_serial_writes": port_runtime.serial_writes(),
    }


#: what :func:`jax_switch_defaults` reads in a fresh process
DEFAULT_SWITCHES = {
    "oversubscribe": True, "hbm_packing": False, "legacy_scan": False,
    "serial_writes": False, "chaos_plan": None, "tracing": False,
    "port_oversubscribe": True, "port_hbm_packing": False,
    "port_legacy_scan": False, "port_serial_writes": False,
}


def canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, indent=1)


def run_full(monkeypatch, script, *, culling=None, arms=("cached",),
             global_lock=False, suspend=None, normalize=None):
    """Run ``script(S)`` on each package's full stack with the same uids:
    the port's once for each of ``arms`` (``"cached"``: the informer
    cache, JAX's default; ``"raw"``: ``cache=False``), JAX's on its
    default cached arm; every port arm's result and object graph must
    equal JAX's after the key map. Returns (the port's result, its
    dump). ``monkeypatch`` is the ``parity`` fixture's. ``global_lock``
    runs both on the apiserver's synchronous-delivery arm: a script that
    deletes and re-creates a pod inside one drain needs it, since JAX's
    cache drops the re-created pod when the old one's delete reaches it
    late (C11) and the port's keeps it, so the order in which the watch
    thread delivers would decide whether the graphs agree. ``suspend``
    is :class:`Side`'s; ``normalize(dump)`` (optional) rewrites what a
    script leaves that is not deterministic (a wall-clock time in an
    Event message) before the graphs are compared."""
    sides, outs = [], []
    try:
        for pkg, arm in [("port", a) for a in arms] + [("jax", "cached")]:
            reset_uids(monkeypatch)
            S = Side(pkg, full=True, cached=arm == "cached",
                     culling=culling, global_lock=global_lock,
                     suspend=suspend)
            sides.append(S)
            out = script(S)
            dump = S.dump()
            if normalize is not None:
                dump = normalize(dump)
            if pkg == "jax":
                out, dump = key_map(out), key_map(dump)
            outs.append((pkg, arm, out, dump))
        _, _, want_out, want_dump = outs[-1]
        for pkg, arm, out, dump in outs[:-1]:
            assert out == want_out, arm
            assert sorted(dump) == sorted(want_dump), arm
            for kind in want_dump:
                assert canon(dump[kind]) == canon(want_dump[kind]), \
                    (arm, kind)
        return outs[0][2], outs[0][3]
    finally:
        for S in sides:
            S.close()


# ---- the deployed layout (``deploy/``) ---------------------------------

#: the manifests' module names: JAX's → the port's (the processes the
#: port's manifests start, and the liveness probe's import)
MODULE_MAP = {
    "kubeflow_rm_tpu.controlplane": "kubeflow_rm_tpu_torch.controlplane",
    "import kubeflow_rm_tpu": "import kubeflow_rm_tpu_torch",
}


def module_map(obj):
    """A JAX manifest as the port renders it: :data:`MODULE_MAP` on every
    string, then :func:`key_map`."""
    def rename(o):
        if isinstance(o, dict):
            return {k: rename(v) for k, v in o.items()}
        if isinstance(o, list):
            return [rename(v) for v in o]
        return MODULE_MAP.get(o, o) if isinstance(o, str) else o
    return key_map(rename(obj))


def drop_enums(obj):
    """A CRD without its ``acceleratorType`` enums: each package's comes
    from its own topology table (checked against it on its own)."""
    if isinstance(obj, dict):
        out = {k: drop_enums(v) for k, v in obj.items()}
        acc = out.get("acceleratorType")
        if isinstance(acc, dict):
            acc.pop("enum", None)
        return out
    if isinstance(obj, list):
        return [drop_enums(v) for v in obj]
    return obj


def cp_module(pkg: str, name: str):
    """``pkg``'s (``"port"``/``"jax"``) ``controlplane`` module ``name``."""
    root = "kubeflow_rm_tpu" if pkg == "jax" else "kubeflow_rm_tpu_torch"
    return importlib.import_module(
        f"{root}.controlplane" + (f".{name}" if name else ""))


class RestCluster:
    """One package's in-memory apiserver behind its REST facade
    (``deploy.restserver.RestServer`` on 127.0.0.1): a cluster without a
    cluster. ``admission`` registers the cluster's admission (the
    Notebook and PodDefault validators; the notebook, PodDefault and
    slice-injection webhooks), ``kubelet`` its fake kubelet (a Manager
    with the StatefulSet and Deployment controllers, ``auto_ready``).
    :meth:`restart` is a shard's restart in place: the server stops, the
    store closes, a new apiserver recovers from the same ``wal_dir`` and
    a new facade binds the same port. :meth:`close` stops everything."""

    def __init__(self, pkg: str, *, clock=None, shard: str | None = None,
                 wal_dir: str | None = None, admission: bool = False,
                 kubelet: bool = False):
        self.pkg = pkg
        self.clock = clock
        self.shard, self.wal_dir = shard, wal_dir
        self.admission, self.with_kubelet = admission, kubelet
        self.api = self.kubelet = self.rest = None
        self._boot(0)

    def _boot(self, port: int) -> None:
        m = functools.partial(cp_module, self.pkg)
        kw = {"clock": self.clock} if self.clock else {}
        if self.shard:
            kw["shard"] = self.shard
        if self.wal_dir:
            kw["wal_dir"] = self.wal_dir
        self.api = m("apiserver").APIServer(**kw)
        if self.admission:
            for name in ("notebook", "poddefault"):
                api_mod = m(f"api.{name}")
                self.api.register_validator(api_mod.KIND, api_mod.validate)
            m("webhook.notebook").NotebookWebhook(self.api).register()
            m("webhook.poddefault").PodDefaultWebhook(self.api).register()
            if self.pkg == "jax":
                inject = m("webhook.tpu_inject").TpuInjectWebhook
            else:
                inject = m("webhook.gpu_inject").GpuInjectWebhook
            inject(self.api).register()
        if self.with_kubelet:
            stc = m("controllers.statefulset")
            self.kubelet = m("runtime").Manager(self.api)
            self.kubelet.add(stc.StatefulSetController(auto_ready=True))
            self.kubelet.add(stc.DeploymentController(auto_ready=True))
        self.rest = m("deploy.restserver").RestServer(self.api, port=port)
        self.port = self.rest.start()
        self.url = self.rest.url

    def restart(self) -> None:
        self.rest.stop()
        self._close_api()
        self._boot(self.port)

    def _close_api(self) -> None:
        if self.wal_dir:
            self.api.close_persistence()
        stop_fanout(self.api)

    def close(self) -> None:
        self.rest.stop()
        self._close_api()
