"""Incremental scheduler cache: kube-scheduler assume/bind for card slices
(counterpart of ``kubeflow_rm_tpu/controlplane/scheduler.py``; the chip
axis reads ``nvidia.com/gpu``, the memory axis the port's card-memory
resource, :mod:`.api.gpu`).

The fake kubelet in ``controllers/statefulset.py`` used to recompute
per-node chip usage by scanning EVERY Pod in the cluster under one
global bind lock on every StatefulSet reconcile — O(pods) per reconcile,
O(pods²) aggregate under the 20-way spawn storm. This module replaces
that with what kube-scheduler actually does (``scheduler/cache/cache.go``):

- an informer-fed usage map, updated O(Δ) from Pod/Node watch events,
  with per-pod resourceVersion guards so stale events can't unwind a
  newer accounting state;
- **assume/bind**: a bind is charged to the cache synchronously at
  decision time (before the apiserver write), then *confirmed* with the
  write's resourceVersion or *forgotten* on failure — so two concurrent
  reconciles can never double-commit the same chips no matter how far
  the watch stream lags;
- **gang-bind**: a whole slice's pods are placed all-or-nothing under
  per-node locks (sorted acquisition), the scheduling unit a TPU slice
  actually is — no rump slices holding chips while the jax rendezvous
  waits forever;
- **relist rebuild**: a ``TOO_OLD`` overflow sentinel marks the cache
  stale and the next scheduling attempt rebuilds it from a fresh
  snapshot, preserving in-flight assumed pods (kube-scheduler keeps its
  assumed set across relists for the same reason).

Terminal pods (``Succeeded``/``Failed``) hold no capacity — a failed
host frees its chips the moment its status event lands, where the old
full scan leaked them forever (the r10 satellite bugfix).

The cache is **mixed-resource** (r11, multi-role gang jobs): every node
tracks chips AND CPU, and ``gang_bind`` places heterogeneous gangs — a
learner slice's chip pods co-bound with CPU-only actor pods in one
assume transaction. CPU-only pods never touch chip accounting, chip
pods without CPU requests never touch CPU accounting, and a partial
fit still rolls back to zero assumed binds across BOTH resources.
"""

from __future__ import annotations

import threading
import time
import weakref

from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    deep_get,
    labels_of,
    matches_selector,
    name_of,
    namespace_of,
    parse_quantity,
)
from kubeflow_rm_tpu_torch.controlplane.api.gpu import (
    NVIDIA_GPU_MEMORY_RESOURCE,
    NVIDIA_GPU_RESOURCE,
    PREDICTED_FLOPS_ANNOTATION,
    PREDICTED_HBM_ANNOTATION,
)
from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock

#: phases whose pods no longer occupy their node's chips (a kubelet
#: frees the device plugin allocation when the pod reaches a terminal
#: phase; only the DELETE frees the name)
TERMINAL_PHASES = ("Succeeded", "Failed")

#: the hermetic fallback node for selector-less CPU pods (tests with no
#: Node inventory); never capacity-tracked
VIRTUAL_NODE = "virtual-node"

#: entry.rv sentinel while a bind is assumed but its write's rv is not
#: yet known — compares newer than every real resourceVersion
_ASSUMED = float("inf")


#: the second tracked resource (mixed-resource gangs): CPU cores,
#: parsed with millicore support ("500m" → 0.5)
CPU_RESOURCE = "cpu"

#: bounded chip overcommit under ``--hbm-packing``: a pod that DECLARED
#: its workload (so the jaxcheck walker priced its HBM) may share a
#: node's chips up to this multiple of the physical chip count — the
#: HBM axis, which is what actually OOMs, is never overcommitted.
#: Undeclared chip pods stay strictly chip-bounded AND charge their
#: full per-chip HBM share, so the two populations can't starve each
#: other invisibly.
CHIP_OVERCOMMIT = 4.0

#: float-sum slack on the HBM axis (GiB): 64 pods × a 4-decimal
#: annotation round each way stays far under this
_HBM_EPS = 1e-4

_hbm_packing = False


def set_hbm_packing(enabled: bool) -> None:
    """Enable predicted-HBM as the second gang-packing axis (the
    ``--hbm-packing`` conformance arm). Off (default) = chip-count-only
    admission, the A/B baseline."""
    global _hbm_packing
    _hbm_packing = bool(enabled)


def hbm_packing() -> bool:
    return _hbm_packing


def _pod_resource(pod: dict, resource: str) -> float:
    """Amount of ``resource`` a pod occupies: requests defaulting to
    limits (the kube quota convention — mirrors
    ``statefulset._pod_tpu_request``)."""
    total = 0.0
    for c in deep_get(pod, "spec", "containers", default=[]) or []:
        amount = deep_get(c, "resources", "requests", resource)
        if amount is None:
            amount = deep_get(c, "resources", "limits", resource)
        if amount is not None:
            total += parse_quantity(amount)
    return total


def _pod_chips(pod: dict) -> float:
    return _pod_resource(pod, NVIDIA_GPU_RESOURCE)


def _pod_cpu(pod: dict) -> float:
    return _pod_resource(pod, CPU_RESOURCE)


def _pod_declared_hbm_gib(pod: dict) -> float | None:
    """The webhook-priced per-pod HBM share (decimal GB annotation →
    GiB), or None when the pod carries no declaration."""
    raw = deep_get(pod, "metadata", "annotations",
                   PREDICTED_HBM_ANNOTATION)
    if raw is None:
        return None
    try:
        gb = float(raw)
    except (TypeError, ValueError):
        return None
    if gb < 0:
        return None
    return gb * 1e9 / 2**30


def _pod_flops(pod: dict) -> float:
    """Predicted FLOPs/step (the packing tiebreak); 0 when undeclared."""
    raw = deep_get(pod, "metadata", "annotations",
                   PREDICTED_FLOPS_ANNOTATION)
    try:
        return max(0.0, float(raw))
    except (TypeError, ValueError):
        return 0.0


def _hbm_charge(declared: float | None, chips: float,
                hbm_capacity: float, capacity: float) -> float:
    """What a pod charges on a node's HBM axis: its declared share, or
    — undeclared chip pod — the full per-chip HBM slice of that node
    (it may use every byte, so it must be accounted as if it will)."""
    if declared is not None:
        return declared
    if chips > 0 and capacity > 0 and hbm_capacity > 0:
        return chips * hbm_capacity / capacity
    return 0.0


class _Node:
    """One node's slice of the usage map — both resources under one
    lock so a mixed bind is atomic per node. ``used``/``cpu_used`` are
    guarded by the node's own lock — binds against different nodes
    never contend."""

    __slots__ = ("name", "labels", "capacity", "used",
                 "cpu_capacity", "cpu_used",
                 "hbm_capacity", "hbm_used", "flops_used", "lock")

    def __init__(self, name: str, labels: dict, capacity: float,
                 cpu_capacity: float = 0.0, hbm_capacity: float = 0.0):
        self.name = name
        self.labels = labels
        self.capacity = capacity        # chips
        self.used = 0.0                 # chips
        self.cpu_capacity = cpu_capacity
        self.cpu_used = 0.0
        self.hbm_capacity = hbm_capacity   # GiB, never overcommitted
        self.hbm_used = 0.0
        self.flops_used = 0.0           # predicted FLOPs/step (tiebreak)
        # one ranked family: _commit acquires gang members sorted by
        # node name, which is exactly the rank the analyser verifies
        self.lock = make_lock("scheduler.node", rank=name)


class _Entry:
    __slots__ = ("node", "chips", "cpu", "hbm", "flops", "rv",
                 "harvested")

    def __init__(self, node: str, chips: float, cpu: float, rv: float,
                 hbm: float = 0.0, flops: float = 0.0):
        self.node = node
        self.chips = chips
        self.cpu = cpu
        self.hbm = hbm                  # GiB actually charged
        self.flops = flops
        self.rv = rv
        # harvest lease (r20): a harvested charge is serving work
        # squatting on idle notebook chips — instantly reclaimable,
        # it NEVER blocks a notebook bind the way a real charge does
        self.harvested = False


class SchedulerCache:
    """Informer-fed per-node chip accounting with assume/bind.

    Lock order (held-simultaneously pairs only): ``_relist_lock`` →
    ``_nlock`` → node locks (sorted by name) → ``_plock``. The event
    path takes ``_plock`` and node locks sequentially, never nested.
    The canonical cross-module hierarchy lives in
    :mod:`kubeflow_rm_tpu_torch.analysis.hierarchy`; the lockgraph storm arm
    verifies the measured acquisition graph embeds into it.
    """

    def __init__(self, backend=None):
        self._nodes: dict[str, _Node] = {}
        self._pods: dict[tuple[str | None, str], _Entry] = {}
        self._plock = make_lock("scheduler.pods_map")
        self._nlock = make_lock("scheduler.nodes_map")
        self._relist_lock = make_lock("scheduler.relist")
        self._stale = True                   # prime on first use
        self._assumed = 0
        self._backend = (weakref.ref(backend)
                         if backend is not None else None)
        #: the ChipHarvestController's synchronous give-back: called
        #: with an optional node-name filter, drains the harvest
        #: replicas charged there and releases their leases, returning
        #: the chips freed. None when no harvester is attached.
        self.harvest_reclaimer = None

    # -- the informer feed (one dispatch thread per backend) -----------
    def observe(self, etype: str, obj: dict, old: dict | None = None) -> None:
        if etype == "TOO_OLD":
            # the fanout queue overflowed: the dropped window can't be
            # replayed, so the next scheduling attempt rebuilds from a
            # fresh snapshot (kube-scheduler's 410 relist)
            self._stale = True
            return
        kind = obj.get("kind")
        if kind == "Node":
            self._apply_node(etype, obj)
        elif kind == "Pod":
            self._apply_pod(etype, obj)

    def _apply_node(self, etype: str, obj: dict) -> None:
        from kubeflow_rm_tpu_torch.controlplane import metrics
        metrics.SCHEDULER_CACHE_EVENTS_TOTAL.labels(kind="Node").inc()
        name = name_of(obj)
        with self._nlock:
            if etype == "DELETED":
                self._nodes.pop(name, None)
                return
            node = self._nodes.get(name)
            cap = parse_quantity(deep_get(
                obj, "status", "allocatable", NVIDIA_GPU_RESOURCE,
                default=0))
            cpu_cap = parse_quantity(deep_get(
                obj, "status", "allocatable", CPU_RESOURCE, default=0))
            hbm_cap = parse_quantity(deep_get(
                obj, "status", "allocatable", NVIDIA_GPU_MEMORY_RESOURCE,
                default=0))
            if node is None:
                self._nodes[name] = _Node(name, labels_of(obj), cap,
                                          cpu_cap, hbm_cap)
            else:
                # keep the object (its lock + used survive relabels)
                node.labels = labels_of(obj)
                node.capacity = cap
                node.cpu_capacity = cpu_cap
                node.hbm_capacity = hbm_cap

    def _apply_pod(self, etype: str, obj: dict) -> None:
        from kubeflow_rm_tpu_torch.controlplane import metrics
        metrics.SCHEDULER_CACHE_EVENTS_TOTAL.labels(kind="Pod").inc()
        key = (namespace_of(obj), name_of(obj))
        try:
            rv = float(obj["metadata"].get("resourceVersion") or 0)
        except (TypeError, ValueError):
            rv = 0.0
        gone = (etype == "DELETED"
                or deep_get(obj, "status", "phase") in TERMINAL_PHASES)
        node_name = None if gone else deep_get(obj, "spec", "nodeName")
        chips = _pod_chips(obj)
        cpu = _pod_cpu(obj)
        # the HBM charge depends on the landing node's shape (an
        # undeclared pod charges that node's per-chip share), so it is
        # resolved here — BEFORE _plock, respecting the _nlock order
        hbm = flops = 0.0
        if node_name:
            with self._nlock:
                node = self._nodes.get(node_name)
            if node is not None:
                hbm = _hbm_charge(_pod_declared_hbm_gib(obj), chips,
                                  node.hbm_capacity, node.capacity)
            flops = _pod_flops(obj)
        with self._plock:
            cur = self._pods.get(key)
            if cur is not None and rv < cur.rv:
                # stale event (assumed entries compare newest): a bind
                # already charged this pod at a later version — applying
                # the older view would free chips that are still held
                return
            dec = (cur.node, cur.chips, cur.cpu, cur.hbm, cur.flops) \
                if cur is not None else None
            if node_name:
                self._pods[key] = _Entry(node_name, chips, cpu, rv,
                                         hbm, flops)
                inc = (node_name, chips, cpu, hbm, flops)
            else:
                self._pods.pop(key, None)
                inc = None
        self._adjust(dec, inc)

    def _adjust(self, dec: tuple[str, float, float, float, float] | None,
                inc: tuple[str, float, float, float, float] | None
                ) -> None:
        if dec == inc:
            return
        for charge, delta in ((dec, -1), (inc, +1)):
            if charge is None:
                continue
            name, chips, cpu, hbm, flops = charge
            if not chips and not cpu and not hbm:
                continue
            with self._nlock:
                node = self._nodes.get(name)
            if node is None:
                continue  # virtual node / node gone: untracked capacity
            with node.lock:
                node.used = max(0.0, node.used + delta * chips)
                node.cpu_used = max(0.0, node.cpu_used + delta * cpu)
                node.hbm_used = max(0.0, node.hbm_used + delta * hbm)
                node.flops_used = max(0.0,
                                      node.flops_used + delta * flops)

    # -- snapshot rebuild (prime + TOO_OLD recovery) -------------------
    def rebuild(self, api) -> None:
        """Replace the accounting with a fresh snapshot, keeping
        in-flight assumed binds (their writes are racing this relist)."""
        from kubeflow_rm_tpu_torch.controlplane import metrics
        scan = getattr(api, "scan", api.list)
        with self._relist_lock:
            self._stale = False
            nodes = list(scan("Node"))
            pods = list(scan("Pod"))
            with self._nlock:
                seen = set()
                for n in nodes:
                    name = name_of(n)
                    seen.add(name)
                    cap = parse_quantity(deep_get(
                        n, "status", "allocatable", NVIDIA_GPU_RESOURCE,
                        default=0))
                    cpu_cap = parse_quantity(deep_get(
                        n, "status", "allocatable", CPU_RESOURCE,
                        default=0))
                    hbm_cap = parse_quantity(deep_get(
                        n, "status", "allocatable",
                        NVIDIA_GPU_MEMORY_RESOURCE, default=0))
                    node = self._nodes.get(name)
                    if node is None:
                        self._nodes[name] = _Node(name, labels_of(n),
                                                  cap, cpu_cap, hbm_cap)
                    else:
                        node.labels = labels_of(n)
                        node.capacity = cap
                        node.cpu_capacity = cpu_cap
                        node.hbm_capacity = hbm_cap
                for name in list(self._nodes):
                    if name not in seen:
                        del self._nodes[name]
                live_nodes = dict(self._nodes)
            with self._plock:
                fresh: dict = {}
                for p in pods:
                    if deep_get(p, "status", "phase") in TERMINAL_PHASES:
                        continue
                    node_name = deep_get(p, "spec", "nodeName")
                    if not node_name:
                        continue
                    key = (namespace_of(p), name_of(p))
                    try:
                        rv = float(p["metadata"].get(
                            "resourceVersion") or 0)
                    except (TypeError, ValueError):
                        rv = 0.0
                    chips = _pod_chips(p)
                    lnode = live_nodes.get(node_name)
                    hbm = _hbm_charge(
                        _pod_declared_hbm_gib(p), chips,
                        lnode.hbm_capacity if lnode else 0.0,
                        lnode.capacity if lnode else 0.0)
                    fresh[key] = _Entry(node_name, chips,
                                        _pod_cpu(p), rv, hbm,
                                        _pod_flops(p))
                for key, e in self._pods.items():
                    if e.rv is _ASSUMED and key not in fresh:
                        fresh[key] = e
                self._pods = fresh
                per_node: dict[str, list[float]] = {}
                for e in fresh.values():
                    acc = per_node.setdefault(
                        e.node, [0.0, 0.0, 0.0, 0.0])
                    acc[0] += e.chips
                    acc[1] += e.cpu
                    acc[2] += e.hbm
                    acc[3] += e.flops
            for node in live_nodes.values():
                with node.lock:
                    (node.used, node.cpu_used, node.hbm_used,
                     node.flops_used) = per_node.get(
                        node.name, (0.0, 0.0, 0.0, 0.0))
        metrics.SCHEDULER_CACHE_REBUILDS_TOTAL.inc()

    def _ensure_fresh(self) -> None:
        if not self._stale:
            return
        backend = self._backend() if self._backend is not None else None
        if backend is not None:
            self.rebuild(backend)

    # -- assume / confirm / forget (the bind protocol) -----------------
    def gang_bind(self, pods: list[dict], *,
                  allow_virtual: bool,
                  exclude_nodes: set[str] | None = None,
                  prefer_whole_nodes: bool = False
                  ) -> dict[tuple, str] | None:
        """Place a whole gang all-or-nothing. Returns ``{(ns, name):
        node_name}`` with every placement *assumed* in the cache, or
        None (nothing charged) when the gang doesn't fit. The caller
        must ``confirm`` each bind after its apiserver write lands, or
        ``forget`` it on failure. ``exclude_nodes`` bars named nodes
        from the plan — live migration's re-bind passes the nodes the
        slice just drained off so it genuinely moves.
        ``prefer_whole_nodes`` inverts the fragmentation tiebreak:
        harvest gangs take ENTIRELY free nodes first (the slices their
        notebooks just vacated), so a lease returns a whole slice and
        never pins a remainder under a half-used node."""
        from kubeflow_rm_tpu_torch.controlplane import metrics, tracing
        self._ensure_fresh()
        with tracing.start_span_if_active(
                "gang_bind", attrs={"pods": len(pods),
                                    "allow_virtual": allow_virtual}) as sp:
            t0 = time.perf_counter()
            plan = self._try_gang(pods, allow_virtual,
                                  exclude_nodes=exclude_nodes,
                                  prefer_whole_nodes=prefer_whole_nodes)
            result = "bound" if plan is not None else "unschedulable"
            metrics.SCHEDULE_LATENCY_SECONDS.labels(
                result=result).observe(time.perf_counter() - t0)
            sp.set_attr("result", result)
        return plan

    def _try_gang(self, pods: list[dict], allow_virtual: bool,
                  exclude_nodes: set[str] | None = None,
                  prefer_whole_nodes: bool = False
                  ) -> dict[tuple, str] | None:
        # pick first (selection without locks), then verify-and-commit
        # under the chosen nodes' locks; capacity taken by a concurrent
        # gang between the two phases fails verification and retries
        for _ in range(4):
            with self._nlock:
                nodes = list(self._nodes.values())
            # best-fragmentation-fit ordering (ParvaGPU's allocation
            # tiebreak): try the nodes with the LEAST free capacity
            # first, so a gang soaks up already-fragmented remainders
            # and the emptiest nodes stay whole for future large gangs
            # — first-fit in arrival order eroded largest_free_gang by
            # carving every new gang out of the freest node. Free is
            # snapshotted once per attempt; name breaks ties so plans
            # are deterministic.
            free0: dict[str, float] = {}
            flops0: dict[str, float] = {}
            for node in nodes:
                with node.lock:
                    free0[node.name] = node.capacity - node.used
                    flops0[node.name] = node.flops_used
            # predicted FLOPs/step is the SECOND sort key: among
            # equally-fragmented nodes, land on the computationally
            # coolest one — declared heavy trainers spread out instead
            # of stacking behind one oversubscribed systolic array
            if prefer_whole_nodes:
                # harvest gangs: wholly-free nodes first (free ==
                # capacity), then the usual least-free-first remainder
                nodes.sort(key=lambda n: (
                    0 if (n.capacity > 0
                          and free0[n.name] >= n.capacity) else 1,
                    free0[n.name], flops0[n.name], n.name))
            else:
                nodes.sort(key=lambda n: (free0[n.name],
                                          flops0[n.name], n.name))
            plan: dict[tuple, str] = {}
            # per-node tentative [chips, cpu, hbm, relaxed] charged by
            # THIS gang — heterogeneous pods share the map so a learner
            # host and an actor landing on the same node both count;
            # ``relaxed`` records that a declared-HBM pod was admitted
            # past the physical chip count (hbm-packing overcommit)
            tentative: dict[str, list] = {}
            packing = hbm_packing()
            for pod in sorted(pods, key=name_of):
                key = (namespace_of(pod), name_of(pod))
                selector = deep_get(pod, "spec", "nodeSelector",
                                    default={}) or {}
                need = _pod_chips(pod)
                need_cpu = _pod_cpu(pod)
                declared = _pod_declared_hbm_gib(pod)
                chosen = None
                chosen_hbm = 0.0
                relax = False
                for node in nodes:
                    if exclude_nodes and node.name in exclude_nodes:
                        continue
                    if selector and not matches_selector(
                            node.labels, {"matchLabels": selector}):
                        continue
                    need_hbm = _hbm_charge(declared, need,
                                           node.hbm_capacity,
                                           node.capacity)
                    if need or need_cpu:
                        with node.lock:
                            used, cpu_used = node.used, node.cpu_used
                            hbm_used = node.hbm_used
                        t = tentative.get(node.name)
                        t_chips, t_cpu, t_hbm = (
                            (t[0], t[1], t[2]) if t else
                            (0.0, 0.0, 0.0))
                        # a priced pod on a priced node may pack past
                        # the chip count (bounded) — the HBM check
                        # below is then the real admission gate
                        relax = (packing and declared is not None
                                 and node.hbm_capacity > 0)
                        limit = node.capacity * (
                            CHIP_OVERCOMMIT if relax else 1.0)
                        if need and (used + t_chips + need > limit):
                            continue
                        if need_cpu and (cpu_used + t_cpu + need_cpu
                                         > node.cpu_capacity):
                            continue
                        # the HBM axis is NEVER overcommitted — this
                        # is what makes the chip relaxation safe
                        if need_hbm and node.hbm_capacity > 0 and (
                                hbm_used + t_hbm + need_hbm
                                > node.hbm_capacity + _HBM_EPS):
                            continue
                    chosen = node.name
                    chosen_hbm = need_hbm if (need or need_cpu) else 0.0
                    break
                if chosen is None:
                    if allow_virtual and not selector and not need \
                            and not need_cpu:
                        plan[key] = VIRTUAL_NODE
                        continue
                    return None  # gang is all-or-nothing
                plan[key] = chosen
                if need or need_cpu:
                    t = tentative.setdefault(
                        chosen, [0.0, 0.0, 0.0, False, 0.0])
                    t[0] += need
                    t[1] += need_cpu
                    t[2] += chosen_hbm
                    t[3] = t[3] or relax
                    t[4] += _pod_flops(pod)
            if self._commit(pods, plan, tentative):
                return plan
        return None

    def _commit(self, pods: list[dict], plan: dict[tuple, str],
                tentative: dict[str, list]) -> bool:
        """Re-verify EVERY axis and charge the gang under its
        nodes' locks (sorted acquisition — deadlock-free against
        sibling gangs), then record the assumed entries. Verification
        failure on any axis rejects the whole gang with nothing
        charged."""
        with self._nlock:
            locked = [self._nodes[n] for n in sorted(tentative)
                      if n in self._nodes]
        if len(locked) != len(tentative):
            return False  # a chosen node vanished mid-flight
        with self._relist_lock:
            for node in locked:
                node.lock.acquire()
            try:
                for node in locked:
                    (t_chips, t_cpu, t_hbm, relax,
                     _t_flops) = tentative[node.name]
                    limit = node.capacity * (
                        CHIP_OVERCOMMIT if relax else 1.0)
                    if node.used + t_chips > limit:
                        return False
                    if node.cpu_used + t_cpu > node.cpu_capacity:
                        return False
                    if t_hbm and node.hbm_capacity > 0 and (
                            node.hbm_used + t_hbm
                            > node.hbm_capacity + _HBM_EPS):
                        return False
                for node in locked:
                    (t_chips, t_cpu, t_hbm, _,
                     t_flops) = tentative[node.name]
                    node.used += t_chips
                    node.cpu_used += t_cpu
                    node.hbm_used += t_hbm
                    node.flops_used += t_flops
            finally:
                for node in locked:
                    node.lock.release()
            from kubeflow_rm_tpu_torch.controlplane import metrics
            stale: list[tuple[str, float, float, float, float]] = []
            node_shapes = {n.name: (n.hbm_capacity, n.capacity)
                           for n in locked}
            with self._plock:
                for pod in pods:
                    key = (namespace_of(pod), name_of(pod))
                    cur = self._pods.get(key)
                    if cur is not None:
                        # re-bind over an existing entry (a stale cached
                        # list raced a prior bind): release the old
                        # charge so the gang's doesn't double-count
                        if cur.rv is _ASSUMED:
                            self._assumed -= 1
                        stale.append((cur.node, cur.chips, cur.cpu,
                                      cur.hbm, cur.flops))
                    chips = _pod_chips(pod)
                    hbm_cap, cap = node_shapes.get(plan[key],
                                                   (0.0, 0.0))
                    hbm = _hbm_charge(_pod_declared_hbm_gib(pod),
                                      chips, hbm_cap, cap)
                    flops = _pod_flops(pod)
                    self._pods[key] = _Entry(
                        plan[key], chips, _pod_cpu(pod),
                        _ASSUMED, hbm, flops)
                    self._assumed += 1
                metrics.SCHEDULER_ASSUMED_PODS.set(self._assumed)
            for dec in stale:
                self._adjust(dec, None)
        return True

    def confirm(self, key: tuple, rv) -> None:
        """The bind write landed: pin the entry at its resourceVersion
        so the echo event (and anything older) folds in idempotently."""
        from kubeflow_rm_tpu_torch.controlplane import metrics
        try:
            rv = float(rv)
        except (TypeError, ValueError):
            rv = 0.0
        with self._plock:
            e = self._pods.get(key)
            if e is not None and e.rv is _ASSUMED:
                e.rv = rv
                self._assumed -= 1
                metrics.SCHEDULER_ASSUMED_PODS.set(self._assumed)

    def forget(self, key: tuple) -> None:
        """The bind write failed: release the assumed charge."""
        from kubeflow_rm_tpu_torch.controlplane import metrics
        with self._plock:
            e = self._pods.get(key)
            if e is None or e.rv is not _ASSUMED:
                return
            del self._pods[key]
            self._assumed -= 1
            metrics.SCHEDULER_ASSUMED_PODS.set(self._assumed)
        self._adjust((e.node, e.chips, e.cpu, e.hbm, e.flops), None)

    def release(self, key: tuple) -> None:
        """Out-of-band eviction for suspend/preemption teardown: the
        caller just deleted the pod and needs its chips free NOW, not
        after the DELETE event clears the async fanout — a preemptive
        gang-bind retries synchronously in the same reconcile. Unlike
        ``forget`` this drops confirmed entries too. The later DELETE
        echo folds in as a no-op; a stale pre-delete UPDATE still in
        the queue can transiently re-charge until its DELETE lands —
        that converges and can only under-admit, never over-commit."""
        from kubeflow_rm_tpu_torch.controlplane import metrics
        with self._plock:
            e = self._pods.pop(key, None)
            if e is None:
                return
            if e.rv is _ASSUMED:
                self._assumed -= 1
                metrics.SCHEDULER_ASSUMED_PODS.set(self._assumed)
        self._adjust((e.node, e.chips, e.cpu, e.hbm, e.flops), None)

    # -- harvest leases (r20) ------------------------------------------
    def mark_harvested(self, key: tuple) -> None:
        """Tag a charge as a harvest lease: serving work on idle
        notebook chips, instantly reclaimable by ANY notebook bind.
        Harvest charges stay ``_ASSUMED`` forever (there is no
        apiserver pod behind them), which is exactly what lets them
        survive a relist rebuild."""
        from kubeflow_rm_tpu_torch.controlplane import metrics
        with self._plock:
            e = self._pods.get(key)
            if e is not None:
                e.harvested = True
            metrics.HARVESTED_CHIPS.set(sum(
                x.chips for x in self._pods.values() if x.harvested))

    def harvested_entries(self) -> dict[tuple, tuple[str, float]]:
        """``{(ns, name): (node, chips)}`` for every live harvest
        lease."""
        with self._plock:
            return {k: (e.node, e.chips)
                    for k, e in self._pods.items() if e.harvested}

    def harvested_chips(self) -> float:
        with self._plock:
            return sum(e.chips for e in self._pods.values()
                       if e.harvested)

    def release_harvested(self, key: tuple) -> None:
        """Release one harvest lease (give-back)."""
        from kubeflow_rm_tpu_torch.controlplane import metrics
        self.release(key)
        with self._plock:
            metrics.HARVESTED_CHIPS.set(sum(
                e.chips for e in self._pods.values() if e.harvested))

    def reclaim_harvested(self, nodes: set[str] | None = None, *,
                          trigger: str = "preempt") -> float:
        """Synchronous give-back: ask the attached harvester to drain
        and release its leases (optionally only those charged on
        ``nodes``). Returns chips freed; 0.0 when no harvester is
        attached or nothing was harvested there. Notebook resume and
        preemption call this FIRST — notebook demand always outranks
        harvested serving."""
        fn = self.harvest_reclaimer
        if fn is None:
            return 0.0
        try:
            return float(fn(nodes, trigger) or 0.0)
        except Exception:
            from kubeflow_rm_tpu_torch.controlplane import metrics
            metrics.swallowed("scheduler", "harvest reclaim")
            return 0.0

    # -- read-side helpers ---------------------------------------------
    def total_used(self) -> float:
        """Chips currently charged across the fleet — O(nodes), serves
        the ``tpu_chips_requested`` gauge without a Pod scan."""
        with self._nlock:
            nodes = list(self._nodes.values())
        total = 0.0
        for node in nodes:
            with node.lock:
                total += node.used
        return total

    def node_used(self, name: str) -> float:
        with self._nlock:
            node = self._nodes.get(name)
        if node is None:
            return 0.0
        with node.lock:
            return node.used

    def node_cpu_used(self, name: str) -> float:
        with self._nlock:
            node = self._nodes.get(name)
        if node is None:
            return 0.0
        with node.lock:
            return node.cpu_used

    def free_by_node(self) -> dict[str, tuple[float, dict]]:
        """Snapshot of ``{node: (free_chips, labels)}`` — the read side
        preemption simulates victim teardown against."""
        with self._nlock:
            nodes = list(self._nodes.values())
        out: dict[str, tuple[float, dict]] = {}
        for node in nodes:
            with node.lock:
                free = max(0.0, node.capacity - node.used)
            out[node.name] = (free, node.labels)
        return out

    def hbm_by_node(self) -> dict[str, tuple[float, float]]:
        """``{node: (hbm_used_gib, hbm_capacity_gib)}`` — the
        conformance harness's zero-overcommit assertion reads this
        after every bind wave."""
        with self._nlock:
            nodes = list(self._nodes.values())
        out: dict[str, tuple[float, float]] = {}
        for node in nodes:
            with node.lock:
                out[node.name] = (node.hbm_used, node.hbm_capacity)
        return out

    def stats(self) -> dict:
        """Cache counters plus the bin-packing view: ``free_chips``
        (total unclaimed capacity), ``largest_free_gang`` (the biggest
        slice placeable as a gang of identical hosts — max over c of
        c × |{nodes with ≥ c chips free}|, ParvaGPU's "largest
        allocatable unit"), and ``fragmentation`` = 1 − largest/free
        (0 when free chips are gang-placeable whole, → 1 as free
        capacity shatters into unusable crumbs). Refreshes the
        matching Prometheus gauges as a side effect."""
        from kubeflow_rm_tpu_torch.controlplane import metrics
        with self._plock:
            pods, assumed = len(self._pods), self._assumed
            harvested = sum(e.chips for e in self._pods.values()
                            if e.harvested)
        with self._nlock:
            nodes = list(self._nodes.values())
        free: list[float] = []
        free_cpu = 0.0
        free_hbm = 0.0
        for node in nodes:
            with node.lock:
                free.append(max(0.0, node.capacity - node.used))
                free_cpu += max(0.0, node.cpu_capacity - node.cpu_used)
                free_hbm += max(0.0, node.hbm_capacity - node.hbm_used)
        free_chips = sum(free)
        largest = 0.0
        for i, f in enumerate(sorted(free, reverse=True)):
            if f <= 0:
                break
            largest = max(largest, f * (i + 1))
        frag = 0.0 if free_chips <= 0 else 1.0 - largest / free_chips
        metrics.SCHEDULER_FREE_CHIPS.set(free_chips)
        metrics.SCHEDULER_LARGEST_FREE_GANG.set(largest)
        metrics.SCHEDULER_FRAGMENTATION.set(frag)
        metrics.SCHEDULER_FREE_HBM_GIB.set(free_hbm)
        metrics.HARVESTED_CHIPS.set(harvested)
        return {"nodes": len(nodes), "pods": pods, "assumed": assumed,
                "stale": self._stale, "free_chips": free_chips,
                "free_cpu": free_cpu, "free_hbm_gib": free_hbm,
                "largest_free_gang": largest, "fragmentation": frag,
                "harvested_chips": harvested}


# ---- per-backend cache registry + the legacy A/B switch --------------

_caches: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_caches_lock = make_lock("scheduler.registry")

_legacy_scan = False


def set_legacy_scan(enabled: bool) -> None:
    """Restore the pre-r10 scheduling path: full Pod scan under the
    global bind lock per reconcile (the ``--legacy-schedule``
    conformance arm)."""
    global _legacy_scan
    _legacy_scan = bool(enabled)


def legacy_scan() -> bool:
    return _legacy_scan


def refresh_gauges() -> None:
    """Recompute the free-chips/fragmentation gauges for every live
    cache — called by text-scrape endpoints (``deploy/restserver.py``
    ``/metrics``) so the exposition reflects now, not the last bind."""
    with _caches_lock:
        caches = list(_caches.values())
    for cache in caches:
        cache.stats()


def cache_for(api) -> SchedulerCache:
    """The one SchedulerCache per apiserver backend, informer-fed from
    registration time and primed from a snapshot on first use. Accepts
    a CachedAPI and unwraps it — accounting must feed from the
    authoritative event stream, not a read cache."""
    backend = getattr(api, "api", api)
    with _caches_lock:
        cache = _caches.get(backend)
        if cache is None:
            cache = SchedulerCache(backend)
            # subscribe BEFORE the first rebuild: an event raced between
            # snapshot and subscription would be lost forever, while one
            # arriving twice is absorbed by the rv guards
            backend.add_watcher(cache.observe, name="scheduler")
            _caches[backend] = cache
    return cache
