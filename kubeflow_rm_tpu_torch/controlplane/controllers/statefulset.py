"""StatefulSet → Pods: the fake kubelet + scheduler for tests
(counterpart of ``kubeflow_rm_tpu/controlplane/controllers/statefulset.py``;
``make_gpu_node`` is ``make_tpu_node``'s, on :mod:`..api.gpu`).

The reference gets these semantics from a real cluster (envtest stops at
the apiserver, so its suites never see Pods; the pvcviewer suite
fabricates them by hand — ``pvcviewer-controller/controllers/test_utils.go:21-128``).
This controller goes one step further than envtest: it realizes a
StatefulSet into ordinal Pods, runs them through the admission chain
(where the TPU webhook injects rendezvous env), schedules them onto
Nodes by nodeSelector + ``nvidia.com/gpu`` capacity, and mirrors a
Running/Ready status — or leaves them Pending with a FailedScheduling
event, which is what the slice-health machinery watches for.

This is test infrastructure with production semantics: every behavior
here (ordinal naming, subdomain DNS, Parallel management, capacity
gating) is exactly what GKE does to a real slice StatefulSet.
"""

from __future__ import annotations

import copy
import json

from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    fast_deepcopy,
    deep_get,
    labels_of,
    matches_selector,
    name_of,
    namespace_of,
    parse_quantity,
    set_controller_reference,
)
from kubeflow_rm_tpu_torch.controlplane.api.gpu import NVIDIA_GPU_RESOURCE
from kubeflow_rm_tpu_torch.controlplane.api import tpujob as tj_api
from kubeflow_rm_tpu_torch.controlplane.apiserver import (
    AdmissionDenied, APIServer, NotFound, is_status,
)
from kubeflow_rm_tpu_torch.controlplane import chaos, runtime, scheduler
from kubeflow_rm_tpu_torch.controlplane.runtime import (
    Controller, Request, map_all_in_namespace, map_to_owner,
    phase_observer,
)
from kubeflow_rm_tpu_torch.controlplane.scheduler import (
    TERMINAL_PHASES, VIRTUAL_NODE,
)

POD_NAME_LABEL = "statefulset.kubernetes.io/pod-name"


def make_gpu_node(name: str, accelerator_type: str) -> dict:
    """A Node carrying one host's worth of cards of ``accelerator_type``
    (an :mod:`..api.gpu` slice type) + the GKE GPU node labels."""
    from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api

    topo = gpu_api.lookup(accelerator_type)
    return {
        "apiVersion": "v1",
        "kind": "Node",
        "metadata": {
            "name": name,
            "labels": {
                gpu_api.NODE_LABEL_ACCELERATOR: topo.gke_accelerator,
                gpu_api.NODE_LABEL_TOPOLOGY: topo.topology,
            },
        },
        "status": {
            "capacity": {
                NVIDIA_GPU_RESOURCE: str(topo.cards_per_host),
                gpu_api.NVIDIA_GPU_MEMORY_RESOURCE:
                    str(topo.hbm_gib_per_host),
                "cpu": "96",
                "memory": "384Gi",
            },
            "allocatable": {
                NVIDIA_GPU_RESOURCE: str(topo.cards_per_host),
                gpu_api.NVIDIA_GPU_MEMORY_RESOURCE:
                    str(topo.hbm_gib_per_host),
                "cpu": "96",
                "memory": "384Gi",
            },
        },
    }


class StatefulSetController(Controller):
    kind = "StatefulSet"

    def __init__(self, auto_ready: bool = True,
                 virtual_node_fallback: bool | None = None):
        # auto_ready=False leaves scheduled pods un-Ready so tests can
        # exercise status ladders and slice-health timing.
        # virtual_node_fallback: place selector-less CPU pods on a
        # synthetic node when no Node inventory exists. None (default)
        # resolves per-backend: allowed against the hermetic in-memory
        # APIServer, refused against a KubeAPIServer — there an empty
        # node list is a real "no nodes at all" condition that must
        # surface as FailedScheduling, not be papered over.
        self.auto_ready = auto_ready
        self.virtual_node_fallback = virtual_node_fallback
        self._observe = phase_observer(self.kind.lower())

    def watches(self):
        # ResourceQuota: a raised quota must requeue every STS in its
        # namespace immediately — a quota-rejected slice used to wait
        # out a 30s poll before admission.
        # Gang pods additionally fan out to EVERY role STS of their
        # TPUJob — the gang's binder must wake when a sibling role's
        # pods appear, and pod-create events only map to their owner
        return (("Pod", map_to_owner("StatefulSet")),
                ("Pod", _map_gang_pod),
                ("ResourceQuota", map_all_in_namespace("StatefulSet")))

    def reconcile(self, api: APIServer, req: Request):
        try:
            sts = api.get(self.kind, req.name, req.namespace)
        except NotFound:
            return None  # pods are GC'd via ownerReferences
        with self._observe("render"):
            replicas = deep_get(sts, "spec", "replicas", default=1)
            ns = req.namespace

            scan = getattr(api, "scan", api.list)  # read-only fast path
            existing = {
                name_of(p): p for p in scan("Pod", ns)
                if any(r.get("uid") == sts["metadata"]["uid"]
                       for r in p["metadata"].get("ownerReferences", []))
            }

            # scale down: remove pods at ordinals >= replicas
            for pname, pod in existing.items():
                ordinal = _ordinal(pname, req.name)
                if ordinal is None or ordinal >= replicas:
                    api.delete("Pod", pname, ns)

            missing = [i for i in range(replicas)
                       if f"{req.name}-{i}" not in existing]

        # slice admission is all-or-nothing: pre-check EVERY missing pod
        # against namespace quota before creating any. Creating ordinals
        # until one is denied would either leave a rump slice holding
        # chips while the jax rendezvous waits forever, or (if torn
        # down) free the quota and retry in an endless create/teardown
        # loop. Reject whole, once, with an event.
        if missing and not self._missing_pods_fit_quota(api, sts, missing):
            msg = (f"namespace quota cannot admit all {replicas} hosts "
                   "of the slice; rejecting whole (slice admission is "
                   "all-or-nothing)")
            if not any(e["reason"] == "SliceAdmissionFailed"
                       and e["message"] == msg
                       for e in api.events_for(sts)):
                api.record_event(sts, "Warning", "SliceAdmissionFailed",
                                 msg)
            missing = []
            # no timed poll: the ResourceQuota watch (watches() above)
            # requeues this STS the moment the quota is raised

        # scale up: create missing ordinals (Parallel policy: all at once)
        with self._observe("child_writes"):
            if missing:
                self._create_missing(api, sts, missing)
            self._schedule_and_run(api, sts)
        self._maybe_chaos_pod_kill(api, sts)
        with self._observe("status"):
            self._mirror_status(api, sts)
            from kubeflow_rm_tpu_torch.controlplane import metrics
            if scheduler.legacy_scan():
                metrics.TPU_CHIPS_REQUESTED.set(sum(
                    _pod_tpu_request(p)
                    for p in getattr(api, "scan", api.list)("Pod")
                    if deep_get(p, "spec", "nodeName")
                    and deep_get(p, "status", "phase")
                    not in TERMINAL_PHASES))
            else:
                # O(nodes) from the usage cache, not an O(pods) scan
                metrics.TPU_CHIPS_REQUESTED.set(
                    scheduler.cache_for(api).total_used())
        return None

    def _create_missing(self, api: APIServer, sts: dict,
                        missing: list[int]) -> None:
        pods = []
        for i in missing:
            pod = self._render_pod(sts, i)
            set_controller_reference(sts, pod)
            pods.append(pod)
        create_many = getattr(api, "create_many", None)
        if (create_many is not None and len(pods) > 1
                and not runtime.serial_writes()):
            # whole slice in one verb: one lock acquisition, one rv
            # range, one coalesced watch emit; admission runs per-pod
            # inside the batch, failures come back as Status items
            for pod, res in zip(pods, create_many(pods)):
                if is_status(res):
                    api.record_event(
                        sts, "Warning", "FailedCreate",
                        f"create Pod {name_of(pod)} failed: "
                        f"{res.get('message')}")
            return
        for pod in pods:
            try:
                api.create(pod)
            except AdmissionDenied as e:
                # backstop for admission races the pre-check can't see
                api.record_event(
                    sts, "Warning", "FailedCreate",
                    f"create Pod {name_of(pod)} failed: {e}")
                break  # quota: further ordinals would fail identically

    def _missing_pods_fit_quota(self, api: APIServer, sts: dict,
                                missing: list[int]) -> bool:
        """Would creating every missing ordinal clear the namespace's
        ResourceQuotas? Mirrors the apiserver's per-pod enforcement
        (``apiserver._enforce_quota``) summed over the whole batch."""
        # KubeAPIServer has no client-side toggle: quota admission is
        # the server's job there, this pre-check stays advisory
        if not getattr(api, "quota_enforcement", True):
            return True
        ns = namespace_of(sts)
        scan = getattr(api, "scan", api.list)
        quotas = scan("ResourceQuota", ns)
        if not quotas:
            return True
        template_pod = self._render_pod(sts, 0)
        live = [p for p in scan("Pod", ns)
                if not p["metadata"].get("deletionTimestamp")]
        for quota in quotas:
            hard = deep_get(quota, "spec", "hard", default={}) or {}
            for resource, limit in hard.items():
                limit_v = parse_quantity(limit)
                if resource == "pods":
                    if len(live) + len(missing) > limit_v:
                        return False
                    continue
                # mirror _enforce_quota exactly: "limits.X" charges
                # limits only; everything else charges requests
                # defaulting to limits
                rname, rkind = resource, "requests"
                if rname.startswith("requests."):
                    rname = rname[len("requests."):]
                elif rname.startswith("limits."):
                    rname = rname[len("limits."):]
                    rkind = "limits"
                per_pod = _pod_resource_request(template_pod, rname, rkind)
                if not per_pod:
                    continue
                used = sum(_pod_resource_request(p, rname, rkind)
                           for p in live)
                if used + per_pod * len(missing) > limit_v:
                    return False
        return True

    # -- pod rendering -------------------------------------------------
    def _render_pod(self, sts: dict, ordinal: int) -> dict:
        name = f"{name_of(sts)}-{ordinal}"
        tmpl = fast_deepcopy(deep_get(sts, "spec", "template", default={}))
        labels = dict(tmpl.get("metadata", {}).get("labels") or {})
        labels[POD_NAME_LABEL] = name
        pod = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "namespace": namespace_of(sts),
                "labels": labels,
                "annotations": dict(
                    tmpl.get("metadata", {}).get("annotations") or {}),
            },
            "spec": fast_deepcopy(tmpl.get("spec") or {}),
        }
        pod["spec"]["hostname"] = name
        svc = deep_get(sts, "spec", "serviceName")
        if svc:
            pod["spec"]["subdomain"] = svc
        return pod

    # -- scheduling + status (the fake kubelet) ------------------------
    #: legacy arm only: scheduling there is a read-compute-write over
    #: SHARED node capacity, serialized whole under one global lock.
    #: The default path runs assume/bind against the incremental usage
    #: cache in ``controlplane/scheduler.py`` — per-node locks, no
    #: global serialization, no per-reconcile Pod scan.
    _bind_lock = __import__("threading").Lock()

    def _schedule_and_run(self, api: APIServer, sts: dict) -> None:
        if _gang_of(sts) is not None:
            # multi-role gangs always take the cached assume/bind path:
            # mixed-resource all-or-nothing placement needs the dual
            # (chips, cpu) accounting the legacy scan never had
            self._schedule_and_run_cached(api, sts)
            return
        if scheduler.legacy_scan():
            with self._bind_lock:
                self._schedule_and_run_locked(api, sts)
            return
        self._schedule_and_run_cached(api, sts)

    def _owned_pods(self, api: APIServer, sts: dict) -> list[dict]:
        # this STS's pods ARE mutated by the kubelet half -> copies
        return [p for p in api.list("Pod", namespace_of(sts))
                if any(r.get("uid") == sts["metadata"]["uid"]
                       for r in p["metadata"].get("ownerReferences", []))]

    def _allow_virtual(self, api: APIServer) -> bool:
        return (self.virtual_node_fallback
                if self.virtual_node_fallback is not None
                # unwrap a CachedAPI: the backend decides — hermetic
                # in-memory yes, real cluster no
                else isinstance(getattr(api, "api", api), APIServer))

    @staticmethod
    def _exclude_nodes(sts: dict) -> set[str] | None:
        """Live migration: the notebook controller mirrors the CR's
        migrate-exclude annotation onto the STS; the re-bind must avoid
        those nodes or the "migration" would land right back where it
        drained from."""
        from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
        raw = (sts["metadata"].get("annotations") or {}).get(
            nb_api.MIGRATE_EXCLUDE_ANNOTATION)
        if not raw:
            return None
        try:
            nodes = json.loads(raw)
        except ValueError:
            return None
        return {str(n) for n in nodes} if isinstance(nodes, list) \
            else None

    def _mark_unschedulable(self, api: APIServer, pod: dict,
                            message: str | None = None) -> None:
        if deep_get(pod, "status", "phase") != "Pending":
            pod["status"] = {"phase": "Pending"}
            api.update_status(pod)
        if not any(e["reason"] == "FailedScheduling"
                   for e in api.events_for(pod)):
            api.record_event(
                pod, "Warning", "FailedScheduling",
                message or ("no node matches TPU nodeSelector with free "
                            f"{NVIDIA_GPU_RESOURCE} capacity"))

    def _schedule_and_run_cached(self, api: APIServer, sts: dict) -> None:
        """Assume/bind over the incremental usage cache: the whole
        slice gang-binds all-or-nothing, each bind charged to the cache
        before its write and confirmed with the write's rv (or
        forgotten on failure) — concurrent reconciles can't over-commit
        a node no matter how far the watch stream lags."""
        sched = scheduler.cache_for(api)
        unbound = []
        for pod in sorted(self._owned_pods(api, sts), key=name_of):
            if deep_get(pod, "spec", "nodeName"):
                # pre-pinned (RWO node affinity) or already scheduled:
                # the kubelet half still owes it a Running status
                if (self.auto_ready
                        and deep_get(pod, "status", "phase")
                        not in ("Running",) + TERMINAL_PHASES):
                    # terminal pods stay terminal — recovery is the
                    # slice-health controller's whole-slice decision,
                    # and a real kubelet never resurrects a Failed or
                    # Succeeded pod
                    self.mark_running(api, pod)
                continue
            unbound.append(pod)
        gang = _gang_of(sts)
        if gang is not None:
            self._schedule_gang(api, sts, gang, sched)
            return
        if not unbound:
            # active-defrag arm: a settled reconcile is the cheap place
            # to ask "is the pool fragmented enough to compact now?" —
            # flag-gated no-op by default
            from kubeflow_rm_tpu_torch.controlplane import suspend
            if suspend.active_defrag():
                suspend.maybe_active_defrag(
                    api, sched, allow_virtual=self._allow_virtual(api))
            return
        allow_virtual = self._allow_virtual(api)
        exclude = self._exclude_nodes(sts)
        plan = sched.gang_bind(unbound, allow_virtual=allow_virtual,
                               exclude_nodes=exclude)
        if plan is None:
            # priority preemption: suspend strictly lower-priority
            # victim slices and retry the gang in this same reconcile
            from kubeflow_rm_tpu_torch.controlplane import suspend
            plan = suspend.try_preempt(api, sts, unbound, sched,
                                       allow_virtual=allow_virtual)
        if plan is None:
            # fragmentation-triggered live migration: when free chips
            # would seat the gang but sit stranded across nodes, move a
            # small victim out of the way (no-op unless enabled)
            from kubeflow_rm_tpu_torch.controlplane import suspend
            suspend.try_compact_migration(api, sts, unbound, sched,
                                          allow_virtual=allow_virtual)
            for pod in unbound:
                self._mark_unschedulable(api, pod)
            return
        for pod in unbound:
            key = (namespace_of(pod), name_of(pod))
            pod["spec"]["nodeName"] = plan[key]
            try:
                live = api.update(pod)
            except Exception:
                # bind write lost (conflict/deleted): release the
                # assumed charge; the retried reconcile re-plans
                sched.forget(key)
                raise
            sched.confirm(key, deep_get(
                live, "metadata", "resourceVersion", default=0))
            if self.auto_ready:
                self.mark_running(api, pod, live=live)

    def _schedule_gang(self, api: APIServer, sts: dict,
                       gang: tuple[str, list[dict]], sched) -> None:
        """Bind a TPUJob's WHOLE heterogeneous gang — every role's pods
        across every role StatefulSet — in one mixed-resource assume
        transaction. Exactly one STS acts as the binder (the first
        role's — deterministic, so two role reconciles never race a
        bind for the same pod); the others only run the kubelet half.
        Binding waits until every role has materialised its pods: a
        half-created gang is never partially placed."""
        job, roles = gang
        ns = namespace_of(sts)
        if name_of(sts) != tj_api.role_sts_name(
                job, roles[0].get("name", "")):
            return  # not the binder; _map_gang_pod keeps it requeued
        expected = sum(int(r.get("pods") or 0) for r in roles)
        gang_pods = [
            p for p in api.list(
                "Pod", ns,
                {"matchLabels": {tj_api.JOB_NAME_LABEL: job}})
            if deep_get(p, "status", "phase") not in TERMINAL_PHASES
        ]
        if len(gang_pods) < expected:
            return  # sibling roles still creating; their events requeue
        unbound = sorted(
            [p for p in gang_pods
             if not deep_get(p, "spec", "nodeName")], key=name_of)
        if not unbound:
            return
        plan = sched.gang_bind(unbound,
                               allow_virtual=self._allow_virtual(api))
        if plan is None:
            msg = (f"gang of {expected} pods ({len(roles)} roles) does "
                   "not fit: needs chip AND cpu headroom on matching "
                   "nodes; nothing was placed (all-or-nothing)")
            for pod in unbound:
                self._mark_unschedulable(api, pod, message=msg)
            return
        for pod in unbound:
            key = (namespace_of(pod), name_of(pod))
            pod["spec"]["nodeName"] = plan[key]
            try:
                live = api.update(pod)
            except Exception:
                sched.forget(key)
                raise
            sched.confirm(key, deep_get(
                live, "metadata", "resourceVersion", default=0))
            if self.auto_ready:
                self.mark_running(api, pod, live=live)

    def _schedule_and_run_locked(self, api: APIServer, sts: dict) -> None:
        scan = getattr(api, "scan", api.list)
        nodes = scan("Node")
        pods = self._owned_pods(api, sts)

        # chips already committed per node; terminal pods hold none (a
        # Failed host must free its chips for the replacement slice,
        # not leak them until the Pod object is deleted)
        used: dict[str, float] = {}
        for p in scan("Pod"):
            node = deep_get(p, "spec", "nodeName")
            if node and deep_get(p, "status", "phase") \
                    not in TERMINAL_PHASES:
                used[node] = used.get(node, 0.0) + _pod_tpu_request(p)

        for pod in sorted(pods, key=name_of):
            if deep_get(pod, "spec", "nodeName"):
                # pre-pinned (RWO node affinity) or already scheduled:
                # the kubelet half still owes it a Running status
                if (self.auto_ready
                        and deep_get(pod, "status", "phase")
                        not in ("Running",) + TERMINAL_PHASES):
                    self.mark_running(api, pod)
                continue
            node = self._pick_node(api, pod, nodes, used)
            if node is None:
                self._mark_unschedulable(api, pod)
                continue
            used[name_of(node)] = used.get(name_of(node), 0.0) + \
                _pod_tpu_request(pod)
            pod["spec"]["nodeName"] = name_of(node)
            api.update(pod)
            if self.auto_ready:
                self.mark_running(api, pod)

    def _maybe_chaos_pod_kill(self, api: APIServer, sts: dict) -> None:
        """Seeded kubelet pod-kill: one chaos opportunity per reconcile
        of an STS with Running pods. The victim goes to phase=Failed —
        exactly what a real kubelet reports for an OOM-killed or
        node-lost container — so the platform's own recovery ladders
        (slice health restart, replica failover) do the healing."""
        if chaos.active() is None:
            return
        running = [p for p in self._owned_pods(api, sts)
                   if deep_get(p, "status", "phase") == "Running"]
        site = f"{namespace_of(sts)}/{name_of(sts)}"
        victim = chaos.pod_kill_victim(site,
                                       [name_of(p) for p in running])
        if victim is None:
            return
        pod = next(p for p in running if name_of(p) == victim)
        pod["status"]["phase"] = "Failed"
        pod["status"]["conditions"] = [
            {"type": "Ready", "status": "False"}]
        try:
            api.update_status(pod)
            api.record_event(pod, "Warning", "ChaosKilled",
                             "chaos: injected kubelet pod kill")
        except NotFound:
            pass  # raced a delete; the kill is moot

    def mark_running(self, api: APIServer, pod: dict,
                     live: dict | None = None) -> None:
        # a caller holding the pod's freshly-written state (the bind
        # update's return) passes it as ``live`` to skip the re-read
        pod = live if live is not None else api.get(
            "Pod", name_of(pod), namespace_of(pod))
        containers = deep_get(pod, "spec", "containers", default=[]) or []
        pod["status"] = {
            "phase": "Running",
            "podIP": "10.0.0.1",
            "conditions": [
                {"type": "Ready", "status": "True"},
                {"type": "PodScheduled", "status": "True"},
            ],
            "containerStatuses": [
                {
                    "name": c["name"],
                    "ready": True,
                    "restartCount": 0,
                    "state": {"running": {"startedAt":
                                          api.clock().isoformat()}},
                }
                for c in containers
            ],
        }
        api.update_status(pod)
        # synthesize the container boot transcript (what `kubectl logs`
        # would show): per-ordinal debugging of a multi-host slice is a
        # first-class JWA feature here
        env = {e.get("name"): e.get("value")
               for c in containers for e in (c.get("env") or [])}
        ns, name = namespace_of(pod), name_of(pod)
        now = api.clock().isoformat()
        for c in containers:
            api.append_pod_log(
                ns, name, f"{now} pulled image {c.get('image')}")
        api.append_pod_log(ns, name, f"{now} s6: services started")
        if "TPU_WORKER_ID" in env:
            api.append_pod_log(
                ns, name,
                f"{now} worker-agent: TPU_WORKER_ID={env['TPU_WORKER_ID']} "
                f"hostnames={env.get('TPU_WORKER_HOSTNAMES', '')} "
                "joining torch.distributed")

    def _pick_node(self, api: APIServer, pod: dict, nodes: list[dict],
                   used: dict[str, float]):
        selector = deep_get(pod, "spec", "nodeSelector", default={}) or {}
        need = _pod_tpu_request(pod)
        for node in nodes:
            if selector and not matches_selector(
                    labels_of(node), {"matchLabels": selector}):
                continue
            if need:
                cap = parse_quantity(deep_get(
                    node, "status", "allocatable", NVIDIA_GPU_RESOURCE,
                    default=0))
                if used.get(name_of(node), 0.0) + need > cap:
                    continue
            return node
        if self._allow_virtual(api) and not selector and not need:
            # plain CPU pod: runnable even in a test with no Node inventory
            return {"metadata": {"name": VIRTUAL_NODE}}
        return None

    def _mirror_status(self, api: APIServer, sts: dict) -> None:
        ns = namespace_of(sts)
        pods = [p for p in getattr(api, "scan", api.list)("Pod", ns)
                if any(r.get("uid") == sts["metadata"]["uid"]
                       for r in p["metadata"].get("ownerReferences", []))]
        ready = sum(
            1 for p in pods
            if any(c.get("type") == "Ready" and c.get("status") == "True"
                   for c in deep_get(p, "status", "conditions",
                                     default=[]) or [])
        )
        status = {"replicas": len(pods), "readyReplicas": ready}
        if deep_get(sts, "status") != status:
            sts["status"] = status
            api.update_status(sts)


class DeploymentController(StatefulSetController):
    """Deployment → Pods: same fake kubelet, Deployment semantics
    (no ordinal identity guarantees needed at this fidelity; status
    mirrors readyReplicas/availableReplicas)."""

    kind = "Deployment"

    def watches(self):
        return (("Pod", map_to_owner("Deployment")),)

    def _mirror_status(self, api: APIServer, deploy: dict) -> None:
        ns = namespace_of(deploy)
        pods = [p for p in getattr(api, "scan", api.list)("Pod", ns)
                if any(r.get("uid") == deploy["metadata"]["uid"]
                       for r in p["metadata"].get("ownerReferences", []))]
        ready = sum(
            1 for p in pods
            if any(c.get("type") == "Ready" and c.get("status") == "True"
                   for c in deep_get(p, "status", "conditions",
                                     default=[]) or [])
        )
        status = {"replicas": len(pods), "readyReplicas": ready,
                  "availableReplicas": ready}
        if deep_get(deploy, "status") != status:
            deploy["status"] = status
            api.update_status(deploy)


def _gang_of(sts: dict) -> tuple[str, list[dict]] | None:
    """(job_name, roles) when this STS is one role of a TPUJob gang —
    read off the pod template's gang label + roles annotation, so the
    binder needs no TPUJob CR round-trip."""
    tmpl_md = deep_get(sts, "spec", "template", "metadata",
                       default={}) or {}
    job = (tmpl_md.get("labels") or {}).get(tj_api.JOB_NAME_LABEL)
    if not job:
        return None
    roles = tj_api.parse_roles_annotation({"metadata": tmpl_md})
    if not roles:
        return None
    return job, roles


def _map_gang_pod(obj: dict) -> list[Request]:
    """Fan a gang pod's events out to every role STS of its TPUJob —
    the binder (first role's STS) must reconcile when ANY role's pods
    change, and plain ownership mapping only reaches one role."""
    job = labels_of(obj).get(tj_api.JOB_NAME_LABEL)
    if not job:
        return []
    roles = tj_api.parse_roles_annotation(obj) or []
    ns = namespace_of(obj)
    return [Request(ns, tj_api.role_sts_name(job, r["name"]))
            for r in roles if r.get("name")]


def _ordinal(pod_name: str, sts_name: str) -> int | None:
    prefix = sts_name + "-"
    if not pod_name.startswith(prefix):
        return None
    try:
        return int(pod_name[len(prefix):])
    except ValueError:
        return None


def _pod_tpu_request(pod: dict) -> float:
    return _pod_resource_request(pod, NVIDIA_GPU_RESOURCE)


def _pod_resource_request(pod: dict, resource: str,
                          kind: str = "requests") -> float:
    """kind='requests': requests defaulting to limits (the kube quota
    convention); kind='limits': limits only — matches
    ``apiserver._enforce_quota`` so pre-checks and admission agree."""
    total = 0.0
    for c in deep_get(pod, "spec", "containers", default=[]) or []:
        if kind == "limits":
            amount = deep_get(c, "resources", "limits", resource)
        else:
            amount = deep_get(c, "resources", "requests", resource)
            if amount is None:
                amount = deep_get(c, "resources", "limits", resource)
        if amount is not None:
            total += parse_quantity(amount)
    return total
