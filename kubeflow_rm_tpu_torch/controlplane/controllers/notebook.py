"""Notebook reconciler: Notebook CR → card-slice StatefulSet + Services
(counterpart of ``kubeflow_rm_tpu/controlplane/controllers/notebook.py``).

Slice-first rework of the reference core reconciler
(``notebook-controller/controllers/notebook_controller.go``):

- ``generateStatefulSet`` (ref ``:408-484``): here replicas =
  hosts-per-slice (the reference hardcodes replicas ∈ {0,1} — ``:409-412``),
  ``podManagementPolicy: Parallel`` for multihost slices (rendezvous
  needs all workers up together, not ordered), ``nvidia.com/gpu`` card
  limits and the GKE GPU node selectors rendered from ``spec.tpu``
  (:mod:`..api.gpu`).
- two Services instead of one (ref ``generateService`` ``:486-513``): a
  ClusterIP service pinned to worker-0 (the Jupyter UI lives there) and
  a headless service over all workers (stable per-ordinal DNS — the
  rendezvous substrate the webhook's TPU_WORKER_HOSTNAMES points at).
- stop-annotation → replicas=0 (``:410-412``), whole slice at once: a
  TPU slice is all-or-nothing.
- status mirroring from pod ordinal 0 (ref ``updateNotebookStatus``
  ``:274-349``) plus slice-aware readyReplicas.
- pod-event re-emission onto the Notebook (ref ``:94-123,662-736``) so
  users see FailedScheduling (no free slice) on the CR itself.
"""

from __future__ import annotations

import copy

from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    fast_deepcopy,
    annotations_of,
    deep_get,
    name_of,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer, NotFound
from kubeflow_rm_tpu_torch.controlplane.webhook.admission_pricer import (
    is_admission_rejected,
)
from kubeflow_rm_tpu_torch.controlplane.runtime import (
    Controller,
    Request,
    copy_service_fields,
    copy_statefulset_fields,
    map_by_label,
    map_to_owner,
    phase_observer,
    reconcile_children,
)
from kubeflow_rm_tpu_torch.controlplane import metrics
from kubeflow_rm_tpu_torch.utils.profiling import PhaseRecorder

DEFAULT_CONTAINER_PORT = 8888
SERVICE_PORT = 80


def headless_name(notebook_name: str) -> str:
    return f"{notebook_name}-workers"


def standby_name(notebook_name: str) -> str:
    return f"{notebook_name}-standby"


# label carried by standby pods INSTEAD of NOTEBOOK_NAME_LABEL: the
# drain/slice-health/failover machinery counts gang pods by the
# notebook-name label, and a CPU standby must never be mistaken for a
# slice member
STANDBY_LABEL = "notebook-standby"


class NotebookController(Controller):
    kind = nb_api.KIND

    def __init__(self, use_istio: bool = True,
                 istio_gateway: str = "kubeflow/kubeflow-gateway"):
        # the reference gates VirtualService rendering on USE_ISTIO
        # (notebook_controller.go:519-533); here it is constructor
        # config like every other knob
        self.use_istio = use_istio
        self.istio_gateway = istio_gateway
        self.phases = PhaseRecorder()
        self._observe = phase_observer("notebook", self.phases)

    def watches(self):
        return (
            ("StatefulSet", map_to_owner(nb_api.KIND)),
            ("Pod", map_by_label(nb_api.NOTEBOOK_NAME_LABEL)),
            ("Event", _map_event_to_notebook),
        )

    def reconcile(self, api: APIServer, req: Request):
        try:
            notebook = api.get(nb_api.KIND, req.name, req.namespace)
        except NotFound:
            return None  # children follow via GC

        with self._observe("render"):
            topo = nb_api.tpu_spec(notebook)
            parked, deferring = self._parked_state(api, notebook)
            # predictive admission: a priced-rejected declaration never
            # renders pods — the OOM is refused BEFORE placement; the
            # webhook's status.admission carries the explanation and
            # the advisor rung that would lift the gate
            rejected = is_admission_rejected(notebook)
            sts = self._generate_statefulset(
                notebook, topo, parked=parked or deferring or rejected)
            children = [(sts, copy_statefulset_fields)]
            replicas = nb_api.replicas_of(notebook)
            if replicas > 1:
                children.append((
                    self._generate_standby_statefulset(notebook, replicas),
                    copy_statefulset_fields))
            children += [(svc, copy_service_fields)
                         for svc in self._generate_services(notebook, topo)]
            if self.use_istio:
                children.append((self._generate_virtualservice(notebook),
                                 _copy_virtualservice_fields))

        creating = api.try_get("StatefulSet", req.name, req.namespace) is None
        try:
            with self._observe("child_writes"):
                reconcile_children(api, notebook, children)
        except Exception:
            if creating:
                # the STS write itself may have landed before a sibling
                # failed — only count a failed *create* if it didn't
                if api.try_get("StatefulSet", req.name,
                               req.namespace) is None:
                    metrics.NOTEBOOK_CREATE_FAILED_TOTAL.inc()
                else:
                    metrics.NOTEBOOK_CREATE_TOTAL.inc()
            raise
        if creating:
            metrics.NOTEBOOK_CREATE_TOTAL.inc()
        if nb_api.replicas_of(notebook) <= 1:
            # replicas collapsed back to 1: retire the standby fleet
            standby = api.try_get("StatefulSet",
                                  standby_name(req.name), req.namespace)
            if standby is not None:
                api.delete("StatefulSet", standby_name(req.name),
                           req.namespace)

        with self._observe("status"):
            self._mirror_status(api, notebook, topo,
                                parked=parked, deferring=deferring)
        with self._observe("events"):
            self._reemit_pod_events(api, notebook)
        return None

    # -- rendering -----------------------------------------------------
    def _parked_state(self, api: APIServer,
                      notebook: dict) -> tuple[bool, bool]:
        """(parked, deferring): parked = user-stopped OR suspended
        (chips released to the pool) — renders to zero replicas; the
        difference is who brings them back (a user vs. any incoming
        request). deferring = the park was just lifted but the OLD
        epoch's pods are still draining: the slice stays at zero until
        they are gone, so a restart can never interleave fresh ordinals
        with half-drained ones (the slice-health controller would read
        that mix as a rump slice and churn-restart it)."""
        ann = annotations_of(notebook)
        parked = (nb_api.STOP_ANNOTATION in ann
                  or nb_api.SUSPEND_ANNOTATION in ann)
        deferring = False
        if not parked and deep_get(notebook, "status", "parked",
                                   default=False):
            name = name_of(notebook)
            ns = notebook["metadata"]["namespace"]
            owned = [
                p for p in getattr(api, "scan", api.list)("Pod", ns)
                if (p["metadata"].get("labels") or {}).get(
                    nb_api.NOTEBOOK_NAME_LABEL) == name
            ]
            deferring = bool(owned)
        return parked, deferring

    def _generate_statefulset(self, notebook: dict,
                              topo: gpu_api.SliceTopology | None, *,
                              parked: bool) -> dict:
        name = name_of(notebook)
        ns = notebook["metadata"]["namespace"]
        # multislice: one StatefulSet spans every slice (slice_id =
        # ordinal // hosts-per-slice); the webhook derives per-slice
        # rendezvous + MEGASCALE_* DCN env from the labels below
        hosts = nb_api.total_hosts(notebook)
        ann = annotations_of(notebook)
        replicas = 0 if parked else hosts

        pod_spec = fast_deepcopy(
            deep_get(notebook, "spec", "template", "spec", default={}))
        containers = pod_spec.get("containers") or []
        if containers:
            c0 = containers[0]
            env = c0.setdefault("env", [])
            _upsert_env(env, "NB_PREFIX", f"/notebook/{ns}/{name}")
        # CR labels flow onto the pods (ref notebook_controller.go:441-443)
        # — the hook PodDefault selectors match on (JWA "configurations"
        # writes label keys to the Notebook metadata); ours win on clash
        pod_labels = dict(notebook["metadata"].get("labels") or {})
        pod_labels.update({
            "statefulset": name,
            nb_api.NOTEBOOK_NAME_LABEL: name,
        })
        pod_annotations = {}
        if topo:
            pod_labels[nb_api.TPU_ACCELERATOR_LABEL] = topo.accelerator_type
            nslices = nb_api.num_slices(notebook)
            if nslices > 1:
                pod_labels[nb_api.TPU_NUM_SLICES_LABEL] = str(nslices)
            if containers:
                limits = containers[0].setdefault("resources", {}) \
                    .setdefault("limits", {})
                limits[gpu_api.NVIDIA_GPU_RESOURCE] = str(topo.cards_per_host)
            sel = pod_spec.setdefault("nodeSelector", {})
            sel[gpu_api.NODE_LABEL_ACCELERATOR] = topo.gke_accelerator
            if topo.multihost:
                # multi-host slices need the exact ICI topology
                sel[gpu_api.NODE_LABEL_TOPOLOGY] = topo.topology
            # single-host slices select on accelerator family only: a
            # v6e-1 kernel packs onto any free v6e host regardless of
            # the node pool's nominal topology, which is what lets the
            # scheduler bin-pack small kernels and the compaction
            # migrator defragment them

            # priced admission: fan the slice's predicted HBM/FLOPs
            # onto every host pod as its per-pod share — the scheduler
            # packs on these beside the chip count
            pred_hbm = ann.get(gpu_api.PREDICTED_HBM_ANNOTATION)
            if pred_hbm:
                try:
                    pod_annotations[gpu_api.PREDICTED_HBM_ANNOTATION] = \
                        f"{float(pred_hbm) / topo.hosts:.4f}"
                except (TypeError, ValueError):
                    pass
            pred_flops = ann.get(gpu_api.PREDICTED_FLOPS_ANNOTATION)
            if pred_flops:
                try:
                    pod_annotations[gpu_api.PREDICTED_FLOPS_ANNOTATION] = \
                        f"{float(pred_flops) / topo.hosts:.6g}"
                except (TypeError, ValueError):
                    pass

        sts_annotations: dict = {}
        if nb_api.MIGRATE_EXCLUDE_ANNOTATION in ann:
            # live migration: the re-bind must avoid the nodes the
            # slice just drained off; the STS controller reads this
            # through to gang_bind(exclude_nodes=...)
            sts_annotations[nb_api.MIGRATE_EXCLUDE_ANNOTATION] = \
                ann[nb_api.MIGRATE_EXCLUDE_ANNOTATION]

        return {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {
                "name": name,
                "namespace": ns,
                "labels": {nb_api.NOTEBOOK_NAME_LABEL: name},
                **({"annotations": sts_annotations}
                   if sts_annotations else {}),
            },
            "spec": {
                "replicas": replicas,
                "serviceName": headless_name(name),
                "podManagementPolicy": "Parallel" if hosts > 1
                                       else "OrderedReady",
                "selector": {"matchLabels": {"statefulset": name}},
                "template": {
                    "metadata": {"labels": pod_labels,
                                 "annotations": pod_annotations},
                    "spec": pod_spec,
                },
            },
        }

    def _generate_standby_statefulset(self, notebook: dict,
                                      replicas: int) -> dict:
        """R−1 parked CPU-only standby kernels (NotebookOS replication).

        Standbys hold NO chips: no TPU resource limits, no TPU node
        selector — they bind anywhere (or virtually) and stay warm
        purely through the checkpoint state store, which is what makes
        R−1 extra replicas nearly free. They deliberately do NOT carry
        ``NOTEBOOK_NAME_LABEL``: every gang-membership scan (drain
        completion, slice health, failover death detection) counts
        pods by that label, and a standby is not a slice member."""
        name = name_of(notebook)
        ns = notebook["metadata"]["namespace"]
        ann = annotations_of(notebook)
        sname = standby_name(name)
        pod_spec = fast_deepcopy(
            deep_get(notebook, "spec", "template", "spec", default={}))
        pod_spec.pop("nodeSelector", None)
        for c in pod_spec.get("containers") or []:
            limits = deep_get(c, "resources", "limits")
            if limits:
                limits.pop(gpu_api.NVIDIA_GPU_RESOURCE, None)
        containers = pod_spec.get("containers") or []
        if containers:
            env = containers[0].setdefault("env", [])
            _upsert_env(env, "NB_PREFIX", f"/notebook/{ns}/{name}")
            _upsert_env(env, "NB_STANDBY", "1")
        count = 0 if nb_api.STOP_ANNOTATION in ann else replicas - 1
        return {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {
                "name": sname,
                "namespace": ns,
                "labels": {STANDBY_LABEL: name},
            },
            "spec": {
                "replicas": count,
                "serviceName": headless_name(name),
                "podManagementPolicy": "Parallel",
                "selector": {"matchLabels": {"statefulset": sname}},
                "template": {
                    "metadata": {"labels": {
                        "statefulset": sname,
                        STANDBY_LABEL: name,
                    }},
                    "spec": pod_spec,
                },
            },
        }

    def _generate_services(self, notebook: dict,
                           topo: gpu_api.SliceTopology | None) -> list[dict]:
        name = name_of(notebook)
        ns = notebook["metadata"]["namespace"]
        # UI service: port 80 → 8888 on worker 0 only
        ui = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": name, "namespace": ns,
                         "labels": {nb_api.NOTEBOOK_NAME_LABEL: name}},
            "spec": {
                "type": "ClusterIP",
                "selector": {
                    "statefulset.kubernetes.io/pod-name": f"{name}-0"},
                "ports": [{
                    "name": "http-" + name,
                    "port": SERVICE_PORT,
                    "targetPort": DEFAULT_CONTAINER_PORT,
                    "protocol": "TCP",
                }],
            },
        }
        # headless worker service: stable DNS for every ordinal
        workers = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": headless_name(name), "namespace": ns,
                         "labels": {nb_api.NOTEBOOK_NAME_LABEL: name}},
            "spec": {
                "type": "ClusterIP",
                "clusterIP": "None",
                "selector": {"statefulset": name},
                "ports": [{"name": "jax-coordinator", "port": 8476,
                           "targetPort": 8476, "protocol": "TCP"}],
            },
        }
        return [ui, workers]

    def _generate_virtualservice(self, notebook: dict) -> dict:
        """Gateway route for the notebook UI (ref
        ``notebook_controller.go:519-619`` ``generateVirtualService``):
        prefix-match ``/notebook/<ns>/<name>/``, rewrite to the
        annotation's URI (default "/"), optional request headers from
        the headers annotation, destination = the worker-0 UI Service."""
        import json as _json

        name = name_of(notebook)
        ns = notebook["metadata"]["namespace"]
        ann = annotations_of(notebook)
        prefix = f"/notebook/{ns}/{name}/"
        rewrite = ann.get(nb_api.REWRITE_URI_ANNOTATION) or "/"
        http_route: dict = {
            "match": [{"uri": {"prefix": prefix}}],
            "rewrite": {"uri": rewrite},
            "route": [{"destination": {
                "host": f"{name}.{ns}.svc.cluster.local",
                "port": {"number": SERVICE_PORT},
            }}],
            "timeout": "300s",
        }
        raw_headers = ann.get(nb_api.HEADERS_ANNOTATION)
        if raw_headers:
            try:
                headers = _json.loads(raw_headers)
                if isinstance(headers, dict):
                    http_route["headers"] = {"request": {"set": headers}}
            except ValueError:
                pass  # malformed annotation: route without headers, as ref
        return {
            "apiVersion": "networking.istio.io/v1beta1",
            "kind": "VirtualService",
            "metadata": {"name": f"notebook-{ns}-{name}", "namespace": ns,
                         "labels": {nb_api.NOTEBOOK_NAME_LABEL: name}},
            "spec": {
                "hosts": ["*"],
                "gateways": [self.istio_gateway],
                "http": [http_route],
            },
        }

    # -- status --------------------------------------------------------
    def _mirror_status(self, api: APIServer, notebook: dict,
                       topo: gpu_api.SliceTopology | None, *,
                       parked: bool, deferring: bool) -> None:
        name, ns = name_of(notebook), notebook["metadata"]["namespace"]
        hosts = nb_api.total_hosts(notebook)
        sts = api.try_get("StatefulSet", name, ns)
        ready = deep_get(sts, "status", "readyReplicas", default=0) if sts \
            else 0
        ann = annotations_of(notebook)
        effective_parked = parked or deferring
        epoch = int(deep_get(notebook, "status", "restartEpoch",
                             default=0))
        prev_parked = bool(deep_get(notebook, "status", "parked",
                                    default=False))
        if prev_parked and not effective_parked:
            # the park fully lifted (old pods drained): this status
            # write starts a NEW epoch AND zeroes readyReplicas in the
            # same write — a watcher waiting on the restart must never
            # see the previous epoch's stale ready count
            epoch += 1
            ready = 0
        status: dict = {
            "readyReplicas": ready,
            "desiredReplicas": 0 if effective_parked else hosts,
            "parked": effective_parked,
            "restartEpoch": epoch,
        }
        if (nb_api.SUSPEND_ANNOTATION in ann
                and nb_api.SUSPEND_DRAINED_ANNOTATION in ann):
            status["phase"] = nb_api.SUSPENDED_PHASE
        replicas = nb_api.replicas_of(notebook)
        if replicas > 1:
            status["replicas"] = replicas
            active = ann.get(nb_api.ACTIVE_REPLICA_ANNOTATION)
            if active is not None:
                status["activeReplica"] = active
            raw_states = ann.get(nb_api.REPLICA_STATES_ANNOTATION)
            if raw_states:
                import json as _json
                try:
                    status["replicaStates"] = _json.loads(raw_states)
                except ValueError:
                    pass
        pod0 = api.try_get("Pod", f"{name}-0", ns)
        if pod0:
            cs = deep_get(pod0, "status", "containerStatuses", 0)
            if cs:
                status["containerState"] = cs.get("state", {})
            status["conditions"] = [
                {"type": c.get("type"), "status": c.get("status")}
                for c in deep_get(pod0, "status", "conditions",
                                  default=[]) or []
            ]
        # status.admission is webhook-owned: carry it through the
        # mirror or the replace-style status write would wipe it, the
        # webhook would re-stamp it, and the reconcile never quiesces
        adm = deep_get(notebook, "status", "admission")
        if adm is not None:
            status["admission"] = adm
        if deep_get(notebook, "status") != status:
            prev_ready = deep_get(notebook, "status", "readyReplicas",
                                  default=0)
            notebook["status"] = status
            api.update_status(notebook)
            if not parked and hosts > 0 and prev_ready < hosts <= ready:
                self._observe_provision_latency(api, notebook)
        metrics.NOTEBOOK_RUNNING.set(self._count_running(api))

    @staticmethod
    def _observe_provision_latency(api: APIServer, notebook: dict
                                   ) -> None:
        """First transition to fully-ready: record creationTimestamp ->
        now as the provision SLI (``provision_latency_seconds``). Uses
        the apiserver's clock so injected test clocks stay coherent."""
        import datetime
        try:
            created = deep_get(notebook, "metadata", "creationTimestamp")
            if not created:
                return
            clock = getattr(api, "clock", None)
            now = clock() if callable(clock) \
                else datetime.datetime.now(datetime.timezone.utc)
            then = datetime.datetime.fromisoformat(
                str(created).replace("Z", "+00:00"))
            if then.tzinfo is None and now.tzinfo is not None:
                then = then.replace(tzinfo=now.tzinfo)
            if now.tzinfo is None and then.tzinfo is not None:
                then = then.replace(tzinfo=None)
            elapsed = (now - then).total_seconds()
            if elapsed >= 0:
                metrics.PROVISION_LATENCY_SECONDS.observe(elapsed)
        except Exception:  # noqa: BLE001 - SLI capture is best-effort
            metrics.swallowed("notebook", "provision latency observe")

    def _count_running(self, api: APIServer) -> int:
        # scan(): read-only references — this gauge refresh runs at the
        # tail of EVERY notebook reconcile, and copying every Notebook
        # in the cluster for a counter was pure overhead
        n = 0
        for nb in getattr(api, "scan", api.list)(nb_api.KIND):
            if deep_get(nb, "status", "readyReplicas", default=0) >= 1:
                n += 1
        return n

    # -- event re-emission (ref :662-736) ------------------------------
    def _reemit_pod_events(self, api: APIServer, notebook: dict) -> None:
        """Surface Warning events of the notebook's Pods AND its
        StatefulSet onto the Notebook CR — the reference's watch
        predicate covers both (``isStsOrPodEvent``,
        ``notebook_controller.go:700-736``), and the STS is where
        slice-level failures land (SliceAdmissionFailed,
        FailedCreate)."""
        name, ns = name_of(notebook), notebook["metadata"]["namespace"]
        already = {
            (e.get("reason"), e.get("message"))
            for e in api.events_for(notebook)
        }

        def reemit(ev, source):
            if ev.get("type") != "Warning":
                return  # only surface problems, as the ref predicate does
            sig = (ev.get("reason"), f"[{source}] {ev.get('message')}")
            if sig in already:
                return
            already.add(sig)
            api.record_event(notebook, "Warning", sig[0], sig[1])

        pods = api.list("Pod", ns, {"matchLabels":
                                    {nb_api.NOTEBOOK_NAME_LABEL: name}})
        for pod in pods:
            for ev in api.events_for(pod):
                reemit(ev, f"pod {name_of(pod)}")
        sts = api.try_get("StatefulSet", name, ns)
        if sts is not None:
            for ev in api.events_for(sts):
                reemit(ev, f"sts {name}")


def _map_event_to_notebook(event_obj: dict):
    inv = event_obj.get("involvedObject") or {}
    if inv.get("kind") == "Pod" and inv.get("name"):
        # pod name {notebook}-{ordinal}
        base = inv["name"].rsplit("-", 1)[0]
        return [Request(inv.get("namespace"), base)]
    if inv.get("kind") == "StatefulSet" and inv.get("name"):
        # the notebook's STS shares its name
        return [Request(inv.get("namespace"), inv["name"])]
    return []


def _copy_virtualservice_fields(desired: dict, found: dict) -> bool:
    changed = False
    for field in ("labels", "annotations"):
        want = desired["metadata"].get(field) or {}
        if (found["metadata"].get(field) or {}) != want:
            found["metadata"][field] = dict(want)
            changed = True
    if found.get("spec") != desired.get("spec"):
        found["spec"] = fast_deepcopy(desired["spec"])
        changed = True
    return changed


def _upsert_env(env: list, name: str, value: str) -> None:
    for e in env:
        if e.get("name") == name:
            e["value"] = value
            return
    env.append({"name": name, "value": value})
