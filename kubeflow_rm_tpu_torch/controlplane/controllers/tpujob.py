"""TPUJob reconciler: one heterogeneous gang → one StatefulSet per role.

The first controller whose children are heterogeneous: a TPUJob's
ordered role groups each materialise as a StatefulSet (named
``{job}-{role}``) plus a headless Service, but the *scheduling* unit is
the whole gang — the StatefulSet controller recognises the gang labels
this reconciler stamps and binds every role's pods in ONE mixed-resource
``gang_bind`` transaction (see ``controllers/statefulset.py``). This
reconciler owns:

- rendering: role STS + headless Service per role, gang labels
  (``JOB_NAME_LABEL``/``JOB_ROLE_LABEL``) and the gang-wide
  ``JOB_ROLES_ANNOTATION`` on every pod template — the whole contract
  the webhook's role-aware rendezvous injection reads;
- the single job phase ladder
  Pending→Provisioning→Running→Succeeded/Failed (plus Suspended),
  mirrored into ``status`` with per-role ready counts;
- whole-gang suspend/resume: the shared Notebook suspend annotations
  park EVERY role to zero replicas at once, the drain stamp lands only
  after the last gang pod is gone (and the scheduler charges for both
  resources are released), and demand-resume scales every role back in
  the same render — no half-gang ever runs;
- pod/STS Warning re-emission onto the CR (users see FailedScheduling
  for the gang on the job itself).

(The port's copy of ``kubeflow_rm_tpu/controlplane/controllers/tpujob.py``:
the slice's vocabulary is :mod:`..api.gpu`'s — ``nvidia.com/gpu`` card
limits, the GKE GPU node labels, ``cards_per_host``. The whole-gang
suspend's drain ends in ``suspend.kick_pending_pods``, which requeues
every gang still waiting for cards.)
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane import metrics, scheduler
from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api
from kubeflow_rm_tpu_torch.controlplane.api import tpujob as tj_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    annotations_of,
    deep_get,
    fast_deepcopy,
    name_of,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer, NotFound
from kubeflow_rm_tpu_torch.controlplane.webhook.admission_pricer import (
    is_admission_rejected,
    slice_topology_of,
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
from kubeflow_rm_tpu_torch.utils.profiling import PhaseRecorder

COORDINATOR_PORT = 8476


class TPUJobController(Controller):
    kind = tj_api.KIND

    def __init__(self):
        self.phases = PhaseRecorder()
        self._observe = phase_observer("tpujob", self.phases)

    def watches(self):
        return (
            ("StatefulSet", map_to_owner(tj_api.KIND)),
            ("Pod", map_by_label(tj_api.JOB_NAME_LABEL)),
        )

    def reconcile(self, api: APIServer, req: Request):
        try:
            job = api.get(tj_api.KIND, req.name, req.namespace)
        except NotFound:
            return None  # children follow via GC

        roles = tj_api.roles(job)
        with self._observe("render"):
            children = []
            for role in roles:
                children.append((self._generate_role_sts(job, role),
                                 copy_statefulset_fields))
                children.append((self._generate_role_service(job, role),
                                 copy_service_fields))
        with self._observe("child_writes"):
            reconcile_children(api, job, children)
        with self._observe("suspend"):
            job = self._reconcile_suspend(api, job, roles)
        with self._observe("status"):
            self._mirror_status(api, job, roles)
        with self._observe("events"):
            self._reemit_child_events(api, job, roles)
        return None

    # -- rendering -----------------------------------------------------
    def _generate_role_sts(self, job: dict, role: dict) -> dict:
        job_name = name_of(job)
        ns = job["metadata"]["namespace"]
        sts_name = tj_api.role_sts_name(job_name, role["name"])
        acc = tj_api.role_accelerator(role)
        pods = tj_api.role_pods(role)
        # priced admission: a rejected declaration parks the WHOLE gang
        # — no pod of any role renders until the declaration reprices
        parked = (tj_api.is_stopped(job) or tj_api.is_suspended(job)
                  or is_admission_rejected(job))

        template = fast_deepcopy(role.get("template") or {})
        pod_spec = template.get("spec") or {}
        containers = pod_spec.setdefault("containers", [])
        if not containers:
            containers.append({
                "name": role["name"],
                "image": deep_get(job, "spec", "image",
                                  default=tj_api.DEFAULT_IMAGE),
            })

        pod_labels = dict(job["metadata"].get("labels") or {})
        pod_labels.update({
            "statefulset": sts_name,
            tj_api.JOB_NAME_LABEL: job_name,
            tj_api.JOB_ROLE_LABEL: role["name"],
        })
        pod_annotations = dict(
            deep_get(template, "metadata", "annotations", default={})
            or {})
        pod_annotations[tj_api.JOB_ROLES_ANNOTATION] = \
            tj_api.roles_annotation_value(job)

        if acc:
            topo = gpu_api.lookup(acc)
            pod_labels[nb_api.TPU_ACCELERATOR_LABEL] = acc
            nslices = int(role.get("replicas", 1))
            if nslices > 1:
                pod_labels[nb_api.TPU_NUM_SLICES_LABEL] = str(nslices)
            limits = containers[0].setdefault("resources", {}) \
                .setdefault("limits", {})
            limits[gpu_api.NVIDIA_GPU_RESOURCE] = str(topo.cards_per_host)
            sel = pod_spec.setdefault("nodeSelector", {})
            sel[gpu_api.NODE_LABEL_ACCELERATOR] = topo.gke_accelerator
            sel[gpu_api.NODE_LABEL_TOPOLOGY] = topo.topology
            # priced admission: the declared workload lives on the
            # learner slice — fan its predicted HBM/FLOPs per-pod onto
            # that role only (CPU actors carry no HBM charge)
            priced_topo = slice_topology_of(job)
            if priced_topo and acc == priced_topo.accelerator_type:
                job_ann = annotations_of(job)
                pred = job_ann.get(gpu_api.PREDICTED_HBM_ANNOTATION)
                if pred:
                    try:
                        pod_annotations[
                            gpu_api.PREDICTED_HBM_ANNOTATION] = \
                            f"{float(pred) / topo.hosts:.4f}"
                    except (TypeError, ValueError):
                        pass
                pred = job_ann.get(gpu_api.PREDICTED_FLOPS_ANNOTATION)
                if pred:
                    try:
                        pod_annotations[
                            gpu_api.PREDICTED_FLOPS_ANNOTATION] = \
                            f"{float(pred) / topo.hosts:.6g}"
                    except (TypeError, ValueError):
                        pass
        cpu = role.get("cpu")
        if cpu is not None:
            requests = containers[0].setdefault("resources", {}) \
                .setdefault("requests", {})
            requests[scheduler.CPU_RESOURCE] = str(cpu)

        return {
            "apiVersion": "apps/v1",
            "kind": "StatefulSet",
            "metadata": {
                "name": sts_name,
                "namespace": ns,
                "labels": {tj_api.JOB_NAME_LABEL: job_name,
                           tj_api.JOB_ROLE_LABEL: role["name"]},
            },
            "spec": {
                "replicas": 0 if parked else pods,
                "serviceName": sts_name,
                # a gang needs all its workers together — never ordered
                "podManagementPolicy": "Parallel",
                "selector": {"matchLabels": {"statefulset": sts_name}},
                "template": {
                    "metadata": {"labels": pod_labels,
                                 "annotations": pod_annotations},
                    "spec": pod_spec,
                },
            },
        }

    def _generate_role_service(self, job: dict, role: dict) -> dict:
        job_name = name_of(job)
        ns = job["metadata"]["namespace"]
        sts_name = tj_api.role_sts_name(job_name, role["name"])
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": sts_name, "namespace": ns,
                         "labels": {tj_api.JOB_NAME_LABEL: job_name}},
            "spec": {
                "type": "ClusterIP",
                "clusterIP": "None",
                "selector": {"statefulset": sts_name},
                "ports": [{"name": "jax-coordinator",
                           "port": COORDINATOR_PORT,
                           "targetPort": COORDINATOR_PORT,
                           "protocol": "TCP"}],
            },
        }

    # -- suspend / resume ----------------------------------------------
    def _reconcile_suspend(self, api: APIServer, job: dict,
                           roles: list[dict]) -> dict:
        """Drain/resume bookkeeping for the whole gang. The render
        above already parked every role at zero replicas; here we stamp
        the drain only once the LAST gang pod is gone (and free the
        scheduler's dual-resource charges), and finish a resume only
        once EVERY role is ready again — the no-half-gang invariant."""
        from kubeflow_rm_tpu_torch.controlplane import suspend as suspend_mod

        ann = annotations_of(job)
        name, ns = name_of(job), job["metadata"]["namespace"]
        gang_pods = api.list(
            "Pod", ns,
            {"matchLabels": {tj_api.JOB_NAME_LABEL: name}})
        if nb_api.SUSPEND_ANNOTATION in ann \
                and nb_api.RESUME_REQUESTED_ANNOTATION in ann:
            # demand resume: un-park the gang (the SuspendController
            # does this for Notebooks; TPUJobs own their whole-gang
            # cycle). The next reconcile renders full replicas for
            # EVERY role at once; the completion branch below pops the
            # cycle annotations only when all of them are ready.
            job["metadata"]["annotations"].pop(
                nb_api.SUSPEND_ANNOTATION, None)
            job = api.update(job)
            api.record_event(job, "Normal", "Resuming",
                             "resume requested; re-ganging every role")
        elif nb_api.SUSPEND_ANNOTATION in ann \
                and nb_api.SUSPEND_DRAINED_ANNOTATION not in ann:
            if gang_pods:
                return job  # pods still terminating; events re-trigger
            sched = scheduler.cache_for(api)
            for role in roles:
                sts_name = tj_api.role_sts_name(name, role["name"])
                for i in range(tj_api.role_pods(role)):
                    sched.release((ns, f"{sts_name}-{i}"))
            job["metadata"].setdefault("annotations", {})[
                nb_api.SUSPEND_DRAINED_ANNOTATION] = \
                api.clock().isoformat()
            job = api.update(job)
            api.record_event(
                job, "Normal", "Suspended",
                f"gang drained ({tj_api.total_pods(job)} pods across "
                f"{len(roles)} roles); chips and cpu released")
            # freed capacity may unblock queued gangs right now
            suspend_mod.kick_pending_pods(api, now=api.clock())
        elif nb_api.SUSPEND_ANNOTATION not in ann \
                and nb_api.RESUME_REQUESTED_ANNOTATION in ann:
            ready, total = self._gang_readiness(api, job, roles)
            if total and ready == total:
                md_ann = job["metadata"].setdefault("annotations", {})
                for key in (nb_api.RESUME_REQUESTED_ANNOTATION,
                            nb_api.SUSPEND_DRAINED_ANNOTATION,
                            nb_api.SUSPEND_REASON_ANNOTATION,
                            nb_api.SUSPEND_CHECKPOINT_ANNOTATION):
                    md_ann.pop(key, None)
                job = api.update(job)
                api.record_event(
                    job, "Normal", "Resumed",
                    f"gang restored atomically: {ready}/{total} pods "
                    "across every role")
        return job

    def _gang_readiness(self, api: APIServer, job: dict,
                        roles: list[dict]) -> tuple[int, int]:
        name, ns = name_of(job), job["metadata"]["namespace"]
        ready = total = 0
        for role in roles:
            sts = api.try_get(
                "StatefulSet", tj_api.role_sts_name(name, role["name"]),
                ns)
            ready += deep_get(sts, "status", "readyReplicas",
                              default=0) if sts else 0
            total += tj_api.role_pods(role)
        return ready, total

    # -- status --------------------------------------------------------
    def _mirror_status(self, api: APIServer, job: dict,
                       roles: list[dict]) -> None:
        name, ns = name_of(job), job["metadata"]["namespace"]
        ann = annotations_of(job)
        role_status: dict = {}
        ready = total = 0
        for role in roles:
            sts = api.try_get(
                "StatefulSet", tj_api.role_sts_name(name, role["name"]),
                ns)
            r = deep_get(sts, "status", "readyReplicas",
                         default=0) if sts else 0
            t = tj_api.role_pods(role)
            role_status[role["name"]] = {"ready": r, "total": t}
            ready += r
            total += t
        gang_pods = api.list(
            "Pod", ns, {"matchLabels": {tj_api.JOB_NAME_LABEL: name}})
        phase = self._phase(ann, gang_pods, ready, total)
        status = {"phase": phase, "readyPods": ready,
                  "totalPods": total, "roles": role_status}
        # status.admission is webhook-owned: carry it through the
        # mirror so the replace-style status write doesn't wipe it
        # (the webhook would re-stamp it and reconcile never quiesces)
        adm = deep_get(job, "status", "admission")
        if adm is not None:
            status["admission"] = adm
        prev_phase = deep_get(job, "status", "phase")
        if deep_get(job, "status") != status:
            job["status"] = status
            api.update_status(job)
        if phase != prev_phase:
            metrics.TPUJOB_PHASE_TRANSITIONS_TOTAL.labels(
                phase=phase).inc()
            api.record_event(job, "Normal", phase,
                             f"job phase: {prev_phase or 'none'} → "
                             f"{phase} ({ready}/{total} pods ready)")
        self._refresh_gauges(api)

    @staticmethod
    def _phase(ann: dict, gang_pods: list[dict], ready: int,
               total: int) -> str:
        if nb_api.SUSPEND_ANNOTATION in ann \
                and nb_api.SUSPEND_DRAINED_ANNOTATION in ann:
            return tj_api.SUSPENDED_PHASE
        pod_phases = [deep_get(p, "status", "phase")
                      for p in gang_pods]
        if pod_phases and any(p == "Failed" for p in pod_phases):
            return tj_api.FAILED_PHASE
        if pod_phases and len(pod_phases) >= total \
                and all(p == "Succeeded" for p in pod_phases):
            return tj_api.SUCCEEDED_PHASE
        if total and ready == total:
            return tj_api.RUNNING_PHASE
        if gang_pods:
            return tj_api.PROVISIONING_PHASE
        return tj_api.PENDING_PHASE

    def _refresh_gauges(self, api: APIServer) -> None:
        # cluster-wide recompute (scan: read-only references) so the
        # gauges survive any single job's deletion
        running = 0
        per_role: dict[str, int] = {}
        for job in getattr(api, "scan", api.list)(tj_api.KIND):
            if deep_get(job, "status", "phase") == tj_api.RUNNING_PHASE:
                running += 1
            for rname, rs in (deep_get(job, "status", "roles",
                                       default={}) or {}).items():
                per_role[rname] = per_role.get(rname, 0) \
                    + int(rs.get("ready", 0))
        metrics.TPUJOB_RUNNING.set(running)
        for rname, n in per_role.items():
            metrics.TPUJOB_READY_PODS.labels(role=rname).set(n)

    # -- event re-emission ---------------------------------------------
    def _reemit_child_events(self, api: APIServer, job: dict,
                             roles: list[dict]) -> None:
        name, ns = name_of(job), job["metadata"]["namespace"]
        already = {(e.get("reason"), e.get("message"))
                   for e in api.events_for(job)}

        def reemit(ev, source):
            if ev.get("type") != "Warning":
                return
            sig = (ev.get("reason"), f"[{source}] {ev.get('message')}")
            if sig in already:
                return
            already.add(sig)
            api.record_event(job, "Warning", sig[0], sig[1])

        for pod in api.list(
                "Pod", ns,
                {"matchLabels": {tj_api.JOB_NAME_LABEL: name}}):
            for ev in api.events_for(pod):
                reemit(ev, f"pod {name_of(pod)}")
        for role in roles:
            sts_name = tj_api.role_sts_name(name, role["name"])
            sts = api.try_get("StatefulSet", sts_name, ns)
            if sts is not None:
                for ev in api.events_for(sts):
                    reemit(ev, f"sts {sts_name}")
