"""Slice health: failure detection + whole-slice restart.

The reference's recovery story is level-triggered reconciliation of a
single pod (SURVEY.md §5: "Elasticity is only replicas 0↔1"). A card
slice changes the failure calculus: an SPMD program spans every host,
so ONE failed/preempted worker wedges the other N−1 — they hold cards,
the NCCL collectives block, and nothing recovers until all N pods
restart together. This controller supplies the missing semantic:

- a Failed pod (OOM-kill, preemption, node drain) in a multi-host
  slice ⇒ delete EVERY pod of the slice at once; the StatefulSet
  controller re-creates all ordinals in parallel and the workers
  re-rendezvous from a clean state;
- a vanished pod (count < hosts while peers still run) ⇒ same
  whole-slice restart — a rump slice is never left holding chips;
- single-host notebooks keep the reference behavior: delete just the
  failed pod and let it come back.

Events (``SliceRestart``) make the restart visible in the UI's
activity feed, the way the reference re-emits scheduling failures
(``notebook_controller.go:94-123``).

(The port's copy of ``kubeflow_rm_tpu/controlplane/controllers/slicehealth.py``;
beside these docstring words, the ``SliceRestart`` Event says "GPU
slice unhealthy" where JAX's says "TPU slice unhealthy". A failed pod
here is what the kubelet reports after an Xid error or an OOM kill.)
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import deep_get, name_of
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer, NotFound
from kubeflow_rm_tpu_torch.controlplane.runtime import Controller, Request


def _map_pod_to_notebook(pod: dict):
    label = (pod["metadata"].get("labels") or {}).get(
        nb_api.NOTEBOOK_NAME_LABEL)
    if not label:
        return []
    return [Request(pod["metadata"].get("namespace"), label)]


class SliceHealthController(Controller):
    kind = nb_api.KIND

    def watches(self):
        return (("Pod", _map_pod_to_notebook),)

    def reconcile(self, api: APIServer, req: Request):
        try:
            nb = api.get(self.kind, req.name, req.namespace)
        except NotFound:
            return None
        ann = nb["metadata"].get("annotations") or {}
        if nb_api.STOP_ANNOTATION in ann:
            return None  # stopped/culled: drained pods are expected
        if (nb_api.SUSPEND_ANNOTATION in ann
                or nb_api.RESUME_REQUESTED_ANNOTATION in ann):
            return None  # suspend/resume drains on purpose mid-flight
        if nb_api.replicas_of(nb) > 1:
            # replicated kernels: the failover controller owns recovery
            # (promote a warm standby), not a cold in-place restart
            return None

        # a multislice job is ONE gang: any slice's failure restarts all
        hosts = nb_api.total_hosts(nb)
        # scan(): phase/labels are only read here; deletes go through
        # the verb surface by name
        pods = [
            p for p in getattr(api, "scan", api.list)("Pod", req.namespace)
            if (p["metadata"].get("labels") or {}).get(
                nb_api.NOTEBOOK_NAME_LABEL) == req.name
            and not p["metadata"].get("deletionTimestamp")
        ]
        failed = [p for p in pods
                  if deep_get(p, "status", "phase") == "Failed"]
        running = [p for p in pods
                   if deep_get(p, "status", "phase") == "Running"]

        if hosts == 1:
            # reference behavior: recycle just the failed pod
            for p in failed:
                api.delete("Pod", name_of(p), req.namespace)
            return None

        unhealthy = bool(failed) or (running and len(pods) < hosts)
        if not unhealthy:
            return None

        reason = (f"{len(failed)} failed pod(s)" if failed else
                  f"only {len(pods)}/{hosts} pods present")
        api.record_event(
            nb, "Warning", "SliceRestart",
            f"GPU slice unhealthy ({reason}); restarting all {hosts} "
            "hosts — a slice recovers whole or not at all")
        # tear down by ORDINAL NAME, not by "pods currently visible":
        # this controller reads through an informer cache, and during a
        # churn the cache can momentarily show a partial slice — a
        # visibility-based sweep would then leave survivors, breaking
        # the whole-or-not-at-all guarantee (deletes of already-gone
        # ordinals are NotFound no-ops)
        for i in range(hosts):
            try:
                api.delete("Pod", f"{req.name}-{i}", req.namespace)
            except NotFound:
                pass
        return None
