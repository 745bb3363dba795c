"""Notebook status derivation — the UI's status ladder (the port's copy
of ``kubeflow_rm_tpu/controlplane/webapps/status.py``).

Mirrors the reference's ``process_status``
(``crud-web-apps/jupyter/backend/apps/common/status.py:9-60``): a
Notebook is reported as one of [ready | waiting | warning |
terminating | stopped], derived in priority order from the stop
annotation, deletionTimestamp, readyReplicas vs the slice's host
count, containerState, conditions, and finally warning Events. The
slice difference: readiness is *slice* readiness — an h100-80gb-2x4
notebook is "waiting" until BOTH hosts are Ready, because a partially-up
slice cannot join its torch.distributed world.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    annotations_of, deep_get,
)

PHASE_READY = "ready"
PHASE_WAITING = "waiting"
PHASE_WARNING = "warning"
PHASE_TERMINATING = "terminating"
PHASE_STOPPED = "stopped"
PHASE_SUSPENDED = "suspended"


@dataclass(frozen=True)
class Status:
    phase: str
    message: str

    def to_dict(self) -> dict:
        return asdict(self)


def process_status(notebook: dict, events: list[dict] | None = None) -> Status:
    ann = annotations_of(notebook)

    if notebook["metadata"].get("deletionTimestamp"):
        return Status(PHASE_TERMINATING, "Deleting this Notebook.")

    if nb_api.SUSPEND_ANNOTATION in ann:
        # suspended ≠ stopped: the cards went back to the pool, but any
        # incoming request (this UI included) transparently resumes it
        if deep_get(notebook, "status", "readyReplicas", default=0):
            return Status(PHASE_WAITING, "Suspending this Notebook.")
        return Status(PHASE_SUSPENDED,
                      "Notebook is suspended; its GPU slice was released. "
                      "It will resume automatically on the next request.")
    if nb_api.RESUME_REQUESTED_ANNOTATION in ann:
        return Status(PHASE_WAITING, "Resuming this Notebook.")

    if nb_api.STOP_ANNOTATION in ann:
        # mirrors get_stopped_status: a stopped CR with replicas still
        # up is "stopping"; fully drained is "stopped"
        if deep_get(notebook, "status", "readyReplicas", default=0):
            return Status(PHASE_WAITING, "Stopping this Notebook.")
        return Status(PHASE_STOPPED, "No Pods are currently running for "
                                     "this Notebook.")

    topo = nb_api.tpu_spec(notebook)
    want = nb_api.total_hosts(notebook)
    ready = deep_get(notebook, "status", "readyReplicas", default=0)
    if ready >= want:
        return Status(PHASE_READY, "Running.")

    # waiting on containers: surface the container state if one exists
    cstate = deep_get(notebook, "status", "containerState", default={}) or {}
    if "waiting" in cstate:
        reason = deep_get(cstate, "waiting", "reason", default="")
        phase = PHASE_WARNING if reason in (
            "ImagePullBackOff", "CrashLoopBackOff", "ErrImagePull",
        ) else PHASE_WAITING
        return Status(phase, f"Container is waiting: {reason}.")

    # scan warning events for scheduling errors (get_status_from_events)
    for ev in reversed(events or []):
        if ev.get("type") == "Warning":
            return Status(PHASE_WARNING, ev.get("message", ev.get("reason",
                                                                  "")))

    if topo and topo.multihost and ready:
        return Status(PHASE_WAITING,
                      f"Slice is starting: {ready}/{want} hosts ready.")
    return Status(PHASE_WAITING, "Starting this Notebook.")
