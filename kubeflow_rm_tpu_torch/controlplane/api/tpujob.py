"""TPUJob — multi-role gang jobs (Podracer-style actor–learner).

A ``TPUJob`` is the first CRD whose children are heterogeneous: its
spec holds an **ordered list of role groups**, each materialised as one
StatefulSet, and the whole job is scheduled as ONE gang — the learner
slice's chip pods and the actors' CPU-only pods bind all-or-nothing in
a single assume transaction (``scheduler.SchedulerCache.gang_bind``).
Podracer (arxiv 2104.06272) is the workload template: a learner on a
TPU slice plus many CPU actors feeding it trajectories; NotebookOS
(arxiv 2503.20591) shows one control plane multiplexing such
heterogeneous roles.

Spec shape (v1, the storage version)::

    spec:
      roles:
        - name: learner
          replicas: 1                 # slices for TPU roles
          tpu: {acceleratorType: h100-80gb-2x4}
        - name: actors
          replicas: 4                 # pods for CPU roles
          cpu: "2"                    # per-pod CPU request
      priorityClassName: default      # optional

A TPU role's pod count is ``replicas × hosts(acceleratorType)`` (one
pod per host, exactly like a Notebook slice); a CPU role's is
``replicas``. The controller stamps every gang pod with
``JOB_NAME_LABEL``/``JOB_ROLE_LABEL`` and the gang-wide
``JOB_ROLES_ANNOTATION`` so the webhook can inject role-aware
rendezvous env (``TPU_JOB_ROLE``, ``TPU_JOB_ROLE_INDEX``, per-role
hostname lists, the learner address) without the client polling.

Suspend/resume reuses the Notebook annotation vocabulary
(``notebook.SUSPEND_ANNOTATION`` etc.) so ``controlplane/suspend.py``
helpers drive both kinds; parking a TPUJob scales EVERY role to zero —
no half-gang ever runs.
"""

from __future__ import annotations

import json
import re

from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    annotations_of,
    deep_get,
    labels_of,
    make_object,
    name_of,
    parse_quantity,
)

API_VERSION = "kubeflow.org/v1"
KIND = "TPUJob"

#: stamped on every gang pod (and role STS pod template) — the webhook
#: keys role injection off these, the controller maps Pod events back
#: to the job, and the binder collects the whole gang by this label
JOB_NAME_LABEL = "tpu.kubeflow.org/job"
JOB_ROLE_LABEL = "tpu.kubeflow.org/job-role"

#: gang-wide role metadata, JSON on every gang pod:
#: ``[{"name", "pods", "service", "tpu"}, ...]`` in spec order — enough
#: for the webhook to render every role's hostname list and for the
#: StatefulSet binder to know the expected gang size without a CR read
JOB_ROLES_ANNOTATION = "tpu.kubeflow.org/job-roles"

# ---- the rendezvous env contract (webhook → launcher) ----------------
ENV_JOB_NAME = "TPU_JOB_NAME"
ENV_JOB_ROLE = "TPU_JOB_ROLE"
ENV_JOB_ROLE_INDEX = "TPU_JOB_ROLE_INDEX"
ENV_JOB_ROLE_HOSTNAMES = "TPU_JOB_ROLE_HOSTNAMES"
#: + TPU_JOB_HOSTNAMES_<ROLE> (uppercased, ``-``→``_``) per role
ENV_JOB_HOSTNAMES_PREFIX = "TPU_JOB_HOSTNAMES_"
ENV_LEARNER_ADDRESS = "TPU_JOB_LEARNER_ADDRESS"

# ---- job phases ------------------------------------------------------
PENDING_PHASE = "Pending"
PROVISIONING_PHASE = "Provisioning"
RUNNING_PHASE = "Running"
SUCCEEDED_PHASE = "Succeeded"
FAILED_PHASE = "Failed"
#: parked gangs report the shared suspend phase
SUSPENDED_PHASE = nb_api.SUSPENDED_PHASE

MAX_ROLES = 8
MAX_ROLE_REPLICAS = 512

_ROLE_NAME_RE = re.compile(r"^[a-z]([a-z0-9-]{0,30}[a-z0-9])?$")

DEFAULT_IMAGE = "jupyter-jax:latest"


def roles(job: dict) -> list[dict]:
    """The ordered role groups (spec order is rendezvous order — the
    first role's STS is the gang's binder)."""
    return deep_get(job, "spec", "roles", default=[]) or []


def role_accelerator(role: dict) -> str | None:
    return deep_get(role, "tpu", "acceleratorType")


def role_pods(role: dict) -> int:
    """Pods this role materialises: slices × hosts for TPU roles,
    replicas for CPU roles."""
    replicas = int(role.get("replicas", 1))
    acc = role_accelerator(role)
    if acc:
        return replicas * gpu_api.lookup(acc).hosts
    return replicas


def total_pods(job: dict) -> int:
    return sum(role_pods(r) for r in roles(job))


def role_sts_name(job_name: str, role_name: str) -> str:
    """One StatefulSet (and identically-named headless Service) per
    role — pod DNS is ``{job}-{role}-{i}.{job}-{role}.{ns}.svc...``."""
    return f"{job_name}-{role_name}"


def learner_role(job_roles: list[dict]) -> dict | None:
    """The role whose pod 0 is the gang's rendezvous anchor: the role
    named ``learner`` if present, else the first TPU role, else the
    first role. Accepts both spec-shape roles (``tpu`` is a dict) and
    annotation-shape roles (``tpu`` is the accelerator string)."""
    if not job_roles:
        return None
    for r in job_roles:
        if r.get("name") == "learner":
            return r
    for r in job_roles:
        if r.get("tpu"):
            return r
    return job_roles[0]


def roles_annotation_value(job: dict) -> str:
    """The JSON the controller stamps on every gang pod."""
    out = []
    for r in roles(job):
        out.append({
            "name": r["name"],
            "pods": role_pods(r),
            "service": role_sts_name(name_of(job), r["name"]),
            "tpu": role_accelerator(r),
        })
    return json.dumps(out, separators=(",", ":"))


def parse_roles_annotation(pod: dict) -> list[dict] | None:
    """Decode ``JOB_ROLES_ANNOTATION`` off a gang pod (or a pod
    template dict); None when absent or malformed."""
    raw = annotations_of(pod).get(JOB_ROLES_ANNOTATION)
    if not raw:
        return None
    try:
        parsed = json.loads(raw)
    except (TypeError, ValueError):
        return None
    if not isinstance(parsed, list):
        return None
    return parsed


def priority_of(job: dict) -> int:
    cls = deep_get(job, "spec", "priorityClassName",
                   default="default")
    return nb_api.PRIORITY_CLASSES.get(cls, nb_api.DEFAULT_PRIORITY)


def is_suspended(job: dict) -> bool:
    return nb_api.SUSPEND_ANNOTATION in annotations_of(job)


def is_stopped(job: dict) -> bool:
    return nb_api.STOP_ANNOTATION in annotations_of(job)


def make_tpujob(name: str, namespace: str | None = None, *,
                roles: list[dict],
                image: str = DEFAULT_IMAGE,
                priority_class: str | None = None,
                labels: dict | None = None,
                annotations: dict | None = None) -> dict:
    spec: dict = {"roles": roles, "image": image}
    if priority_class:
        spec["priorityClassName"] = priority_class
    return make_object(API_VERSION, KIND, name, namespace,
                       labels=labels, annotations=annotations,
                       spec=spec)


def validate(job: dict) -> None:
    """Admission validation (raises ValueError on a bad spec)."""
    job_roles = roles(job)
    if not job_roles:
        raise ValueError("spec.roles must name at least one role group")
    if len(job_roles) > MAX_ROLES:
        raise ValueError(
            f"spec.roles has {len(job_roles)} groups; max {MAX_ROLES}")
    seen: set[str] = set()
    for r in job_roles:
        rname = r.get("name")
        if not rname or not _ROLE_NAME_RE.match(str(rname)):
            raise ValueError(
                f"role name {rname!r} must be a short DNS label "
                "(lowercase alphanumerics and '-')")
        if rname in seen:
            raise ValueError(f"duplicate role name {rname!r}")
        seen.add(rname)
        replicas = r.get("replicas", 1)
        if not isinstance(replicas, int) or \
                not 1 <= replicas <= MAX_ROLE_REPLICAS:
            raise ValueError(
                f"role {rname!r}: replicas must be an integer in "
                f"[1, {MAX_ROLE_REPLICAS}], got {replicas!r}")
        acc = role_accelerator(r)
        if acc:
            gpu_api.lookup(acc)  # raises UnknownAcceleratorType
        cpu = r.get("cpu")
        if cpu is not None:
            try:
                amount = parse_quantity(cpu)
            except (TypeError, ValueError):
                raise ValueError(
                    f"role {rname!r}: cpu {cpu!r} is not a quantity"
                ) from None
            if amount <= 0:
                raise ValueError(
                    f"role {rname!r}: cpu must be positive, got {cpu!r}")
    cls = deep_get(job, "spec", "priorityClassName")
    if cls is not None and cls not in nb_api.PRIORITY_CLASSES:
        raise ValueError(
            f"unknown priorityClassName {cls!r}; known: "
            f"{sorted(nb_api.PRIORITY_CLASSES)}")


def job_name_of_pod(pod: dict) -> str | None:
    """The owning TPUJob's name, for any pod carrying the gang label."""
    return labels_of(pod).get(JOB_NAME_LABEL)
