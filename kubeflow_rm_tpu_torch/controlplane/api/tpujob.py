"""The TPUJob fields and rendezvous env names the port's seams read
(copies from ``kubeflow_rm_tpu/controlplane/api/tpujob.py``)."""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane.api.meta import deep_get

KIND = "TPUJob"

# ---- the rendezvous env contract (webhook → launcher) ----------------
ENV_JOB_NAME = "TPU_JOB_NAME"
ENV_JOB_ROLE = "TPU_JOB_ROLE"
ENV_JOB_ROLE_INDEX = "TPU_JOB_ROLE_INDEX"
ENV_JOB_ROLE_HOSTNAMES = "TPU_JOB_ROLE_HOSTNAMES"
#: + TPU_JOB_HOSTNAMES_<ROLE> (uppercased, ``-``→``_``) per role
ENV_JOB_HOSTNAMES_PREFIX = "TPU_JOB_HOSTNAMES_"
ENV_LEARNER_ADDRESS = "TPU_JOB_LEARNER_ADDRESS"


def roles(job: dict) -> list[dict]:
    """The ordered role groups (spec order is rendezvous order)."""
    return deep_get(job, "spec", "roles", default=[]) or []


def role_accelerator(role: dict) -> str | None:
    return deep_get(role, "tpu", "acceleratorType")


def learner_role(job_roles: list[dict]) -> dict | None:
    """The role whose pod 0 is the gang's rendezvous anchor: the role
    named ``learner`` if present, else the first accelerator role, else
    the first role."""
    if not job_roles:
        return None
    for r in job_roles:
        if r.get("name") == "learner":
            return r
    for r in job_roles:
        if r.get("tpu"):
            return r
    return job_roles[0]
