"""Card-slice rendezvous injection webhook (counterpart of
``kubeflow_rm_tpu/controlplane/webhook/tpu_inject.py``) — the north-star
seam.

The producer half of the contract consumed by
``kubeflow_rm_tpu_torch/parallel/distributed.py`` and
``launcher/torchrun.py``: every pod of a card-slice notebook gets the
env JAX's injector gives a TPU pod, names included

- ``TPU_WORKER_ID``        — its ordinal (from the StatefulSet pod name),
- ``TPU_WORKER_HOSTNAMES`` — comma-joined stable DNS of all workers
  through the headless service,
- ``TPU_ACCELERATOR_TYPE`` / ``TPU_TOPOLOGY`` — the slice type and the
  cards on a host (:mod:`..api.gpu`), so in-notebook code builds the
  right mesh,
- a ``/dev/shm`` Memory volume (the reference injects the same for
  NCCL DDP — ``jupyter .../form.py:264-276``).

The reference has no counterpart (its servers are single-pod,
``notebook_controller.go:409-412``); SURVEY.md §2.6 designates the
PodDefault merge point as the natural home for this injection, which is
exactly where this webhook sits in the admission chain.
"""

from __future__ import annotations

import copy

from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api
from kubeflow_rm_tpu_torch.controlplane.api import tpujob as tj_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    fast_deepcopy,
    annotations_of,
    deep_get,
    labels_of,
    name_of,
    namespace_of,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer

SHM_VOLUME = {"name": "dshm", "emptyDir": {"medium": "Memory"}}
SHM_MOUNT = {"name": "dshm", "mountPath": "/dev/shm"}


class GpuInjectWebhook:
    def __init__(self, api: APIServer, cluster_domain: str = "cluster.local"):
        self.api = api
        self.cluster_domain = cluster_domain

    def register(self) -> None:
        self.api.register_admission("Pod", self)

    def __call__(self, op: str, pod: dict, old: dict | None) -> dict | None:
        if op != "CREATE":
            return None
        if annotations_of(pod).get(
                nb_api.TPU_INJECT_EXCLUDE_ANNOTATION) == "true":
            return None
        acc_type = labels_of(pod).get(nb_api.TPU_ACCELERATOR_LABEL)
        in_gang = tj_api.JOB_NAME_LABEL in labels_of(pod)
        if not acc_type:
            if in_gang:
                # CPU-only gang member (an actor): role rendezvous env
                # only — the TPU-scoped vars (TPU_WORKER_ID/
                # TPU_WORKER_HOSTNAMES) stay slice-scoped and are NOT
                # injected into chipless pods
                pod = fast_deepcopy(pod)
                self._inject_role_env(pod)
                return pod
            return None
        if in_gang:
            # a gang's chip pods (the learner slice) get BOTH the
            # role env and the slice-scoped TPU rendezvous below
            pod = fast_deepcopy(pod)
            self._inject_role_env(pod)
        topo = gpu_api.lookup(acc_type)
        nslices = int(labels_of(pod).get(
            nb_api.TPU_NUM_SLICES_LABEL, "1"))

        # multislice: ordinals are laid out slice-major, so ICI
        # rendezvous (TPU_WORKER_*) is per-slice while MEGASCALE_*
        # carries the DCN dimension
        ordinal = _pod_ordinal(pod)
        slice_id, worker_in_slice = divmod(ordinal, topo.hosts)
        slice_hosts = self._worker_hostnames(pod, topo, slice_id)

        pod = fast_deepcopy(pod)
        spec = pod["spec"]
        for c in spec.get("containers") or []:
            env = c.setdefault("env", [])
            _upsert(env, "TPU_WORKER_ID", str(worker_in_slice))
            _upsert(env, "TPU_WORKER_HOSTNAMES", ",".join(slice_hosts))
            _upsert(env, "TPU_ACCELERATOR_TYPE", topo.accelerator_type)
            _upsert(env, "TPU_TOPOLOGY", topo.topology)
            if nslices > 1:
                coord = self._worker_hostnames(pod, topo, 0)[0]
                _upsert(env, "MEGASCALE_NUM_SLICES", str(nslices))
                _upsert(env, "MEGASCALE_SLICE_ID", str(slice_id))
                _upsert(env, "MEGASCALE_COORDINATOR_ADDRESS", coord)
            mounts = c.setdefault("volumeMounts", [])
            if not any(m.get("mountPath") == "/dev/shm" for m in mounts):
                mounts.append(dict(SHM_MOUNT))
        vols = spec.setdefault("volumes", [])
        if not any(v.get("name") == SHM_VOLUME["name"] for v in vols):
            vols.append(copy.deepcopy(SHM_VOLUME))
        return pod

    def _inject_role_env(self, pod: dict) -> None:
        """Role-aware gang rendezvous (mutates ``pod`` in place):
        every member of a TPUJob gang — chip pods and CPU actors alike
        — learns its role, its ordinal within the role, its own role's
        peer hostnames, every sibling role's hostname list, and the
        learner's address (pod 0 of the anchor role), so the gang
        self-assembles without polling the control plane."""
        labels = labels_of(pod)
        job = labels.get(tj_api.JOB_NAME_LABEL) or ""
        role = labels.get(tj_api.JOB_ROLE_LABEL) or ""
        roles = tj_api.parse_roles_annotation(pod) or []
        ns = namespace_of(pod)
        ordinal = _pod_ordinal(pod)

        role_hosts: dict[str, list[str]] = {}
        for r in roles:
            rname = r.get("name")
            if not rname:
                continue
            svc = r.get("service") or tj_api.role_sts_name(job, rname)
            role_hosts[rname] = [
                f"{svc}-{i}.{svc}.{ns}.svc.{self.cluster_domain}"
                for i in range(int(r.get("pods") or 0))
            ]
        own_hosts = role_hosts.get(role, [])
        learner = tj_api.learner_role(roles)
        learner_addr = ""
        if learner is not None:
            anchor = role_hosts.get(learner.get("name") or "", [])
            if anchor:
                learner_addr = anchor[0]

        for c in pod["spec"].get("containers") or []:
            env = c.setdefault("env", [])
            _upsert(env, tj_api.ENV_JOB_NAME, job)
            _upsert(env, tj_api.ENV_JOB_ROLE, role)
            _upsert(env, tj_api.ENV_JOB_ROLE_INDEX, str(ordinal))
            _upsert(env, tj_api.ENV_JOB_ROLE_HOSTNAMES,
                    ",".join(own_hosts))
            for rname, hosts in role_hosts.items():
                suffix = rname.upper().replace("-", "_")
                _upsert(env, tj_api.ENV_JOB_HOSTNAMES_PREFIX + suffix,
                        ",".join(hosts))
            if learner_addr:
                _upsert(env, tj_api.ENV_LEARNER_ADDRESS, learner_addr)

    def _worker_hostnames(self, pod: dict, topo: gpu_api.SliceTopology,
                          slice_id: int = 0) -> list[str]:
        subdomain = deep_get(pod, "spec", "subdomain")
        ns = namespace_of(pod)
        base = _base_name(pod)
        if not subdomain:
            # single-host fallback: the pod's own DNS
            return [f"{name_of(pod)}.{ns}.svc.{self.cluster_domain}"]
        start = slice_id * topo.hosts
        return [
            f"{base}-{i}.{subdomain}.{ns}.svc.{self.cluster_domain}"
            for i in range(start, start + topo.hosts)
        ]


def _pod_ordinal(pod: dict) -> int:
    name = labels_of(pod).get("statefulset.kubernetes.io/pod-name") \
        or name_of(pod)
    tail = name.rsplit("-", 1)
    if len(tail) == 2 and tail[1].isdigit():
        return int(tail[1])
    return 0


def _base_name(pod: dict) -> str:
    name = labels_of(pod).get("statefulset.kubernetes.io/pod-name") \
        or name_of(pod)
    tail = name.rsplit("-", 1)
    if len(tail) == 2 and tail[1].isdigit():
        return tail[0]
    return name


def _upsert(env: list, name: str, value: str) -> None:
    for e in env:
        if e.get("name") == name:
            return  # user-set values win
    env.append({"name": name, "value": value})
