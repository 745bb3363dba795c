"""Tensorboard controller: Tensorboard CR → Deployment + Service.

Mirrors ``tensorboard-controller/controllers/tensorboard_controller.go``:
``spec.logspath`` is either ``pvc://name/subpath`` (mount the PVC,
``:178-232``) or ``gs://bucket/path`` (``:234-249``). The reference
mounts a ``user-gcp-sa`` secret for GCS; the GKE-native build relies on
GKE Workload Identity (the profile plugin annotates default-editor), so
the GCS branch sets the SA and no secret. RWO scheduling
(``RWO_PVC_SCHEDULING``, ``:207-232``): when the PVC is RWO and already
mounted by a running pod, pin the deployment to that pod's node so the
volume can attach.

(The port's copy of
``kubeflow_rm_tpu/controlplane/controllers/tensorboard.py``, verbatim
beside one word of this docstring.)
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    deep_get,
    make_object,
    name_of,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer, NotFound
from kubeflow_rm_tpu_torch.controlplane.runtime import (
    Controller,
    Request,
    copy_deployment_fields,
    copy_service_fields,
    map_to_owner,
    reconcile_children,
    rwo_mounting_node,
)

API_VERSION = "tensorboard.kubeflow.org/v1alpha1"
KIND = "Tensorboard"

DEFAULT_IMAGE = "tensorflow/tensorflow:latest"  # env TENSORBOARD_IMAGE


def make_tensorboard(name: str, namespace: str, logspath: str) -> dict:
    return make_object(API_VERSION, KIND, name, namespace,
                       spec={"logspath": logspath})


def parse_logspath(path: str) -> tuple[str, str, str]:
    """→ (scheme, pvc_name_or_bucket, subpath)."""
    if path.startswith("pvc://"):
        rest = path[len("pvc://"):]
        pvc, _, sub = rest.partition("/")
        return ("pvc", pvc, sub)
    if path.startswith("gs://"):
        return ("gs", path, "")
    return ("raw", path, "")


class TensorboardController(Controller):
    kind = KIND

    def __init__(self, image: str = DEFAULT_IMAGE,
                 rwo_scheduling: bool = True):
        self.image = image
        self.rwo_scheduling = rwo_scheduling

    def watches(self):
        return (("Deployment", map_to_owner(KIND)),)

    def reconcile(self, api: APIServer, req: Request):
        try:
            tb = api.get(KIND, req.name, req.namespace)
        except NotFound:
            return None
        deploy = self._generate_deployment(api, tb)
        svc = make_object("v1", "Service", req.name, req.namespace, spec={
            "selector": {"app": req.name},
            "ports": [{"port": 80, "targetPort": 6006, "protocol": "TCP"}],
        })
        reconcile_children(api, tb, [(deploy, copy_deployment_fields),
                                     (svc, copy_service_fields)])

        live = api.try_get("Deployment", req.name, req.namespace)
        ready = deep_get(live, "status", "readyReplicas", default=0) if live \
            else 0
        status = {"readyReplicas": ready}
        if deep_get(tb, "status") != status:
            tb["status"] = status
            api.update_status(tb)
        return None

    def _generate_deployment(self, api: APIServer, tb: dict) -> dict:
        name, ns = name_of(tb), tb["metadata"]["namespace"]
        scheme, target, sub = parse_logspath(
            deep_get(tb, "spec", "logspath", default=""))
        container = {
            "name": "tensorboard",
            "image": self.image,
            "command": ["/usr/local/bin/tensorboard"],
            "args": ["--port", "6006", "--bind_all"],
            "ports": [{"containerPort": 6006}],
        }
        pod_spec: dict = {"containers": [container]}
        if scheme == "pvc":
            container["args"] += ["--logdir", f"/tensorboard_logs/{sub}"]
            container["volumeMounts"] = [
                {"name": "logs", "mountPath": "/tensorboard_logs"}]
            pod_spec["volumes"] = [
                {"name": "logs",
                 "persistentVolumeClaim": {"claimName": target}}]
            if self.rwo_scheduling:
                node = rwo_mounting_node(api, ns, target)
                if node:
                    pod_spec["nodeName"] = node
        elif scheme == "gs":
            container["args"] += ["--logdir", target]
            pod_spec["serviceAccountName"] = "default-editor"
        else:
            container["args"] += ["--logdir", target]

        return {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": name, "namespace": ns,
                         "labels": {"app": name}},
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": {"app": name}},
                "template": {
                    "metadata": {"labels": {"app": name}},
                    "spec": pod_spec,
                },
            },
        }
