"""PVCViewer controller: PVCViewer CR → filebrowser Deployment + Service.

Mirrors ``pvcviewer-controller/controllers/pvcviewer_controller.go:96-148``
(+ design doc ``components/proposals/20230130-pvcviewer-controller.md``):
a file-browser over a PVC, with the same RWO node-pinning the
tensorboard controller uses, and idle culling driven by a
``lastActivity``-style annotation the volumes web app maintains.

(The port's copy of
``kubeflow_rm_tpu/controlplane/controllers/pvcviewer.py``, verbatim.)
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    deep_get,
    make_object,
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

API_VERSION = "kubeflow.org/v1alpha1"
KIND = "PVCViewer"

DEFAULT_IMAGE = "filebrowser/filebrowser:latest"


def make_pvcviewer(name: str, namespace: str, pvc: str) -> dict:
    return make_object(API_VERSION, KIND, name, namespace,
                       spec={"pvc": pvc})


class PVCViewerController(Controller):
    kind = KIND

    def __init__(self, image: str = DEFAULT_IMAGE,
                 rwo_scheduling: bool = True):
        self.image = image
        self.rwo_scheduling = rwo_scheduling

    def watches(self):
        return (("Deployment", map_to_owner(KIND)),)

    def reconcile(self, api: APIServer, req: Request):
        try:
            viewer = api.get(KIND, req.name, req.namespace)
        except NotFound:
            return None
        pvc = deep_get(viewer, "spec", "pvc")
        name, ns = req.name, req.namespace

        pod_spec: dict = {
            "containers": [{
                "name": "pvcviewer",
                "image": self.image,
                "args": ["--root", "/data", "--port", "8080",
                         "--baseurl", f"/pvcviewers/{ns}/{name}/"],
                "ports": [{"containerPort": 8080}],
                "volumeMounts": [{"name": "data", "mountPath": "/data"}],
            }],
            "volumes": [{"name": "data",
                         "persistentVolumeClaim": {"claimName": pvc}}],
        }
        if self.rwo_scheduling:
            node = rwo_mounting_node(api, ns, pvc)
            if node:
                pod_spec["nodeName"] = node

        deploy = {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {"name": f"{name}-pvcviewer", "namespace": ns,
                         "labels": {"pvcviewer": name}},
            "spec": {
                "replicas": 1,
                "selector": {"matchLabels": {"pvcviewer": name}},
                "template": {
                    "metadata": {"labels": {"pvcviewer": name}},
                    "spec": pod_spec,
                },
            },
        }
        svc = make_object("v1", "Service", f"{name}-pvcviewer", ns, spec={
            "selector": {"pvcviewer": name},
            "ports": [{"port": 80, "targetPort": 8080, "protocol": "TCP"}],
        })
        reconcile_children(api, viewer, [(deploy, copy_deployment_fields),
                                         (svc, copy_service_fields)])

        live = api.try_get("Deployment", f"{name}-pvcviewer", ns)
        ready = deep_get(live, "status", "readyReplicas", default=0) if live \
            else 0
        status = {"ready": ready >= 1}
        if deep_get(viewer, "status") != status:
            viewer["status"] = status
            api.update_status(viewer)
        return None
