"""Volumes web app backend — PVC CRUD + PVCViewer lifecycle (the port's
copy of ``kubeflow_rm_tpu/controlplane/webapps/volumes.py``).

Behavioral mirror of the reference VWA
(``crud-web-apps/volumes/backend``): PVC list/create/delete with
in-use detection (a PVC mounted by a pod can't be deleted from the
UI), plus the file-browser viewer flow — the backend stamps a
templated PVCViewer CR per PVC (``apps/common/viewer.py:16-49``
substitutes ``$NAME``/``$PVC_NAME``/``$NAMESPACE`` into a viewer-spec
mounted from a ConfigMap; here the template is injectable the same
way) and the pvcviewer controller renders it.
"""

from __future__ import annotations

import copy
from string import Template

from kubeflow_rm_tpu_torch.controlplane.api.meta import deep_get
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer
from kubeflow_rm_tpu_torch.controlplane.controllers.pvcviewer import (
    API_VERSION as VIEWER_API_VERSION, KIND as VIEWER_KIND,
)
from kubeflow_rm_tpu_torch.controlplane.webapps.core import WebApp, json_body
from kubeflow_rm_tpu_torch.controlplane.webapps.serving import HTTPError

# default viewer spec (the reference ships this as a ConfigMap mounted
# at /etc/config/viewer-spec.yaml)
DEFAULT_VIEWER_SPEC = {"pvc": "$PVC_NAME"}


def create_app(api: APIServer, *, viewer_spec: dict | None = None,
               disable_auth: bool = False, prefix: str = "",
               **app_kwargs) -> WebApp:
    app = WebApp("volumes", api, prefix=prefix, disable_auth=disable_auth,
                 **app_kwargs)
    spec_template = viewer_spec or DEFAULT_VIEWER_SPEC

    @app.route("/api/namespaces/<namespace>/pvcs")
    def list_pvcs(req, namespace):
        app.ensure_authorized(req, "list", "persistentvolumeclaims",
                              namespace)
        pods = api.list("Pod", namespace)
        out = []
        for pvc in api.list("PersistentVolumeClaim", namespace):
            name = pvc["metadata"]["name"]
            mounted_by = [
                p["metadata"]["name"] for p in pods
                if any(deep_get(v, "persistentVolumeClaim", "claimName")
                       == name
                       for v in deep_get(p, "spec", "volumes",
                                         default=[]) or [])
            ]
            viewer = api.try_get(VIEWER_KIND, name, namespace)
            out.append({
                "pvc": pvc,
                "inUseBy": mounted_by,
                "viewer": (deep_get(viewer, "status", "phase",
                                    default="ready")
                           if viewer else None),
            })
        return {"pvcs": out}

    @app.route("/api/namespaces/<namespace>/pvcs", methods=("POST",))
    def post_pvc(req, namespace):
        app.ensure_authorized(req, "create", "persistentvolumeclaims",
                              namespace)
        body = json_body(req)
        pvc = body.get("pvc") or {}
        if not deep_get(pvc, "metadata", "name"):
            raise HTTPError(400, "'pvc.metadata.name' is required")
        pvc.setdefault("apiVersion", "v1")
        pvc.setdefault("kind", "PersistentVolumeClaim")
        pvc["metadata"]["namespace"] = namespace
        api.create(pvc)
        return {"message": "PVC created successfully."}

    @app.route("/api/namespaces/<namespace>/pvcs/<name>",
               methods=("DELETE",))
    def delete_pvc(req, namespace, name):
        app.ensure_authorized(req, "delete", "persistentvolumeclaims",
                              namespace)
        # the PVC's own viewer goes first (its filebrowser pod mounts
        # the PVC and must not count as an external user)
        if api.try_get(VIEWER_KIND, name, namespace):
            api.delete(VIEWER_KIND, name, namespace)
        pods = api.list("Pod", namespace)
        users = [p["metadata"]["name"] for p in pods
                 if any(deep_get(v, "persistentVolumeClaim", "claimName")
                        == name
                        for v in deep_get(p, "spec", "volumes",
                                          default=[]) or [])]
        if users:
            raise HTTPError(409, f"PVC {name} is in use by pods: {users}")
        api.delete("PersistentVolumeClaim", name, namespace)
        return {"message": "PVC deleted successfully."}

    @app.route("/api/namespaces/<namespace>/viewers/<pvc>",
               methods=("POST",))
    def post_viewer(req, namespace, pvc):
        app.ensure_authorized(req, "create", "pvcviewers", namespace)
        api.get("PersistentVolumeClaim", pvc, namespace)  # 404 if absent
        spec = _substitute(copy.deepcopy(spec_template),
                           {"NAME": pvc, "PVC_NAME": pvc,
                            "NAMESPACE": namespace})
        api.create({
            "apiVersion": VIEWER_API_VERSION,
            "kind": VIEWER_KIND,
            "metadata": {"name": pvc, "namespace": namespace},
            "spec": spec,
        })
        return {"message": "PVCViewer created successfully."}

    @app.route("/api/namespaces/<namespace>/viewers/<pvc>",
               methods=("DELETE",))
    def delete_viewer(req, namespace, pvc):
        app.ensure_authorized(req, "delete", "pvcviewers", namespace)
        api.delete(VIEWER_KIND, pvc, namespace)
        return {"message": "PVCViewer deleted successfully."}

    return app


def _substitute(node, variables: dict):
    """Recursive $VAR substitution (viewer.py:16-49 equivalent)."""
    if isinstance(node, str):
        return Template(node).safe_substitute(variables)
    if isinstance(node, list):
        return [_substitute(x, variables) for x in node]
    if isinstance(node, dict):
        return {k: _substitute(v, variables) for k, v in node.items()}
    return node
