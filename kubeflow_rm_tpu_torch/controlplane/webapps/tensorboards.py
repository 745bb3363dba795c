"""Tensorboards web app backend (the port's copy of
``kubeflow_rm_tpu/controlplane/webapps/tensorboards.py``).

Behavioral mirror of the reference TWA
(``crud-web-apps/tensorboards/backend/app/routes``): Tensorboard CR
CRUD keyed on ``{name, logspath}`` (``post.py:14-38`` requires both),
with the same ``pvc://`` / ``gs://`` logspath vocabulary the
tensorboard controller consumes. GCS paths need no secret here —
workload identity on default-editor covers them (the replacement for
the reference's ``user-gcp-sa`` secret mount).
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane.api.meta import deep_get
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer
from kubeflow_rm_tpu_torch.controlplane.controllers.tensorboard import (
    KIND, make_tensorboard, parse_logspath,
)
from kubeflow_rm_tpu_torch.controlplane.webapps.core import WebApp, json_body
from kubeflow_rm_tpu_torch.controlplane.webapps.serving import HTTPError


def create_app(api: APIServer, *, disable_auth: bool = False,
               prefix: str = "", **app_kwargs) -> WebApp:
    app = WebApp("tensorboards", api, prefix=prefix,
                 disable_auth=disable_auth, **app_kwargs)

    @app.route("/api/namespaces/<namespace>/tensorboards")
    def list_tensorboards(req, namespace):
        app.ensure_authorized(req, "list", "tensorboards", namespace)
        out = []
        for tb in api.list(KIND, namespace):
            ready = deep_get(tb, "status", "readyReplicas", default=0)
            out.append({
                "name": tb["metadata"]["name"],
                "namespace": namespace,
                "logspath": deep_get(tb, "spec", "logspath"),
                "status": {"phase": "ready" if ready else "waiting"},
                "age": tb["metadata"].get("creationTimestamp"),
            })
        return {"tensorboards": out}

    @app.route("/api/namespaces/<namespace>/tensorboards",
               methods=("POST",))
    def post_tensorboard(req, namespace):
        app.ensure_authorized(req, "create", "tensorboards", namespace)
        body = json_body(req)
        for field in ("name", "logspath"):
            if field not in body:
                raise HTTPError(400, f"'{field}' is a required body field")
        scheme, _, _ = parse_logspath(body["logspath"])
        if scheme == "raw":
            raise HTTPError(400, "logspath must be a pvc:// or gs:// URI, "
                                 f"got {body['logspath']!r}")
        api.create(make_tensorboard(body["name"], namespace,
                                    body["logspath"]))
        return {"message": "Tensorboard created successfully."}

    @app.route("/api/namespaces/<namespace>/tensorboards/<name>",
               methods=("DELETE",))
    def delete_tensorboard(req, namespace, name):
        app.ensure_authorized(req, "delete", "tensorboards", namespace)
        api.delete(KIND, name, namespace)
        return {"message": "Tensorboard deleted successfully."}

    return app
