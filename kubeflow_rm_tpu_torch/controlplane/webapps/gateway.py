"""Single-origin gateway over every web app (the port's copy of
``kubeflow_rm_tpu/controlplane/webapps/gateway.py``) — the role the
Istio gateway + VirtualService path routes play in-cluster
(``deploy/manifests._gateway_virtualservice``) and the reference
dashboard's Express proxy plays in dev
(``centraldashboard/app/server.ts:56-91``).

``make_gateway`` mounts:

    /                     central dashboard API + SPA shell + static
    /jupyter/...          jupyter web app (spawner)
    /volumes/...          volumes web app
    /tensorboards/...     tensorboards web app
    /kfam/...             access management

The dispatcher is werkzeug's ``DispatcherMiddleware`` on the standard
library: the longest mount prefix of the path wins, and the prefix
moves from ``PATH_INFO`` to ``SCRIPT_NAME`` (a bare ``/jupyter``
reaches the jupyter app with an empty ``PATH_INFO``); a path under no
mount goes to the dashboard unchanged.

Used by the ``gateway`` process entrypoint. ``dev_user`` plays the mesh
auth proxy: it stamps the trusted identity header on every request,
which is how a browser (that has no Istio sidecar in front of it) gets
an identity in dev/e2e — NEVER set it behind a real proxy.
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane.webapps import (
    dashboard as dashboard_mod,
    jupyter as jupyter_mod,
    kfam as kfam_mod,
    tensorboards as tensorboards_mod,
    volumes as volumes_mod,
)
from kubeflow_rm_tpu_torch.controlplane.webapps.core import (
    USER_HEADER, USER_PREFIX,
)


class Dispatcher:
    """Path-prefix WSGI dispatch with ``DispatcherMiddleware``'s
    semantics: ``mounts`` maps a prefix (``"/jupyter"``) to its app,
    ``app`` takes every other path."""

    def __init__(self, app, mounts: dict):
        self.app = app
        self.mounts = dict(mounts)

    def __call__(self, environ, start_response):
        script = environ.get("PATH_INFO", "")
        path_info = ""
        while "/" in script:
            if script in self.mounts:
                app = self.mounts[script]
                break
            script, last_item = script.rsplit("/", 1)
            path_info = f"/{last_item}{path_info}"
        else:
            app = self.mounts.get(script, self.app)
        environ["SCRIPT_NAME"] = environ.get("SCRIPT_NAME", "") + script
        environ["PATH_INFO"] = path_info
        return app(environ, start_response)


def make_gateway(api, *, dev_user: str | None = None,
                 secure_cookies: bool = True):
    """One WSGI app path-routing every web app off a shared backend; its
    ``app`` is the dashboard (whose history sampler a caller stops)."""
    kw = dict(secure_cookies=secure_cookies)
    gw = Dispatcher(
        dashboard_mod.create_app(api, **kw),
        {
            "/jupyter": jupyter_mod.create_app(api, **kw),
            "/volumes": volumes_mod.create_app(api, **kw),
            "/tensorboards": tensorboards_mod.create_app(api, **kw),
            "/kfam": kfam_mod.create_app(api, **kw),
        },
    )
    if dev_user is None:
        return gw

    header_key = "HTTP_" + USER_HEADER.upper().replace("-", "_")

    def with_identity(environ, start_response):
        # Overwrite unconditionally: dev_user pins the identity, so a
        # client-supplied header must not be able to impersonate others.
        environ[header_key] = USER_PREFIX + dev_user
        return gw(environ, start_response)

    with_identity.app = gw.app  # the dashboard, as on the plain gateway
    return with_identity
