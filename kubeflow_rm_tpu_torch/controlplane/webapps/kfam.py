"""Access management (KFAM) REST service (the port's copy of
``kubeflow_rm_tpu/controlplane/webapps/kfam.py``).

Behavioral mirror of the reference's Go KFAM
(``access-management/kfam/routers.go:32-90``): the dashboard's
profile/contributor management API. Endpoints:

- ``/kfam/v1/bindings`` GET/POST/DELETE — contributor management: a
  binding ``{user, referredNamespace, roleRef}`` becomes a RoleBinding
  (role mapped through admin/edit/view → kubeflow-* —
  ``bindings.go:33-40``) plus an Istio AuthorizationPolicy admitting
  that user's identity header through the gateway
  (``bindings.go:79-157``).
- ``/kfam/v1/profiles`` POST / ``/kfam/v1/profiles/<name>`` DELETE —
  registration flow (``api_default.go:134-156``).
- ``/kfam/v1/role/clusteradmin`` GET — admin check backed by the
  apiserver's access review (the reference submits a
  SubjectAccessReview — ``api_default.go:104-132``).
"""

from __future__ import annotations

import functools
import re

from kubeflow_rm_tpu_torch.controlplane.api.meta import deep_get, make_object
from kubeflow_rm_tpu_torch.controlplane.api.profile import make_profile
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer
from kubeflow_rm_tpu_torch.controlplane.metrics import KFAM_REQUESTS_TOTAL
from kubeflow_rm_tpu_torch.controlplane.webapps.core import (
    USER_HEADER, USER_PREFIX, WebApp, json_body,
)
from kubeflow_rm_tpu_torch.controlplane.webapps.serving import HTTPError

USER_ANNOTATION = "user"
ROLE_ANNOTATION = "role"

ROLE_MAP = {"admin": "kubeflow-admin", "edit": "kubeflow-edit",
            "view": "kubeflow-view"}


def _counted(action: str):
    """Per-action success/error counters, the reference's KFAM
    prometheus surface (``kfam/monitoring.go:46-77``); scraped from
    this app's ``/metrics`` like every control-plane process.

    Counts requests that REACH the handler — in-handler authz denials
    land in the ``error`` bucket, while gateway-level rejections
    (missing identity header, CSRF) happen before dispatch and are not
    KFAM actions, the same boundary the reference has behind its
    mesh's auth filter."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            try:
                out = fn(*a, **kw)
            except Exception:
                KFAM_REQUESTS_TOTAL.labels(action, "error").inc()
                raise
            KFAM_REQUESTS_TOTAL.labels(action, "success").inc()
            return out
        return wrapper
    return deco


def binding_name(user: str, role: str) -> str:
    safe = re.sub(r"[^a-z0-9]", "-", user.lower())
    return f"user-{safe}-clusterrole-{ROLE_MAP[role]}"


def create_app(api: APIServer, *, disable_auth: bool = False,
               prefix: str = "", **app_kwargs) -> WebApp:
    app = WebApp("kfam", api, prefix=prefix, disable_auth=disable_auth,
                 **app_kwargs)

    @app.route("/kfam/v1/bindings")
    @_counted("read_bindings")
    def get_bindings(req):
        ns_filter = req.args.get("namespace")
        user_filter = req.args.get("user")
        role_filter = req.args.get("role")
        out = []
        if ns_filter:
            # explicit namespace: hard 403 if the caller may not read
            # its role grants (ADVICE r2: was world-readable)
            app.ensure_authorized(req, "list", "rolebindings", ns_filter)
            namespaces = [ns_filter]
        else:
            # cluster-wide listing: silently scope to namespaces the
            # caller may read, mirroring the reference's per-namespace
            # SubjectAccessReview filtering
            caller = app.username(req)
            namespaces = [
                n["metadata"]["name"] for n in api.list("Namespace")
                if app.disable_auth or api.access_review(
                    caller, "list", "rolebindings",
                    n["metadata"]["name"])
            ]
        for ns in namespaces:
            for rb in api.list("RoleBinding", ns):
                ann = rb["metadata"].get("annotations") or {}
                if USER_ANNOTATION not in ann:
                    continue  # not a KFAM-managed binding
                role = ann.get(ROLE_ANNOTATION)
                if user_filter and ann[USER_ANNOTATION] != user_filter:
                    continue
                if role_filter and role != role_filter:
                    continue
                out.append({
                    "user": {"kind": "User",
                             "name": ann[USER_ANNOTATION]},
                    "referredNamespace": ns,
                    "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                                "kind": "ClusterRole", "name": role},
                })
        return {"bindings": out}

    @app.route("/kfam/v1/bindings", methods=("POST",))
    @_counted("create_binding")
    def post_binding(req):
        b = _parse_binding(json_body(req))
        ns, user, role = b
        app.ensure_authorized(req, "create", "rolebindings", ns)
        name = binding_name(user, role)
        rb = make_object("rbac.authorization.k8s.io/v1", "RoleBinding",
                         name, ns,
                         annotations={USER_ANNOTATION: user,
                                      ROLE_ANNOTATION: role})
        rb["roleRef"] = {"apiGroup": "rbac.authorization.k8s.io",
                         "kind": "ClusterRole", "name": ROLE_MAP[role]}
        rb["subjects"] = [{"kind": "User", "name": user,
                           "apiGroup": "rbac.authorization.k8s.io"}]
        api.create(rb)

        authz = make_object("security.istio.io/v1beta1",
                            "AuthorizationPolicy", name, ns,
                            annotations={USER_ANNOTATION: user,
                                         ROLE_ANNOTATION: role})
        authz["spec"] = {"rules": [{
            "when": [{
                "key": f"request.headers[{USER_HEADER}]",
                "values": [USER_PREFIX + user],
            }],
        }]}
        api.create(authz)
        return {"message": "Binding created successfully."}

    @app.route("/kfam/v1/bindings", methods=("DELETE",))
    @_counted("delete_binding")
    def delete_binding(req):
        ns, user, role = _parse_binding(json_body(req))
        app.ensure_authorized(req, "delete", "rolebindings", ns)
        name = binding_name(user, role)
        api.delete("RoleBinding", name, ns)
        if api.try_get("AuthorizationPolicy", name, ns):
            api.delete("AuthorizationPolicy", name, ns)
        return {"message": "Binding deleted successfully."}

    @app.route("/kfam/v1/profiles")
    @_counted("read_profiles")
    def get_profiles(req):
        profiles = api.list("Profile")
        if app.disable_auth:
            return {"profiles": profiles}
        caller = app.username(req)
        if api.access_review(caller, "list", "profiles"):
            return {"profiles": profiles}  # cluster admin sees all
        # everyone else: own profiles + namespaces they contribute to
        visible = []
        for p in profiles:
            name = p["metadata"]["name"]
            if deep_get(p, "spec", "owner", "name") == caller or \
                    api.access_review(caller, "get", "profiles", name):
                visible.append(p)
        return {"profiles": visible}

    @app.route("/kfam/v1/profiles", methods=("POST",))
    @_counted("create_profile")
    def post_profile(req):
        body = json_body(req)
        name = deep_get(body, "metadata", "name")
        owner = deep_get(body, "spec", "owner", "name")
        if not name or not owner:
            raise HTTPError(400, "profile requires metadata.name and "
                                 "spec.owner.name")
        # self-registration (the dashboard workgroup flow) is always
        # allowed; creating a profile for SOMEONE ELSE requires real
        # create-profiles RBAC (ADVICE r2: was unauthenticated)
        caller = app.username(req)
        if not app.disable_auth and owner != caller and \
                not api.access_review(caller, "create", "profiles"):
            raise HTTPError(
                403, f"User '{caller}' may not create a profile owned by "
                     f"'{owner}'")
        api.create(make_profile(name, owner))
        return {"message": "Profile created successfully."}

    @app.route("/kfam/v1/profiles/<name>", methods=("DELETE",))
    @_counted("delete_profile")
    def delete_profile(req, name):
        profile = api.get("Profile", name)
        user = app.username(req)
        owner = deep_get(profile, "spec", "owner", "name")
        if not app.disable_auth and user not in (owner,) and \
                not api.access_review(user, "delete", "profiles"):
            raise HTTPError(403, f"User '{user}' may not delete profile "
                                 f"'{name}' owned by '{owner}'")
        api.delete("Profile", name)
        return {"message": "Profile deleted successfully."}

    @app.route("/kfam/v1/role/clusteradmin")
    @_counted("read_clusteradmin")
    def get_clusteradmin(req):
        user = req.args.get("user") or app.username(req)
        is_admin = api.access_review(user, "*", "*")
        return {"clusteradmin": bool(is_admin)}

    return app


def _parse_binding(body: dict) -> tuple[str, str, str]:
    user = deep_get(body, "user", "name")
    ns = body.get("referredNamespace")
    role = deep_get(body, "roleRef", "name")
    if not (user and ns and role):
        raise HTTPError(400, "binding requires user.name, "
                             "referredNamespace and roleRef.name")
    if role not in ROLE_MAP:
        raise HTTPError(400,
                        f"roleRef.name must be one of {sorted(ROLE_MAP)}")
    return ns, user, role
