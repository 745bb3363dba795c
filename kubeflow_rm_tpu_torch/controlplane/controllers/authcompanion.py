"""Auth companion controller — the odh-notebook-controller equivalent.

A second reconciler on the SAME Notebook CR (the reference runs the
kubeflow notebook-controller and the ODH companion side by side —
``odh-notebook-controller/controllers/notebook_controller.go:150-247``),
owning everything between the slice and the outside world:

- **OAuth sidecar machinery** (``notebook_oauth.go:49-266``): when the
  notebook opts in via the inject-oauth annotation, reconcile a
  ServiceAccount with an OAuth redirect reference, a ``{name}-tls``
  Service on the proxy port, a ``{name}-oauth-config`` Secret with a
  random cookie secret, and a TLS Route to the proxy. The sidecar
  container itself is injected by the webhook
  (``notebook_webhook.go:76-233`` — see ``webhook/notebook.py``).
- **Plain Route** (``notebook_route.go:34-146``): without OAuth, an
  edge Route straight to worker-0's UI Service.
- **NetworkPolicies** (``notebook_network.go:131-174``): ingress to
  the notebook port only from inside the namespace (+ gateway), and
  to the OAuth port from anywhere — a multi-host slice addition admits
  the slice's own pods to one another and nothing else there.
- **Pipeline RBAC** (``notebook_rbac.go:36-154``): RoleBinding letting
  the notebook's ServiceAccount drive the pipeline API, gated like
  ``SET_PIPELINE_RBAC``.
- **Trusted CA bundle** (``CreateNotebookCertConfigMap`` ``:254-357``):
  assemble a per-namespace ``workbench-trusted-ca-bundle`` ConfigMap
  from the cluster's ``odh-trusted-ca-bundle`` so every notebook
  trusts the org's CAs; the webhook mounts it into pods.

(The port's copy of
``kubeflow_rm_tpu/controlplane/controllers/authcompanion.py``. One
difference beside these comments: the ``{name}-slice-np`` policy. JAX's
opens TCP 8471 and 8476 between a multi-host slice's pods, the TPU's
ICI bootstrap and ``jax.distributed`` ports. The port's ranks meet at
``MASTER_PORT`` (``launcher/torchrun.py``), and NCCL's bootstrap and
socket transport listen on ephemeral ports, so the port's policy admits
the slice's own pods on every port: one ``from`` rule, no ``ports``.)
"""

from __future__ import annotations

import secrets

from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    annotations_of,
    make_object,
    set_controller_reference,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer, NotFound
from kubeflow_rm_tpu_torch.controlplane.runtime import (
    Controller, Request, reconcile_children,
)

OAUTH_INJECT_ANNOTATION = "notebooks.kubeflow.org/inject-oauth"
LOGOUT_URL_ANNOTATION = "notebooks.kubeflow.org/oauth-logout-url"

NOTEBOOK_PORT = 8888
OAUTH_PORT = 8443
OAUTH_PORT_NAME = "oauth-proxy"
OAUTH_SERVICE_PORT = 443

TRUSTED_CA_BUNDLE = "workbench-trusted-ca-bundle"
SOURCE_CA_BUNDLE = "odh-trusted-ca-bundle"
SOURCE_CA_NAMESPACE = "kubeflow"

PIPELINE_ROLE = "ds-pipeline-user-access"


def oauth_enabled(notebook: dict) -> bool:
    return annotations_of(notebook).get(OAUTH_INJECT_ANNOTATION) == "true"


class AuthCompanionController(Controller):
    kind = nb_api.KIND

    def __init__(self, *, set_pipeline_rbac: bool = True,
                 cluster_domain: str = "apps.example.com"):
        self.set_pipeline_rbac = set_pipeline_rbac
        self.cluster_domain = cluster_domain

    def reconcile(self, api: APIServer, req: Request):
        try:
            nb = api.get(self.kind, req.name, req.namespace)
        except NotFound:
            return None

        # the four groups touch disjoint objects (ordering matters only
        # WITHIN a group) — fan them out as callables
        groups = [
            lambda: self._reconcile_ca_bundle(api, nb),
            lambda: self._reconcile_network_policies(api, nb),
        ]
        if self.set_pipeline_rbac:
            groups.append(lambda: self._reconcile_pipeline_rbac(api, nb))
        if oauth_enabled(nb):
            groups.append(lambda: self._reconcile_oauth(api, nb))
        else:
            groups.append(lambda: self._reconcile_plain_route(api, nb))
        reconcile_children(api, nb, groups)
        return None

    # ---- OAuth machinery (notebook_oauth.go:49-266) ------------------
    def _reconcile_oauth(self, api: APIServer, nb: dict) -> None:
        name, ns = nb["metadata"]["name"], nb["metadata"]["namespace"]

        sa = make_object(
            "v1", "ServiceAccount", name, ns,
            annotations={
                "serviceaccounts.openshift.io/oauth-redirectreference."
                "first": '{"kind":"OAuthRedirectReference","apiVersion":'
                         '"v1","reference":{"kind":"Route","name":"%s"}}'
                         % name,
            })
        self._ensure(api, nb, sa)

        svc = make_object("v1", "Service", f"{name}-tls", ns,
                          annotations={
                              "service.beta.openshift.io/serving-cert-"
                              "secret-name": f"{name}-tls",
                          })
        svc["spec"] = {
            "ports": [{"name": OAUTH_PORT_NAME,
                       "port": OAUTH_SERVICE_PORT,
                       "targetPort": OAUTH_PORT_NAME,
                       "protocol": "TCP"}],
            "selector": {nb_api.NOTEBOOK_NAME_LABEL: name,
                         "statefulset.kubernetes.io/pod-name": f"{name}-0"},
        }
        self._ensure(api, nb, svc)

        if api.try_get("Secret", f"{name}-oauth-config", ns) is None:
            secret = make_object("v1", "Secret", f"{name}-oauth-config", ns)
            secret["type"] = "Opaque"
            secret["stringData"] = {
                "cookie_secret": secrets.token_urlsafe(32),
            }
            set_controller_reference(nb, secret)
            api.create(secret)

        route = make_object("route.openshift.io/v1", "Route", name, ns)
        route["spec"] = {
            "host": f"{name}-{ns}.{self.cluster_domain}",
            "to": {"kind": "Service", "name": f"{name}-tls",
                   "weight": 100},
            "port": {"targetPort": OAUTH_PORT_NAME},
            "tls": {"termination": "reencrypt",
                    "insecureEdgeTerminationPolicy": "Redirect"},
        }
        self._ensure(api, nb, route)

    def _reconcile_plain_route(self, api: APIServer, nb: dict) -> None:
        name, ns = nb["metadata"]["name"], nb["metadata"]["namespace"]
        route = make_object("route.openshift.io/v1", "Route", name, ns)
        route["spec"] = {
            "host": f"{name}-{ns}.{self.cluster_domain}",
            "to": {"kind": "Service", "name": name, "weight": 100},
            "port": {"targetPort": NOTEBOOK_PORT},
        }
        self._ensure(api, nb, route)

    # ---- NetworkPolicies (notebook_network.go:131-174 + slice) -------
    def _reconcile_network_policies(self, api: APIServer, nb: dict) -> None:
        name, ns = nb["metadata"]["name"], nb["metadata"]["namespace"]
        pod_sel = {"matchLabels": {nb_api.NOTEBOOK_NAME_LABEL: name}}

        ctrl_np = make_object("networking.k8s.io/v1", "NetworkPolicy",
                              f"{name}-ctrl-np", ns)
        ctrl_np["spec"] = {
            "podSelector": pod_sel,
            "policyTypes": ["Ingress"],
            "ingress": [{
                "ports": [{"protocol": "TCP", "port": NOTEBOOK_PORT}],
                "from": [{"namespaceSelector": {"matchLabels": {
                    "kubernetes.io/metadata.name": ns}}}],
            }],
        }
        self._ensure(api, nb, ctrl_np)

        if oauth_enabled(nb):
            oauth_np = make_object("networking.k8s.io/v1", "NetworkPolicy",
                                   f"{name}-oauth-np", ns)
            oauth_np["spec"] = {
                "podSelector": pod_sel,
                "policyTypes": ["Ingress"],
                "ingress": [{"ports": [{"protocol": "TCP",
                                        "port": OAUTH_PORT}]}],
            }
            self._ensure(api, nb, oauth_np)

        # slice addition: the ranks' rendezvous (MASTER_PORT) and NCCL's
        # bootstrap and socket transport (ephemeral ports) reachable
        # only from the slice's own pods
        topo = nb_api.tpu_spec(nb)
        if topo and topo.multihost:
            peer_np = make_object("networking.k8s.io/v1", "NetworkPolicy",
                                  f"{name}-slice-np", ns)
            peer_np["spec"] = {
                "podSelector": pod_sel,
                "policyTypes": ["Ingress"],
                "ingress": [{
                    "from": [{"podSelector": pod_sel}],
                }],
            }
            self._ensure(api, nb, peer_np)

    # ---- pipeline RBAC (notebook_rbac.go:36-154) ---------------------
    def _reconcile_pipeline_rbac(self, api: APIServer, nb: dict) -> None:
        name, ns = nb["metadata"]["name"], nb["metadata"]["namespace"]
        rb = make_object("rbac.authorization.k8s.io/v1", "RoleBinding",
                         f"elyra-pipelines-{name}", ns)
        rb["roleRef"] = {"apiGroup": "rbac.authorization.k8s.io",
                         "kind": "Role", "name": PIPELINE_ROLE}
        rb["subjects"] = [{"kind": "ServiceAccount", "name": name,
                           "namespace": ns}]
        self._ensure(api, nb, rb)

    # ---- trusted CA bundle (:254-357) --------------------------------
    def _reconcile_ca_bundle(self, api: APIServer, nb: dict) -> None:
        ns = nb["metadata"]["namespace"]
        source = api.try_get("ConfigMap", SOURCE_CA_BUNDLE,
                             SOURCE_CA_NAMESPACE)
        if source is None:
            return
        bundle = "".join(
            v for k, v in sorted((source.get("data") or {}).items())
            if k.endswith(".crt"))
        cm = make_object("v1", "ConfigMap", TRUSTED_CA_BUNDLE, ns,
                         labels={"config.openshift.io/inject-trusted-"
                                 "cabundle": "true"})
        cm["data"] = {"ca-bundle.crt": bundle}
        existing = api.try_get("ConfigMap", TRUSTED_CA_BUNDLE, ns)
        if existing is None:
            api.create(cm)
        elif existing.get("data") != cm["data"]:
            existing["data"] = cm["data"]
            api.update(existing)

    # ---- helper ------------------------------------------------------
    @staticmethod
    def _ensure(api: APIServer, owner: dict, obj: dict) -> None:
        """Create-or-repair a companion object.

        Diffs every field the companion controller owns — not just
        ``spec``: the ServiceAccount's oauth-redirectreference and the
        Service's serving-cert annotations live in metadata, and the
        RoleBinding's reconciled state is ``roleRef``/``subjects``;
        objects mutated there (or created without them) must be
        repaired too (ADVICE r2).
        """
        existing = api.try_get(obj["kind"], obj["metadata"]["name"],
                               obj["metadata"].get("namespace"))
        set_controller_reference(owner, obj)
        if existing is None:
            api.create(obj)
            return
        changed = False
        # adopt pre-existing objects: without the ownerReference, GC
        # would skip them on Notebook deletion and leak the companion
        # (a stale RoleBinding = a lingering access grant)
        want_refs = obj["metadata"].get("ownerReferences") or []
        if want_refs and not (
                existing["metadata"].get("ownerReferences") or []):
            existing["metadata"]["ownerReferences"] = want_refs
            changed = True
        want_ann = obj["metadata"].get("annotations") or {}
        have_ann = existing["metadata"].get("annotations") or {}
        # only repair annotations this controller set; foreign
        # annotations (kubectl applied-config, etc.) are left alone
        for k, v in want_ann.items():
            if have_ann.get(k) != v:
                existing["metadata"].setdefault(
                    "annotations", {})[k] = v
                changed = True
        for top in ("spec", "roleRef", "subjects", "rules", "data",
                    "stringData", "type"):
            if top in obj and existing.get(top) != obj[top]:
                existing[top] = obj[top]
                changed = True
        if changed:
            api.update(existing)
