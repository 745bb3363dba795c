"""Profile reconciler: Profile CR → namespace + RBAC + card quota.

Mirrors ``profile-controller/controllers/profile_controller.go:105-335``:
namespace with owner annotation and ``istio-injection: enabled`` label
(``:126-172``, re-applied to pre-existing namespaces as ``:181`` does),
the owner ``ns-owner-access-istio`` AuthorizationPolicy (``:419-557``),
``default-editor``/``default-viewer`` ServiceAccounts, an admin
RoleBinding for the owner, and a ``kf-resource-quota`` ResourceQuota
created/updated iff ``spec.resourceQuotaSpec.hard`` is set and deleted
when unset (``:252-281``) — with ``nvidia.com/gpu`` as a first-class
quota resource, enforced by the apiserver's quota admission on every
pod of a slice. Plugins follow the reference's interface (``:77-84``);
the GCP Workload Identity plugin replaces the AWS-first ordering. A
``profile-finalizer`` gates deletion on ``plugin.revoke`` so external
grants (Workload Identity bindings) are cleaned up (``:297-331``).

(The port's copy of ``kubeflow_rm_tpu/controlplane/controllers/profile.py``.)
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane import metrics
from kubeflow_rm_tpu_torch.controlplane.api import profile as profile_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    deep_get,
    make_object,
    set_controller_reference,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import (
    AlreadyExists, APIServer, NotFound,
)
from kubeflow_rm_tpu_torch.controlplane.runtime import (
    Controller,
    Request,
    copy_simple_spec,
    reconcile_child,
)
from kubeflow_rm_tpu_torch.controlplane.webapps.core import (
    USER_HEADER, USER_PREFIX,
)

#: ref profile_controller.go:57
FINALIZER = "profile-finalizer"
#: ref profile_controller.go:51
OWNER_POLICY_NAME = "ns-owner-access-istio"
#: ref profile_controller.go:71,132
ISTIO_INJECTION_LABEL = "istio-injection"

# mesh principals admitted by the owner policy; the reference reads
# these from env with the same defaults (profile_controller.go:420-430)
NOTEBOOK_CONTROLLER_PRINCIPAL = (
    "cluster.local/ns/kubeflow/sa/notebook-controller-service-account")
INGRESS_GATEWAY_PRINCIPAL = (
    "cluster.local/ns/istio-system/sa/istio-ingressgateway-service-account")


class ProfilePlugin:
    """Plugin contract (ref ``profile_controller.go:77-84``)."""

    kind: str = ""

    def apply(self, api: APIServer, profile: dict, spec: dict) -> None:
        raise NotImplementedError

    def revoke(self, api: APIServer, profile: dict, spec: dict) -> None:
        pass


class GcpWorkloadIdentityPlugin(ProfilePlugin):
    """Binds the namespace's default-editor SA to a GCP service account
    via Workload Identity annotation — the GKE-native first-class plugin
    (ref ``plugin_workload_identity.go``; checkpoints and tensorboard
    logs live in GCS)."""

    kind = "WorkloadIdentity"

    ANNOTATION = "iam.gke.io/gcp-service-account"

    def apply(self, api: APIServer, profile: dict, spec: dict) -> None:
        ns = profile["metadata"]["name"]
        sa = api.try_get("ServiceAccount", profile_api.DEFAULT_EDITOR, ns)
        if sa is None:
            return
        gsa = spec.get("gcpServiceAccount")
        if not gsa:
            return
        ann = sa["metadata"].setdefault("annotations", {})
        if ann.get(self.ANNOTATION) != gsa:
            ann[self.ANNOTATION] = gsa
            api.update(sa)

    def revoke(self, api: APIServer, profile: dict, spec: dict) -> None:
        """Remove the Workload Identity grant — the external state the
        finalizer exists to clean up (ref ``plugin_workload_identity.go``
        revoke path / ``profile_controller.go:311-321``)."""
        ns = profile["metadata"]["name"]
        sa = api.try_get("ServiceAccount", profile_api.DEFAULT_EDITOR, ns)
        if sa is None:
            return
        ann = sa["metadata"].get("annotations") or {}
        if self.ANNOTATION in ann:
            del ann[self.ANNOTATION]
            api.update(sa)


PLUGINS: dict[str, ProfilePlugin] = {
    p.kind: p for p in (GcpWorkloadIdentityPlugin(),)
}


class ProfileController(Controller):
    kind = profile_api.KIND

    def reconcile(self, api: APIServer, req: Request):
        try:
            profile = api.get(profile_api.KIND, req.name)
        except NotFound:
            return None  # namespace + children go via GC (ownerReferences)
        name = req.name
        owner = deep_get(profile, "spec", "owner", "name", default="")

        # Deletion: revoke every plugin's external grants, then release
        # the finalizer so the apiserver finalizes the object
        # (ref profile_controller.go:297-331).
        if profile["metadata"].get("deletionTimestamp"):
            if FINALIZER in (profile["metadata"].get("finalizers") or []):
                for plugin_spec in deep_get(profile, "spec", "plugins",
                                            default=[]) or []:
                    plugin = PLUGINS.get(plugin_spec.get("kind", ""))
                    if plugin:
                        plugin.revoke(api, profile,
                                      plugin_spec.get("spec", {}))
                profile["metadata"]["finalizers"] = [
                    f for f in profile["metadata"]["finalizers"]
                    if f != FINALIZER]
                api.update(profile)
            return None

        if FINALIZER not in (profile["metadata"].get("finalizers") or []):
            profile["metadata"].setdefault("finalizers", []).append(FINALIZER)
            api.update(profile)

        # Every pod in the profile namespace gets an Istio sidecar by
        # default, and the labels are re-asserted on a pre-existing
        # namespace too (ref :126-172 and :181).
        ns_labels = {
            "app.kubernetes.io/part-of": "kubeflow-profile",
            "katib.kubeflow.org/metrics-collector-injection": "enabled",
            ISTIO_INJECTION_LABEL: "enabled",
        }
        ns = api.try_get("Namespace", name)
        if ns is None:
            ns = {
                "apiVersion": "v1",
                "kind": "Namespace",
                "metadata": {
                    "name": name,
                    "annotations": {profile_api.OWNER_ANNOTATION: owner},
                    "labels": dict(ns_labels),
                },
            }
            set_controller_reference(profile, ns)
            try:
                api.create(ns)
            except AlreadyExists:
                pass
            metrics.PROFILE_CREATE_TOTAL.inc()
        else:
            labels = ns["metadata"].setdefault("labels", {})
            if any(labels.get(k) != v for k, v in ns_labels.items()):
                labels.update(ns_labels)
                api.update(ns)

        for sa_name in (profile_api.DEFAULT_EDITOR,
                        profile_api.DEFAULT_VIEWER):
            sa = make_object("v1", "ServiceAccount", sa_name, name)
            reconcile_child(api, profile, sa, copy_simple_spec)

        admin_binding = make_object(
            "rbac.authorization.k8s.io/v1", "RoleBinding",
            "namespaceAdmin", name)
        admin_binding["roleRef"] = {
            "apiGroup": "rbac.authorization.k8s.io",
            "kind": "ClusterRole", "name": "kubeflow-admin",
        }
        admin_binding["subjects"] = [
            {"kind": "User", "name": owner,
             "apiGroup": "rbac.authorization.k8s.io"},
        ]
        reconcile_child(api, profile, admin_binding, copy_simple_spec)

        for sa_name, role in ((profile_api.DEFAULT_EDITOR, "kubeflow-edit"),
                              (profile_api.DEFAULT_VIEWER, "kubeflow-view")):
            rb = make_object("rbac.authorization.k8s.io/v1", "RoleBinding",
                             sa_name, name)
            rb["roleRef"] = {"apiGroup": "rbac.authorization.k8s.io",
                             "kind": "ClusterRole", "name": role}
            rb["subjects"] = [{"kind": "ServiceAccount", "name": sa_name,
                               "namespace": name}]
            reconcile_child(api, profile, rb, copy_simple_spec)

        # Owner AuthorizationPolicy: the profile owner reaches every
        # workload in their namespace through the mesh — without it the
        # owner's own traffic is unauthorized to their notebooks
        # (ref profile_controller.go:419-557). KFAM writes the matching
        # per-contributor policies (webapps/kfam.py).
        authz = make_object(
            "security.istio.io/v1beta1", "AuthorizationPolicy",
            OWNER_POLICY_NAME, name,
            annotations={"user": owner, "role": "admin"})
        authz["spec"] = {
            "action": "ALLOW",
            "rules": [
                {   # the owner, arriving through the ingress gateway
                    "when": [{
                        "key": f"request.headers[{USER_HEADER}]",
                        "values": [USER_PREFIX + owner],
                    }],
                    "from": [{"source": {
                        "principals": [INGRESS_GATEWAY_PRINCIPAL]}}],
                },
                {   # workloads in the namespace reach each other (the
                    # slice's rendezvous + worker-to-worker traffic)
                    "when": [{"key": "source.namespace",
                              "values": [name]}],
                },
                {   # probe paths stay open for platform health checks
                    "to": [{"operation": {"paths": [
                        "/healthz", "/metrics", "/wait-for-drain"]}}],
                },
                {   # the culler probes kernel activity on every server
                    "from": [{"source": {"principals": [
                        NOTEBOOK_CONTROLLER_PRINCIPAL]}}],
                    "to": [{"operation": {"methods": ["GET"],
                                          "paths": ["*/api/kernels"]}}],
                },
            ],
        }
        reconcile_child(api, profile, authz, copy_simple_spec)

        # ResourceQuota: present iff spec.resourceQuotaSpec.hard (ref :252-281)
        hard = deep_get(profile, "spec", "resourceQuotaSpec", "hard")
        existing = api.try_get("ResourceQuota", profile_api.QUOTA_NAME, name)
        if hard:
            quota = make_object("v1", "ResourceQuota",
                                profile_api.QUOTA_NAME, name,
                                spec={"hard": dict(hard)})
            reconcile_child(api, profile, quota, copy_simple_spec)
        elif existing is not None:
            api.delete("ResourceQuota", profile_api.QUOTA_NAME, name)

        for plugin_spec in deep_get(profile, "spec", "plugins",
                                    default=[]) or []:
            plugin = PLUGINS.get(plugin_spec.get("kind", ""))
            if plugin:
                plugin.apply(api, profile, plugin_spec.get("spec", {}))
        return None
