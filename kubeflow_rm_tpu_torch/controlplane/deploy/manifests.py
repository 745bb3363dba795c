"""Kustomize manifest tree for the port's control plane (the port's copy
of ``kubeflow_rm_tpu/controlplane/deploy/manifests.py``).

Mirrors the reference's kubebuilder layout
(``notebook-controller/config/{crd,rbac,manager,webhook,default}`` and
``config/overlays/{standalone,...}``): one controller-manager Deployment
(all reconcilers in one process), one webhook Deployment (HTTPS
admission), five web-app Deployments, and the CRDs from ``crds.py``.
Every process runs ``python -m kubeflow_rm_tpu_torch.controlplane <cmd>``
(``controlplane/__main__.py``; each ``<cmd>`` is one of its commands).
:func:`write_tree` writes the tree as JSON documents, which a YAML 1.2
reader takes as they are; no rendered tree is checked in.
"""

from __future__ import annotations

import os

IMAGE = "kubeflow-rm-tpu/controlplane"
NAMESPACE = "kubeflow"
APP_LABEL = "app.kubernetes.io/part-of"


def _deployment(name: str, command: list[str], *, port: int,
                sa: str = "controlplane", env: list[dict] | None = None,
                volumes: list[dict] | None = None,
                mounts: list[dict] | None = None,
                probe_path: str = "/healthz") -> dict:
    container = {
        "name": name,
        "image": IMAGE,
        "command": command,
        "ports": [{"containerPort": port}],
        "env": env or [],
        "readinessProbe": {
            "httpGet": {"path": probe_path, "port": port,
                        **({"scheme": "HTTPS"} if name == "webhook"
                           else {})},
            "initialDelaySeconds": 3,
        },
        "resources": {
            "requests": {"cpu": "100m", "memory": "128Mi"},
            "limits": {"cpu": "1", "memory": "512Mi"},
        },
    }
    if mounts:
        container["volumeMounts"] = mounts
    pod_spec: dict = {"serviceAccountName": sa,
                      "containers": [container]}
    if volumes:
        pod_spec["volumes"] = volumes
    return {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {"name": name,
                     "labels": {APP_LABEL: "kubeflow-rm-tpu",
                                "app": name}},
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": {"app": name}},
            "template": {
                "metadata": {"labels": {"app": name}},
                "spec": pod_spec,
            },
        },
    }


def _service(name: str, port: int, target: int | None = None) -> dict:
    return {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {"name": name, "labels": {"app": name}},
        "spec": {"selector": {"app": name},
                 "ports": [{"port": port,
                            "targetPort": target or port}]},
    }


# gateway route prefix per app — the SAME path the SPA fetches and the
# VirtualService matches; each app serves its routes under this prefix
# in-cluster (APP_PREFIX) so the VS forwards without rewriting. The
# dashboard owns the root (SPA shell + /static + /api).
ROUTE_PREFIXES = {
    "jupyter-web-app": "/jupyter",
    "volumes-web-app": "/volumes",
    "tensorboards-web-app": "/tensorboards",
    "kfam": "/kfam",
    "dashboard": "",
}


def _webapp_pair(name: str, cmd: str, port: int) -> list[dict]:
    prefix = ROUTE_PREFIXES[name]
    return [
        _deployment(name, ["python", "-m",
                           "kubeflow_rm_tpu_torch.controlplane", cmd],
                    port=port, probe_path=f"{prefix}/healthz",
                    env=[{"name": "PORT", "value": str(port)},
                         {"name": "APP_PREFIX", "value": prefix}]),
        _service(name, 80, port),
    ]


def controller_manager_objects() -> list[dict]:
    dep = _deployment(
        "controller-manager",
        ["python", "-m", "kubeflow_rm_tpu_torch.controlplane",
         "controller-manager"],
        port=8081,
        env=[{"name": "ENABLE_CULLING", "value": "true"},
             {"name": "CULL_IDLE_TIME", "value": "1440"},
             {"name": "IDLENESS_CHECK_PERIOD", "value": "1"},
             # HA pair: both replicas run, the lease decides who
             # reconciles (controlplane/ha); POD_NAME is the election
             # identity, qps/burst bound the shared apiserver budget
             {"name": "LEADER_ELECT", "value": "true"},
             {"name": "POD_NAME", "valueFrom": {"fieldRef": {
                 "fieldPath": "metadata.name"}}},
             {"name": "KUBE_CLIENT_QPS", "value": "20"},
             {"name": "KUBE_CLIENT_BURST", "value": "40"}],
    )
    dep["spec"]["replicas"] = 2
    # the manager serves no HTTP; probe is exec-based liveness instead
    c = dep["spec"]["template"]["spec"]["containers"][0]
    del c["readinessProbe"]
    del c["ports"]
    c["livenessProbe"] = {
        "exec": {"command": ["python", "-c",
                             "import kubeflow_rm_tpu_torch"]},
        "periodSeconds": 60,
    }
    return [dep]


def webhook_objects() -> list[dict]:
    dep = _deployment(
        "webhook", ["python", "-m", "kubeflow_rm_tpu_torch.controlplane",
                    "webhook-server"],
        port=8443,
        env=[{"name": "WEBHOOK_TLS_CERT",
              "value": "/etc/webhook/certs/tls.crt"},
             {"name": "WEBHOOK_TLS_KEY",
              "value": "/etc/webhook/certs/tls.key"}],
        volumes=[{"name": "certs",
                  "secret": {"secretName": "webhook-server-cert"}}],
        mounts=[{"name": "certs", "mountPath": "/etc/webhook/certs",
                 "readOnly": True}],
    )
    svc = _service("webhook", 443, 8443)
    cfg = {
        "apiVersion": "admissionregistration.k8s.io/v1",
        "kind": "MutatingWebhookConfiguration",
        "metadata": {"name": "kubeflow-rm-tpu-mutating"},
        "webhooks": [
            {
                "name": "notebooks.kubeflow.org",
                "admissionReviewVersions": ["v1"],
                "sideEffects": "None",
                "failurePolicy": "Fail",
                "clientConfig": {
                    "service": {"name": "webhook",
                                "namespace": NAMESPACE,
                                "path": "/mutate-notebook",
                                "port": 443},
                    # caBundle patched in by the overlay / cert-manager
                },
                "rules": [{"apiGroups": ["kubeflow.org"],
                           "apiVersions": ["v1"],
                           "operations": ["CREATE", "UPDATE"],
                           "resources": ["notebooks"]}],
            },
            {
                "name": "pods.kubeflow.org",
                "admissionReviewVersions": ["v1"],
                "sideEffects": "None",
                # pods must start even if the webhook is down — the
                # reference's PodDefault webhook is Ignore too
                "failurePolicy": "Ignore",
                "namespaceSelector": {
                    "matchLabels": {
                        "app.kubernetes.io/part-of": "kubeflow-profile"},
                },
                "clientConfig": {
                    "service": {"name": "webhook",
                                "namespace": NAMESPACE,
                                "path": "/mutate-pod",
                                "port": 443},
                },
                "rules": [{"apiGroups": [""],
                           "apiVersions": ["v1"],
                           "operations": ["CREATE"],
                           "resources": ["pods"]}],
            },
        ],
    }
    return [dep, svc, cfg]


def rbac_objects() -> list[dict]:
    sa = {"apiVersion": "v1", "kind": "ServiceAccount",
          "metadata": {"name": "controlplane"}}
    # everything the reconcilers + web apps touch (the union of the
    # reference's per-component roles)
    rules = [
        {"apiGroups": ["kubeflow.org", "tensorboard.kubeflow.org"],
         "resources": ["notebooks", "notebooks/status", "profiles",
                       "profiles/status", "poddefaults", "pvcviewers",
                       "pvcviewers/status", "tensorboards",
                       "tensorboards/status"],
         "verbs": ["*"]},
        {"apiGroups": [""],
         "resources": ["namespaces", "services", "serviceaccounts",
                       "configmaps", "secrets", "events", "pods",
                       "pods/log", "resourcequotas",
                       "persistentvolumeclaims", "nodes"],
         "verbs": ["*"]},
        {"apiGroups": ["apps"],
         "resources": ["statefulsets", "deployments"],
         "verbs": ["*"]},
        {"apiGroups": ["rbac.authorization.k8s.io"],
         "resources": ["rolebindings", "clusterroles",
                       "clusterrolebindings"],
         "verbs": ["*"]},
        {"apiGroups": ["networking.k8s.io"],
         "resources": ["networkpolicies"], "verbs": ["*"]},
        {"apiGroups": ["networking.istio.io", "security.istio.io"],
         "resources": ["virtualservices", "authorizationpolicies"],
         "verbs": ["*"]},
        {"apiGroups": ["route.openshift.io"], "resources": ["routes"],
         "verbs": ["*"]},
        {"apiGroups": ["authorization.k8s.io"],
         "resources": ["subjectaccessreviews"], "verbs": ["create"]},
        # leader-election lock for the two-replica manager
        {"apiGroups": ["coordination.k8s.io"],
         "resources": ["leases"],
         "verbs": ["get", "list", "watch", "create", "update"]},
    ]
    role = {"apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRole",
            "metadata": {"name": "kubeflow-rm-tpu-manager"},
            "rules": rules}
    rb = {"apiVersion": "rbac.authorization.k8s.io/v1",
          "kind": "ClusterRoleBinding",
          "metadata": {"name": "kubeflow-rm-tpu-manager"},
          "roleRef": {"apiGroup": "rbac.authorization.k8s.io",
                      "kind": "ClusterRole",
                      "name": "kubeflow-rm-tpu-manager"},
          "subjects": [{"kind": "ServiceAccount", "name": "controlplane",
                        "namespace": NAMESPACE}]}
    # the user-facing aggregated roles the profile controller binds
    user_roles = []
    for name, verbs in (("kubeflow-admin", ["*"]),
                        ("kubeflow-edit", ["*"]),
                        ("kubeflow-view", ["get", "list", "watch"])):
        user_roles.append({
            "apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRole",
            "metadata": {"name": name},
            "rules": [
                {"apiGroups": ["kubeflow.org",
                               "tensorboard.kubeflow.org"],
                 "resources": ["notebooks", "poddefaults",
                               "tensorboards", "pvcviewers"],
                 "verbs": verbs},
                {"apiGroups": [""],
                 "resources": ["persistentvolumeclaims", "events",
                               "pods", "pods/log", "configmaps"],
                 "verbs": verbs if verbs == ["*"]
                 else ["get", "list", "watch"]},
            ],
        })
    return [sa, role, rb, *user_roles]


def webapp_objects() -> list[dict]:
    objs: list[dict] = []
    for name, cmd, port in (
            ("jupyter-web-app", "jupyter-web-app", 5000),
            ("volumes-web-app", "volumes-web-app", 5001),
            ("tensorboards-web-app", "tensorboards-web-app", 5002),
            ("kfam", "kfam", 8081),
            ("dashboard", "dashboard", 8082)):
        objs.extend(_webapp_pair(name, cmd, port))
    objs.append(_gateway_virtualservice())
    return objs


def _gateway_virtualservice() -> dict:
    """ONE VirtualService path-routing every web app behind the gateway
    (the reference dashboard's proxy table,
    ``centraldashboard/app/server.ts:56-91``). A single resource with
    ordered routes — dashboard's "/" catch-all LAST — because Istio's
    cross-resource merge order for the same host is undefined; within
    one VirtualService route order is contractual. No rewrites: each
    app serves its routes under its own prefix (APP_PREFIX in
    ``_webapp_pair``); destinations use the SERVICE port (80)."""
    ordered = sorted(ROUTE_PREFIXES.items(),
                     key=lambda kv: -len(kv[1]))  # "/" last
    return {
        "apiVersion": "networking.istio.io/v1beta1",
        "kind": "VirtualService",
        "metadata": {"name": "kubeflow-webapps", "namespace": "kubeflow"},
        "spec": {
            "hosts": ["*"],
            "gateways": ["kubeflow/kubeflow-gateway"],
            "http": [{
                "match": [{"uri": {"prefix": prefix + "/"}}],
                "route": [{"destination": {
                    "host": f"{name}.kubeflow.svc.cluster.local",
                    "port": {"number": 80},
                }}],
            } for name, prefix in ordered],
        },
    }


def _kustomization(resources: list[str], *, namespace: str | None = None,
                   extra: dict | None = None) -> dict:
    k: dict = {"apiVersion": "kustomize.config.k8s.io/v1beta1",
               "kind": "Kustomization",
               "resources": resources}
    if namespace:
        k["namespace"] = namespace
    if extra:
        k.update(extra)
    return k


def write_tree(outdir: str) -> list[str]:
    """Write the full kustomize tree; returns the files written."""
    from kubeflow_rm_tpu_torch.controlplane.deploy.crds import (
        all_crds,
        render_yaml,
    )

    def dump(objs) -> str:
        return render_yaml([objs] if isinstance(objs, dict) else objs)

    files: dict[str, str] = {}

    crd_files = []
    for crd in all_crds():
        fname = f"crd/bases/{crd['metadata']['name']}.yaml"
        files[fname] = dump(crd)
        crd_files.append(os.path.basename(fname))
    files["crd/kustomization.yaml"] = dump(_kustomization(
        [f"bases/{f}" for f in crd_files]))

    files["rbac/rbac.yaml"] = dump(rbac_objects())
    files["rbac/kustomization.yaml"] = dump(_kustomization(["rbac.yaml"]))

    files["manager/manager.yaml"] = dump(controller_manager_objects())
    files["manager/kustomization.yaml"] = dump(
        _kustomization(["manager.yaml"]))

    files["webhook/webhook.yaml"] = dump(webhook_objects())
    files["webhook/kustomization.yaml"] = dump(
        _kustomization(["webhook.yaml"]))

    files["webapps/webapps.yaml"] = dump(webapp_objects())
    files["webapps/kustomization.yaml"] = dump(
        _kustomization(["webapps.yaml"]))

    files["default/kustomization.yaml"] = dump(_kustomization(
        ["../crd", "../rbac", "../manager", "../webhook", "../webapps",
         "namespace.yaml"],
        namespace=NAMESPACE,
        extra={"images": [{"name": IMAGE,
                           "newName": IMAGE, "newTag": "latest"}]}))
    files["default/namespace.yaml"] = dump({
        "apiVersion": "v1", "kind": "Namespace",
        "metadata": {"name": NAMESPACE}})

    # overlays: standalone (plain) and kind (CI: local image, no TLS
    # verification dance — cert generated by the e2e script)
    files["overlays/standalone/kustomization.yaml"] = dump(
        _kustomization(["../../default"]))
    files["overlays/kind/kustomization.yaml"] = dump(_kustomization(
        ["../../default"],
        extra={"images": [{"name": IMAGE,
                           "newName": "localhost/kubeflow-rm-tpu",
                           "newTag": "ci"}]}))

    written = []
    for rel, content in files.items():
        path = os.path.join(outdir, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(content if content.endswith("\n")
                    else content + "\n")
        written.append(path)
    return written
