"""PodDefault resource: label-selected pod-patch bundles.

Mirrors the reference CRD
(``admission-webhook/pkg/apis/settings/v1alpha1/poddefault_types.go:27-125``):
a namespaced bundle of env/envFrom/volumes/volumeMounts/sidecars/
initContainers/tolerations/labels/annotations/serviceAccountName/
command/args/imagePullSecrets applied to every pod in the namespace
whose labels match ``spec.selector``.

(The port's copy of ``kubeflow_rm_tpu/controlplane/api/poddefault.py``,
verbatim.)
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane.api.meta import deep_get, make_object

API_VERSION = "kubeflow.org/v1alpha1"
KIND = "PodDefault"

EXCLUDE_ANNOTATION = "poddefault.admission.kubeflow.org/exclude"
APPLIED_ANNOTATION_PREFIX = "poddefault.admission.kubeflow.org/poddefault-"

MERGE_FIELDS = (
    "env", "envFrom", "volumes", "volumeMounts", "sidecars",
    "initContainers", "tolerations", "imagePullSecrets",
)


def make_poddefault(name: str, namespace: str, *, selector: dict,
                    desc: str = "", **spec_fields) -> dict:
    spec = {"selector": selector, "desc": desc or name}
    for k, v in spec_fields.items():
        if k not in MERGE_FIELDS and k not in (
                "serviceAccountName", "automountServiceAccountToken",
                "labels", "annotations", "command", "args"):
            raise ValueError(f"unknown PodDefault spec field {k!r}")
        spec[k] = v
    return make_object(API_VERSION, KIND, name, namespace, spec=spec)


def validate(pd: dict) -> None:
    if deep_get(pd, "spec", "selector") is None:
        raise ValueError("PodDefault spec.selector is required")
