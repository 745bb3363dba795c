"""CRD manifests, generated from the port's API modules (the port's
copy of ``kubeflow_rm_tpu/controlplane/deploy/crds.py``).

The reference's CRDs are kubebuilder-generated Go structs
(``notebook-controller/config/crd/bases/kubeflow.org_notebooks.yaml``,
``profile-controller/config/crd/bases/``, admission-webhook's
PodDefault, tensorboard's and pvcviewer's). Here the Python API modules
(``api/notebook.py``, ``api/profile.py``, ``api/poddefault.py``, the
tensorboard/pvcviewer controllers) are the source of truth, and this
module renders openAPIV3Schema CRDs from them — the acceleratorType
enum comes live from ``api/gpu.py``'s topology table, so the CRD can
never drift from what the controller schedules.

The schemas are JAX's field for field: the port's Notebook and TPUJob
carry their card slice under ``tpu`` (``spec.tpu`` / a role's ``tpu``,
what :mod:`..api.notebook`'s validator and every controller read) and
the spoke versions under :mod:`..api.conversion`'s annotation keys, so
a cluster that prunes unknown fields keeps what the controllers need.
:func:`render_yaml` writes each object as JSON, which a YAML 1.2 reader
takes as it is: the port carries no YAML library.
"""

from __future__ import annotations

import json

from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api
from kubeflow_rm_tpu_torch.controlplane.api.notebook import MAX_SLICES

# Free-form object: pod specs / quota specs / plugin configs — CRDs
# model these as x-kubernetes-preserve-unknown-fields, exactly how the
# reference embeds corev1.PodSpec.
_ANY = {"type": "object", "x-kubernetes-preserve-unknown-fields": True}


def _crd(group: str, kind: str, plural: str, versions: list[dict],
         scope: str = "Namespaced", short_names: list[str] | None = None,
         categories: list[str] | None = None) -> dict:
    names = {
        "kind": kind,
        "listKind": f"{kind}List",
        "plural": plural,
        "singular": kind.lower(),
    }
    if short_names:
        names["shortNames"] = short_names
    if categories:
        names["categories"] = categories
    return {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{group}"},
        "spec": {
            "group": group,
            "names": names,
            "scope": scope,
            "versions": versions,
        },
    }


def _version(name: str, schema: dict, *, served: bool = True,
             storage: bool = True, status: bool = True,
             printer_columns: list[dict] | None = None) -> dict:
    v: dict = {
        "name": name,
        "served": served,
        "storage": storage,
        "schema": {"openAPIV3Schema": schema},
    }
    if status:
        v["subresources"] = {"status": {}}
    if printer_columns:
        v["additionalPrinterColumns"] = printer_columns
    return v


def notebook_crd() -> dict:
    """kubeflow.org/v1 Notebook with the first-class ``spec.tpu`` block
    (the validator in ``api/notebook.py:validate`` rendered as schema)."""
    tpu_block = {
        "type": "object",
        "required": ["acceleratorType"],
        "properties": {
            "acceleratorType": {
                "type": "string",
                # live from the topology table: quota, scheduling and
                # the spawner picker all share this vocabulary
                "enum": sorted(gpu_api.TOPOLOGIES),
            },
            "numSlices": {
                "type": "integer",
                "minimum": 1,
                "maximum": MAX_SLICES,
                "description": "Multislice width: >1 renders a DCN job "
                               "of identical slices with MEGASCALE_* "
                               "rendezvous injected.",
            },
        },
    }
    schema = {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "required": ["template"],
                "properties": {
                    "template": {
                        "type": "object",
                        "required": ["spec"],
                        "properties": {"spec": _ANY},
                    },
                    "tpu": tpu_block,
                },
            },
            "status": {
                "type": "object",
                "properties": {
                    "conditions": {"type": "array", "items": _ANY},
                    "readyReplicas": {"type": "integer"},
                    "containerState": _ANY,
                },
            },
        },
    }
    cols = [
        {"name": "Accelerator", "type": "string",
         "jsonPath": ".spec.tpu.acceleratorType"},
        {"name": "Ready", "type": "integer",
         "jsonPath": ".status.readyReplicas"},
        {"name": "Age", "type": "date",
         "jsonPath": ".metadata.creationTimestamp"},
    ]
    # v1beta1: the reference-era shape — NO spec.tpu; TPU placement
    # rides annotations (api/conversion.py hoists/demotes losslessly).
    # Served for API evolution parity with the reference, which serves
    # v1alpha1/v1beta1/v1 with conversion shims
    # (notebook-controller/api/v1beta1/notebook_types.go:27-34,
    # api/v1/notebook_conversion.go).
    import copy as _copy
    beta_schema = _copy.deepcopy(schema)
    del beta_schema["properties"]["spec"]["properties"]["tpu"]
    beta_cols = [
        {"name": "Accelerator", "type": "string",
         "jsonPath": ".metadata.annotations['notebooks\\.kubeflow\\."
                     "org/tpu-accelerator-type']"},
    ] + cols[1:]
    # v1alpha1: same annotation-carried shape under the pre-prefix
    # ``kubeflow.org/tpu-*`` keys (api/conversion.py LEGACY_*)
    alpha_schema = _copy.deepcopy(beta_schema)
    alpha_cols = [
        {"name": "Accelerator", "type": "string",
         "jsonPath": ".metadata.annotations['kubeflow\\.org/"
                     "tpu-accelerator-type']"},
    ] + cols[1:]
    crd = _crd("kubeflow.org", "Notebook", "notebooks",
               [_version("v1alpha1", alpha_schema, storage=False,
                         printer_columns=alpha_cols),
                _version("v1beta1", beta_schema, storage=False,
                         printer_columns=beta_cols),
                _version("v1", schema, printer_columns=cols)],
               short_names=["nb"], categories=["kubeflow"])
    crd["spec"]["conversion"] = {
        "strategy": "Webhook",
        "webhook": {
            "conversionReviewVersions": ["v1"],
            "clientConfig": {
                # same Service the admission configs point at
                # (deploy/manifests.py webhook_objects)
                "service": {
                    "name": "webhook",
                    "namespace": "kubeflow",
                    "path": "/convert",
                    "port": 443,
                },
                # caBundle patched in by the overlay / cert-manager
            },
        },
    }
    return crd


def tpujob_crd() -> dict:
    """kubeflow.org/v1 TPUJob — multi-role gang jobs (the validator in
    ``api/tpujob.py:validate`` rendered as schema). Spokes v1alpha1 and
    v1beta1 carry the role list as a JSON annotation
    (``api/conversion.py:TPU_JOB_ROLES_ANNOTATION``), converted through
    the same webhook as Notebook."""
    from kubeflow_rm_tpu_torch.controlplane.api.tpujob import (
        MAX_ROLE_REPLICAS,
        MAX_ROLES,
    )
    role_schema = {
        "type": "object",
        "required": ["name"],
        "properties": {
            "name": {
                "type": "string",
                "pattern": r"^[a-z]([a-z0-9-]{0,30}[a-z0-9])?$",
            },
            "replicas": {
                "type": "integer",
                "minimum": 1,
                "maximum": MAX_ROLE_REPLICAS,
                "description": "Slices for TPU roles (pods = replicas "
                               "× hosts), pods for CPU roles.",
            },
            "tpu": {
                "type": "object",
                "required": ["acceleratorType"],
                "properties": {
                    "acceleratorType": {
                        "type": "string",
                        "enum": sorted(gpu_api.TOPOLOGIES),
                    },
                },
            },
            "cpu": {
                "type": "string",
                "description": "Per-pod CPU request for chipless "
                               "roles (quantity, e.g. \"2\" or "
                               "\"500m\").",
            },
            "template": _ANY,
        },
    }
    schema = {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "required": ["roles"],
                "properties": {
                    "roles": {
                        "type": "array",
                        "minItems": 1,
                        "maxItems": MAX_ROLES,
                        "items": role_schema,
                    },
                    "image": {"type": "string"},
                    "priorityClassName": {"type": "string"},
                },
            },
            "status": {
                "type": "object",
                "properties": {
                    "phase": {"type": "string"},
                    "readyPods": {"type": "integer"},
                    "totalPods": {"type": "integer"},
                    "roles": _ANY,
                },
            },
        },
    }
    cols = [
        {"name": "Phase", "type": "string", "jsonPath": ".status.phase"},
        {"name": "Ready", "type": "integer",
         "jsonPath": ".status.readyPods"},
        {"name": "Total", "type": "integer",
         "jsonPath": ".status.totalPods"},
        {"name": "Age", "type": "date",
         "jsonPath": ".metadata.creationTimestamp"},
    ]
    # spokes: spec.roles demoted to the JSON roles annotation
    import copy as _copy
    spoke_schema = _copy.deepcopy(schema)
    del spoke_schema["properties"]["spec"]["properties"]["roles"]
    spoke_schema["properties"]["spec"].pop("required", None)
    crd = _crd("kubeflow.org", "TPUJob", "tpujobs",
               [_version("v1alpha1", _copy.deepcopy(spoke_schema),
                         storage=False),
                _version("v1beta1", _copy.deepcopy(spoke_schema),
                         storage=False),
                _version("v1", schema, printer_columns=cols)],
               short_names=["tj"], categories=["kubeflow"])
    crd["spec"]["conversion"] = {
        "strategy": "Webhook",
        "webhook": {
            "conversionReviewVersions": ["v1"],
            "clientConfig": {
                "service": {
                    "name": "webhook",
                    "namespace": "kubeflow",
                    "path": "/convert",
                    "port": 443,
                },
            },
        },
    }
    return crd


def profile_crd() -> dict:
    schema = {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "required": ["owner"],
                "properties": {
                    "owner": {
                        "type": "object",
                        "required": ["kind", "name"],
                        "properties": {
                            "kind": {"type": "string",
                                     "enum": ["User", "Group",
                                              "ServiceAccount"]},
                            "name": {"type": "string"},
                        },
                    },
                    "resourceQuotaSpec": _ANY,
                    "plugins": {
                        "type": "array",
                        "items": {
                            "type": "object",
                            "required": ["kind"],
                            "properties": {"kind": {"type": "string"},
                                           "spec": _ANY},
                        },
                    },
                },
            },
            "status": _ANY,
        },
    }
    return _crd("kubeflow.org", "Profile", "profiles",
                [_version("v1", schema)], scope="Cluster")


def poddefault_crd() -> dict:
    from kubeflow_rm_tpu_torch.controlplane.api.poddefault import MERGE_FIELDS
    props: dict = {
        "selector": _ANY,
        "desc": {"type": "string"},
        "serviceAccountName": {"type": "string"},
        "automountServiceAccountToken": {"type": "boolean"},
        "labels": {"type": "object",
                   "additionalProperties": {"type": "string"}},
        "annotations": {"type": "object",
                        "additionalProperties": {"type": "string"}},
        "command": {"type": "array", "items": {"type": "string"}},
        "args": {"type": "array", "items": {"type": "string"}},
    }
    for f in MERGE_FIELDS:
        props[f] = {"type": "array", "items": _ANY}
    schema = {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "required": ["selector"],
                "properties": props,
            },
        },
    }
    return _crd("kubeflow.org", "PodDefault", "poddefaults",
                [_version("v1alpha1", schema, status=False)])


def tensorboard_crd() -> dict:
    schema = {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "required": ["logspath"],
                "properties": {
                    "logspath": {
                        "type": "string",
                        "description": "pvc://claim/sub/path or "
                                       "gs://bucket/path",
                    },
                },
            },
            "status": _ANY,
        },
    }
    cols = [{"name": "Logspath", "type": "string",
             "jsonPath": ".spec.logspath"}]
    return _crd("tensorboard.kubeflow.org", "Tensorboard", "tensorboards",
                [_version("v1alpha1", schema, printer_columns=cols)])


def pvcviewer_crd() -> dict:
    schema = {
        "type": "object",
        "properties": {
            "spec": {
                "type": "object",
                "required": ["pvc"],
                "properties": {
                    "pvc": {"type": "string"},
                    "podSpec": _ANY,
                    "networking": _ANY,
                    "rwoScheduling": {"type": "boolean"},
                },
            },
            "status": _ANY,
        },
    }
    return _crd("kubeflow.org", "PVCViewer", "pvcviewers",
                [_version("v1alpha1", schema)])


def all_crds() -> list[dict]:
    return [notebook_crd(), tpujob_crd(), profile_crd(),
            poddefault_crd(), tensorboard_crd(), pvcviewer_crd()]


def render_yaml(objs: list[dict]) -> str:
    """The objects as YAML documents: indented JSON (YAML 1.2 is a
    superset of JSON), keys in the order they were built."""
    return "---\n".join(json.dumps(o, indent=2) + "\n" for o in objs)
