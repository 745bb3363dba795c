"""Profile resource: per-user namespace onboarding.

Mirrors ``profile-controller/api/v1/profile_types.go:36-44``: a
cluster-scoped CR carrying the owner subject, an optional
ResourceQuotaSpec (where card quotas live, as ``nvidia.com/gpu`` —
``profile_controller.go:252-281``), and a plugin list.

(The port's copy of ``kubeflow_rm_tpu/controlplane/api/profile.py``; only
this docstring's quota resource differs.)
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane.api.meta import make_object

API_VERSION = "kubeflow.org/v1"
KIND = "Profile"

OWNER_ANNOTATION = "owner"
QUOTA_NAME = "kf-resource-quota"
DEFAULT_EDITOR = "default-editor"
DEFAULT_VIEWER = "default-viewer"


def make_profile(name: str, owner_email: str, *,
                 quota_hard: dict | None = None,
                 plugins: list | None = None) -> dict:
    spec: dict = {"owner": {"kind": "User", "name": owner_email}}
    if quota_hard:
        spec["resourceQuotaSpec"] = {"hard": dict(quota_hard)}
    if plugins:
        spec["plugins"] = list(plugins)
    return make_object(API_VERSION, KIND, name, spec=spec)
