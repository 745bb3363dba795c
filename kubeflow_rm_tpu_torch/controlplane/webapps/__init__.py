"""Web apps (SURVEY.md §2.2–§2.3 layer L5; counterpart of
``kubeflow_rm_tpu/controlplane/webapps``): standard-library WSGI
backends over the apiserver — jupyter (spawner), volumes, tensorboards
and KFAM, all built on the shared ``core.WebApp`` pipeline (authn/authz/
CSRF/probes/envelopes), the crud_backend equivalent — and
:mod:`.serving`, the multi-tenant serving gateway over the
continuous-batching engine."""

from kubeflow_rm_tpu_torch.controlplane.webapps.core import WebApp

__all__ = ["WebApp"]
