"""Admission webhooks of the port (counterpart of
``kubeflow_rm_tpu/controlplane/webhook``): :mod:`.admission_pricer` and
:mod:`.gpu_inject` (JAX's ``tpu_inject``)."""
