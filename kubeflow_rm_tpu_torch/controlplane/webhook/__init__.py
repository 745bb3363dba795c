"""Admission webhooks of the port (counterpart of
``kubeflow_rm_tpu/controlplane/webhook``): :mod:`.notebook` (the
reconciliation lock, image resolution, the no-restart guard),
:mod:`.admission_pricer`, :mod:`.poddefault` and :mod:`.gpu_inject`
(JAX's ``tpu_inject``)."""
