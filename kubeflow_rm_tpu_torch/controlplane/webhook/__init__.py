"""Admission seams of the port (counterpart of
``kubeflow_rm_tpu/controlplane/webhook``): :mod:`.admission_pricer`."""
