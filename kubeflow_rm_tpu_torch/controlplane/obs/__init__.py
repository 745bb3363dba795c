"""Observability seams of the port (counterpart of
``kubeflow_rm_tpu/controlplane/obs``): :mod:`.slo`'s probe bridges."""
