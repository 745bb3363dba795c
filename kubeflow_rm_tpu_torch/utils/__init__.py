"""Utilities of the port (counterpart of ``kubeflow_rm_tpu/utils``)."""
