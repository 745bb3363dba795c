"""Client-side pieces of the port's control plane (counterpart of
``kubeflow_rm_tpu/controlplane/deploy``): :mod:`.kubeclient`'s
``TokenBucket``."""
