"""Consistent hashing of the port's serving fleet (counterpart of
``kubeflow_rm_tpu/controlplane/shard``): :mod:`.ring`'s ``HashRing``."""
