"""Parallel layers of the port (counterpart of
``kubeflow_rm_tpu/parallel``). Single device so far: the dense-dispatch
MoE layer (``moe``). Meshes, sharding, ring/Ulysses attention and the
pipeline come with the parallel slice."""
