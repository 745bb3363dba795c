"""Program analysis of the port (counterpart of
``kubeflow_rm_tpu/analysis``): :mod:`.torchcheck`, the auditor of what
the compute path does to the card. The JAX package's concurrency
toolkit (``lockgraph``, ``lint``) has no counterpart here yet.
"""
