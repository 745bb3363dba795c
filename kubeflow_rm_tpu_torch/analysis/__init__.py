"""Program analysis of the port (counterpart of
``kubeflow_rm_tpu/analysis``): :mod:`.torchcheck`, the auditor of what
the compute path does to the card, and :mod:`.lint`, its static rules
(KFRM006-008). The JAX package's lock-order analysis (``lockgraph``) and
its locking rules (KFRM001-005) have no counterpart here yet.
"""
