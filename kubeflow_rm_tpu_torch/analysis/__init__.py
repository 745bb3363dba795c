"""Program analysis of the port (counterpart of
``kubeflow_rm_tpu/analysis``): :mod:`.torchcheck`, the auditor of what
the compute path does to the card; :mod:`.lint`, its static rules
(KFRM001-008); and :mod:`.lockgraph`, the lock factory and its dynamic
lock-order analysis.
"""
