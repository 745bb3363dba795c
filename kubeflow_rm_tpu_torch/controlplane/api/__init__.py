"""The control plane's API vocabulary (counterpart of
``kubeflow_rm_tpu/controlplane/api``): object helpers (:mod:`.meta`), the
card slice table (:mod:`.gpu`, JAX's ``tpu.py``), and the Notebook,
TPUJob, Profile and PodDefault resources (:mod:`.notebook`,
:mod:`.tpujob`, :mod:`.profile`, :mod:`.poddefault`)."""
