"""HA reconcile runtime (counterpart of ``kubeflow_rm_tpu/controlplane/ha``):
the rate-limited work queue every controller's requests pass through
(``workqueue.py``). Leader election (``leases.py``) is not ported yet:
``Manager.run_forever(elector=...)`` refuses it."""

from kubeflow_rm_tpu_torch.controlplane.ha.workqueue import (  # noqa: F401
    ExponentialBackoff,
    WorkQueue,
)
