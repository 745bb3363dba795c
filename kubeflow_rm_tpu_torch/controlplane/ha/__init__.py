"""HA reconcile runtime (counterpart of ``kubeflow_rm_tpu/controlplane/ha``):
lease-based leader election (``leases.py``: only the elected leader's
Manager reconciles, a standby takes over within one lease duration) and
the rate-limited work queue every controller's requests pass through
(``workqueue.py``)."""

from kubeflow_rm_tpu_torch.controlplane.ha.leases import (  # noqa: F401
    DEFAULT_LEASE_NAME,
    LeaderElector,
    make_lease,
)
from kubeflow_rm_tpu_torch.controlplane.ha.workqueue import (  # noqa: F401
    ExponentialBackoff,
    WorkQueue,
)
