"""Horizontal sharding of the port's control plane (counterpart of
``kubeflow_rm_tpu/controlplane/shard``).

The apiserver partitions by NAMESPACE under a consistent-hash ring
(:mod:`.ring`): every object of a namespace — and the cluster-scoped
objects keyed by the same name, like a Profile and the Namespace it
owns — lives on exactly one shard. :mod:`.worker` is one shard's
process (apiserver + WAL + kubelet + REST + elected platform manager);
:mod:`.runner` supervises N of them and respawns a killed shard in
place; :mod:`.elastic` splits and merges shards live by snapshot and
WAL tail replay, under an autoscaler. The client-side router is
``deploy.kubeclient.ShardedKubeAPIServer``; the serving fleet rides the
same ring.
"""

from kubeflow_rm_tpu_torch.controlplane.shard.ring import (
    DEFAULT_VNODES,
    HashRing,
)
from kubeflow_rm_tpu_torch.controlplane.shard.runner import ShardRunner

__all__ = ["HashRing", "DEFAULT_VNODES", "ShardRunner"]
