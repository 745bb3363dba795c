"""Horizontal sharding of the port's control plane (counterpart of
``kubeflow_rm_tpu/controlplane/shard``).

The apiserver partitions by NAMESPACE under a consistent-hash ring
(:mod:`.ring`): every object of a namespace — and the cluster-scoped
objects keyed by the same name, like a Profile and the Namespace it
owns — lives on exactly one shard. The client-side router is
``deploy.kubeclient.ShardedKubeAPIServer``; the serving fleet rides the
same ring. The shard worker, its supervisor and the elastic split/merge
(``worker.py``, ``runner.py``, ``elastic.py``) are ROADMAP slice 7e-3.
"""

from kubeflow_rm_tpu_torch.controlplane.shard.ring import (
    DEFAULT_VNODES,
    HashRing,
)

__all__ = ["HashRing", "DEFAULT_VNODES"]
