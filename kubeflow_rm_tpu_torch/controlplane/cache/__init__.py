"""controlplane.cache — shared informer read cache for the reconcile hot path.

controller-runtime serves all controller reads from a watch-fed
informer cache and sends only writes to the apiserver (its "cached
client"); NotebookOS leans on replicated cached state the same way to
keep interactive scheduling latency off the request path. This package
is that layer for both of this repo's backends:

- ``store.ObjectStore``  — indexed, thread-safe object store (kind/ns/
  name primary key; per-namespace, label and owner-UID secondary
  indices; per-key rv history for conflict rebase; relist-safe
  ``replace`` with deletion tombstones; ``wait_for_sync`` gating).
- ``informer.SharedInformer`` — feeds a store from ``add_watcher``
  events; lazily primes kinds from the backend's list on first read
  (in-memory backend) or rides the kube adapter's list+watch threads
  (remote backend, which owns 410-relist recovery in ``watch_kind``).
- ``cached.CachedAPI``   — the drop-in verb surface controllers, web
  apps and webhooks talk to: reads from memory once synced, writes to
  the server with no-op suppression and a conflict fast-path.

(The port's copy of ``kubeflow_rm_tpu/controlplane/cache/__init__.py``,
verbatim.)
"""

from kubeflow_rm_tpu_torch.controlplane.cache.cached import CachedAPI
from kubeflow_rm_tpu_torch.controlplane.cache.informer import SharedInformer
from kubeflow_rm_tpu_torch.controlplane.cache.store import ObjectStore

__all__ = ["CachedAPI", "ObjectStore", "SharedInformer"]
