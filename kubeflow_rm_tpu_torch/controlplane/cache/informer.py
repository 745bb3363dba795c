"""Shared informer: one watch-fed feed per backend, many read paths.

controller-runtime starts one informer per watched type and shares it
between every controller's cached client; this module is that object
for both backends the platform runs against:

- **in-memory ``APIServer``**: events arrive (ordered, per-kind rv
  order) on the apiserver's fanout dispatch thread — a kind is primed
  lazily (one ``list`` on first read) and the store's rv monotonicity
  plus the relist-merge horizon keep concurrent event delivery and
  priming from ever rolling the cache back. A ``TOO_OLD`` overflow
  sentinel forces a relist of every synced kind (the 410 path).
- **``KubeAPIServer``**: the adapter's ``watch_kind`` loops own the
  transport (list+watch with rv resume, full relist on 410 Gone) and
  feed the adapter's ``ObjectStore``; the informer adopts that store,
  spawns the watch threads, and exposes ``wait_for_sync`` over it.

Read-your-writes freshness is the ``CachedAPI``'s half of the deal: a
write's returned object (with its fresh rv) is folded into the same
store before the verb returns, and the store's rv comparison keeps a
lagging watch event from rolling it back.

(The port's copy of ``kubeflow_rm_tpu/controlplane/cache/informer.py``,
verbatim; ``informer.prime`` is ranked in the port's
``analysis/lockgraph.LOCK_HIERARCHY``.)
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Iterable

from kubeflow_rm_tpu_torch.controlplane.cache.store import ObjectStore
from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock

log = logging.getLogger("kubeflow_rm_tpu_torch.cache")


class SharedInformer:
    def __init__(self, api, store: ObjectStore | None = None):
        self.api = api
        # a backend that maintains its own informer cache (the kube
        # adapter) shares it; otherwise the informer owns a fresh store
        # and rides the backend's synchronous watcher fanout
        backend_store = getattr(api, "cache", None)
        if store is None and isinstance(backend_store, ObjectStore):
            self.store = backend_store
            self._backend_fed = True
        else:
            self.store = store or ObjectStore()
            self._backend_fed = False
            api.add_watcher(self._on_event, name="informer")
        # lazy priming is only sound against the in-memory backend,
        # whose list() is exact at call time (events racing the prime
        # are reconciled by replace()'s rv horizon); a remote backend
        # must sync through its watch threads
        self.lazy = not hasattr(api, "watch_kind")
        self._prime_lock = make_lock("informer.prime")
        self._threads: list[threading.Thread] = []

    # ---- event feed (in-memory backend) ------------------------------
    def _on_event(self, etype: str, obj: dict, old: dict | None) -> None:
        if etype == "TOO_OLD":
            # the apiserver's fanout queue overflowed for this watcher:
            # the event window is gone, so relist every synced kind —
            # the same recovery a kube watch 410 forces, reusing the
            # store's relist-merge (rv horizon keeps later events sane)
            for kind in self.store.synced_kinds():
                try:
                    self.store.replace(kind, self.api.list(kind))
                except Exception:  # noqa: BLE001 - kind vanished mid-relist
                    log.exception("TOO_OLD relist of %s failed", kind)
            return
        self.store.apply(etype, obj)
        from kubeflow_rm_tpu_torch.controlplane import metrics
        kind = obj.get("kind")
        if kind:
            metrics.INFORMER_EVENTS_TOTAL.labels(kind=kind).inc()
        metrics.INFORMER_LAST_EVENT_TIMESTAMP.set(time.time())

    # ---- sync --------------------------------------------------------
    def ensure_synced(self, kind: str) -> bool:
        """True when ``kind`` may be served from the store. Under a
        lazy (in-memory) backend a cold kind is primed here with one
        list; under a remote backend sync only comes from the watch
        threads' initial list."""
        if self.store.is_synced(kind):
            return True
        if not self.lazy:
            return False
        from kubeflow_rm_tpu_torch.controlplane import metrics
        with self._prime_lock:
            if self.store.is_synced(kind):
                return True
            try:
                objs = self.api.list(kind)
            except Exception:  # noqa: BLE001 - kind may not be served
                metrics.swallowed("informer", f"lazy prime list {kind}")
                return False
            self.store.replace(kind, objs)
            metrics.INFORMER_SYNCED_KINDS.set(
                len(self.store.synced_kinds()))
        return True

    def wait_for_sync(self, kinds: Iterable[str],
                      timeout: float | None = None) -> bool:
        kinds = list(kinds)
        if self.lazy:
            return all(self.ensure_synced(k) for k in kinds)
        return self.store.wait_for_sync(kinds, timeout)

    # ---- watch threads (remote backend) ------------------------------
    def start(self, kinds: Iterable[str],
              stop: threading.Event | None = None,
              timeout_s: int = 300) -> list[threading.Thread]:
        """Spawn one list+watch loop per kind on the backend (remote
        backends only — the in-memory backend needs none). Relist on
        410 and rv-resume live in the backend's ``watch_kind``; the
        shared store both paths feed is what makes recovery invisible
        to readers."""
        if self.lazy:
            return []
        stop = stop or threading.Event()
        for kind in kinds:
            t = threading.Thread(
                target=self.api.watch_kind, args=(kind, None, stop,
                                                  timeout_s),
                daemon=True, name=f"informer-{kind}")
            t.start()
            self._threads.append(t)
        return self._threads
