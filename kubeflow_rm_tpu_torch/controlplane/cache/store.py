"""Indexed, thread-safe object store — the informer cache's data half.

The store holds the latest observed version of every object of every
watched kind, exactly as client-go's ``ThreadSafeStore`` + ``Indexers``
do for controller-runtime's cached client. Three properties carry the
correctness load:

- **rv monotonicity**: ``apply`` never lets an older watch event roll
  back a newer write that was folded in directly (read-your-writes).
- **relist safety**: ``replace`` (the 410-Gone recovery path, and the
  lazy prime) merges a freshly-listed snapshot against events that
  raced it — entries newer than the snapshot survive, and deletion
  tombstones stop a stale snapshot from resurrecting an object deleted
  during the race window.
- **sync gating**: a kind serves reads only after its initial list
  (``is_synced``/``wait_for_sync``), so a cold cache can never report
  NotFound for objects it simply hasn't seen yet.

Stored objects are treated as immutable: ``apply``/``replace`` keep
references, readers receive references and MUST NOT mutate them (the
``CachedAPI`` copies before handing objects to callers; ``scan``-style
consumers honor the same contract the in-memory apiserver's ``scan``
documents). A bounded per-key rv history backs the conflict fast-path's
three-way rebase.

(The port's copy of ``kubeflow_rm_tpu/controlplane/cache/store.py``; its
locks come from the port's lock factory, at the level
``analysis/lockgraph.LOCK_HIERARCHY`` gives ``cache.store``. One
difference, C11: a DELETED event older than the entry it would remove
(a pod deleted, re-created and folded in by the ``CachedAPI``'s write
before the watch delivered the delete) leaves the newer incarnation in
place. JAX's ``apply`` removes it and tombstones the key at the newer
rv, so the re-created pod's own events are dropped and the cache reports
a live pod NotFound until its next change.)
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Iterable

from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    labels_of,
    matches_selector,
    name_of,
    namespace_of,
)
from kubeflow_rm_tpu_torch.analysis.lockgraph import make_condition, make_rlock

# same scope table the in-memory apiserver and the kube adapter's REST
# mapping use — a cluster-scoped object is keyed under namespace None
# no matter what namespace a caller passes
CLUSTER_SCOPED_KINDS = {
    "Namespace", "Profile", "Node", "ClusterRole", "ClusterRoleBinding",
    "PersistentVolume", "CustomResourceDefinition",
}

# rv versions retained per key for the conflict fast-path's base lookup
HISTORY_DEPTH = 4


def rv_of(obj: dict | None) -> int:
    try:
        return int((obj.get("metadata") or {}).get("resourceVersion", 0))
    except (TypeError, ValueError, AttributeError):
        return 0


class ObjectStore:
    def __init__(self, cluster_scoped: set[str] | None = None):
        self._lock = make_rlock("cache.store")
        self._cond = make_condition("cache.store", lock=self._lock)
        self._cluster_scoped = cluster_scoped or CLUSTER_SCOPED_KINDS
        # kind -> {(ns, name): obj}
        self._by_kind: dict[str, dict[tuple, dict]] = {}
        # kind -> {ns: set[key]}
        self._by_ns: dict[str, dict[str | None, set[tuple]]] = {}
        # kind -> {(label_key, label_value): set[key]}
        self._by_label: dict[str, dict[tuple[str, str], set[tuple]]] = {}
        # kind -> {owner_uid: set[key]} (controller + non-controller refs)
        self._by_owner: dict[str, dict[str, set[tuple]]] = {}
        # Events only: (involved kind, ns, involved name) -> set[key] —
        # the notebook controller asks "events for this pod/STS" every
        # reconcile, which scanned the whole Event list per call
        self._by_involved: dict[tuple, set[tuple]] = {}
        # kind -> {key: {rv: obj}} bounded base history (conflict rebase)
        self._history: dict[str, dict[tuple, "collections.OrderedDict"]] = {}
        # kind -> {key: rv} deletion tombstones guarding replace races
        self._tombstones: dict[str, dict[tuple, int]] = {}
        self._synced: set[str] = set()
        # observability: events folded in + wall time of the last one
        self.events_applied = 0
        self.last_event_t: float = 0.0

    # ---- keys --------------------------------------------------------
    def key_for(self, kind: str, name: str,
                namespace: str | None) -> tuple:
        if kind in self._cluster_scoped:
            return (None, name)
        return (namespace, name)

    def _key_of(self, obj: dict) -> tuple:
        return self.key_for(obj["kind"], name_of(obj), namespace_of(obj))

    # ---- index maintenance (callers hold the lock) -------------------
    def _index_add(self, kind: str, key: tuple, obj: dict) -> None:
        ns = key[0]
        self._by_ns.setdefault(kind, {}).setdefault(ns, set()).add(key)
        lbl = self._by_label.setdefault(kind, {})
        for pair in labels_of(obj).items():
            lbl.setdefault(pair, set()).add(key)
        own = self._by_owner.setdefault(kind, {})
        for ref in obj["metadata"].get("ownerReferences") or []:
            uid = ref.get("uid")
            if uid:
                own.setdefault(uid, set()).add(key)
        if kind == "Event":
            ikey = self._involved_key(obj)
            if ikey is not None:
                self._by_involved.setdefault(ikey, set()).add(key)

    @staticmethod
    def _involved_key(event: dict) -> tuple | None:
        inv = event.get("involvedObject") or {}
        if not inv.get("kind") or not inv.get("name"):
            return None
        return (inv["kind"], namespace_of(event), inv["name"])

    def _index_remove(self, kind: str, key: tuple, obj: dict) -> None:
        ns_idx = self._by_ns.get(kind, {})
        bucket = ns_idx.get(key[0])
        if bucket:
            bucket.discard(key)
            if not bucket:
                ns_idx.pop(key[0], None)
        lbl = self._by_label.get(kind, {})
        for pair in labels_of(obj).items():
            bucket = lbl.get(pair)
            if bucket:
                bucket.discard(key)
                if not bucket:
                    lbl.pop(pair, None)
        own = self._by_owner.get(kind, {})
        for ref in obj["metadata"].get("ownerReferences") or []:
            bucket = own.get(ref.get("uid"))
            if bucket:
                bucket.discard(key)
                if not bucket:
                    own.pop(ref.get("uid"), None)
        if kind == "Event":
            ikey = self._involved_key(obj)
            bucket = self._by_involved.get(ikey)
            if bucket:
                bucket.discard(key)
                if not bucket:
                    self._by_involved.pop(ikey, None)

    def _remember(self, kind: str, key: tuple, obj: dict) -> None:
        hist = self._history.setdefault(kind, {}).setdefault(
            key, collections.OrderedDict())
        hist[rv_of(obj)] = obj
        while len(hist) > HISTORY_DEPTH:
            hist.popitem(last=False)

    # ---- writes ------------------------------------------------------
    def apply(self, etype: str, obj: dict) -> None:
        """Fold one watch event (or a write's server response) in.
        ADDED/MODIFIED upsert rv-compared; DELETED removes and leaves a
        tombstone so a racing relist can't resurrect the object."""
        kind = obj.get("kind")
        if not kind:
            return
        key = self._key_of(obj)
        with self._lock:
            store = self._by_kind.setdefault(kind, {})
            cur = store.get(key)
            if etype == "DELETED":
                if cur is not None and rv_of(obj) < rv_of(cur):
                    # C11: a lagging delete of an older incarnation
                    # (deleted, then re-created and folded in by a
                    # write before the watch caught up): the newer
                    # one stays, and its own events are not shadowed
                    self.events_applied += 1
                    self.last_event_t = time.time()
                    return
                self._tombstones.setdefault(kind, {})[key] = max(
                    rv_of(obj), rv_of(cur))
                if cur is not None:
                    self._index_remove(kind, key, cur)
                    del store[key]
                self._history.get(kind, {}).pop(key, None)
            else:
                if cur is not None and rv_of(obj) < rv_of(cur):
                    return  # stale event behind a folded-in write
                tombs = self._tombstones.get(kind, {})
                if key in tombs:
                    if rv_of(obj) <= tombs[key]:
                        return  # stale event from before the delete
                    del tombs[key]  # object genuinely came back
                if cur is not None:
                    self._index_remove(kind, key, cur)
                store[key] = obj
                self._index_add(kind, key, obj)
                self._remember(kind, key, obj)
            self.events_applied += 1
            self.last_event_t = time.time()

    def replace(self, kind: str, objs: Iterable[dict]) -> None:
        """Relist: replace a kind's contents with a fresh snapshot and
        mark it synced. Entries newer than the snapshot's horizon (rv
        above the snapshot's max) survive — they arrived through the
        watch/write path while the list was in flight — and tombstoned
        deletions newer than their snapshot version stay deleted."""
        objs = list(objs)
        horizon = max((rv_of(o) for o in objs), default=0)
        with self._lock:
            store = self._by_kind.setdefault(kind, {})
            tombs = self._tombstones.setdefault(kind, {})
            fresh: dict[tuple, dict] = {}
            for o in objs:
                key = self._key_of(o)
                if tombs.get(key, -1) >= rv_of(o):
                    continue  # deleted after this snapshot version
                cur = store.get(key)
                fresh[key] = cur if cur is not None and \
                    rv_of(cur) > rv_of(o) else o
            # keep racing additions the snapshot predates
            for key, cur in store.items():
                if key not in fresh and rv_of(cur) > horizon:
                    fresh[key] = cur
            for key, cur in store.items():
                self._index_remove(kind, key, cur)
            store.clear()
            for key, o in fresh.items():
                store[key] = o
                self._index_add(kind, key, o)
                self._remember(kind, key, o)
            # tombstones at/below the horizon can never matter again
            for key in [k for k, rv in tombs.items() if rv <= horizon]:
                del tombs[key]
            self._synced.add(kind)
            self._cond.notify_all()

    def discard(self, kind: str, name: str,
                namespace: str | None) -> None:
        """Optimistic local removal after a DELETE verb (no rv known):
        tombstoned at the current entry's rv so only a strictly newer
        snapshot/event can bring the object back (finalizer-bearing
        objects do return, via their MODIFIED watch event)."""
        key = self.key_for(kind, name, namespace)
        with self._lock:
            store = self._by_kind.get(kind, {})
            cur = store.get(key)
            if cur is not None:
                self._tombstones.setdefault(kind, {})[key] = rv_of(cur)
                self._index_remove(kind, key, cur)
                del store[key]
            self._history.get(kind, {}).pop(key, None)

    # ---- sync gating -------------------------------------------------
    def is_synced(self, kind: str) -> bool:
        with self._lock:
            return kind in self._synced

    def synced_kinds(self) -> set[str]:
        with self._lock:
            return set(self._synced)

    def mark_synced(self, kind: str) -> None:
        with self._lock:
            self._synced.add(kind)
            self._cond.notify_all()

    def unsync(self, kind: str) -> None:
        """Stop serving a kind (its watch died past recovery); reads
        fall through to the server until the next relist."""
        with self._lock:
            self._synced.discard(kind)

    def wait_for_sync(self, kinds: Iterable[str],
                      timeout: float | None = None) -> bool:
        """Block until every kind has completed its initial list.
        Returns False on timeout — callers decide whether a cold cache
        is fatal (a serving loop) or fine (reads fall through)."""
        kinds = set(kinds)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while not kinds <= self._synced:
                remaining = None if deadline is None else \
                    deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cond.wait(remaining)
            return True

    # ---- reads (references — callers must not mutate) ----------------
    def get_ref(self, kind: str, name: str,
                namespace: str | None = None) -> dict | None:
        key = self.key_for(kind, name, namespace)
        with self._lock:
            return self._by_kind.get(kind, {}).get(key)

    def base_ref(self, kind: str, name: str, namespace: str | None,
                 rv: int) -> dict | None:
        """The retained historical version at exactly ``rv`` (conflict
        fast-path three-way base), or None if it aged out."""
        key = self.key_for(kind, name, namespace)
        with self._lock:
            return self._history.get(kind, {}).get(key, {}).get(rv)

    def list_refs(self, kind: str, namespace: str | None = None,
                  label_selector: dict | None = None) -> list[dict]:
        with self._lock:
            store = self._by_kind.get(kind, {})
            if namespace is not None:
                keys = set(self._by_ns.get(kind, {}).get(namespace, ()))
            else:
                keys = None  # whole kind
            if label_selector:
                pairs = (label_selector.get("matchLabels")
                         if "matchLabels" in label_selector
                         or "matchExpressions" in label_selector
                         else label_selector) or {}
                # narrow through the label index on one required pair;
                # the full selector (expressions included) still runs
                for pair in pairs.items():
                    hits = set(self._by_label.get(kind, {}).get(pair, ()))
                    keys = hits if keys is None else keys & hits
                    break
            objs = (store.values() if keys is None
                    else [store[k] for k in keys if k in store])
            if label_selector:
                objs = [o for o in objs
                        if matches_selector(labels_of(o), label_selector)]
            else:
                objs = list(objs)
        objs.sort(key=lambda o: (namespace_of(o) or "", name_of(o)))
        return objs

    def events_for_ref(self, involved_kind: str, involved_name: str,
                       namespace: str | None) -> list[dict]:
        """Events whose involvedObject matches, via the involved-object
        index — O(matches), not O(events in namespace). Returns store
        references; callers must not mutate."""
        with self._lock:
            store = self._by_kind.get("Event", {})
            keys = self._by_involved.get(
                (involved_kind, namespace, involved_name), ())
            out = [store[k] for k in keys if k in store]
        out.sort(key=lambda o: (namespace_of(o) or "", name_of(o)))
        return out

    def owned_by(self, owner_uid: str,
                 kind: str | None = None) -> list[dict]:
        """Dependents carrying an ownerReference to ``owner_uid`` —
        the owner-UID index behind watch-map fanout and GC-style
        queries, without an O(store) scan."""
        with self._lock:
            kinds = [kind] if kind else list(self._by_owner)
            out = []
            for k in kinds:
                store = self._by_kind.get(k, {})
                for key in self._by_owner.get(k, {}).get(owner_uid, ()):
                    if key in store:
                        out.append(store[key])
        out.sort(key=lambda o: (o["kind"], namespace_of(o) or "",
                                name_of(o)))
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                "kinds": len(self._by_kind),
                "objects": sum(len(s) for s in self._by_kind.values()),
                "synced_kinds": len(self._synced),
                "events_applied": self.events_applied,
                "last_event_t": self.last_event_t,
            }
