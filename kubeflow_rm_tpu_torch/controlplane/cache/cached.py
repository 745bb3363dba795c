"""``CachedAPI`` — controller-runtime's cached client for this repo.

Drop-in for the ``APIServer`` verb surface: reads (``get``/``try_get``/
``list``/``scan``/``events_for``) are served from the shared informer's
store once the kind has synced, writes go to the backing server with
the response folded straight back into the store (read-your-writes).
Two write-path optimizations ride on the cache:

- **no-op suppression**: ``update``/``update_status``/``patch`` deep-
  compare the desired object against the cached current one after
  normalization (volatile metadata — resourceVersion, generation,
  managedFields, creationTimestamp, uid, selfLink — stripped), and a
  semantically identical write returns the current object without
  touching the server. A steady-state reconcile of an unchanged object
  therefore issues zero write verbs.
- **conflict fast-path**: a Conflict normally costs GET + retry. Here
  the cache already holds the latest version AND the version the caller
  based its write on (bounded rv history), so the adapter does a
  three-way rebase in memory: if the caller's changes and the
  concurrent writer's changes touch disjoint paths, the caller's diff
  is replayed onto the latest object and retried once — no extra GET,
  and never a blind rv refresh (which would stomp the concurrent
  write).

Unknown attributes delegate to the backend, so backend-specific surface
(``watch_kind``, ``write_log``, ``set_writer``, ``limiter``, …) stays
reachable through the wrapper.

(The port's copy of ``kubeflow_rm_tpu/controlplane/cache/cached.py``,
verbatim.)
"""

from __future__ import annotations

import logging

from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    fast_deepcopy,
    name_of,
    namespace_of,
    strategic_merge,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import Conflict, NotFound
from kubeflow_rm_tpu_torch.controlplane.cache.informer import SharedInformer
from kubeflow_rm_tpu_torch.controlplane.cache.store import rv_of

log = logging.getLogger("kubeflow_rm_tpu_torch.cache")

# server-owned metadata that never makes a write semantically different
_VOLATILE_META = ("resourceVersion", "generation", "managedFields",
                  "creationTimestamp", "uid", "selfLink")

_DELETE = object()  # tombstone value in a leaf diff: "key removed"


def normalized(obj: dict) -> dict:
    """A copy with server-owned volatile metadata stripped — the shape
    no-op detection and the three-way diff compare on."""
    out = fast_deepcopy(obj)
    meta = out.get("metadata")
    if isinstance(meta, dict):
        for k in _VOLATILE_META:
            meta.pop(k, None)
    return out


def leaf_diff(base, new, prefix=()) -> dict:
    """Leaf-level changes turning ``base`` into ``new`` as
    ``{path_tuple: new_value | _DELETE}``. Dicts recurse; anything else
    (lists included) is one leaf — list surgery is not safely
    rebasable, so a changed list is one opaque change."""
    ops: dict = {}
    if isinstance(base, dict) and isinstance(new, dict):
        for k in set(base) | set(new):
            if k not in new:
                ops[prefix + (k,)] = _DELETE
            elif k not in base:
                ops[prefix + (k,)] = new[k]
            else:
                ops.update(leaf_diff(base[k], new[k], prefix + (k,)))
    elif base != new:
        ops[prefix] = new
    return ops


def _paths_clash(ours, theirs) -> bool:
    """True when any path pair overlaps (equal, or one a prefix of the
    other) — then the two writes touched the same region and a rebase
    would silently pick a winner."""
    for p in ours:
        for q in theirs:
            n = min(len(p), len(q))
            if p[:n] == q[:n]:
                return True
    return False


class CachedAPI:
    def __init__(self, api, informer: SharedInformer | None = None):
        self.api = api
        self.informer = informer or SharedInformer(api)
        self.store = self.informer.store
        from kubeflow_rm_tpu_torch.controlplane import metrics
        # pre-bound label children: the read path runs per reconcile
        self._m_hit = {v: metrics.CACHE_READS_TOTAL.labels(
            verb=v, result="hit") for v in ("get", "list", "scan")}
        self._m_miss = {v: metrics.CACHE_READS_TOTAL.labels(
            verb=v, result="miss") for v in ("get", "list", "scan")}
        self._m_suppressed = {
            v: metrics.CACHE_SUPPRESSED_WRITES_TOTAL.labels(verb=v)
            for v in ("update", "update_status", "patch")}
        self._m_fastpath = {
            r: metrics.CACHE_CONFLICT_FASTPATH_TOTAL.labels(result=r)
            for r in ("noop", "rebased", "fallthrough")}

    # ---- plumbing ----------------------------------------------------
    def __getattr__(self, name):
        return getattr(self.api, name)

    def _serves(self, kind: str) -> bool:
        return self.informer.ensure_synced(kind)

    def wait_for_sync(self, kinds, timeout: float | None = None) -> bool:
        return self.informer.wait_for_sync(kinds, timeout)

    # ---- reads -------------------------------------------------------
    def get(self, kind: str, name: str,
            namespace: str | None = None) -> dict:
        if self._serves(kind):
            self._m_hit["get"].inc()
            obj = self.store.get_ref(kind, name, namespace)
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            return fast_deepcopy(obj)
        self._m_miss["get"].inc()
        return self.api.get(kind, name, namespace)

    def try_get(self, kind: str, name: str,
                namespace: str | None = None) -> dict | None:
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def list(self, kind: str, namespace: str | None = None,
             label_selector: dict | None = None) -> list[dict]:
        if self._serves(kind):
            self._m_hit["list"].inc()
            return [fast_deepcopy(o) for o in
                    self.store.list_refs(kind, namespace, label_selector)]
        self._m_miss["list"].inc()
        return self.api.list(kind, namespace, label_selector)

    def scan(self, kind: str, namespace: str | None = None) -> list[dict]:
        """READ-ONLY ``list``: store references, no copies — same
        contract as the in-memory apiserver's ``scan`` (callers must
        not mutate; write through ``update`` on a ``get()`` copy)."""
        if self._serves(kind):
            self._m_hit["scan"].inc()
            return self.store.list_refs(kind, namespace)
        self._m_miss["scan"].inc()
        return getattr(self.api, "scan", self.api.list)(kind, namespace)

    def events_for(self, involved: dict) -> list[dict]:
        if self._serves("Event"):
            # involved-object index: O(matches) per lookup where the
            # namespace filter was O(events) — the notebook controller
            # calls this per pod per reconcile (the re-emit storm)
            return [
                fast_deepcopy(e)
                for e in self.store.events_for_ref(
                    involved["kind"], name_of(involved),
                    namespace_of(involved))
            ]
        return self.api.events_for(involved)

    def ensure_namespace(self, namespace: str) -> dict:
        if self._serves("Namespace"):
            cur = self.store.get_ref("Namespace", namespace, None)
            if cur is not None:
                return fast_deepcopy(cur)
        out = self.api.ensure_namespace(namespace)
        self._fold("ADDED", out)
        return out

    # ---- writes ------------------------------------------------------
    def _fold(self, etype: str, obj: dict) -> None:
        """Read-your-writes: the server's response (fresh rv) lands in
        the store before the verb returns. A copy goes in — the caller
        keeps the returned object and may mutate it. rv-compared, so a
        concurrently-delivered watch event can't roll it back (nor the
        fold roll back anything newer)."""
        self.store.apply(etype, fast_deepcopy(obj))

    def create(self, obj: dict) -> dict:
        out = self.api.create(obj)
        self._fold("ADDED", out)
        return out

    def create_many(self, objs: list[dict]) -> list[dict]:
        """Bulk create through the backend's batch verb (one lock/HTTP
        round trip), folding each created object into the store;
        per-item Status failures pass through untouched. Backends
        without the verb fall back to per-object creates."""
        from kubeflow_rm_tpu_torch.controlplane.apiserver import (
            APIError,
            is_status,
            status_from_error,
        )
        creator = getattr(self.api, "create_many", None)
        if creator is None:
            out = []
            for obj in objs:
                try:
                    out.append(self.create(obj))
                except APIError as e:
                    out.append(status_from_error(e))
            return out
        out = creator(objs)
        for item in out:
            if not is_status(item):
                self._fold("ADDED", item)
        return out

    def update(self, obj: dict) -> dict:
        kind = obj["kind"]
        if self._serves(kind):
            cur = self.store.get_ref(kind, name_of(obj),
                                     namespace_of(obj))
            if cur is not None and normalized(obj) == normalized(cur):
                self._m_suppressed["update"].inc()
                return fast_deepcopy(cur)
        try:
            out = self.api.update(obj)
        except Conflict:
            out = self._resolve_conflict(obj)
        self._fold("MODIFIED", out)
        return out

    def update_status(self, obj: dict) -> dict:
        kind = obj["kind"]
        if self._serves(kind):
            cur = self.store.get_ref(kind, name_of(obj),
                                     namespace_of(obj))
            if cur is not None and \
                    obj.get("status", {}) == cur.get("status", {}):
                self._m_suppressed["update_status"].inc()
                return fast_deepcopy(cur)
        out = self.api.update_status(obj)
        self._fold("MODIFIED", out)
        return out

    def patch(self, kind: str, name: str, patch: dict,
              namespace: str | None = None) -> dict:
        if self._serves(kind):
            cur = self.store.get_ref(kind, name, namespace)
            if cur is not None:
                merged = strategic_merge(fast_deepcopy(cur), patch)
                if normalized(merged) == normalized(cur):
                    self._m_suppressed["patch"].inc()
                    return fast_deepcopy(cur)
        out = self.api.patch(kind, name, patch, namespace)
        self._fold("MODIFIED", out)
        return out

    def delete(self, kind: str, name: str,
               namespace: str | None = None) -> None:
        out = self.api.delete(kind, name, namespace)
        # read-your-writes: the in-memory server's DELETED/MODIFIED
        # event arrives on the fanout thread, so reconcile the store
        # from the backend's post-delete truth before returning — gone
        # means discard, finalizer-pending means fold the
        # deletionTimestamp. (The kube adapter feeds its own shared
        # store and already discards optimistically in its delete.)
        if not self.informer._backend_fed and self._serves(kind):
            cur = self.api.try_get(kind, name, namespace)
            if cur is None:
                self.store.discard(kind, name, namespace)
            else:
                self._fold("MODIFIED", cur)
        return out

    def record_event(self, involved: dict, etype: str, reason: str,
                     message: str) -> dict:
        out = self.api.record_event(involved, etype, reason, message)
        self._fold("ADDED", out)
        return out

    # ---- conflict fast-path ------------------------------------------
    def _resolve_conflict(self, desired: dict) -> dict:
        """Resolve one Conflict without a server GET. Safe outcomes
        only: (a) the write is a semantic no-op against the latest
        cached version — return it; (b) the caller's changes (diffed
        against the exact base version it read, from the store's rv
        history) touch paths disjoint from the concurrent writer's —
        replay them onto latest and retry once. Anything else re-raises
        for the caller's own retry loop (which re-reads). A blind rv
        refresh is deliberately NOT done: it would overwrite the
        concurrent write with the caller's stale copy."""
        kind = desired["kind"]
        name, ns = name_of(desired), namespace_of(desired)
        if not self._serves(kind):
            raise
        latest = self.store.get_ref(kind, name, ns)
        if latest is None:
            raise  # deleted under us: the caller's NotFound handling wins
        if normalized(desired) == normalized(latest):
            self._m_fastpath["noop"].inc()
            return fast_deepcopy(latest)
        base = self.store.base_ref(kind, name, ns, rv_of(desired))
        if base is None:
            self._m_fastpath["fallthrough"].inc()
            raise  # base aged out of history — can't prove disjointness
        ours = leaf_diff(normalized(base), normalized(desired))
        theirs = leaf_diff(normalized(base), normalized(latest))
        if not ours:
            self._m_fastpath["noop"].inc()
            return fast_deepcopy(latest)
        if _paths_clash(ours, theirs):
            self._m_fastpath["fallthrough"].inc()
            raise  # overlapping edits: a rebase would pick a winner
        rebased = fast_deepcopy(latest)
        for path, val in ours.items():
            node = rebased
            for k in path[:-1]:
                nxt = node.get(k)
                if not isinstance(nxt, dict):
                    nxt = {}
                    node[k] = nxt
                node = nxt
            if val is _DELETE:
                node.pop(path[-1], None)
            else:
                node[path[-1]] = fast_deepcopy(val) \
                    if isinstance(val, (dict, list)) else val
        out = self.api.update(rebased)  # a second Conflict propagates
        self._m_fastpath["rebased"].inc()
        return out
