"""Rate-limited work queue: the Manager's dispatch substrate.

Mirrors client-go's workqueue semantics, which the reference's
controllers inherit through controller-runtime:

- **dedup on add**: an item queued twice before it is handed out is
  reconciled once (level-triggered — the queue stores *keys*, not
  events).
- **processing/dirty**: an item re-added while a worker holds it is
  not handed out again (one reconcile per key at a time); it is
  re-queued when the worker finishes, so no event is lost.
- **rate-limited requeue**: failed items come back with per-item
  exponential backoff plus jitter; conflicts (expected under cached
  reads) get their own, tighter backoff curve and a separate, larger
  budget — mirroring the Manager's historical dual retry counters.
- **terminal path**: an item that exhausts its budget is dropped and
  reported through ``on_terminal`` instead of spinning forever.
- **per-queue concurrency cap**: ``max_concurrent`` bounds how many
  items of one queue may be processing at once
  (MaxConcurrentReconciles).

Time is injected (``clock`` returning float seconds) so backoff is
deterministic under the apiserver's frozen test clocks; the Manager's
``run_until_idle`` drains with ``ignore_backoff=True`` so deterministic
tests keep their immediate-retry semantics while the serving loop
(``run_forever``) honors real backoff.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Hashable

from kubeflow_rm_tpu_torch.controlplane import metrics
from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock


class ExponentialBackoff:
    """Per-item exponential backoff with multiplicative jitter."""

    def __init__(self, base_delay_s: float = 0.005,
                 max_delay_s: float = 2.0, jitter: float = 0.25,
                 rng: random.Random | None = None):
        self.base_delay_s = base_delay_s
        self.max_delay_s = max_delay_s
        self.jitter = jitter
        self._rng = rng or random.Random()
        self._failures: dict[Hashable, int] = {}

    def failures(self, item: Hashable) -> int:
        return self._failures.get(item, 0)

    def next_delay(self, item: Hashable) -> float:
        """Record one more failure for ``item`` and return the delay
        before its next attempt."""
        n = self._failures.get(item, 0)
        self._failures[item] = n + 1
        delay = min(self.base_delay_s * (2 ** n), self.max_delay_s)
        if self.jitter:
            # jitter spreads a burst of same-cause failures (e.g. one
            # apiserver hiccup failing every in-flight reconcile) so
            # the retries don't land as a second synchronized burst
            delay *= 1.0 + self.jitter * self._rng.random()
        return delay

    def forget(self, item: Hashable) -> None:
        self._failures.pop(item, None)


class WorkQueue:
    """Deduplicating, delaying, rate-limited queue of hashable items."""

    def __init__(self, name: str = "", *,
                 clock: Callable[[], float] = time.monotonic,
                 backoff: ExponentialBackoff | None = None,
                 conflict_backoff: ExponentialBackoff | None = None,
                 max_retries: int = 5, max_conflict_retries: int = 40,
                 max_concurrent: int | None = None,
                 on_terminal: Callable[[Hashable], None] | None = None):
        self.name = name
        self._clock = clock
        self.backoff = backoff or ExponentialBackoff()
        # conflicts resolve as soon as the informer cache catches up
        # (milliseconds) — back off hard enough to stop the hot loop,
        # short enough not to add visible provision latency
        self.conflict_backoff = conflict_backoff or ExponentialBackoff(
            base_delay_s=0.002, max_delay_s=0.1)
        self.max_retries = max_retries
        self.max_conflict_retries = max_conflict_retries
        self.max_concurrent = max_concurrent
        self.on_terminal = on_terminal
        self._lock = make_lock("workqueue")
        self._pending: dict[Hashable, float] = {}  # item -> enqueue time
        self._processing: set[Hashable] = set()
        self._dirty: set[Hashable] = set()
        # (due_time, from_backoff, item); from_backoff entries may be
        # promoted early by a deterministic drain
        self._delayed: list[tuple[float, bool, Hashable]] = []
        # namespaces with a live workqueue_namespace_depth series —
        # a namespace that drains must be zeroed, not just dropped
        self._ns_exported: set[str] = set()

    # ---- adds --------------------------------------------------------
    def add(self, item: Hashable) -> None:
        with self._lock:
            self._add_locked(item)

    def _add_locked(self, item: Hashable) -> None:
        metrics.WORKQUEUE_ADDS_TOTAL.labels(name=self.name).inc()
        if item in self._processing:
            self._dirty.add(item)
            return
        if item in self._pending:
            return
        self._pending[item] = self._clock()
        self._set_depth()

    def add_after(self, item: Hashable, delay_s: float) -> None:
        """Schedule ``item`` for ``delay_s`` from now (requeue_after).
        These delays are part of controller semantics (the culler's
        period) and are never promoted early."""
        if delay_s <= 0:
            self.add(item)
            return
        with self._lock:
            self._delayed.append((self._clock() + delay_s, False, item))

    def add_rate_limited(self, item: Hashable, *,
                         conflict: bool = False) -> bool:
        """Requeue a failed item with backoff. Returns False when the
        retry budget is exhausted: the item is dropped, its counters
        reset, and ``on_terminal`` fires."""
        exhausted = False
        with self._lock:
            limiter = self.conflict_backoff if conflict else self.backoff
            cap = (self.max_conflict_retries if conflict
                   else self.max_retries)
            if limiter.failures(item) + 1 > cap:
                exhausted = True
                self.backoff.forget(item)
                self.conflict_backoff.forget(item)
                metrics.WORKQUEUE_RETRIES_EXHAUSTED_TOTAL.labels(
                    name=self.name).inc()
            else:
                delay = limiter.next_delay(item)
                metrics.WORKQUEUE_REQUEUES_TOTAL.labels(
                    name=self.name).inc()
                self._delayed.append((self._clock() + delay, True, item))
        if exhausted and self.on_terminal is not None:
            self.on_terminal(item)
        return not exhausted

    def forget(self, item: Hashable) -> None:
        """Reset the item's failure counters (call on success)."""
        with self._lock:
            self.backoff.forget(item)
            self.conflict_backoff.forget(item)

    # ---- hand-out ----------------------------------------------------
    def pop_ready(self, *, limit: int | None = None,
                  ignore_backoff: bool = False) -> list:
        """Promote due delayed items and hand out pending ones, marking
        them processing. ``ignore_backoff`` promotes backoff requeues
        regardless of their due time (deterministic drains)."""
        with self._lock:
            now = self._clock()
            if self._delayed:
                keep = []
                for due, from_backoff, item in self._delayed:
                    if due <= now or (ignore_backoff and from_backoff):
                        self._add_locked(item)
                    else:
                        keep.append((due, from_backoff, item))
                self._delayed = keep
            if self.max_concurrent is not None:
                slots = max(0, self.max_concurrent
                            - len(self._processing))
                limit = slots if limit is None else min(limit, slots)
            items = sorted(self._pending)
            if limit is not None:
                items = items[:limit]
            for item in items:
                queued_at = self._pending.pop(item)
                self._processing.add(item)
                metrics.WORKQUEUE_QUEUE_SECONDS.labels(
                    name=self.name).observe(max(0.0, now - queued_at))
            self._set_depth()
            return items

    def done(self, item: Hashable) -> bool:
        """Finish processing ``item``. Returns True when it was re-added
        mid-flight (dirty) and is pending again."""
        with self._lock:
            self._processing.discard(item)
            if item in self._dirty:
                self._dirty.discard(item)
                if item not in self._pending:
                    self._pending[item] = self._clock()
                    self._set_depth()
                return True
            return False

    # ---- introspection -----------------------------------------------
    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def next_due(self) -> float | None:
        """Earliest due time among delayed items, or None."""
        with self._lock:
            if not self._delayed:
                return None
            return min(due for due, _, _ in self._delayed)

    def snapshot(self) -> list:
        with self._lock:
            return sorted(self._pending)

    def _set_depth(self) -> None:
        metrics.WORKQUEUE_DEPTH.labels(name=self.name).set(
            len(self._pending))
        # per-namespace breakdown: the shard autoscaler's carve-off
        # needs to see WHICH namespace a deep queue belongs to, not
        # just that the queue is deep
        by_ns: dict[str, int] = {}
        for item in self._pending:
            ns = getattr(item, "namespace", None)
            if ns:
                by_ns[ns] = by_ns.get(ns, 0) + 1
        for ns in self._ns_exported - set(by_ns):
            metrics.WORKQUEUE_NAMESPACE_DEPTH.labels(
                name=self.name, namespace=ns).set(0)
        for ns, n in by_ns.items():
            metrics.WORKQUEUE_NAMESPACE_DEPTH.labels(
                name=self.name, namespace=ns).set(n)
        self._ns_exported = set(by_ns)
