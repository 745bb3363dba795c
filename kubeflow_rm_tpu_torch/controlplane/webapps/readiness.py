"""Push-based readiness hub for the web apps (the port's copy of
``kubeflow_rm_tpu/controlplane/webapps/readiness.py``).

The conformance client (and the SPA) used to discover ``slice Ready``
by polling the notebook status on a fixed 50ms tick — so observed
readiness was quantized to the poll interval and every waiting client
cost a status GET per tick. The hub inverts that: it subscribes ONCE
to the backend's watch stream (``add_watcher`` on the in-memory
apiserver's async fanout, or the kube adapter's watch threads) and
wakes blocked readiness long-polls the moment a Notebook event lands.

Wakeups are edge-triggered on a PER-KEY sequence number, kube
wait.Until-style: the waiter snapshots its key's sequence *before*
reading the object (no lost-wakeup window), re-checks its predicate
on every bump, and falls back to a coarse 1s guard tick so a wedged
watch degrades to slow rather than hung. Keying the condition by
``(namespace, name)`` keeps a 20-way storm from thundering-herd
waking every parked long-poll on every sibling's event — only the
event's own waiters (and, on a TOO_OLD overflow, everyone) pay a
wakeup.

``_on_event`` does O(1) work under per-key locks — a slow or
disconnected long-poll client can never back-pressure the apiserver's
write path (the async fanout channel absorbs it; see
``tests/test_watch_fanout.py``).
"""

from __future__ import annotations

import time
from typing import Callable

from kubeflow_rm_tpu_torch.analysis.lockgraph import (
    make_condition, make_lock,
)
from kubeflow_rm_tpu_torch.controlplane import metrics, tracing

# a wedged watch degrades to this guard tick instead of hanging waiters
_GUARD_TICK_S = 1.0


class _KeyState:
    """One waited-on notebook: its condition, edge counter, and the
    perf_counter() of its last event (feeds the wake-to-observe
    histogram: hub-arrival -> waiter-observation)."""

    __slots__ = ("cond", "seq", "event_t", "waiters")

    def __init__(self) -> None:
        self.cond = make_condition("readiness.key")
        self.seq = 0
        self.event_t: float | None = None
        self.waiters = 0


class ReadinessHub:
    """Fan-in point between the watch stream and readiness long-polls."""

    def __init__(self, api) -> None:
        self._lock = make_lock("readiness.registry")  # key registry
        self._keys: dict[tuple[str, str], _KeyState] = {}
        backend = getattr(api, "api", api)
        backend.add_watcher(self._on_event, name="readiness-hub")

    def _state(self, key: tuple[str, str]) -> _KeyState | None:
        with self._lock:
            return self._keys.get(key)

    def _register(self, key: tuple[str, str]) -> _KeyState:
        # waiter-count changes happen under the registry lock so a new
        # waiter can never receive a state a leaving waiter is retiring
        with self._lock:
            st = self._keys.get(key)
            if st is None:
                st = self._keys[key] = _KeyState()
            with st.cond:
                st.waiters += 1
            return st

    def _deregister(self, key: tuple[str, str], st: _KeyState) -> None:
        with self._lock:
            with st.cond:
                st.waiters -= 1
                if st.waiters == 0 and self._keys.get(key) is st:
                    del self._keys[key]

    # -- watch side ----------------------------------------------------
    def _on_event(self, etype: str, obj: dict, old=None) -> None:
        if etype == "TOO_OLD":
            # overflow sentinel: state unknown — wake every waiter so
            # each re-fetches and re-evaluates its predicate
            with self._lock:
                states = list(self._keys.values())
            for st in states:
                with st.cond:
                    st.seq += 1
                    st.cond.notify_all()
            return
        if obj.get("kind") != "Notebook":
            return
        md = obj.get("metadata") or {}
        key = (md.get("namespace") or "", md.get("name") or "")
        st = self._state(key)
        if st is None:
            return  # nobody is waiting on this notebook
        now = time.perf_counter()
        with st.cond:
            st.seq += 1
            # DELETED still stamps: waiters observing the delete get a
            # wake-to-observe sample like any other edge
            st.event_t = now
            st.cond.notify_all()

    # -- waiter side ---------------------------------------------------
    def wait(self, namespace: str, name: str, timeout_s: float,
             fetch: Callable[[], dict | None],
             satisfied: Callable[[dict | None], bool]):
        """Block until ``satisfied(fetch())`` or ``timeout_s`` elapses.

        Returns ``(obj, changed)`` where ``obj`` is the last fetched
        state and ``changed`` says whether the predicate was met.
        """
        # the readiness wake is the LAST hop of a provision trace: the
        # span covers park -> watch-event wake -> predicate satisfied,
        # so critical-path attribution separates "waiting on the
        # controller" from handler overhead
        with tracing.start_span_if_active(
                "readiness.wait",
                attrs={"namespace": namespace, "name": name}) as sp:
            obj, changed = self._wait_inner(namespace, name, timeout_s,
                                            fetch, satisfied)
            sp.set_attr("satisfied", changed)
            return obj, changed

    def _wait_inner(self, namespace: str, name: str, timeout_s: float,
                    fetch: Callable[[], dict | None],
                    satisfied: Callable[[dict | None], bool]):
        deadline = time.monotonic() + max(0.0, timeout_s)
        key = (namespace, name)
        t_start = time.perf_counter()
        waited = False
        st = self._register(key)
        metrics.READINESS_WAITERS.inc()
        try:
            while True:
                # snapshot the sequence BEFORE fetching: an event that
                # lands during the fetch bumps it and skips the wait
                with st.cond:
                    seq = st.seq
                obj = fetch()
                if satisfied(obj):
                    if waited:
                        with st.cond:
                            evt = st.event_t
                        if evt is not None and evt >= t_start:
                            metrics.READINESS_WAKE_TO_OBSERVE_SECONDS \
                                .observe(max(0.0,
                                             time.perf_counter() - evt))
                    return obj, True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return obj, False
                with st.cond:
                    if st.seq == seq:
                        st.cond.wait(min(remaining, _GUARD_TICK_S))
                waited = True
        finally:
            metrics.READINESS_WAITERS.dec()
            self._deregister(key, st)
