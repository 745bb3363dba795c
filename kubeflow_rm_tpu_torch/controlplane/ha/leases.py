"""Lease-based leader election over the APIServer verb surface (the
port's copy of ``kubeflow_rm_tpu/controlplane/ha/leases.py``).

Reimplements client-go's ``leaderelection`` package (which the
reference turns on via ``--leader-elect``,
``notebook-controller/main.go:60-93``) against this repo's apiserver
contract, so the SAME elector runs over the in-memory ``APIServer``
(tests, e2e) and the kube REST adapter (in-cluster):

- the lock is a ``coordination.k8s.io/v1`` Lease object;
- the holder renews ``spec.renewTime`` every ``retry_period_s``;
- a candidate steals only once ``renewTime + leaseDurationSeconds`` has
  passed, bumping ``leaseTransitions``;
- every write is an rv-CAS (the update carries the observed
  resourceVersion; the apiserver 409s stale writers) — the fencing
  that makes split-brain impossible even when two candidates race the
  same expired lease.

The elector is deliberately crash-oriented: leadership is *not*
released on stop by default, so failover exercises the expiry path
(standby takes over within one lease duration), matching what a
SIGKILLed manager pod would look like.
"""

from __future__ import annotations

import datetime
import logging
import threading
from typing import Callable

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock
from kubeflow_rm_tpu_torch.controlplane.apiserver import (
    AlreadyExists,
    Conflict,
    NotFound,
)

log = logging.getLogger("kubeflow_rm_tpu_torch.leaderelection")

LEASE_API_VERSION = "coordination.k8s.io/v1"
DEFAULT_LEASE_NAME = "kubeflow-rm-tpu-controller-manager"


def make_lease(name: str, namespace: str, holder: str,
               duration_s: float, now: datetime.datetime) -> dict:
    iso = now.isoformat()
    return {
        "apiVersion": LEASE_API_VERSION,
        "kind": "Lease",
        "metadata": {"name": name, "namespace": namespace},
        "spec": {
            "holderIdentity": holder,
            "leaseDurationSeconds": int(duration_s),
            "acquireTime": iso,
            "renewTime": iso,
            "leaseTransitions": 0,
        },
    }


def _parse_time(value: str | None) -> datetime.datetime | None:
    if not value:
        return None
    try:
        return datetime.datetime.fromisoformat(value)
    except ValueError:
        return None


class LeaderElector:
    """One candidate's view of the election.

    ``run(stop)`` is the blocking loop; ``is_leader`` is what the
    Manager's serving loop gates on. Callbacks in
    ``on_started_leading`` / ``on_stopped_leading`` fire on
    transitions (the Manager resyncs its queues on promotion).
    """

    def __init__(self, api, identity: str, *,
                 lease_name: str = DEFAULT_LEASE_NAME,
                 namespace: str = "kubeflow",
                 lease_duration_s: float = 15.0,
                 renew_deadline_s: float = 10.0,
                 retry_period_s: float = 2.0,
                 clock: Callable[[], datetime.datetime] | None = None,
                 release_on_exit: bool = False):
        self.api = api
        self.identity = identity
        self.lease_name = lease_name
        self.namespace = namespace
        self.lease_duration_s = lease_duration_s
        self.renew_deadline_s = renew_deadline_s
        self.retry_period_s = retry_period_s
        self.release_on_exit = release_on_exit
        self._clock = clock or getattr(api, "clock", None) or (
            lambda: datetime.datetime.now(datetime.timezone.utc))
        self._lock = make_lock("leases.elector")
        self._leader = False
        self._last_renew: datetime.datetime | None = None
        self.on_started_leading: list[Callable[[], None]] = []
        self.on_stopped_leading: list[Callable[[], None]] = []

    @property
    def is_leader(self) -> bool:
        with self._lock:
            return self._leader

    # ---- protocol ----------------------------------------------------
    def _expired(self, spec: dict, now: datetime.datetime) -> bool:
        renew = _parse_time(spec.get("renewTime")) or \
            _parse_time(spec.get("acquireTime"))
        if renew is None:
            return True
        duration = float(spec.get("leaseDurationSeconds")
                         or self.lease_duration_s)
        return renew + datetime.timedelta(seconds=duration) <= now

    def try_acquire_or_renew(self) -> bool:
        """One election round. True iff this identity holds a fresh
        lease afterwards. Returns False on a definitive loss (another
        fresh holder, or losing a CAS race); raises only on transport
        errors, which ``run`` treats as transient."""
        now = self._clock()
        lease = self.api.try_get("Lease", self.lease_name,
                                 self.namespace)
        if lease is None:
            try:
                self.api.create(make_lease(
                    self.lease_name, self.namespace, self.identity,
                    self.lease_duration_s, now))
            except (AlreadyExists, Conflict):
                return False  # lost the creation race
            except NotFound:
                # the lease namespace doesn't exist yet (fresh cluster)
                self.api.ensure_namespace(self.namespace)
                return False
            return True
        spec = lease.setdefault("spec", {})
        holder = spec.get("holderIdentity")
        if holder == self.identity:
            spec["renewTime"] = now.isoformat()
        elif not holder or self._expired(spec, now):
            # empty holder = graceful release; expired = crashed holder
            spec["holderIdentity"] = self.identity
            spec["acquireTime"] = now.isoformat()
            spec["renewTime"] = now.isoformat()
            spec["leaseDurationSeconds"] = int(self.lease_duration_s)
            spec["leaseTransitions"] = \
                int(spec.get("leaseTransitions") or 0) + 1
        else:
            return False  # someone else holds a fresh lease
        try:
            # fencing: the update carries the resourceVersion observed
            # above; any concurrent writer bumped it, so this CAS loses
            # with a Conflict instead of clobbering the new holder
            self.api.update(lease)
        except (Conflict, NotFound):
            return False
        return True

    def release(self) -> None:
        """Clear holderIdentity (graceful shutdown): the next candidate
        acquires immediately instead of waiting out the lease."""
        try:
            lease = self.api.try_get("Lease", self.lease_name,
                                     self.namespace)
            if lease is None or \
                    lease.get("spec", {}).get("holderIdentity") != \
                    self.identity:
                return
            lease["spec"]["holderIdentity"] = ""
            self.api.update(lease)
        except Exception as e:
            log.debug("lease release failed (harmless): %s", e)

    # ---- loop --------------------------------------------------------
    def run(self, stop: threading.Event) -> None:
        """Blocking election loop: candidates retry every
        ``retry_period_s``; the holder renews on the same period and
        abdicates when the lease is definitively lost, or when renewal
        has not succeeded within ``renew_deadline_s`` (apiserver
        outage)."""
        while not stop.is_set():
            err = None
            try:
                ok = self.try_acquire_or_renew()
            except Exception as e:  # transport trouble: transient
                ok, err = False, e
            now = self._clock()
            if ok:
                self._set_leader(True, now)
            elif err is None:
                self._set_leader(False, now)
            else:
                log.warning("election round for %s failed: %s",
                            self.identity, err)
                with self._lock:
                    deadline_passed = (
                        self._leader and self._last_renew is not None
                        and (now - self._last_renew).total_seconds()
                        > self.renew_deadline_s)
                if deadline_passed:
                    self._set_leader(False, now)
            stop.wait(self.retry_period_s)
        if self.release_on_exit and self.is_leader:
            self.release()
        self._set_leader(False, self._clock())

    def _set_leader(self, value: bool,
                    now: datetime.datetime) -> None:
        with self._lock:
            was = self._leader
            self._leader = value
            if value:
                self._last_renew = now
        from kubeflow_rm_tpu_torch.controlplane import metrics
        metrics.LEADER_IS_LEADER.labels(identity=self.identity).set(
            1.0 if value else 0.0)
        if value and not was:
            log.info("%s acquired leadership of %s/%s", self.identity,
                     self.namespace, self.lease_name)
            self._fire(self.on_started_leading)
        elif was and not value:
            log.info("%s lost leadership of %s/%s", self.identity,
                     self.namespace, self.lease_name)
            self._fire(self.on_stopped_leading)

    @staticmethod
    def _fire(callbacks: list[Callable[[], None]]) -> None:
        for cb in list(callbacks):
            try:
                cb()
            except Exception:
                log.exception("leadership callback failed")
