"""The oversubscription switch and the fake kubelet's three hooks into
the suspend/resume lifecycle (counterpart of the parts of
``kubeflow_rm_tpu/controlplane/suspend.py`` the spawn path calls).

Suspend/resume, priority preemption, compaction migration and active
defragmentation are not ported yet (ROADMAP slice 7d). Until they are,
the port runs JAX's ``--no-oversubscribe`` arm, pin-for-lifetime: the
switch is off and cannot be turned on, and each hook the StatefulSet
controller calls takes the early return JAX's takes with the switch
off (``try_preempt`` counts the skip and returns None). The TPUJob
controller's drain hook, ``kick_pending_pods``, has no early return in
JAX: it raises, and only a job carrying the suspend annotations reaches
it.
"""

from __future__ import annotations

import logging

from kubeflow_rm_tpu_torch.controlplane import metrics, scheduler
from kubeflow_rm_tpu_torch.controlplane.api.meta import name_of, namespace_of
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer

log = logging.getLogger("kubeflow_rm_tpu_torch.suspend")

_LATER = ("suspend/resume, preemption and compaction "
          "(controlplane/suspend.py) are not ported yet — ROADMAP slice 7d")


# ---- the oversubscription A/B switch ---------------------------------

_oversubscribe = False


def set_oversubscribe(enabled: bool) -> None:
    """Only the ``--no-oversubscribe`` arm exists in the port: turning
    the switch on raises until suspend/resume is ported."""
    global _oversubscribe
    if enabled:
        raise NotImplementedError(
            f"set_oversubscribe(True): {_LATER}; the port runs the "
            "--no-oversubscribe arm")
    _oversubscribe = False


def oversubscribe() -> bool:
    return _oversubscribe


def kick_pending_pods(api: APIServer, *, now: str) -> None:
    """Requeue the slices waiting for cards after a drain: a drain is
    part of suspend/resume, so the port's TPUJob controller reaches this
    only through a job carrying the suspend annotations."""
    raise NotImplementedError(
        f"kick_pending_pods (the whole-gang suspend of a TPUJob): {_LATER}")


# ---- fragmentation-triggered live migration (compaction) -------------

_auto_migration = False


def try_compact_migration(api: APIServer, sts: dict,
                          unbound: list[dict],
                          sched: "scheduler.SchedulerCache", *,
                          allow_virtual: bool) -> None:
    """A gang failed to bind: with the switch off nothing migrates."""
    if (not _auto_migration or not oversubscribe()
            or scheduler.legacy_scan()):
        return
    raise NotImplementedError(_LATER)


# ---- active defragmentation --------------------------------------------

_active_defrag = True


def active_defrag() -> bool:
    return _active_defrag


def maybe_active_defrag(api: APIServer,
                        sched: "scheduler.SchedulerCache", *,
                        allow_virtual: bool = False) -> bool:
    """One proactive compaction step: with the switch off, none."""
    if not _active_defrag or not oversubscribe() \
            or scheduler.legacy_scan():
        return False
    raise NotImplementedError(_LATER)


# ---- priority preemption -----------------------------------------------

def try_preempt(api: APIServer, sts: dict, unbound: list[dict],
                sched: "scheduler.SchedulerCache", *,
                allow_virtual: bool) -> dict[tuple, str] | None:
    """A gang that couldn't bind gets no second chance with the switch
    off: the skip is counted and the gang stays unschedulable."""
    if not oversubscribe() or scheduler.legacy_scan():
        _preempt_skipped(
            "oversubscribe_off" if not oversubscribe() else "legacy_scan",
            sts)
        return None
    raise NotImplementedError(_LATER)


def _preempt_skipped(reason: str, sts: dict) -> None:
    """Account for a preemption opportunity that could not be served —
    the counter (``preempt_skipped_total{reason}``) plus a log line."""
    metrics.PREEMPT_SKIPPED_TOTAL.labels(reason=reason).inc()
    log.info("preemption skipped for %s/%s: %s",
             namespace_of(sts), name_of(sts), reason)
