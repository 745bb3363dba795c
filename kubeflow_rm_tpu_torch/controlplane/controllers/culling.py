"""Idle culling: probe kernel activity, stop idle slices whole.

Mirrors the reference culler
(``notebook-controller/pkg/culler/culler.go`` +
``controllers/culling_controller.go:85-169``): each check period, probe
the notebook's Jupyter server for ``/api/kernels`` and
``/api/terminals`` activity, maintain the
``notebooks.kubeflow.org/last-activity`` annotation (newest activity
wins — ``culler.go:242-262``), and set the stop annotation once idle
longer than CULL_IDLE_TIME (``NotebookNeedsCulling`` ``:404-419``).

Slice-aware by construction: activity is only observable on worker 0
(JupyterLab runs there; peers run the worker agent), but the stop
annotation drives the StatefulSet to zero replicas, so one idle
notebook releases ALL hosts of the slice at once — idleness on a
v5p-128 costs 16 hosts. Like the reference (ENABLE_CULLING,
``main.go:111-123``), culling is opt-in: pass
``enable_culling=True`` to ``make_control_plane``.

The probe is injected (``probe_fn(notebook, pod0) -> {"kernels": [...],
"terminals": [...]} | None``) so tests — and deployments with
nonstandard servers — control it; the default implementation does the
same HTTP GET against the worker-0 service DNS the reference does
(``culler.go:155-180``).

(The port's copy of ``kubeflow_rm_tpu/controlplane/controllers/culling.py``,
verbatim; the logger is ``kubeflow_rm_tpu_torch.culling``.)
"""

from __future__ import annotations

import datetime
from typing import Callable

from kubeflow_rm_tpu_torch.controlplane import metrics
from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    annotations_of,
    deep_get,
    set_annotation,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer, NotFound
from kubeflow_rm_tpu_torch.controlplane.runtime import Controller, Request

DEFAULT_CULL_IDLE_TIME_MIN = 1440.0   # culler.go:26
DEFAULT_CHECK_PERIOD_MIN = 1.0        # culler.go:27


import logging

log = logging.getLogger("kubeflow_rm_tpu_torch.culling")


def default_probe(notebook: dict, pod0: dict | None,
                  base_url: str | None = None):
    """HTTP probe of worker 0's Jupyter REST API (culler.go:155-180).

    ``base_url`` overrides the in-cluster service DNS (tests, port
    forwards). Per-endpoint failures are logged with their reason — an
    auth-broken or misconfigured probe must be debuggable from the
    controller log, not silently identical to an idle server
    (culler.go:155-221 logs per-endpoint warnings the same way)."""
    import json
    import urllib.request

    ns = notebook["metadata"]["namespace"]
    name = notebook["metadata"]["name"]
    url = base_url or (
        f"http://{name}.{ns}.svc.cluster.local/notebook/{ns}/{name}/api")
    # per-endpoint failure handling: a server with terminals disabled
    # 404s /api/terminals but still reports busy kernels — discarding
    # the kernel answer would cull an actively-used notebook
    out = {}
    for kind in ("kernels", "terminals"):
        try:
            with urllib.request.urlopen(f"{url}/{kind}", timeout=5) as r:
                out[kind] = json.load(r)
        except Exception as e:
            log.warning("probe %s/%s: GET %s/%s failed: %r",
                        ns, name, url, kind, e)
    return out or None  # both unreachable: no activity info this period


class CullingController(Controller):
    kind = nb_api.KIND

    def __init__(self,
                 cull_idle_minutes: float = DEFAULT_CULL_IDLE_TIME_MIN,
                 check_period_minutes: float = DEFAULT_CHECK_PERIOD_MIN,
                 probe_fn: Callable | None = None):
        self.cull_idle = datetime.timedelta(minutes=cull_idle_minutes)
        self.check_period = datetime.timedelta(minutes=check_period_minutes)
        self.probe_fn = probe_fn or default_probe

    def reconcile(self, api: APIServer, req: Request):
        try:
            notebook = api.get(nb_api.KIND, req.name, req.namespace)
        except NotFound:
            return None
        ann = annotations_of(notebook)
        if nb_api.STOP_ANNOTATION in ann:
            return None  # already stopped: nothing to cull
        if ann.get(nb_api.CULLING_EXCLUDE_ANNOTATION) == "true":
            return None
        if nb_api.SUSPEND_ANNOTATION in ann:
            return None  # suspended: chips already released, nothing to cull
        if nb_api.is_pinned(notebook):
            return None  # pinned: holds its slice for the notebook's lifetime
        requeue = self.check_period.total_seconds()

        pod0 = api.try_get("Pod", f"{req.name}-0", req.namespace)
        if pod0 is None or deep_get(pod0, "status", "phase") != "Running":
            # not running: nothing to probe, nothing to cull
            # (culling_controller.go:103-128 skips pod-absent notebooks)
            return requeue
        activity = self.probe_fn(notebook, pod0)
        now = api.clock()
        if activity is None:
            # a running pod whose probe is entirely unreachable is a
            # misconfiguration signal (auth proxy, NetworkPolicy), not
            # just an idle server — surface it once per incarnation
            already = any(e.get("reason") == "CullingProbeFailed"
                          for e in api.events_for(notebook))
            if not already:
                api.record_event(
                    notebook, "Warning", "CullingProbeFailed",
                    "worker-0 activity probe unreachable; idleness is "
                    "being measured from the last known activity only")

        # activity cannot predate the current incarnation: a restarted
        # slice starts its idle clock at worker-0's start time, so a
        # stale last-activity from before a cull can't re-cull instantly
        started = deep_get(pod0, "status", "containerStatuses", 0, "state",
                           "running", "startedAt")

        if activity is not None:
            last = self._newest_activity(activity, now)
            if last is not None:
                current = ann.get(nb_api.LAST_ACTIVITY_ANNOTATION)
                if current is None or last.isoformat() > current:
                    set_annotation(notebook, nb_api.LAST_ACTIVITY_ANNOTATION,
                                   last.isoformat())
                    notebook = api.update(notebook)
                    ann = annotations_of(notebook)

        last_str = ann.get(nb_api.LAST_ACTIVITY_ANNOTATION)
        if last_str is None:
            # no recorded activity yet: start the idle clock now
            set_annotation(notebook, nb_api.LAST_ACTIVITY_ANNOTATION,
                           now.isoformat())
            api.update(notebook)
            return requeue

        last_activity = datetime.datetime.fromisoformat(last_str)
        if started:
            start_t = datetime.datetime.fromisoformat(
                started.replace("Z", "+00:00"))
            if start_t > last_activity:
                last_activity = start_t
        if now - last_activity >= self.cull_idle:
            set_annotation(notebook, nb_api.STOP_ANNOTATION, now.isoformat())
            api.update(notebook)
            api.record_event(
                notebook, "Normal", "Culling",
                f"idle since {last_str}; stopping the slice "
                f"(threshold {self.cull_idle})")
            metrics.NOTEBOOK_CULL_TOTAL.inc()
            return None
        return requeue

    def _newest_activity(self, activity: dict, now: datetime.datetime):
        """Newest last_activity across kernels+terminals; a busy kernel
        counts as activity *now* (culler.go:223-262)."""
        newest = None
        for kind in ("kernels", "terminals"):
            for item in activity.get(kind) or []:
                if item.get("execution_state") == "busy":
                    return now
                ts = item.get("last_activity")
                if ts:
                    t = datetime.datetime.fromisoformat(
                        ts.replace("Z", "+00:00"))
                    if newest is None or t > newest:
                        newest = t
        return newest
