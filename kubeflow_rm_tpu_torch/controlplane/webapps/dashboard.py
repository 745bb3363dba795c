"""Central dashboard backend (the port's copy of
``kubeflow_rm_tpu/controlplane/webapps/dashboard.py``).

Behavioral mirror of the reference centraldashboard's Express server
(``centraldashboard/app/server.ts:56-91``, ``api.ts:32-99``,
``api_workgroup.ts``): the navigation shell's API — namespaces,
per-namespace activity feeds (Events), cluster metrics, dashboard
links, and the workgroup (profile registration) flow the first-login
page drives. Identity arrives as the trusted ``kubeflow-userid``
header exactly as in the reference (``attach_user_middleware.ts``).

Card differences:
- ``/api/metrics`` exposes card utilization (requested vs allocatable
  ``nvidia.com/gpu`` per node pool) under JAX's keys (``tpu``,
  ``chips_capacity``, ``chips_requested``), which the SPA reads — the
  numbers come from the same collectors the controllers maintain
  (``controlplane/metrics.py``).
- env-info reports slice inventory so the dashboard can render a
  fleet view. ``tpuSliceTypes`` lists every slice type of the
  topology table whose host shape (accelerator, cards a host) some
  node has (``api.gpu.slice_types_on``, the rule the spawner's
  ``/api/tpus`` offers by). A GPU node's labels name one host's shape,
  not the slice it belongs to (JAX's TPU host labels name the slice),
  so two 4-card hosts list ``h100-80gb-4`` beside ``h100-80gb-2x4``.

Errors are the kit's :class:`HTTPError` with werkzeug's texts; the SPA's
files are served with werkzeug's content types (``; charset=utf-8`` on
text and JavaScript).
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import deep_get
from kubeflow_rm_tpu_torch.controlplane.api.profile import (
    KIND as PROFILE_KIND, OWNER_ANNOTATION, make_profile,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer
from kubeflow_rm_tpu_torch.controlplane.webapps.core import (
    Response, WebApp, json_body,
)
from kubeflow_rm_tpu_torch.controlplane.webapps.serving import HTTPError

DEFAULT_LINKS = {
    "menuLinks": [
        {"link": "/jupyter/", "text": "Notebooks", "icon": "book"},
        {"link": "/volumes/", "text": "Volumes", "icon": "device:storage"},
        {"link": "/tensorboards/", "text": "TensorBoards",
         "icon": "assessment"},
    ],
    "externalLinks": [],
    "quickLinks": [
        {"desc": "Create a new Notebook server",
         "link": "/jupyter/new"},
    ],
    "documentationItems": [],
}

#: non-``text/*`` types werkzeug also gives a charset
_CHARSET_TYPES = {"application/ecmascript", "application/javascript",
                  "application/sql", "application/xml",
                  "application/xml-dtd",
                  "application/xml-external-parsed-entity"}


def content_type(mimetype: str) -> str:
    """werkzeug's ``get_content_type(mimetype, "utf-8")``."""
    if mimetype.startswith("text/") or mimetype in _CHARSET_TYPES \
            or mimetype.endswith("+xml"):
        return f"{mimetype}; charset=utf-8"
    return mimetype


def create_app(api: APIServer, *, disable_auth: bool = False,
               prefix: str = "", links: dict | None = None,
               metrics_backend: str | None = None,
               history_interval_s: float = 10.0,
               observer=None,
               **app_kwargs) -> WebApp:
    from kubeflow_rm_tpu_torch.controlplane.webapps.metrics_service import (
        MetricsHistory, make_metrics_service,
    )

    app = WebApp("centraldashboard", api, prefix=prefix,
                 disable_auth=disable_auth, **app_kwargs)
    links = links or DEFAULT_LINKS
    # pluggable chart data source (metrics_service_factory.ts
    # equivalent) + the ring buffer behind utilization-over-time
    metrics_svc = make_metrics_service(api, metrics_backend)
    history = MetricsHistory(metrics_svc,
                             interval_s=history_interval_s)
    app.metrics_history = history
    if observer is None:
        # TSDB + SLO engine + flight recorder over the same registry
        # the facade reads; ticked on demand from /api/alerts (no
        # thread spawned by construction — callers that want the
        # background loop call app.observer.start())
        from kubeflow_rm_tpu_torch.controlplane import obs
        observer = obs.Observer(
            shard_urls=getattr(api, "shard_urls", None))
    app.observer = observer

    # ---- api.ts surface ---------------------------------------------
    @app.route("/api/namespaces")
    def get_namespaces(req):
        return {"namespaces": [n["metadata"]["name"]
                               for n in api.list("Namespace")]}

    @app.route("/api/activities/<namespace>")
    def get_activities(req, namespace):
        evs = sorted(api.list("Event", namespace),
                     key=lambda e: e.get("lastTimestamp") or "",
                     reverse=True)
        # "activities" is what the SPA (and the reference's api.ts
        # naming) reads; "events" kept for existing consumers
        return {"events": evs, "activities": evs}

    @app.route("/api/dashboard-links")
    def get_links(req):
        return dict(links)

    @app.route("/api/metrics")
    def get_metrics(req):
        """Card fleet utilization: the dashboard's resource numbers
        (reference queries Prometheus/Stackdriver behind a factory —
        ``metrics_service_factory.ts``; the backend here is pluggable
        the same way, defaulting to live inventory).

        ``?profile=cpu`` (opt-in, gated on KFRM_ENABLE_PROFILING=1)
        wraps the snapshot in cProfile and returns the stats table —
        the pprof-style "why is this scrape slow" hook."""
        if req.args.get("profile") == "cpu":
            import os
            if os.environ.get("KFRM_ENABLE_PROFILING") != "1":
                raise HTTPError(
                    403,
                    "profiling is disabled; set KFRM_ENABLE_PROFILING=1")
            from kubeflow_rm_tpu_torch.utils import profiling
            with profiling.profile_wsgi() as table:
                snap = metrics_svc.snapshot()
            return {"snapshot": snap, "profile": table.getvalue()}
        return metrics_svc.snapshot()

    @app.route("/api/metrics/history")
    def get_metrics_history(req):
        """Utilization over time for the dashboard charts (the
        reference's ``resource-chart.js`` interval queries; here a
        ring of snapshots sampled in-process)."""
        return {"interval_s": history.interval_s,
                "series": history.series()}

    @app.route("/api/alerts")
    def get_alerts(req):
        """The SLO engine's view: every declared objective with its
        multi-window burn rates and alert state, the active (non-ok)
        alert set, the transition log, and TSDB/flight-recorder health
        counters. Each read ticks the observer at most once per
        sampling interval, so the endpoint is live without a
        background thread."""
        observer.maybe_tick()
        return observer.alerts()

    @app.route("/api/harvest")
    def get_harvest(req):
        """The card-harvesting picture: which notebook slices are on
        loan to the serving fleet right now (the scheduler's lease
        ledger — ground truth, present even when no controller is
        attached to this process), plus the lifetime grant/reclaim
        counters and, when a :class:`ChipHarvestController` is wired
        up via ``app.harvest``, its live lease specs."""
        from kubeflow_rm_tpu_torch.controlplane import metrics, scheduler
        sched = scheduler.cache_for(api)
        ctl = getattr(app, "harvest", None)
        return {
            "harvested_chips": sched.harvested_chips(),
            "leases": [
                {"namespace": ns, "pod": name, "node": node,
                 "chips": chips}
                for (ns, name), (node, chips)
                in sorted(sched.harvested_entries().items())
            ],
            "controller": ctl.leases() if ctl is not None else None,
            "grants_total": metrics.registry_value(
                "harvest_grants_total") or 0.0,
            "reclaims": {
                trigger: metrics.registry_value(
                    "harvest_reclaims_total",
                    {"trigger": trigger}) or 0.0
                for trigger in ("resume", "preempt", "idle_giveback")
            },
            "reclaim_seconds_count": metrics.registry_value(
                "harvest_reclaim_seconds_count") or 0.0,
            "reclaim_seconds_sum": metrics.registry_value(
                "harvest_reclaim_seconds_sum") or 0.0,
        }

    # ---- distributed traces -----------------------------------------
    def _merged_spans():
        """This process's collector merged with every shard's
        ``/debug/traces`` export (a sharded api hops cross-process, so
        one trace's spans are scattered over the shard collectors)."""
        from kubeflow_rm_tpu_torch.controlplane import metrics as cp_metrics
        from kubeflow_rm_tpu_torch.controlplane import tracing
        local = tracing.collector()
        span_lists = [local.spans()]
        slow = list(local.slow_traces())
        shard_urls = getattr(api, "shard_urls", None) or {}
        if shard_urls:
            import json as _json
            import urllib.request
            for url in shard_urls.values():
                try:
                    with urllib.request.urlopen(
                            url.rstrip("/") + "/debug/traces",
                            timeout=2.0) as resp:
                        payload = _json.loads(resp.read().decode())
                except Exception:  # noqa: BLE001 - shard may be down
                    cp_metrics.swallowed("dashboard",
                                         "shard trace fetch")
                    continue
                span_lists.append(payload.get("spans") or [])
                slow.extend(payload.get("slow") or [])
        return tracing.merge_spans(*span_lists), slow

    @app.route("/api/traces")
    def list_traces(req):
        """Slow-trace index: tail-sampled root traces across every
        shard, slowest first, with span counts and the processes each
        trace crossed."""
        from kubeflow_rm_tpu_torch.controlplane import tracing
        spans, slow = _merged_spans()
        by_trace: dict[str, list] = {}
        for s in spans:
            by_trace.setdefault(s["trace_id"], []).append(s)
        slow_index = []
        seen = set()
        for t in sorted(slow, key=lambda t: -(t.get("duration_ms") or 0)):
            if t["trace_id"] in seen:
                continue
            seen.add(t["trace_id"])
            merged = tracing.merge_spans(
                t.get("spans") or [], by_trace.get(t["trace_id"], []))
            slow_index.append({
                "trace_id": t["trace_id"],
                "duration_ms": t.get("duration_ms"),
                "spans": len(merged),
                "processes": sorted({s.get("process") or ""
                                     for s in merged}),
            })
        return {"enabled": tracing.enabled(),
                "traces": len(by_trace),
                "slow": slow_index}

    @app.route("/api/traces/<trace_id>")
    def get_trace(req, trace_id):
        """One whole trace — spans merged across shards — plus its
        critical path (the ordered blocking chain with per-hop self
        time; self_ms sums to the root span's duration)."""
        from kubeflow_rm_tpu_torch.controlplane import tracing
        spans, slow = _merged_spans()
        mine = [s for s in spans if s["trace_id"] == trace_id]
        for t in slow:
            if t["trace_id"] == trace_id:
                mine = tracing.merge_spans(mine, t.get("spans") or [])
        if not mine:
            raise HTTPError(404, f"no spans for trace {trace_id!r}")
        mine.sort(key=lambda s: s["start"])
        return {"trace_id": trace_id,
                "spans": mine,
                "critical_path": tracing.critical_path(mine)}

    # ---- api_workgroup.ts surface -----------------------------------
    @app.route("/api/workgroup/exists")
    def workgroup_exists(req):
        user = app.username(req)
        owned = [p for p in api.list(PROFILE_KIND)
                 if deep_get(p, "spec", "owner", "name") == user]
        member_ns = _member_namespaces(api, user)
        return {
            "hasAuth": True,
            "user": user,
            "hasWorkgroup": bool(owned) or bool(member_ns),
            "registrationFlowAllowed": True,
        }

    @app.route("/api/workgroup/create", methods=("POST",))
    def workgroup_create(req):
        user = app.username(req)
        body = json_body(req)
        name = body.get("namespace")
        if not name:
            raise HTTPError(400, "'namespace' is a required body field")
        api.create(make_profile(name, user))
        return {"message": f"Profile {name} created."}

    @app.route("/api/workgroup/env-info")
    def env_info(req):
        user = app.username(req)
        namespaces = _member_namespaces(api, user)
        return {
            "user": user,
            "platform": {"kubeflowVersion": "tpu-native",
                         "provider": "gke", "providerName": "gke"},
            "namespaces": [
                {"namespace": ns, "role": role, "user": user}
                for ns, role in namespaces
            ],
            "isClusterAdmin": api.access_review(user, "*", "*"),
            "tpuSliceTypes": gpu_api.slice_types_on(api.list("Node")),
        }

    @app.route("/api/workgroup/get-all-namespaces")
    def get_all_namespaces(req):
        user = app.username(req)
        if not api.access_review(user, "*", "*"):
            raise HTTPError(403, "cluster admin required")
        out = []
        for ns in api.list("Namespace"):
            owner = (ns["metadata"].get("annotations") or {}).get(
                OWNER_ANNOTATION)
            out.append({"namespace": ns["metadata"]["name"],
                        "owner": owner})
        return {"namespaces": out}

    @app.route("/api/workgroup/get-contributors/<namespace>")
    def get_contributors(req, namespace):
        from kubeflow_rm_tpu_torch.controlplane.webapps.kfam import (
            ROLE_ANNOTATION, USER_ANNOTATION,
        )
        out = []
        for rb in api.list("RoleBinding", namespace):
            ann = rb["metadata"].get("annotations") or {}
            if USER_ANNOTATION in ann:
                out.append({"user": ann[USER_ANNOTATION],
                            "role": ann.get(ROLE_ANNOTATION)})
        return {"contributors": out}

    # ---- the SPA (replaces centraldashboard/public + the Angular
    # frontends) ------------------------------------------------------
    import mimetypes
    from pathlib import Path

    static_dir = Path(__file__).parent / "static"

    def _serve_static(filename: str) -> Response:
        path = (static_dir / filename).resolve()
        if not path.is_relative_to(static_dir.resolve()) \
                or not path.is_file():
            raise HTTPError(404, f"no static file {filename}")
        ctype = mimetypes.guess_type(path.name)[0] or "text/plain"
        return Response(path.read_bytes(), content_type=content_type(ctype))

    @app.route("/", no_auth=True, no_csrf=True)
    def index(req):
        """The SPA shell; sets the CSRF double-submit cookie the way
        the reference index does (crud_backend/csrf.py)."""
        resp = _serve_static("index.html")
        app.set_csrf_cookie(resp)
        return resp

    @app.route("/static/<path:filename>", no_auth=True, no_csrf=True)
    def static_file(req, filename):
        return _serve_static(filename)

    return app


def _member_namespaces(api: APIServer, user: str | None):
    """(namespace, role) pairs where the user holds a binding — the
    dashboard's namespace selector contents."""
    out = []
    for ns in api.list("Namespace"):
        ns_name = ns["metadata"]["name"]
        owner = (ns["metadata"].get("annotations") or {}).get(
            OWNER_ANNOTATION)
        if owner == user:
            out.append((ns_name, "owner"))
            continue
        for rb in api.list("RoleBinding", ns_name):
            if any(s.get("name") == user
                   for s in rb.get("subjects") or []):
                role = deep_get(rb, "roleRef", "name", default="")
                out.append((ns_name, "contributor"
                            if "admin" not in role else "owner"))
                break
    return out
