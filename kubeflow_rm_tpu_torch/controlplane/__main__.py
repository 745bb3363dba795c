"""Process entrypoints — ``python -m kubeflow_rm_tpu_torch.controlplane <cmd>``.

The reference ships one ``main.go`` per component (controller manager
``notebook-controller/main.go:58-148``, webhook server
``admission-webhook/main.go:755-773``, Flask ``entrypoint.py`` per web
app, Express for the dashboard). This module is all of them behind one
binary, the way kubebuilder projects expose subcommands:

    controller-manager   watch-driven reconcile loop (kube adapter)
    webhook-server       HTTPS AdmissionReview server
    jupyter-web-app      spawner backend          (WSGI, standard library)
    volumes-web-app      PVC + viewer backend
    tensorboards-web-app TB CR backend
    kfam                 access management REST
    dashboard            central dashboard API (+ SPA)
    gateway              every web app + the SPA on one origin
    crds                 print CRD YAML to stdout
    manifests            write the kustomize tree to a directory

Env (reference convention of env-var feature flags, SURVEY.md §5):
``KUBE_API_URL``/``KUBE_TOKEN``/``KUBE_CA_CERT`` override in-cluster
autodetection; ``ENABLE_CULLING``, ``CULL_IDLE_TIME``,
``IDLENESS_CHECK_PERIOD`` gate the culler; ``PORT`` overrides each
server's default port; ``WEBHOOK_TLS_CERT``/``WEBHOOK_TLS_KEY`` for the
admission server; ``DISABLE_AUTH=true`` for dev (reference ``DEV``).
HA/throughput knobs (reference --leader-elect/--qps/--burst,
notebook-controller/main.go:60-93): ``LEADER_ELECT=true`` gates
reconciling on a coordination.k8s.io Lease (``LEASE_NAMESPACE``,
``LEASE_DURATION``, ``LEASE_RENEW_DEADLINE``, ``LEASE_RETRY_PERIOD``);
``KUBE_CLIENT_QPS``/``KUBE_CLIENT_BURST`` throttle the kube client;
``RECONCILE_WORKERS`` sets reconcile parallelism; ``POD_NAME`` names
this replica's election identity. Every server exits 0 on SIGTERM or
SIGINT. No command loads torch: the control plane is the standard
library's.
"""

from __future__ import annotations

import logging
import os
import signal
import sys
import threading


def _env_flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    return default if v is None else v.lower() in ("1", "true", "yes")


def _identity() -> str:
    """This replica's election identity: pod name in-cluster, else
    hostname+pid (unique per process, stable for its lifetime)."""
    import socket
    return os.environ.get("POD_NAME") or \
        f"{socket.gethostname()}_{os.getpid()}"


def _kube_api(identity: str | None = None):
    from kubeflow_rm_tpu_torch.controlplane.deploy.kubeclient import (
        KubeAPIServer,
    )
    qps = os.environ.get("KUBE_CLIENT_QPS")
    burst = os.environ.get("KUBE_CLIENT_BURST")
    return KubeAPIServer(
        base_url=os.environ.get("KUBE_API_URL"),
        token=os.environ.get("KUBE_TOKEN"),
        ca_cert=os.environ.get("KUBE_CA_CERT", True),
        qps=float(qps) if qps else None,
        burst=int(burst) if burst else None,
        identity=identity,
    )


def _stop_on_signals() -> threading.Event:
    """An event SIGTERM and SIGINT set (the process then exits 0)."""
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *a: stop.set())
    return stop


def _serve_wsgi(app, default_port: int) -> None:
    """Serve ``app`` on ``0.0.0.0:$PORT`` with a thread a request (a
    parked readiness long-poll holds no other request back) until
    SIGTERM or SIGINT."""
    import socketserver
    from wsgiref.simple_server import (
        WSGIRequestHandler, WSGIServer, make_server,
    )

    class Server(socketserver.ThreadingMixIn, WSGIServer):
        daemon_threads = True

    class Handler(WSGIRequestHandler):
        def log_message(self, fmt, *args):
            logging.getLogger("kubeflow_rm_tpu_torch.wsgi").info(
                "%s %s", self.address_string(), fmt % args)

    port = int(os.environ.get("PORT", default_port))
    httpd = make_server("0.0.0.0", port, app, server_class=Server,
                        handler_class=Handler)
    stop = _stop_on_signals()
    thread = threading.Thread(target=httpd.serve_forever, name="wsgi",
                              daemon=True)
    thread.start()
    logging.getLogger("kubeflow_rm_tpu_torch").info(
        "serving on :%d", httpd.server_port)
    stop.wait()
    httpd.shutdown()
    httpd.server_close()
    thread.join(30)


def _webapp(module: str, default_port: int) -> None:
    import importlib
    mod = importlib.import_module(
        f"kubeflow_rm_tpu_torch.controlplane.webapps.{module}")
    api = _kube_api()
    if _env_flag("WEBAPP_INFORMER_CACHE", True):
        # web-app list endpoints are read-dominated: run the same
        # informer watch loops the controller manager does so index
        # pages serve from memory instead of a live LIST per request
        from kubeflow_rm_tpu_torch.controlplane import WATCHED_KINDS
        stop = threading.Event()
        for kind in WATCHED_KINDS:
            threading.Thread(
                target=api.watch_kind, args=(kind, None, stop),
                daemon=True, name=f"watch-{kind}").start()
        api.wait_for_sync(WATCHED_KINDS, timeout=30.0)
    app = mod.create_app(
        api, disable_auth=_env_flag("DISABLE_AUTH"),
        prefix=os.environ.get("APP_PREFIX", ""))
    _serve_wsgi(app, default_port)


def cmd_controller_manager() -> int:
    from kubeflow_rm_tpu_torch.controlplane import (
        WATCHED_KINDS,
        make_cluster_manager,
    )
    identity = _identity()
    api = _kube_api(identity=identity)
    culler = {}
    if os.environ.get("CULL_IDLE_TIME"):  # minutes, reference name
        culler["cull_idle_minutes"] = float(os.environ["CULL_IDLE_TIME"])
    if os.environ.get("IDLENESS_CHECK_PERIOD"):
        culler["check_period_minutes"] = float(
            os.environ["IDLENESS_CHECK_PERIOD"])
    manager = make_cluster_manager(
        api, enable_culling=_env_flag("ENABLE_CULLING"),
        culler_config=culler or None)
    elector = None
    if _env_flag("LEADER_ELECT"):
        from kubeflow_rm_tpu_torch.controlplane.ha.leases import (
            LeaderElector,
        )
        elector = LeaderElector(
            api, identity,
            namespace=os.environ.get("LEASE_NAMESPACE", "kubeflow"),
            lease_duration_s=float(
                os.environ.get("LEASE_DURATION", "15")),
            renew_deadline_s=float(
                os.environ.get("LEASE_RENEW_DEADLINE", "10")),
            retry_period_s=float(
                os.environ.get("LEASE_RETRY_PERIOD", "2")),
            release_on_exit=True)
    stop = _stop_on_signals()
    threads = [
        threading.Thread(target=api.watch_kind, args=(kind, None, stop),
                         daemon=True, name=f"watch-{kind}")
        for kind in WATCHED_KINDS
    ]
    for t in threads:
        t.start()
    # gate on the informers' initial lists so the seed resync (and
    # every reconcile it triggers) reads from memory instead of racing
    # the watch threads with live GETs. Best-effort: on timeout the
    # cache serves whatever synced and the rest falls through.
    if not api.wait_for_sync(WATCHED_KINDS, timeout=30.0):
        logging.getLogger("kubeflow_rm_tpu_torch").warning(
            "informer cache not fully synced after 30s; unsynced kinds "
            "fall through to live reads")
    manager.enqueue_all()
    logging.getLogger("kubeflow_rm_tpu_torch").info(
        "controller manager %s running (%d controllers, %d watches, "
        "leader_elect=%s)", identity, len(manager.controllers),
        len(threads), elector is not None)
    manager.run_forever(
        stop, workers=int(os.environ.get("RECONCILE_WORKERS", "1")),
        elector=elector)
    if elector is not None:
        # the election runs on a daemon thread, which the exit would cut
        # before its own release: give the lease up here, so the next
        # replica takes over at once (a no-op unless this one holds it)
        elector.release()
    return 0


def cmd_webhook_server() -> int:
    from kubeflow_rm_tpu_torch.controlplane.deploy.webhook_server import (
        WebhookServer,
        make_admission_handler,
    )
    api = _kube_api()
    server = WebhookServer(
        make_admission_handler(api),
        port=int(os.environ.get("PORT", 8443)),
        certfile=os.environ.get("WEBHOOK_TLS_CERT"),
        keyfile=os.environ.get("WEBHOOK_TLS_KEY"),
    )
    port = server.start()
    logging.getLogger("kubeflow_rm_tpu_torch").info(
        "webhook server on :%d (%s)", port,
        "https" if server.certfile else "http")
    stop = _stop_on_signals()
    stop.wait()
    server.stop()
    return 0


def cmd_crds() -> int:
    from kubeflow_rm_tpu_torch.controlplane.deploy.crds import (
        all_crds,
        render_yaml,
    )
    sys.stdout.write(render_yaml(all_crds()))
    return 0


def cmd_manifests(outdir: str | None = None) -> int:
    from kubeflow_rm_tpu_torch.controlplane.deploy.manifests import (
        write_tree,
    )
    write_tree(outdir or "manifests")
    return 0


def cmd_gateway() -> int:
    """All web apps + the SPA on one origin — the dev/e2e stand-in for
    the in-cluster gateway (VirtualService path routes). DEV_USER
    stamps the identity header the mesh auth proxy would."""
    from kubeflow_rm_tpu_torch.controlplane.webapps.gateway import (
        make_gateway,
    )
    app = make_gateway(
        _kube_api(),
        dev_user=os.environ.get("DEV_USER"),
        secure_cookies=_env_flag("SECURE_COOKIES", True),
    )
    _serve_wsgi(app, 8082)
    return 0


COMMANDS = {
    "controller-manager": cmd_controller_manager,
    "webhook-server": cmd_webhook_server,
    "jupyter-web-app": lambda: _webapp("jupyter", 5000),
    "volumes-web-app": lambda: _webapp("volumes", 5001),
    "tensorboards-web-app": lambda: _webapp("tensorboards", 5002),
    "kfam": lambda: _webapp("kfam", 8081),
    "dashboard": lambda: _webapp("dashboard", 8082),
    "gateway": cmd_gateway,
    "crds": cmd_crds,
}


def main(argv: list[str] | None = None) -> int:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s | %(name)s | %(levelname)s | %(message)s")
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:", ", ".join([*COMMANDS, "manifests"]))
        return 0 if argv else 2
    cmd, *rest = argv
    if cmd == "manifests":
        return cmd_manifests(rest[0] if rest else None)
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; known: "
              f"{', '.join([*COMMANDS, 'manifests'])}", file=sys.stderr)
        return 2
    return COMMANDS[cmd]() or 0


if __name__ == "__main__":
    sys.exit(main())
