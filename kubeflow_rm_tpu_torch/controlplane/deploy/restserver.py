"""Kube-style REST facade over the in-memory ``APIServer``.

Serves the in-memory apiserver's store on real HTTP with the Kubernetes
path/verb/status-code conventions — ``/api/v1/...`` and
``/apis/<group>/<version>/...`` collections, merge-patch, the status
subresource, label selectors, SubjectAccessReview, and streaming
``?watch=true``. Three jobs:

1. Round-trip testing of ``deploy.kubeclient.KubeAPIServer``: the
   adapter is exercised against real kube REST semantics with no
   cluster (the role envtest plays in the reference —
   ``suite_test.go:50-110``).
2. Wall-clock conformance: web apps, webhook server and the controller
   manager run as real processes/threads against this server over
   sockets, so provisioning p50 is measured in wall time (BASELINE.json
   primary metric), not reconcile counts.
3. A fake-cluster e2e harness for CI without KinD credentials.

Admission/validation run INSIDE the wrapped APIServer (its registered
chains), so writes through this facade behave like a cluster whose
webhooks are installed — or construct the APIServer bare and register
nothing to model a cluster with no webhooks.

(The port's copy of ``kubeflow_rm_tpu/controlplane/deploy/restserver.py``.
Multi-version kinds convert through the port's :mod:`..api.conversion`.
A resume at rv 0 replays the backlog (C12). Its ``/debug/*``
endpoints: the elastic handoff's ``snapshot``, ``rv_floor`` and
``tombstone`` (``shard/elastic.py``), the write audit trail
``writelog``, and ``traces``, the span collector that the flight
recorder (``obs/flight.py``) merges across shards.)
"""

from __future__ import annotations

import json
import logging
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from kubeflow_rm_tpu_torch.controlplane.api.conversion import (
    CONVERTERS,
    GROUP,
    SERVED_VERSIONS,
    STORAGE_VERSION,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import (
    AdmissionDenied,
    AlreadyExists,
    APIServer,
    Conflict,
    Invalid,
    NotFound,
    is_status,
)
from kubeflow_rm_tpu_torch.controlplane.deploy.kubeclient import RESOURCES
from kubeflow_rm_tpu_torch.controlplane import tracing
from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock

log = logging.getLogger("kubeflow_rm_tpu_torch.restserver")

# plural -> kind (reverse of the adapter's table, so both sides agree)
PLURALS: dict[str, str] = {
    plural: kind for kind, (_, plural, _ns) in RESOURCES.items()
}


def _status(code: int, reason: str, message: str) -> dict:
    return {"apiVersion": "v1", "kind": "Status", "status": "Failure",
            "code": code, "reason": reason, "message": message}


def _split_selector(raw: str) -> list[str]:
    """Split on commas OUTSIDE parentheses — ``k in (a,b),x=y`` is two
    requirements, not three."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(raw):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth = max(0, depth - 1)
        elif ch == "," and depth == 0:
            parts.append(raw[start:i])
            start = i + 1
    parts.append(raw[start:])
    return [p.strip() for p in parts if p.strip()]


def _selector_from(params: dict) -> dict | None:
    """Parse a kube labelSelector query string into the structured
    LabelSelector ``matches_selector`` evaluates. Full requirement
    grammar: ``k=v``/``k==v`` (equality), ``k!=v`` (NotIn — previously
    misparsed as an equality match on the key ``k!``), bare ``k``
    (Exists), ``!k`` (DoesNotExist), ``k in (a,b)`` / ``k notin (a,b)``
    (set forms)."""
    raw = params.get("labelSelector", [None])[0]
    if not raw:
        return None
    pairs: dict[str, str] = {}
    exprs: list[dict] = []
    for part in _split_selector(raw):
        low = part.lower()
        if " notin (" in low:
            idx = low.index(" notin (")
            vals = part[idx + len(" notin ("):].rstrip(")").strip()
            exprs.append({"key": part[:idx].strip(), "operator": "NotIn",
                          "values": [v.strip() for v in vals.split(",")
                                     if v.strip()]})
        elif " in (" in low:
            idx = low.index(" in (")
            vals = part[idx + len(" in ("):].rstrip(")").strip()
            exprs.append({"key": part[:idx].strip(), "operator": "In",
                          "values": [v.strip() for v in vals.split(",")
                                     if v.strip()]})
        elif "!=" in part:
            k, _, v = part.partition("!=")
            exprs.append({"key": k.strip(), "operator": "NotIn",
                          "values": [v.strip()]})
        elif "=" in part:
            k, _, v = part.partition("==" if "==" in part else "=")
            pairs[k.strip()] = v.strip()
        elif part.startswith("!"):
            exprs.append({"key": part[1:].strip(),
                          "operator": "DoesNotExist"})
        else:
            exprs.append({"key": part, "operator": "Exists"})
    out: dict = {}
    if pairs:
        out["matchLabels"] = pairs
    if exprs:
        out["matchExpressions"] = exprs
    return out or None


class _Route:
    """Parsed collection/object path."""

    def __init__(self, kind: str, namespace: str | None,
                 name: str | None, subresource: str | None,
                 version: str | None = None):
        self.kind, self.namespace = kind, namespace
        self.name, self.subresource = name, subresource
        # the API version the CLIENT asked for — multi-version kinds
        # (conversion.CONVERTERS) are converted at this boundary, the
        # way a real apiserver converts storage-version objects to the
        # request's version
        self.version = version


def _parse_path(path: str) -> _Route | None:
    parts = [p for p in path.split("/") if p]
    # /api/v1/... or /apis/<group>/<version>/...
    if not parts:
        return None
    version = None
    if parts[0] == "api" and len(parts) >= 2:
        version = parts[1]
        rest = parts[2:]
    elif parts[0] == "apis" and len(parts) >= 3:
        version = parts[2]
        rest = parts[3:]
    else:
        return None
    namespace = None
    # /namespaces/{ns}/{plural}... (>=3 segments) is a namespaced
    # collection; /namespaces[/{name}] is the Namespace kind itself
    if len(rest) >= 3 and rest[0] == "namespaces":
        namespace = rest[1]
        rest = rest[2:]
    if not rest or rest[0] not in PLURALS:
        return None
    kind = PLURALS[rest[0]]
    name = rest[1] if len(rest) > 1 else None
    sub = rest[2] if len(rest) > 2 else None
    return _Route(kind, namespace, name, sub, version)


class RestServer:
    def __init__(self, api: APIServer, *, port: int = 0):
        self.api = api
        self.port = port
        self._httpd: ThreadingHTTPServer | None = None
        # watch fan-out: every active watch request owns a queue fed by
        # the apiserver watcher below. A bounded backlog of recent
        # events (rv-ordered) lets a watch opened with
        # ?resourceVersion=N replay what landed between the client's
        # list and its watch registration — without it, any write in
        # that gap (or between 300s stream restarts) reaches no watcher
        # until the next full relist.
        import collections
        self._watch_queues: list[tuple[str, queue.Queue]] = []
        self._backlog: collections.deque = collections.deque(maxlen=2048)
        # rv horizon of the backlog: anything <= this may have been
        # evicted, so a watch asking to resume below it gets 410 Gone
        # (the informer then relists — kubeclient.watch_kind). Starts
        # at the server's CURRENT rv: after a WAL-recovered restart the
        # pre-crash event stream is gone, so a client resuming at a
        # pre-crash rv must relist rather than silently miss the gap.
        self._backlog_floor = int(getattr(api, "_rv", 0) or 0)
        self._watch_lock = make_lock("restserver.watch_registry")
        api.add_watcher(self._on_event, name="rest")

    def _on_event(self, etype: str, obj: dict, old) -> None:
        if etype == "TOO_OLD":
            # our fanout queue overflowed upstream: an unknown window of
            # events never reached this facade, so the backlog has a
            # hole in it. Drop it, raise the horizon to the server's
            # current rv, and 410 every open stream — exactly what a
            # kube watch cache does when a client falls off its window.
            with self._watch_lock:
                self._backlog.clear()
                self._backlog_floor = max(
                    self._backlog_floor,
                    int(getattr(self.api, "_rv", 0) or 0))
                gone = {"type": "ERROR", "object": _status(
                    410, "Expired",
                    "watch window lost (fanout overflow); relist")}
                for _, q in self._watch_queues:
                    q.put((gone, None))
            return
        evt = {"type": {"ADDED": "ADDED",
                        "MODIFIED": "MODIFIED",
                        "DELETED": "DELETED"}.get(etype, etype),
               "object": obj}
        try:
            rv = int((obj.get("metadata") or {}).get("resourceVersion", 0))
        except (TypeError, ValueError):
            rv = 0
        # encode ONCE; every subscriber of this kind (and any backlog
        # replay) shares the same bytes — under a 20-way spawn storm
        # per-client json.dumps was per-event × per-stream CPU inside
        # what used to be the write path
        raw = json.dumps(evt).encode() + b"\n"
        with self._watch_lock:
            if len(self._backlog) == self._backlog.maxlen:
                self._backlog_floor = self._backlog[0][0]
            self._backlog.append((rv, obj.get("kind"), evt, raw))
            for kind, q in self._watch_queues:
                if obj.get("kind") == kind:
                    q.put((evt, raw))

    # ---- request handling -------------------------------------------
    def _handle(self, handler: BaseHTTPRequestHandler) -> None:
        # server-span boundary: adopt the client's traceparent (the
        # kube adapter injects it per call) so cross-process hops —
        # including shard-routed ones — stay one trace. Watch streams
        # are exempt: a 300s stream is a subscription, not a hop.
        if tracing.enabled() and "watch=true" not in handler.path:
            parent = tracing.parse_traceparent(
                handler.headers.get(tracing.TRACE_HEADER))
            if parent is not None:
                # only context-bearing requests get a span — informer
                # lists/watch registrations and metric scrapes carry no
                # traceparent and would otherwise mint orphan roots
                path = handler.path.split("?", 1)[0]
                with tracing.start_span(
                        f"{handler.command} {path}", kind="server",
                        parent=parent,
                        attrs={"component": "restserver"}):
                    self._handle_inner(handler)
                return
        self._handle_inner(handler)

    def _handle_inner(self, handler: BaseHTTPRequestHandler) -> None:
        parsed = urlparse(handler.path)
        params = parse_qs(parsed.query)
        method = handler.command
        # tag this request thread's writes in the apiserver audit log
        # (kubeclient sends the header when built with identity=...)
        self.api.set_writer(handler.headers.get("X-Writer-Identity"))

        if parsed.path == "/apis/authorization.k8s.io/v1/subjectaccessreviews" \
                and method == "POST":
            body = self._read_json(handler)
            attrs = (body.get("spec") or {}).get(
                "resourceAttributes") or {}
            allowed = self.api.access_review(
                (body.get("spec") or {}).get("user"),
                attrs.get("verb", ""), attrs.get("resource", ""),
                attrs.get("namespace"))
            body.setdefault("status", {})["allowed"] = allowed
            self._send(handler, 201, body)
            return
        if parsed.path in ("/healthz", "/readyz", "/livez"):
            self._send_raw(handler, 200, b"ok",
                           content_type="text/plain")
            return
        if parsed.path == "/debug/writelog" and method == "GET":
            # the apiserver's bounded write audit trail, serialized for
            # out-of-process consumers (a sharded harness reconstructs
            # cross-shard phase breakdowns from these)
            self._send(handler, 200,
                       {"writes": list(self.api.write_log)})
            return
        if parsed.path == "/debug/rv_floor" and method == "POST":
            # handoff recipients adopt the donor's rv horizon so the
            # router cache's rv monotonicity survives the move
            body = self._read_json(handler)
            out = self.api.advance_rv_floor(int(body.get("rv", 0)))
            self._send(handler, 200, {"rv": out})
            return
        if parsed.path == "/debug/tombstone" and method == "POST":
            # elastic handoff crash fencing: the coordinator stones a
            # donor's moved partition keys right after the router FLIP
            # (so a donor crash before cleanup cannot resurrect them on
            # respawn) and lifts them after cleanup; recipients lift
            # stale stones for ranges moving back IN before adopting
            body = self._read_json(handler)
            if body.get("clear_all"):
                out = self.api.clear_range_tombstone()
            elif "clear" in body:
                out = self.api.clear_range_tombstone(
                    [str(k) for k in body.get("clear") or []])
            else:
                out = self.api.set_range_tombstone(
                    [str(k) for k in body.get("set") or []])
            self._send(handler, 200, {"tombstones": out})
            return
        if parsed.path == "/debug/snapshot" and method == "POST":
            # force a compacting snapshot NOW: the elastic handoff
            # coordinator calls this on the donor before reading its WAL
            # directory, so the bulk copy reads one snapshot file and a
            # short tail instead of the full log
            took = self.api.snapshot_now()
            self._send(handler, 200, {"snapshotted": took})
            return
        if parsed.path == "/debug/traces" and method == "GET":
            # this process's span collector, serialized: the flight
            # recorder merges these per-shard exports into whole
            # cross-process traces
            col = tracing.collector()
            self._send(handler, 200,
                       {"process": tracing.process_name(),
                        "spans": col.spans(),
                        "slow": col.slow_traces()})
            return
        if parsed.path == "/metrics" and method == "GET":
            # Prometheus exposition of the control-plane registry —
            # schedule_latency_seconds / readiness_wake_to_observe /
            # fanout gauges etc. scraped over the same socket the
            # conformance harness already talks to
            from kubeflow_rm_tpu_torch.controlplane import (
                metrics as cp_metrics,
                scheduler as cp_scheduler,
            )
            # free-chip/fragmentation gauges are recomputed on stats();
            # refresh so a scrape between binds reads the live pool
            cp_scheduler.refresh_gauges()
            self._send_raw(handler, 200, cp_metrics.scrape(),
                           content_type="text/plain; version=0.0.4")
            return

        route = _parse_path(parsed.path)
        if route is None:
            self._send(handler, 404,
                       _status(404, "NotFound",
                               f"no route for {parsed.path}"))
            return
        try:
            self._dispatch(handler, method, route, params)
        except NotFound as e:
            self._send(handler, 404, _status(404, "NotFound", str(e)))
        except AlreadyExists as e:
            self._send(handler, 409,
                       _status(409, "AlreadyExists", str(e)))
        except Conflict as e:
            self._send(handler, 409, _status(409, "Conflict", str(e)))
        except (Invalid, AdmissionDenied) as e:
            self._send(handler, 422, _status(422, "Invalid", str(e)))
        except Exception as e:  # pragma: no cover - defensive
            log.exception("unhandled")
            self._send(handler, 500,
                       _status(500, "InternalError", str(e)))

    # ---- multi-version conversion at the serving boundary ------------
    # (api/conversion.py): reads convert storage-version objects to the
    # requested version; writes convert the client's version to storage
    # before hitting the store — what a real apiserver does around its
    # conversion webhook.
    @staticmethod
    def _needs_conversion(route: _Route) -> bool:
        # identity (storage-version) requests skip the convert copy —
        # this is the provision-latency hot path
        return (route.kind in CONVERTERS and route.version is not None
                and route.version != STORAGE_VERSION)

    @classmethod
    def _convert_out(cls, route: _Route, obj: dict) -> dict:
        if not cls._needs_conversion(route):
            return obj
        try:
            return CONVERTERS[route.kind](obj, route.version)
        except ValueError as e:
            raise Invalid(str(e)) from e

    @classmethod
    def _convert_in(cls, route: _Route, obj: dict) -> dict:
        if not cls._needs_conversion(route):
            return obj
        # the path, not the body's apiVersion, names the version the
        # client speaks — a real apiserver rejects mismatches; we
        # normalize (a v1 apiVersion pasted into a v1beta1 POST must
        # not make the annotations-shaped body skip conversion)
        obj["apiVersion"] = f"{GROUP}/{route.version}"
        try:
            return CONVERTERS[route.kind](obj, STORAGE_VERSION)
        except ValueError as e:
            raise Invalid(str(e)) from e

    def _dispatch(self, handler, method: str, route: _Route,
                  params: dict) -> None:
        api, kind = self.api, route.kind
        if method == "GET" and route.name is None:
            if params.get("watch", ["false"])[0] == "true":
                self._serve_watch(handler, route, params)
                return
            items = [self._convert_out(route, o)
                     for o in api.list(kind, route.namespace,
                                       _selector_from(params))]
            self._send(handler, 200, {
                "apiVersion": "v1", "kind": f"{kind}List",
                "metadata": {"resourceVersion": str(api._rv)},
                "items": items,
            })
        elif method == "GET" and route.subresource == "log" \
                and kind == "Pod":
            tail = params.get("tailLines", [None])[0]
            try:
                tail_n = int(tail) if tail is not None else None
            except ValueError:
                raise Invalid(f"tailLines must be an integer, got {tail!r}")
            text = api.pod_logs(route.namespace, route.name,
                                tail_lines=tail_n)
            self._send_raw(handler, 200, text.encode(),
                           content_type="text/plain")
        elif method == "GET":
            self._send(handler, 200, self._convert_out(
                route, api.get(kind, route.name, route.namespace)))
        elif method == "POST" and route.name is None and \
                params.get("bulk", ["false"])[0] == "true":
            # bulk create: {"items": [...]} -> 200 List whose items are
            # created objects or per-item Status failures, index-aligned
            # with the request (one bad object rejects only itself)
            body = self._read_json(handler)
            items = body.get("items")
            if not isinstance(items, list):
                raise Invalid("bulk create body must be "
                              '{"items": [...]}')
            objs = []
            for obj in items:
                obj.setdefault("kind", kind)
                meta = obj.setdefault("metadata", {})
                if route.namespace and not meta.get("namespace"):
                    meta["namespace"] = route.namespace
                objs.append(self._convert_in(route, obj))
            out = [item if is_status(item)
                   else self._convert_out(route, item)
                   for item in api.create_many(objs)]
            self._send(handler, 200, {
                "apiVersion": "v1", "kind": "List", "items": out})
        elif method == "POST":
            obj = self._read_json(handler)
            obj.setdefault("kind", kind)
            if route.namespace and not obj["metadata"].get("namespace"):
                obj["metadata"]["namespace"] = route.namespace
            obj = self._convert_in(route, obj)
            self._send(handler, 201,
                       self._convert_out(route, api.create(obj)))
        elif method == "PUT":
            obj = self._read_json(handler)
            obj.setdefault("kind", kind)
            obj = self._convert_in(route, obj)
            self._send(handler, 200,
                       self._convert_out(route, api.update(obj)))
        elif method == "PATCH":
            patch = self._read_json(handler)
            if route.subresource == "status":
                # status is version-invariant across served versions
                current = api.get(kind, route.name, route.namespace)
                current["status"] = patch.get("status", {})
                self._send(handler, 200, api.update_status(current))
            else:
                if self._needs_conversion(route):
                    # a merge-patch is expressed in the CLIENT's
                    # version: apply it there, then convert the result
                    # back to storage (what the real apiserver does).
                    # The read-merge-write isn't under the store lock
                    # like api.patch, so retry the rv CAS on Conflict
                    # rather than surfacing a 409 the storage-version
                    # path could never produce
                    from kubeflow_rm_tpu_torch.controlplane.api.meta import (
                        strategic_merge,
                    )
                    for attempt in range(5):
                        current = self._convert_out(
                            route, api.get(kind, route.name,
                                           route.namespace))
                        merged = strategic_merge(current, patch)
                        merged["metadata"]["resourceVersion"] = \
                            current["metadata"]["resourceVersion"]
                        merged = self._convert_in(route, merged)
                        try:
                            out = api.update(merged)
                            break
                        except Conflict:
                            if attempt == 4:
                                raise
                    self._send(handler, 200,
                               self._convert_out(route, out))
                else:
                    self._send(handler, 200,
                               api.patch(kind, route.name, patch,
                                         route.namespace))
        elif method == "DELETE":
            obj = self._convert_out(
                route, api.get(kind, route.name, route.namespace))
            api.delete(kind, route.name, route.namespace)
            self._send(handler, 200, obj)
        else:
            self._send(handler, 405,
                       _status(405, "MethodNotAllowed", method))

    def _serve_watch(self, handler, route: _Route, params: dict) -> None:
        if (route.kind in CONVERTERS and route.version is not None
                and route.version not in SERVED_VERSIONS):
            # reject BEFORE the 200 + chunked headers go out — a
            # conversion error mid-stream would interleave a second
            # HTTP response into the open body
            raise Invalid(f"{route.kind} has no served version "
                          f"{route.version!r}")
        q: queue.Queue = queue.Queue()
        # a resume at rv 0 (the list of a server that has written
        # nothing yet) replays too: JAX's facade reads 0 as "no resume"
        # and loses what lands between that list and this watch (C12)
        raw_rv = params.get("resourceVersion", [""])[0]
        try:
            since_rv = int(raw_rv) if raw_rv else None
        except ValueError:
            since_rv = None
        with self._watch_lock:
            # replay-then-register atomically vs _on_event: events with
            # rv > the client's list rv land in q exactly once. A
            # since_rv below the backlog horizon cannot be replayed
            # faithfully -> 410 Gone ERROR event, client must relist.
            if since_rv is not None and since_rv < self._backlog_floor:
                q.put(({"type": "ERROR", "object": _status(
                    410, "Expired",
                    f"resourceVersion {since_rv} is too old "
                    f"(horizon {self._backlog_floor})")}, None))
            elif since_rv is not None:
                for rv, kind, evt, raw in self._backlog:
                    if kind == route.kind and rv > since_rv:
                        q.put((evt, raw))
            self._watch_queues.append((route.kind, q))
        timeout = float(params.get("timeoutSeconds", ["300"])[0])
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Transfer-Encoding", "chunked")
            handler.end_headers()

            def write_chunk(data: bytes):
                handler.wfile.write(f"{len(data):x}\r\n".encode())
                handler.wfile.write(data + b"\r\n")
                handler.wfile.flush()

            import time
            deadline = time.monotonic() + timeout
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    evt, raw = q.get(timeout=min(remaining, 1.0))
                except queue.Empty:
                    continue
                if evt.get("type") == "ERROR":
                    # 410 Gone: report and end the stream; the client
                    # must relist
                    write_chunk(json.dumps(evt).encode() + b"\n")
                    break
                if route.namespace and (
                        (evt["object"].get("metadata") or {})
                        .get("namespace")) != route.namespace:
                    continue
                if raw is not None and not self._needs_conversion(route):
                    # shared single-encode buffer (the common case:
                    # storage-version streams — every watcher of a kind
                    # writes the exact same bytes)
                    write_chunk(raw)
                    continue
                # multi-version kinds: the stream speaks the version
                # the client's path asked for (evt dicts are shared
                # across subscriber queues — convert a copy)
                out_obj = self._convert_out(route, evt["object"])
                if out_obj is not evt["object"]:
                    evt = dict(evt, object=out_obj)
                write_chunk(json.dumps(evt).encode() + b"\n")
            write_chunk(b"")  # terminal chunk
        except (BrokenPipeError, ConnectionResetError):
            pass
        finally:
            with self._watch_lock:
                try:
                    self._watch_queues.remove((route.kind, q))
                except ValueError:
                    pass

    # ---- plumbing ----------------------------------------------------
    @staticmethod
    def _read_json(handler) -> dict:
        length = int(handler.headers.get("Content-Length", "0"))
        return json.loads(handler.rfile.read(length) or b"{}")

    @staticmethod
    def _send(handler, code: int, body: dict) -> None:
        RestServer._send_raw(handler, code, json.dumps(body).encode())

    @staticmethod
    def _send_raw(handler, code: int, data: bytes,
                  content_type: str = "application/json") -> None:
        handler.send_response(code)
        handler.send_header("Content-Type", content_type)
        handler.send_header("Content-Length", str(len(data)))
        # explicit keep-alive: pins close_connection False so the
        # client's pooled connection survives the response even when a
        # proxy or an HTTP/1.0 client header would otherwise close it
        handler.send_header("Connection", "keep-alive")
        handler.end_headers()
        handler.wfile.write(data)

    def start(self) -> int:
        outer = self

        class H(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"
            # status/headers and body go out as separate small send()s;
            # with Nagle on, the second write stalls ~40ms behind the
            # client's delayed ACK — which would dominate every
            # provision-latency number this server exists to measure
            disable_nagle_algorithm = True

            def _go(self):
                outer._handle(self)

            do_GET = do_POST = do_PUT = do_PATCH = do_DELETE = _go

            def log_message(self, *a):
                pass

        class S(ThreadingHTTPServer):
            # http.server's default listen backlog is 5; boot opens a
            # dozen-plus concurrent connections (watch streams per kind
            # per client, pooled writers, readiness long-polls) and a
            # SYN dropped off a full backlog retransmits after the
            # kernel's 1s initial RTO — a whole second of phantom
            # provision latency for whichever stream loses the race
            request_queue_size = 128

            # accepted sockets, so stop() can sever ESTABLISHED
            # keep-alive connections: shutdown()+server_close() only
            # stop the accept loop, leaving handler threads serving
            # pooled clients as if the shard never went down
            def get_request(self):
                sock, addr = super().get_request()
                with self._conn_lock:
                    self._conns = {c for c in self._conns
                                   if c.fileno() != -1}
                    self._conns.add(sock)
                return sock, addr

        S._conns = set()
        S._conn_lock = make_lock("restserver.conns")
        self._httpd = S(("127.0.0.1", self.port), H)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self._httpd.server_address[1]}"

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            # release the listening socket too: without this the port
            # stays bound (the kernel keeps SYN-queueing clients into a
            # backlog nobody drains) and a restart-in-place at the same
            # address — the shard respawn path — gets EADDRINUSE
            self._httpd.server_close()
            # and sever established connections: a "stopped" server
            # must stop answering, or pooled keep-alive clients keep
            # getting clean replies from a shard that is supposed to
            # be down (their retry/lost-reply paths never engage)
            import socket as _socket
            with self._httpd._conn_lock:
                conns, self._httpd._conns = set(self._httpd._conns), set()
            for sock in conns:
                try:
                    sock.shutdown(_socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    sock.close()
                except OSError:
                    pass
