"""The ``APIServer`` verb surface against a real kube-apiserver.

``KubeAPIServer`` is a drop-in replacement for the in-memory
``controlplane.apiserver.APIServer``: the SAME controllers, webhooks
and web apps run unchanged against a cluster (the reference gets this
for free from controller-runtime's client; here it's ~one REST call per
verb over ``requests``). Differences from the in-memory server, by
design:

- ``register_admission`` / ``register_validator`` are recorded but not
  invoked on writes — in a real cluster admission runs server-side
  (the HTTPS webhook server in ``webhook_server.py``) and validation is
  the CRD schema's job (``crds.py``).
- ``add_watcher`` wires into real watch streams: ``watch_kind`` runs
  one kind's watch loop (list+watch with resourceVersion resume, the
  informer pattern) and fans events into the registered watchers.
- ``access_review`` submits a real ``SubjectAccessReview``
  (the reference's ``crud_backend/authz.py:46-80``).

Auth: in-cluster ServiceAccount (token + CA at the usual paths) or an
explicit ``base_url``/``token``/``ca_cert`` (tests pass a fake server).

(The port's copy of ``kubeflow_rm_tpu/controlplane/deploy/kubeclient.py``.
It sends its requests through ``http.client`` and ``ssl`` of the
standard library; the shard router, :class:`ShardedKubeAPIServer`, routes
on the port's :mod:`..shard.ring`. The router's elastic surface —
``fence``/``unfence`` and ``set_topology``, which the split/merge
coordinator drives — comes with ``shard/elastic.py``, ROADMAP slice
7e-3.)
"""

from __future__ import annotations

import copy
import datetime
import json
import logging
import threading
import time
from typing import Callable

from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    fast_deepcopy,
    name_of,
    namespace_of,
    strategic_merge,
)
from kubeflow_rm_tpu_torch.controlplane.apiserver import (
    AlreadyExists,
    APIError,
    Conflict,
    Invalid,
    NotFound,
    status_from_error,
)
from kubeflow_rm_tpu_torch.controlplane import chaos, metrics, tracing
from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock

log = logging.getLogger("kubeflow_rm_tpu_torch.kubeclient")


class _WatchExpired(Exception):
    """410 Gone from the watch: the resume rv fell below the server's
    backlog horizon — only a full relist can resync."""

SA_TOKEN = "/var/run/secrets/kubernetes.io/serviceaccount/token"
SA_CA = "/var/run/secrets/kubernetes.io/serviceaccount/ca.crt"

# kind -> (api prefix, plural, namespaced). Core kinds live under
# /api/v1; everything else under /apis/<group>/<version>.
RESOURCES: dict[str, tuple[str, str, bool]] = {
    # core/v1
    "Pod": ("api/v1", "pods", True),
    "Service": ("api/v1", "services", True),
    "ConfigMap": ("api/v1", "configmaps", True),
    "Secret": ("api/v1", "secrets", True),
    "ServiceAccount": ("api/v1", "serviceaccounts", True),
    "Namespace": ("api/v1", "namespaces", False),
    "Event": ("api/v1", "events", True),
    "ResourceQuota": ("api/v1", "resourcequotas", True),
    "PersistentVolumeClaim": ("api/v1", "persistentvolumeclaims", True),
    "PersistentVolume": ("api/v1", "persistentvolumes", False),
    "Node": ("api/v1", "nodes", False),
    # apps/v1
    "StatefulSet": ("apis/apps/v1", "statefulsets", True),
    "Deployment": ("apis/apps/v1", "deployments", True),
    # coordination (leader-election Leases, ha/leases.py)
    "Lease": ("apis/coordination.k8s.io/v1", "leases", True),
    # rbac
    "RoleBinding": ("apis/rbac.authorization.k8s.io/v1",
                    "rolebindings", True),
    "ClusterRole": ("apis/rbac.authorization.k8s.io/v1",
                    "clusterroles", False),
    "ClusterRoleBinding": ("apis/rbac.authorization.k8s.io/v1",
                           "clusterrolebindings", False),
    # networking
    "NetworkPolicy": ("apis/networking.k8s.io/v1", "networkpolicies",
                      True),
    # istio + openshift (installed by overlays when present)
    "VirtualService": ("apis/networking.istio.io/v1beta1",
                       "virtualservices", True),
    "AuthorizationPolicy": ("apis/security.istio.io/v1beta1",
                            "authorizationpolicies", True),
    "Route": ("apis/route.openshift.io/v1", "routes", True),
    # this platform's CRDs (deploy/crds.py)
    "Notebook": ("apis/kubeflow.org/v1", "notebooks", True),
    "TPUJob": ("apis/kubeflow.org/v1", "tpujobs", True),
    "Profile": ("apis/kubeflow.org/v1", "profiles", False),
    "PodDefault": ("apis/kubeflow.org/v1alpha1", "poddefaults", True),
    "Tensorboard": ("apis/tensorboard.kubeflow.org/v1alpha1",
                    "tensorboards", True),
    "PVCViewer": ("apis/kubeflow.org/v1alpha1", "pvcviewers", True),
    "CustomResourceDefinition": (
        "apis/apiextensions.k8s.io/v1", "customresourcedefinitions",
        False),
}


class TokenBucket:
    """A qps/burst throttle — client-go's
    ``flowcontrol.NewTokenBucketRateLimiter``.

    ``acquire`` debits tokens, sleeping when the bucket is dry. Tokens
    refill at ``qps``; the bucket holds at most ``burst``, so a cold
    caller may spend ``burst`` back to back before the steady rate
    applies. Tokens may go negative (waiters queue by their computed
    wait). ``try_acquire`` never sleeps: the serving gateway sheds an
    over-limit request at once. Thread-safe; ``clock``/``sleep`` are
    injectable for deterministic tests."""

    def __init__(self, qps: float, burst: int | None = None, *,
                 clock: Callable[[], float] | None = None,
                 sleep: Callable[[float], None] | None = None):
        if qps <= 0:
            raise ValueError(f"qps must be > 0, got {qps}")
        self.qps = float(qps)
        self.burst = int(burst) if burst else max(1, int(2 * qps))
        self._clock = clock or time.monotonic
        self._sleep = sleep or time.sleep
        self._tokens = float(self.burst)
        self._last = self._clock()
        self._lock = make_lock("kubeclient.token_bucket")
        # total seconds of wait injected, and the calls throttled
        self.throttled_seconds = 0.0
        self.throttled_calls = 0

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(float(self.burst),
                           self._tokens + (now - self._last) * self.qps)
        self._last = now

    def acquire(self, n: float = 1.0) -> float:
        """Take ``n`` tokens, sleeping until they are covered. Returns
        the wait injected (0.0 when the bucket had capacity)."""
        with self._lock:
            self._refill_locked()
            self._tokens -= n
            wait = 0.0 if self._tokens >= 0 else -self._tokens / self.qps
            if wait > 0:
                self.throttled_seconds += wait
                self.throttled_calls += 1
        if wait > 0:
            self._sleep(wait)
        return wait

    def try_acquire(self, n: float = 1.0) -> bool:
        """Debit ``n`` tokens iff the bucket covers them now; else leave
        the bucket untouched and return False."""
        with self._lock:
            self._refill_locked()
            if self._tokens < n:
                self.throttled_calls += 1
                return False
            self._tokens -= n
            return True


class _Resp:
    """Minimal response shim over ``http.client.HTTPResponse`` with the
    slice of the requests API this module consumes."""

    def __init__(self, raw, eager: bool):
        self.raw = raw
        self.status_code = raw.status
        self._body: bytes | None = raw.read() if eager else None

    @property
    def ok(self) -> bool:
        return self.status_code < 400

    @property
    def text(self) -> str:
        return (self._body or b"").decode("utf-8", "replace")

    def json(self):
        return json.loads(self._body or b"null")

    def iter_lines(self):
        # HTTPResponse.readline() de-chunks transparently
        while True:
            line = self.raw.readline()
            if not line:
                return
            yield line.rstrip(b"\r\n")

    def close(self):
        try:
            self.raw.close()
        except Exception:
            metrics.swallowed("kubeclient", "stream close")


def _close_quietly(conn) -> None:
    try:
        conn.close()
    except Exception:
        metrics.swallowed("kubeclient", "conn close")


class _ConnPool:
    """Bounded pool of idle keep-alive connections shared by every
    per-thread session of one adapter. A request checks a connection
    out (exclusive use until checkin), and returns it once the response
    body has been read eagerly; stale connections are dropped by the
    retry logic in ``_FastSession._request``. Pooling replaces the
    one-connection-per-thread model: a 20-way storm's short-lived
    threads share warm connections instead of each paying a fresh
    ``connect()``, and the idle bound caps sockets held against the
    apiserver between bursts."""

    def __init__(self, max_idle: int = 16):
        self.max_idle = max_idle
        self._idle: list = []
        self._lock = make_lock("kubeclient.conn_pool")
        self.dials = 0    # fresh connections established
        self.reuses = 0   # requests served on a pooled connection

    def checkout(self):
        with self._lock:
            if self._idle:
                self.reuses += 1
                return self._idle.pop()
            self.dials += 1
        return None  # caller dials

    def checkin(self, conn) -> None:
        with self._lock:
            if len(self._idle) < self.max_idle:
                self._idle.append(conn)
                return
        try:
            conn.close()
        except Exception:
            metrics.swallowed("kubeclient", "pool checkin close")

    def close(self) -> None:
        with self._lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            try:
                conn.close()
            except Exception:
                metrics.swallowed("kubeclient", "pool close")


class _FastSession:
    """Persistent-connection HTTP client on ``http.client``.

    Drop-in for the slice of ``requests.Session`` the adapter uses, at
    ~¼ the per-call CPU — ``requests`` spends ~0.6 ms/call on prepare/
    hook/cookie machinery, which at control-plane request rates (a
    20-way spawn storm is hundreds of calls) made the client library
    itself a top-3 profile entry. Verb requests draw keep-alive
    connections from a shared ``_ConnPool`` (per-session private pool
    when standalone); streaming calls (watches) get a dedicated
    connection so they don't starve the verb path."""

    def __init__(self, base_url: str, token: str | None,
                 ca_cert: str | bool,
                 extra_headers: dict[str, str] | None = None,
                 pool: _ConnPool | None = None):
        import urllib.parse
        u = urllib.parse.urlsplit(base_url)
        self._https = u.scheme == "https"
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or (443 if self._https else 80)
        self._headers = {"Content-Type": "application/json"}
        if token:
            self._headers["Authorization"] = f"Bearer {token}"
        if extra_headers:
            self._headers.update(extra_headers)
        self._ssl_ctx = None
        if self._https:
            import ssl
            if ca_cert is False:
                self._ssl_ctx = ssl._create_unverified_context()
            else:
                self._ssl_ctx = ssl.create_default_context(
                    cafile=ca_cert if isinstance(ca_cert, str) else None)
        # standalone sessions (tests construct _FastSession directly)
        # keep the historical one-warm-connection behavior via a
        # private single-slot pool
        self._pool = pool if pool is not None else _ConnPool(max_idle=1)

    def _connect(self, timeout: float | None):
        import http.client
        if self._https:
            return http.client.HTTPSConnection(
                self._host, self._port, timeout=timeout,
                context=self._ssl_ctx)
        return http.client.HTTPConnection(self._host, self._port,
                                          timeout=timeout)

    def _request(self, method: str, url: str, *, json_body=None,
                 params=None, headers=None, stream=False,
                 timeout=None):
        import http.client
        import urllib.parse
        path = urllib.parse.urlsplit(url).path
        if params:
            path += "?" + urllib.parse.urlencode(params)
        body = None if json_body is None else json.dumps(json_body)
        hdrs = dict(self._headers)
        if headers:
            hdrs.update(headers)
        # propagate the live trace context on EVERY rest call — this
        # single choke point covers all verbs of every session,
        # including the per-shard sessions ShardedKubeAPIServer routes
        # through, so a cross-shard hop stays one trace
        tp = tracing.current_traceparent()
        if tp is not None:
            hdrs.setdefault(tracing.TRACE_HEADER, tp)
        if not stream and chaos.active() is not None:
            # seeded apiserver-fault injection: the same choke point
            # that carries the trace header covers every verb of every
            # session, so an injected timeout (raises) or 5xx (synthetic
            # 503 the normal _raise_for path turns into APIError) hits
            # exactly where a real overloaded shard would
            injected = chaos.api_request_fault(method, path)
            if injected is not None:
                return injected
        if stream:
            conn = self._connect(timeout or 310)
            conn.request(method, path, body=body, headers=hdrs)
            return _Resp(conn.getresponse(), eager=False)
        conn_errors = (http.client.RemoteDisconnected,
                       http.client.BadStatusLine,
                       http.client.CannotSendRequest,
                       BrokenPipeError, ConnectionResetError,
                       ConnectionRefusedError, OSError)
        for attempt in (0, 1):
            # the retry attempt always dials fresh: after a shard
            # restart EVERY pooled socket is stale, and a checkout on
            # attempt 1 would just pop the next dead keep-alive
            conn = (self._pool.checkout() if attempt == 0 else None) \
                or self._connect(timeout or 60)
            try:
                conn.request(method, path, body=body, headers=hdrs)
            except conn_errors as e:
                # failed while SENDING on a stale keep-alive: the
                # server never saw a complete request, so a resend
                # is safe for any method
                _close_quietly(conn)
                if attempt:
                    raise
                if isinstance(e, (ConnectionResetError,
                                  BrokenPipeError)):
                    # peer went away (shard restart), not a quietly
                    # aged-out keep-alive: every idle socket in the
                    # pool is equally dead — discard them all so the
                    # reconcile loops behind this pool don't each eat
                    # one stale socket
                    self._pool.close()
                continue
            try:
                resp = _Resp(conn.getresponse(), eager=True)
            except conn_errors as e:
                # failed reading the RESPONSE: the server may have
                # processed the request — only idempotent reads may
                # retry (urllib3's default Retry excludes POST/PATCH
                # for the same reason)
                _close_quietly(conn)
                if isinstance(e, (ConnectionResetError,
                                  BrokenPipeError)):
                    self._pool.close()  # shard restart: all stale
                if attempt or method not in ("GET", "HEAD"):
                    raise
                continue
            # body fully read (eager): the connection is free for the
            # next caller — unless the server asked to close it
            if getattr(resp.raw, "will_close", False):
                _close_quietly(conn)
            else:
                self._pool.checkin(conn)
            return resp
        raise http.client.CannotSendRequest(
            f"{method} {path}: connection could not be established")

    def get(self, url, *, params=None, stream=False, timeout=None,
            headers=None):
        return self._request("GET", url, params=params, stream=stream,
                             timeout=timeout, headers=headers)

    def post(self, url, *, json=None, headers=None, params=None):
        return self._request("POST", url, json_body=json,
                             headers=headers, params=params)

    def put(self, url, *, json=None, headers=None):
        return self._request("PUT", url, json_body=json,
                             headers=headers)

    def patch(self, url, *, json=None, headers=None):
        return self._request("PATCH", url, json_body=json,
                             headers=headers)

    def delete(self, url, *, headers=None):
        return self._request("DELETE", url, headers=headers)


def _selector_param(label_selector: dict | None) -> dict:
    """Serialize a structured LabelSelector to the query-string grammar
    (the inverse of the REST facade's ``_selector_from``): matchLabels
    as ``k=v`` and matchExpressions as ``k!=v`` / ``k`` / ``!k`` /
    ``k in (a,b)`` / ``k notin (a,b)``."""
    if not label_selector:
        return {}
    if "matchLabels" in label_selector or \
            "matchExpressions" in label_selector:
        pairs = label_selector.get("matchLabels") or {}
        exprs = label_selector.get("matchExpressions") or []
    else:
        pairs, exprs = label_selector, []
    reqs = [f"{k}={v}" for k, v in sorted(pairs.items())]
    for e in exprs:
        key, op = e["key"], e["operator"]
        values = sorted(e.get("values") or [])
        if op == "In":
            reqs.append(f"{key} in ({','.join(values)})")
        elif op == "NotIn":
            if len(values) == 1:
                reqs.append(f"{key}!={values[0]}")
            else:
                reqs.append(f"{key} notin ({','.join(values)})")
        elif op == "Exists":
            reqs.append(key)
        elif op == "DoesNotExist":
            reqs.append(f"!{key}")
        else:
            raise Invalid(f"unknown selector operator {op!r}")
    return {"labelSelector": ",".join(reqs)}


class KubeAPIServer:
    def __init__(self, base_url: str | None = None, *,
                 token: str | None = None, ca_cert: str | bool = True,
                 clock: Callable[[], datetime.datetime] | None = None,
                 session=None, cache_reads: bool = True,
                 qps: float | None = None, burst: int | None = None,
                 identity: str | None = None):
        if base_url is None:
            # in-cluster defaults (KUBERNETES_SERVICE_HOST is set by
            # the kubelet for every pod)
            import os
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            base_url = f"https://{host}:{port}"
            if token is None and os.path.exists(SA_TOKEN):
                token = open(SA_TOKEN).read().strip()
            if ca_cert is True and os.path.exists(SA_CA):
                ca_cert = SA_CA
        self.base_url = base_url.rstrip("/")
        # Sessions are NOT thread-safe (cookie jar + connection-pool
        # mutation), and this adapter is shared by watch threads plus
        # the parallel Manager's reconcile workers — so each thread
        # lazily gets its own Session unless the caller injected one
        # explicitly (tests that stub transport do).
        self._explicit_session = session
        self._ca_cert = ca_cert
        self._token = token
        self._tls = threading.local()
        # keep-alive connections shared across the per-thread sessions
        self._pool = _ConnPool()
        # writer identity: stamped on every request so the facade's
        # apiserver write log can attribute writes (failover conformance)
        self.identity = identity
        # client-side qps/burst throttle, shared across the per-thread
        # sessions; None = unthrottled (the historical default). Watch
        # streams and cache-served reads are NOT debited — client-go
        # likewise exempts watches from the flowcontrol limiter.
        self.limiter = TokenBucket(qps, burst) if qps else None
        if session is not None:
            session.verify = ca_cert
            if token:
                session.headers["Authorization"] = f"Bearer {token}"
            if identity:
                session.headers["X-Writer-Identity"] = identity
        self.clock = clock or (
            lambda: datetime.datetime.now(datetime.timezone.utc))
        self._watchers: list[Callable[[str, dict, dict | None], None]] = []
        self._event_seq = 0
        self._event_lock = make_lock("kubeclient.events_seen")
        # informer read cache: the shared indexed ObjectStore
        # (controlplane/cache/store.py); a kind serves reads only once
        # its initial list has synced. ``cache_reads=False`` keeps the
        # store cold (nothing applied, nothing served) — the
        # conformance A/B's no-cache arm.
        self._cache_reads = cache_reads
        from kubeflow_rm_tpu_torch.controlplane.cache.store import ObjectStore
        self.cache = ObjectStore(cluster_scoped={
            k for k, (_, _, namespaced) in RESOURCES.items()
            if not namespaced})

    # ---- informer read cache -----------------------------------------
    # controller-runtime's default client serves get/list from the
    # informer cache and sends only writes to the apiserver; the
    # reference's reconcilers lean on that (a Reconcile is ~10 reads +
    # 0-2 writes). Mirroring it here turned the 20-way spawn storm from
    # ~1400 live GETs into ~watch traffic. A kind is cache-served only
    # after its informer's initial list (``watch_kind``) has synced;
    # writes are applied to the cache from the server's response
    # (read-your-writes within a reconcile), and watch events reconcile
    # the rest — the store's rv comparison keeps an older event from
    # rolling back a newer write, and its tombstones keep a racing
    # relist from resurrecting a deletion.

    def _cache_apply(self, etype: str, obj: dict) -> None:
        if self._cache_reads:
            self.cache.apply(etype, obj)

    def _cache_serves(self, kind: str) -> bool:
        return self._cache_reads and self.cache.is_synced(kind)

    def wait_for_sync(self, kinds, timeout: float | None = None) -> bool:
        """Block until every kind's informer completed its initial list
        (vacuously true with the cache disabled)."""
        if not self._cache_reads:
            return True
        return self.cache.wait_for_sync(kinds, timeout)

    @property
    def _session(self):
        if self._explicit_session is not None:
            return self._explicit_session
        s = getattr(self._tls, "session", None)
        if s is None:
            extra = {"X-Writer-Identity": self.identity} \
                if self.identity else None
            s = _FastSession(self.base_url, self._token, self._ca_cert,
                             extra_headers=extra, pool=self._pool)
            self._tls.session = s
        return s

    def _throttle(self) -> None:
        if self.limiter is not None:
            self.limiter.acquire()

    # ---- wiring (admission/validation are server-side in-cluster) ----
    def register_admission(self, kind_pattern: str, fn: Callable) -> None:
        log.debug("admission for %s runs in-cluster via the webhook "
                  "server; registration is a no-op here", kind_pattern)

    def register_validator(self, kind: str, fn: Callable) -> None:
        log.debug("validation for %s is the CRD schema's job in-cluster",
                  kind)

    def add_watcher(self, fn: Callable[[str, dict, dict | None], None],
                    name: str | None = None) -> None:
        # ``name`` labels in-memory fanout gauges; the adapter's watch
        # threads deliver synchronously, so it's accepted and unused
        self._watchers.append(fn)

    # ---- URL plumbing ------------------------------------------------
    def _collection_url(self, kind: str, namespace: str | None) -> str:
        try:
            prefix, plural, namespaced = RESOURCES[kind]
        except KeyError:
            raise Invalid(f"kind {kind!r} has no REST mapping") from None
        if namespaced and namespace:
            return f"{self.base_url}/{prefix}/namespaces/{namespace}/{plural}"
        return f"{self.base_url}/{prefix}/{plural}"

    def _object_url(self, kind: str, name: str,
                    namespace: str | None) -> str:
        _, _, namespaced = RESOURCES.get(kind, (None, None, True))
        if namespaced and not namespace:
            raise Invalid(f"{kind}/{name}: namespaced kind requires "
                          "namespace")
        return f"{self._collection_url(kind, namespace)}/{name}"

    @staticmethod
    def _raise_for(resp, context: str):
        if resp.status_code == 404:
            raise NotFound(context)
        if resp.status_code == 409:
            body = resp.text
            if "AlreadyExists" in body or "already exists" in body:
                raise AlreadyExists(context + ": " + body[:200])
            raise Conflict(context + ": " + body[:200])
        if resp.status_code == 422 or resp.status_code == 400:
            raise Invalid(context + ": " + resp.text[:500])
        if not resp.ok:
            raise APIError(f"{context}: HTTP {resp.status_code} "
                           f"{resp.text[:500]}")

    # ---- verbs (the APIServer contract) ------------------------------
    def create(self, obj: dict) -> dict:
        kind = obj["kind"]
        self._throttle()
        resp = self._session.post(
            self._collection_url(kind, namespace_of(obj)), json=obj)
        self._raise_for(resp, f"create {kind}/{name_of(obj)}")
        out = resp.json()
        out.setdefault("kind", kind)
        self._cache_apply("ADDED", out)
        return out

    def create_many(self, objs: list[dict]) -> list[dict]:
        """Bulk create via ``POST <collection>?bulk=true`` — one HTTP
        round trip, one token debit, one server-side lock acquisition
        for the whole batch (all objects share one kind + namespace:
        the pods of a slice). Per-object failures come back as
        Status-shaped dicts at that object's index. Servers without
        the bulk verb (a real kube-apiserver) answer 404/405/400 —
        fall back to per-object creates with the same Status-dict
        failure shape, so callers are backend-agnostic."""
        if not objs:
            return []
        kind = objs[0]["kind"]
        self._throttle()
        resp = self._session.post(
            self._collection_url(kind, namespace_of(objs[0])),
            json={"items": objs}, params={"bulk": "true"})
        if resp.status_code in (400, 404, 405):
            return [self._create_one_status(o) for o in objs]
        self._raise_for(resp, f"bulk create {len(objs)} {kind}")
        out = []
        for item in resp.json().get("items", []):
            if (item or {}).get("kind") == "Status":
                out.append(item)
                continue
            item.setdefault("kind", kind)
            self._cache_apply("ADDED", item)
            out.append(item)
        return out

    def _create_one_status(self, obj: dict) -> dict:
        try:
            return self.create(obj)
        except APIError as e:
            return status_from_error(e)

    def get(self, kind: str, name: str,
            namespace: str | None = None) -> dict:
        if self._cache_serves(kind):
            obj = self.cache.get_ref(kind, name, namespace)
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            return fast_deepcopy(obj)
        self._throttle()
        resp = self._session.get(self._object_url(kind, name, namespace))
        self._raise_for(resp, f"{kind} {namespace}/{name} not found")
        return resp.json()

    def try_get(self, kind: str, name: str,
                namespace: str | None = None) -> dict | None:
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def list(self, kind: str, namespace: str | None = None,
             label_selector: dict | None = None) -> list[dict]:
        if self._cache_serves(kind):
            return [fast_deepcopy(o) for o in
                    self.cache.list_refs(kind, namespace, label_selector)]
        self._throttle()
        resp = self._session.get(
            self._collection_url(kind, namespace),
            params=_selector_param(label_selector))
        self._raise_for(resp, f"list {kind} in {namespace}")
        items = resp.json().get("items", [])
        for it in items:  # list responses omit kind/apiVersion per item
            it.setdefault("kind", kind)
        return items

    def scan(self, kind: str, namespace: str | None = None) -> list[dict]:
        """READ-ONLY ``list`` (store references, no copies) when the
        kind is cache-served; falls back to a live ``list`` otherwise.
        Same caller contract as the in-memory apiserver's ``scan``:
        never mutate the returned objects."""
        if self._cache_serves(kind):
            return self.cache.list_refs(kind, namespace)
        return self.list(kind, namespace)

    def update(self, obj: dict) -> dict:
        kind = obj["kind"]
        self._throttle()
        resp = self._session.put(
            self._object_url(kind, name_of(obj), namespace_of(obj)),
            json=obj)
        self._raise_for(resp, f"update {kind}/{name_of(obj)}")
        out = resp.json()
        out.setdefault("kind", kind)
        self._cache_apply("MODIFIED", out)
        return out

    def patch(self, kind: str, name: str, patch: dict,
              namespace: str | None = None) -> dict:
        self._throttle()
        resp = self._session.patch(
            self._object_url(kind, name, namespace), json=patch,
            headers={"Content-Type": "application/merge-patch+json"})
        self._raise_for(resp, f"patch {kind}/{name}")
        out = resp.json()
        out.setdefault("kind", kind)
        self._cache_apply("MODIFIED", out)
        return out

    def update_status(self, obj: dict) -> dict:
        kind = obj["kind"]
        url = self._object_url(kind, name_of(obj), namespace_of(obj)) \
            + "/status"
        self._throttle()
        resp = self._session.patch(
            url, json={"status": obj.get("status", {})},
            headers={"Content-Type": "application/merge-patch+json"})
        if resp.status_code == 404:
            # kinds without a status subresource: merge-patch the object
            return self.patch(kind, name_of(obj),
                              {"status": obj.get("status", {})},
                              namespace_of(obj))
        self._raise_for(resp, f"status {kind}/{name_of(obj)}")
        out = resp.json()
        out.setdefault("kind", kind)
        self._cache_apply("MODIFIED", out)
        return out

    def delete(self, kind: str, name: str,
               namespace: str | None = None) -> None:
        self._throttle()
        resp = self._session.delete(
            self._object_url(kind, name, namespace))
        self._raise_for(resp, f"delete {kind} {namespace}/{name}")
        if self._cache_reads:
            _discard_unless_finalized(self.cache, kind, name, namespace)

    def ensure_namespace(self, namespace: str) -> dict:
        found = self.try_get("Namespace", namespace)
        if found is not None:
            return found
        return self.create({"apiVersion": "v1", "kind": "Namespace",
                            "metadata": {"name": namespace}})

    # ---- events ------------------------------------------------------
    def record_event(self, involved: dict, etype: str, reason: str,
                     message: str) -> dict:
        with self._event_lock:
            self._event_seq += 1
            seq = self._event_seq
        ns = namespace_of(involved) or "default"
        now = self.clock().isoformat()
        ev = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": f"{name_of(involved)}.{seq:08x}",
                         "namespace": ns},
            "type": etype,
            "reason": reason,
            "message": message,
            "involvedObject": {
                "kind": involved["kind"],
                "name": name_of(involved),
                "namespace": ns,
                "uid": involved["metadata"].get("uid"),
            },
            "firstTimestamp": now,
            "lastTimestamp": now,
            "count": 1,
            "source": {"component": "kubeflow-rm-tpu"},
        }
        return self.create(ev)

    def events_for(self, involved: dict) -> list[dict]:
        ns = namespace_of(involved)
        if self._cache_serves("Event"):
            # involved-object index: the notebook controller re-emits
            # pod events every reconcile, and filtering the full Event
            # list per call made the storm O(notebooks × events)
            return [fast_deepcopy(e) for e in self.cache.events_for_ref(
                involved["kind"], name_of(involved), ns)]
        return [
            e for e in self.list("Event", ns)
            if (e.get("involvedObject") or {}).get("name")
            == name_of(involved)
            and (e.get("involvedObject") or {}).get("kind")
            == involved["kind"]
        ]

    def pod_logs(self, namespace: str, pod_name: str,
                 tail_lines: int | None = None) -> str:
        """``GET .../pods/<name>/log`` (the verb behind `kubectl logs`)."""
        params = {}
        if tail_lines is not None:
            params["tailLines"] = str(tail_lines)
        self._throttle()
        resp = self._session.get(
            self._object_url("Pod", pod_name, namespace) + "/log",
            params=params)
        self._raise_for(resp, f"logs {namespace}/{pod_name}")
        return resp.text

    # ---- SubjectAccessReview -----------------------------------------
    def access_review(self, user: str | None, verb: str, resource: str,
                      namespace: str | None = None) -> bool:
        if user is None:
            return False
        body = {
            "apiVersion": "authorization.k8s.io/v1",
            "kind": "SubjectAccessReview",
            "spec": {
                "user": user,
                "resourceAttributes": {
                    "verb": verb,
                    "resource": resource,
                    **({"namespace": namespace} if namespace else {}),
                },
            },
        }
        self._throttle()
        resp = self._session.post(
            f"{self.base_url}/apis/authorization.k8s.io/v1/"
            "subjectaccessreviews", json=body)
        self._raise_for(resp, f"subjectaccessreview {user} {verb} "
                              f"{resource}")
        return bool(resp.json().get("status", {}).get("allowed"))

    # ---- watch loop (the informer) -----------------------------------
    def watch_kind(self, kind: str, namespace: str | None = None,
                   stop: threading.Event | None = None,
                   timeout_s: int = 300) -> None:
        """List+watch one kind forever (until ``stop``), fanning events
        into the registered watchers. Run one thread per kind — the
        controller manager entrypoint does."""
        stop = stop or threading.Event()
        rv: str | None = None
        while not stop.is_set():
            try:
                if rv is None:
                    rv = self._initial_list(kind, namespace)
                # resume from the last seen rv on stream restart — the
                # server's backlog replays anything that landed in the
                # gap, so no event (crucially DELETEDs, which a relist
                # cannot re-synthesize) is ever lost; a 410 Gone (rv
                # below the backlog horizon) falls back to a relist
                rv = self._stream(kind, namespace, rv, stop, timeout_s)
            except (NotFound, Invalid):
                raise  # misconfigured kind: crash loudly
            except _WatchExpired as e:
                log.info("watch %s: %s; relisting", kind, e)
                rv = None
            except Exception as e:
                log.warning("watch %s: %s; retrying in 2s", kind, e)
                stop.wait(2.0)

    def _list_raw(self, kind: str,
                  namespace: str | None) -> tuple[list[dict], str]:
        """One live list: (items, collection resourceVersion). The
        shard router lists each shard through this and merges."""
        resp = self._session.get(self._collection_url(kind, namespace))
        self._raise_for(resp, f"list {kind}")
        body = resp.json()
        items = body.get("items", [])
        for item in items:
            item.setdefault("kind", kind)
        return items, body.get("metadata", {}).get("resourceVersion", "")

    def _initial_list(self, kind: str, namespace: str | None) -> str:
        items, rv = self._list_raw(kind, namespace)
        if self._cache_reads and namespace is None:
            # (re)list replaces the kind's store contents — objects
            # deleted while the watch was down drop out, entries newer
            # than the snapshot survive (ObjectStore.replace's horizon
            # merge) — and marks the kind cache-served from here on
            self.cache.replace(kind, items)
            from kubeflow_rm_tpu_torch.controlplane import metrics
            metrics.INFORMER_SYNCED_KINDS.set(
                len(self.cache.synced_kinds()))
        for item in items:
            self._fan("ADDED", item)
        return rv

    def _stream(self, kind: str, namespace: str | None, rv: str,
                stop: threading.Event, timeout_s: int,
                fan: Callable[[str, dict], None] | None = None) -> str:
        """One watch stream; returns the last resourceVersion seen so
        the next stream resumes without a relist (informer resume).
        ``fan`` overrides event delivery (the shard router injects its
        merged-subscription fan)."""
        params = {"watch": "true",
                  "timeoutSeconds": str(timeout_s),
                  "allowWatchBookmarks": "true"}
        if rv:
            params["resourceVersion"] = rv
        resp = self._session.get(
            self._collection_url(kind, namespace), params=params,
            stream=True, timeout=timeout_s + 10)
        if resp.status_code == 410:
            # a real apiserver can reject the resume rv with a direct
            # HTTP 410 after compaction (client-go handles both forms)
            raise _WatchExpired(f"HTTP 410 resuming {kind} at rv {rv}")
        self._raise_for(resp, f"watch {kind}")
        last_rv = rv
        for line in resp.iter_lines():
            if stop.is_set():
                resp.close()
                return last_rv
            if not line:
                continue
            evt = json.loads(line)
            etype, obj = evt.get("type"), evt.get("object") or {}
            if etype == "BOOKMARK":
                continue
            if etype == "ERROR":  # expired rv -> relist
                raise _WatchExpired(str(obj.get("message") or obj))
            obj.setdefault("kind", kind)
            seen = (obj.get("metadata") or {}).get("resourceVersion")
            if seen:
                last_rv = seen
            (fan or self._fan)(etype, obj)
        return last_rv

    def _fan(self, etype: str, obj: dict) -> None:
        if self._cache_reads:
            self._cache_apply(etype, obj)
            from kubeflow_rm_tpu_torch.controlplane import metrics
            kind = obj.get("kind")
            if kind:
                metrics.INFORMER_EVENTS_TOTAL.labels(kind=kind).inc()
            metrics.INFORMER_LAST_EVENT_TIMESTAMP.set(time.time())
        for w in list(self._watchers):
            try:
                w(etype, obj, None)
            except Exception:
                log.exception("watcher failed on %s %s", etype,
                              obj.get("kind"))


def _discard_unless_finalized(cache, kind: str, name: str,
                              namespace: str | None) -> None:
    """The optimistic removal from the store after a DELETE verb, unless
    the stored object carries finalizers: the server only marks such an
    object, and its own watch events (MODIFIED with a deletionTimestamp,
    then DELETED) bring the store along. JAX discards it anyway; when
    that MODIFIED has already arrived, no newer event restores the
    entry, and the controller that must release the finalizer reads
    NotFound — the object is never finalized (C14)."""
    ref = cache.get_ref(kind, name, namespace)
    if ref is None or not (ref.get("metadata") or {}).get("finalizers"):
        cache.discard(kind, name, namespace)


def strategic_patch_for(current: dict, desired: dict) -> dict:
    """Helper for callers migrating from in-memory ``patch`` semantics:
    the in-memory server applies ``strategic_merge`` locally; against a
    real apiserver we send merge-patch, which matches for the object
    shapes this platform writes (maps + whole-list replacement)."""
    return strategic_merge(current, desired)


# ---- shard-aware router ----------------------------------------------
# kinds replicated to EVERY shard instead of hashed: cluster-wide RBAC
# must be visible to whichever shard evaluates a SubjectAccessReview
# for its namespaces, and CRDs describe the schema every shard serves
BROADCAST_KINDS = frozenset(
    {"ClusterRole", "ClusterRoleBinding", "CustomResourceDefinition"})

def _is_transient(e: Exception) -> bool:
    # transport-level failures worth a routed retry: the shard is
    # restarting (connection refused while it replays its WAL) or just
    # restarted (every pooled keep-alive socket reset at once)
    import http.client
    return isinstance(e, (http.client.HTTPException, OSError)) \
        and not isinstance(e, Invalid)


class ShardedKubeAPIServer:
    """One ``KubeAPIServer``-shaped client over N apiserver shards.

    Routing: a namespaced object's NAMESPACE (a cluster-scoped
    object's name) hashes onto the consistent ring — one shard owns
    every object of a namespace, so per-object rv ordering, Conflict
    semantics, quota, and the profile→namespace→children chain all
    stay single-shard properties. ``BROADCAST_KINDS`` replicate to all
    shards. Cluster-wide lists fan out and merge.

    Retry-with-remap: a write hitting a restarting shard retries with
    backoff inside ``retry_window_s``, re-resolving the ring each
    attempt (the pooled stale sockets are dropped by ``_FastSession``'s
    fresh-dial retry; the window covers WAL replay + rebind time).

    Watch aggregation: ``watch_kind`` runs one list+stream loop PER
    SHARD and merges events into one subscription feeding the
    router-level ``ObjectStore`` and the registered watchers. Each
    shard's resourceVersion sequence is tracked independently (per-
    shard rv bookkeeping) — no global ordering exists or is claimed;
    per-OBJECT ordering holds because an object lives on exactly one
    shard. A shard's stream death falls back to a per-shard relist
    that synthesizes DELETEDs for that shard's vanished objects only.
    """

    def __init__(self, shard_urls: dict[str, str], *,
                 identity: str | None = None,
                 qps: float | None = None, burst: int | None = None,
                 retry_window_s: float = 10.0,
                 clock: Callable[[], datetime.datetime] | None = None):
        from kubeflow_rm_tpu_torch.controlplane import metrics
        from kubeflow_rm_tpu_torch.controlplane.cache.store import ObjectStore
        from kubeflow_rm_tpu_torch.controlplane.shard.ring import HashRing
        if not shard_urls:
            raise Invalid("ShardedKubeAPIServer needs >= 1 shard url")
        self.shard_urls = dict(shard_urls)
        self.ring = HashRing(list(self.shard_urls))
        self.retry_window_s = retry_window_s
        self.identity = identity
        self._qps, self._burst = qps, burst
        self.clock = clock or (
            lambda: datetime.datetime.now(datetime.timezone.utc))
        # per-shard clients: caches OFF — the router owns the one
        # merged informer store; double-caching would double memory
        # and split rv bookkeeping
        self._clients = {
            name: KubeAPIServer(url, identity=identity, qps=qps,
                                burst=burst, cache_reads=False)
            for name, url in self.shard_urls.items()}
        self.limiter = None
        self._cache_reads = True
        # elastic handoff: predicate over partition keys whose writes
        # are held during the fence-drain-flip window, and the active
        # watch subscriptions (so a topology change can extend them to
        # an added shard)
        self._fence_pred: Callable[[str], bool] | None = None
        self._fence_clear = threading.Event()
        self._fence_clear.set()
        self._watch_specs: list[tuple] = []
        self.cache = ObjectStore(cluster_scoped={
            k for k, (_, _, namespaced) in RESOURCES.items()
            if not namespaced})
        self._watchers: list[Callable[[str, dict, dict | None], None]] = []
        # kind -> set of shards whose initial list completed (the
        # router cache serves a kind once EVERY shard has listed it)
        self._listed: dict[str, set[str]] = {}
        self._listed_lock = make_lock("kubeclient.router_listed")
        metrics.SHARD_RING_MEMBERS.labels(
            shard=metrics.shard_label()).set(len(self.ring))

    # ---- routing -----------------------------------------------------
    @staticmethod
    def _partition_key(kind: str, name: str | None,
                       namespace: str | None) -> str:
        _, _, namespaced = RESOURCES.get(kind, (None, None, True))
        return (namespace if namespaced else name) or ""

    def _client_for(self, kind: str, name: str | None,
                    namespace: str | None) -> "KubeAPIServer":
        key = self._partition_key(kind, name, namespace)
        return self._clients[self.ring.shard_for(key)]

    def shard_of(self, kind: str, name: str | None,
                 namespace: str | None) -> str:
        return self.ring.shard_for(
            self._partition_key(kind, name, namespace))

    # ---- elastic topology (split / merge / pinned migration) ---------
    def fence(self, predicate: Callable[[str], bool]) -> None:
        """Hold writes whose partition key satisfies ``predicate`` (the
        handoff coordinator passes "ownership changes between the old
        and new ring" — a predicate, not a key list, so a namespace
        CREATED during the fence window is held too). The coordinator
        fences the moving range, drains the donor's last WAL tail into
        the recipient, flips the ring, then unfences — an in-flight
        client write lands EITHER before the drain (donor WAL, carried
        by the drain) or after the flip (recipient), never in between.
        Fenced callers wait inside their normal retry window; reads
        served from the merged informer cache are unaffected."""
        self._fence_clear.clear()
        self._fence_pred = predicate

    def unfence(self) -> None:
        self._fence_pred = None
        self._fence_clear.set()

    def set_topology(self, shard_urls: dict[str, str], *,
                     pins: dict[str, str] | None = None) -> None:
        """Atomically adopt a new shard set (and pin map): rebuild the
        ring, keep surviving shards' clients (their pooled sockets and
        per-shard rv bookkeeping stay valid — ports never change),
        build clients for added shards, drop retired ones, and extend
        every active watch subscription to the added shards. Callers
        (the elastic coordinator) flip only AFTER the moving range is
        copied + drained, so routing and data never disagree."""
        from kubeflow_rm_tpu_torch.controlplane import metrics
        from kubeflow_rm_tpu_torch.controlplane.shard.ring import HashRing
        new_urls = dict(shard_urls)
        if not new_urls:
            raise Invalid("set_topology needs >= 1 shard url")
        new_ring = HashRing(list(new_urls), pins=pins)
        added = [n for n in new_urls if n not in self._clients]
        removed = [n for n in self._clients if n not in new_urls]
        clients = dict(self._clients)
        for name in removed:
            clients.pop(name)
        for name in added:
            clients[name] = KubeAPIServer(
                new_urls[name], identity=self.identity, qps=self._qps,
                burst=self._burst, cache_reads=False)
        # one assignment each: every in-flight ``_routed`` attempt
        # resolves against either the old or the new topology — both
        # route correctly for unmoved keys, and moved keys are fenced
        self.shard_urls = new_urls
        self.ring = new_ring
        self._clients = clients
        with self._listed_lock:
            for listed in self._listed.values():
                for name in removed:
                    listed.discard(name)
        # a retired shard's _watch_shard loops notice their name left
        # ``_clients`` and exit; added shards need fresh loops for
        # every live subscription
        for kind, namespace, stop, timeout_s in list(self._watch_specs):
            if stop.is_set():
                continue
            for shard in added:
                threading.Thread(
                    target=self._watch_shard, daemon=True,
                    name=f"router-watch-{kind}-{shard}",
                    args=(shard, kind, namespace, stop,
                          timeout_s)).start()
        metrics.SHARD_RING_MEMBERS.labels(
            shard=metrics.shard_label()).set(len(self.ring))

    def _routed(self, kind: str, name: str | None,
                namespace: str | None, fn: Callable, *,
                lost_reply: dict | None = None):
        """Run ``fn(client)`` against the owning shard, retrying with
        remap on transport failures inside the retry window (a
        restarting shard refuses connections while it replays its
        WAL; it rejoins the ring at the same position).

        ``lost_reply`` maps APIError types to ``handler(client)`` for
        the at-least-once ambiguity: a crashed shard may have
        COMMITTED the verb to its WAL with the reply lost in flight,
        so the retry's AlreadyExists (create) or NotFound (delete) IS
        success. Only consulted after a transport retry — a
        first-attempt conflict is a genuine caller error."""
        deadline = time.monotonic() + self.retry_window_s
        delay = 0.1
        retried = False
        while True:
            pred = self._fence_pred
            if pred is not None and pred(
                    self._partition_key(kind, name, namespace)):
                # handoff fence: this key's range is mid-flip; wait it
                # out (the coordinator unfences within its drain
                # budget) and then resolve against the NEW ring
                self._fence_clear.wait(self.retry_window_s)
            client = self._client_for(kind, name, namespace)
            try:
                return fn(client)
            except APIError as e:
                if retried and lost_reply:
                    for etype, handler in lost_reply.items():
                        if isinstance(e, etype):
                            log.debug(
                                "%s after shard retry: treating as "
                                "lost reply of a committed %s", type(e).
                                __name__, kind)
                            return handler(client)
                raise
            except Exception as e:
                if not _is_transient(e) or time.monotonic() > deadline:
                    raise
                log.debug("shard %s unreachable (%s); retrying",
                          self.shard_of(kind, name, namespace), e)
                time.sleep(delay)
                delay = min(delay * 2, 1.0)
                retried = True

    # ---- wiring ------------------------------------------------------
    def register_admission(self, kind_pattern: str, fn: Callable) -> None:
        log.debug("admission for %s runs inside each shard", kind_pattern)

    def register_validator(self, kind: str, fn: Callable) -> None:
        log.debug("validation for %s runs inside each shard", kind)

    def add_watcher(self, fn: Callable[[str, dict, dict | None], None],
                    name: str | None = None) -> None:
        self._watchers.append(fn)

    def wait_for_sync(self, kinds, timeout: float | None = None) -> bool:
        return self.cache.wait_for_sync(kinds, timeout)

    def _cache_serves(self, kind: str) -> bool:
        return self.cache.is_synced(kind)

    # ---- verbs -------------------------------------------------------
    def create(self, obj: dict) -> dict:
        kind = obj["kind"]
        if kind in BROADCAST_KINDS:
            out = None
            for client in self._clients.values():
                try:
                    res = client.create(obj)
                except AlreadyExists:
                    res = client.get(kind, name_of(obj))
                out = out or res
            self.cache.apply("ADDED", out)
            return out
        out = self._routed(
            kind, name_of(obj), namespace_of(obj),
            lambda c: c.create(obj),
            lost_reply={AlreadyExists: lambda c: c.get(
                kind, name_of(obj), namespace_of(obj))})
        self.cache.apply("ADDED", out)
        return out

    def create_many(self, objs: list[dict]) -> list[dict]:
        if not objs:
            return []
        kind = objs[0]["kind"]
        # one bulk POST per namespace (the collection URL carries the
        # namespace); each namespace lives wholly on one shard
        by_ns: dict[str | None, list[int]] = {}
        for i, o in enumerate(objs):
            by_ns.setdefault(namespace_of(o), []).append(i)
        results: list = [None] * len(objs)
        for _ns, idxs in by_ns.items():
            batch = [objs[i] for i in idxs]

            def one_by_one(c, b=batch):
                # lost-reply replay of a bulk POST: re-create each
                # object individually, absorbing the ones that landed
                outs = []
                for o in b:
                    try:
                        outs.append(c.create(o))
                    except AlreadyExists:
                        outs.append(c.get(kind, name_of(o),
                                          namespace_of(o)))
                return outs

            outs = self._routed(
                kind, name_of(batch[0]), namespace_of(batch[0]),
                lambda c, b=batch: c.create_many(b),
                lost_reply={AlreadyExists: one_by_one})
            for i, out in zip(idxs, outs):
                results[i] = out
                if not (out or {}).get("kind") == "Status":
                    self.cache.apply("ADDED", out)
        return results

    def get(self, kind: str, name: str,
            namespace: str | None = None) -> dict:
        if self._cache_serves(kind):
            obj = self.cache.get_ref(kind, name, namespace)
            if obj is None:
                raise NotFound(f"{kind} {namespace}/{name} not found")
            return fast_deepcopy(obj)
        return self._routed(kind, name, namespace,
                            lambda c: c.get(kind, name, namespace))

    def try_get(self, kind: str, name: str,
                namespace: str | None = None) -> dict | None:
        try:
            return self.get(kind, name, namespace)
        except NotFound:
            return None

    def list(self, kind: str, namespace: str | None = None,
             label_selector: dict | None = None) -> list[dict]:
        if self._cache_serves(kind):
            return [fast_deepcopy(o) for o in
                    self.cache.list_refs(kind, namespace, label_selector)]
        _, _, namespaced = RESOURCES.get(kind, (None, None, True))
        if namespaced and namespace is not None:
            return self._routed(
                kind, None, namespace,
                lambda c: c.list(kind, namespace, label_selector))
        # cluster-wide list: fan out and merge, deduping the broadcast
        # and cluster-scoped kinds by name (every shard holds a copy
        # of e.g. the "kubeflow" Namespace it needs locally)
        merged: dict[tuple, dict] = {}
        for client in self._clients.values():
            for o in client.list(kind, namespace, label_selector):
                merged.setdefault(
                    (namespace_of(o), name_of(o)), o)
        out = list(merged.values())
        out.sort(key=lambda o: (namespace_of(o) or "", name_of(o)))
        return out

    def scan(self, kind: str, namespace: str | None = None) -> list[dict]:
        if self._cache_serves(kind):
            return self.cache.list_refs(kind, namespace)
        return self.list(kind, namespace)

    def update(self, obj: dict) -> dict:
        kind = obj["kind"]
        out = self._routed(kind, name_of(obj), namespace_of(obj),
                           lambda c: c.update(obj))
        self.cache.apply("MODIFIED", out)
        return out

    def patch(self, kind: str, name: str, patch: dict,
              namespace: str | None = None) -> dict:
        out = self._routed(kind, name, namespace,
                           lambda c: c.patch(kind, name, patch, namespace))
        self.cache.apply("MODIFIED", out)
        return out

    def update_status(self, obj: dict) -> dict:
        out = self._routed(obj["kind"], name_of(obj), namespace_of(obj),
                           lambda c: c.update_status(obj))
        self.cache.apply("MODIFIED", out)
        return out

    def delete(self, kind: str, name: str,
               namespace: str | None = None) -> None:
        if kind in BROADCAST_KINDS:
            for client in self._clients.values():
                try:
                    client.delete(kind, name, namespace)
                except NotFound:
                    pass
        else:
            self._routed(kind, name, namespace,
                         lambda c: c.delete(kind, name, namespace),
                         lost_reply={NotFound: lambda c: None})
        _discard_unless_finalized(self.cache, kind, name, namespace)

    def ensure_namespace(self, namespace: str) -> dict:
        return self._routed(
            "Namespace", namespace, None,
            lambda c: c.ensure_namespace(namespace))

    def record_event(self, involved: dict, etype: str, reason: str,
                     message: str) -> dict:
        ns = namespace_of(involved) or "default"
        return self._routed(
            "Event", None, ns,
            lambda c: c.record_event(involved, etype, reason, message))

    def events_for(self, involved: dict) -> list[dict]:
        ns = namespace_of(involved)
        if self._cache_serves("Event"):
            return [fast_deepcopy(e) for e in self.cache.events_for_ref(
                involved["kind"], name_of(involved), ns)]
        return self._routed("Event", None, ns or "default",
                            lambda c: c.events_for(involved))

    def pod_logs(self, namespace: str, pod_name: str,
                 tail_lines: int | None = None) -> str:
        return self._routed(
            "Pod", pod_name, namespace,
            lambda c: c.pod_logs(namespace, pod_name, tail_lines))

    def access_review(self, user: str | None, verb: str, resource: str,
                      namespace: str | None = None) -> bool:
        return self._routed(
            "Namespace" if namespace is None else "Pod",
            namespace or "", namespace,
            lambda c: c.access_review(user, verb, resource, namespace))

    # ---- cross-shard watch aggregation -------------------------------
    def watch_kind(self, kind: str, namespace: str | None = None,
                   stop: threading.Event | None = None,
                   timeout_s: int = 300) -> None:
        """Merged subscription: one list+stream loop per shard, all
        feeding the router store + watchers. Blocks until ``stop``."""
        stop = stop or threading.Event()
        self._watch_specs.append((kind, namespace, stop, timeout_s))
        threads = [
            threading.Thread(
                target=self._watch_shard, daemon=True,
                name=f"router-watch-{kind}-{shard}",
                args=(shard, kind, namespace, stop, timeout_s))
            for shard in self._clients]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def _watch_shard(self, shard: str, kind: str,
                     namespace: str | None, stop: threading.Event,
                     timeout_s: int) -> None:
        fan = self._shard_fan(shard)
        rv: str | None = None
        while not stop.is_set():
            client = self._clients.get(shard)
            if client is None:
                return  # shard retired by a merge: subscription over
            try:
                if rv is None:
                    items, rv = client._list_raw(kind, namespace)
                    self._merge_shard_list(shard, kind, items)
                rv = client._stream(kind, namespace, rv, stop,
                                    timeout_s, fan=fan)
            except (NotFound, Invalid):
                raise  # misconfigured kind: crash loudly
            except _WatchExpired as e:
                log.info("watch %s@%s: %s; relisting", kind, shard, e)
                rv = None
            except Exception as e:
                # shard down (restarting): relist once it's back so
                # deletes that raced the outage aren't missed
                log.debug("watch %s@%s: %s; retrying", kind, shard, e)
                rv = None
                stop.wait(1.0)

    def _merge_shard_list(self, shard: str, kind: str,
                          items: list[dict]) -> None:
        """Fold one shard's (re)list into the merged store: upsert
        everything listed (rv-guarded), synthesize DELETED for THIS
        shard's entries that vanished while its watch was down, and
        mark the kind synced once every shard has listed."""
        present = set()
        for item in items:
            present.add(self.cache.key_for(
                kind, name_of(item), namespace_of(item)))
        stale = [
            ref for ref in self.cache.list_refs(kind)
            if self.cache.key_for(kind, name_of(ref), namespace_of(ref))
            not in present
            and kind not in BROADCAST_KINDS
            and self.shard_of(kind, name_of(ref),
                              namespace_of(ref)) == shard]
        fan = self._shard_fan(shard)
        for ref in stale:
            fan("DELETED", fast_deepcopy(ref))
        for item in items:
            fan("ADDED", item)
        with self._listed_lock:
            listed = self._listed.setdefault(kind, set())
            listed.add(shard)
            synced = listed >= set(self._clients)
        # outside the listed map's lock: the store's lock ranks below it
        # (JAX marks the kind under it, a downhill edge: C13)
        if synced:
            self.cache.mark_synced(kind)

    def _shard_fan(self, shard: str) -> Callable[[str, dict], None]:
        def fan(etype: str, obj: dict) -> None:
            from kubeflow_rm_tpu_torch.controlplane import metrics
            kind_f = obj.get("kind")
            if shard not in self._clients:
                return  # retired by a merge: its tail of events is void
            if kind_f and kind_f not in BROADCAST_KINDS and \
                    self.shard_of(kind_f, name_of(obj),
                                  namespace_of(obj)) != shard:
                # ownership filter: a shard may hold objects the ring
                # puts elsewhere (a Node registered with its own
                # cluster), and after an elastic flip the donor still
                # holds (and may relist, update or delete) stale copies
                # of moved objects — an event about a key from a shard
                # that does not own it must not touch the merged cache,
                # or a moved object could be resurrected or deleted out
                # from under its new owner
                return
            self.cache.apply(etype, obj)
            kind = obj.get("kind")
            if kind:
                metrics.INFORMER_EVENTS_TOTAL.labels(kind=kind).inc()
            metrics.INFORMER_LAST_EVENT_TIMESTAMP.set(time.time())
            for w in list(self._watchers):
                try:
                    w(etype, obj, None)
                except Exception:
                    log.exception("router watcher failed on %s %s",
                                  etype, kind)
        return fan
