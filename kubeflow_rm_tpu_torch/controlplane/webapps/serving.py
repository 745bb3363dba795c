"""Multi-tenant serving gateway over the continuous-batching engine
(counterpart of ``kubeflow_rm_tpu/controlplane/webapps/serving.py``).

The engine (``models.generate.ContinuousBatchingEngine``) admits and
retires requests at token boundaries; this module puts a tenant-aware
front door on it so that one tenant's storm cannot blow another's p95.

Admission control, in order (the first failure sheds the request before
it touches the engine):

1. **Request rate** — a per-tenant ``TokenBucket.try_acquire(1)``: an
   over-rate request is shed with 429 at once instead of queueing into
   everyone else's latency.
2. **Token budget** — a second per-tenant bucket in TOKENS
   (``try_acquire(max_new_tokens)``).
3. **Queue cap** — a bounded engine queue; beyond it, 503.
4. **p95 SLO projection** — shed (503) when the queue-depth-scaled EMA
   of recent service times projects past the tenant's SLO:
   ``(queue/slots + 1) * ema_ms > slo_ms``.

One drain thread a gateway steps the engine. It holds the gateway's lock
across ``engine.step()``, and a step reads its sampled tokens back to
the host, so gateways whose engines share a card take turns on it, as
the reference's do. The thread makes its engine's card the current CUDA
device (a per-thread setting), and every engine call from a caller's
thread (``prefill_chain``, ``adopt_chain``, ``install_chain``) runs on
that card with autograd off.

Everything is observable through ``controlplane.metrics`` (the JAX
series names) and this app's ``/metrics`` and ``/api/metrics``.

API (``make_serving_app``, a standard-library WSGI app): ``POST
/generate {"prompt": [ids...], "tenant"?: "name", "max_new_tokens"?:
n}`` → ``{"tokens": [...], "latency_ms": ...}``; ``GET /healthz``;
``GET /metrics`` (Prometheus text); ``GET /api/metrics`` (the serving
JSON section).
"""

from __future__ import annotations

import contextlib
import http
import json
import threading
import time
from dataclasses import dataclass

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock
from kubeflow_rm_tpu_torch.controlplane import metrics as cp_metrics
from kubeflow_rm_tpu_torch.controlplane import tracing
from kubeflow_rm_tpu_torch.controlplane.deploy.kubeclient import TokenBucket

# torch and the model stack are imported where an engine runs: the web
# apps (``core``) build on this module's WSGI surface, and the control
# plane's processes that serve them import no torch


@dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant admission knobs. ``qps``/``burst`` bound request RATE;
    ``tokens_per_s``/``token_burst`` bound decoded-token SPEND;
    ``slo_p95_ms`` is the latency promise the gateway sheds to keep;
    ``slo_class`` is the engine queue the tenant's requests drain from
    (interactive | batch | best_effort)."""
    qps: float = 20.0
    burst: int = 40
    tokens_per_s: float = 2000.0
    token_burst: int = 4000
    slo_p95_ms: float = 2000.0
    slo_class: str = "interactive"


class ReplicaUnavailable(Exception):
    """The replica gave this request up before finishing it (drain or
    death). The request is NOT failed: the caller (the serving fleet, or
    any retrying client) resubmits it elsewhere and the generation
    resumes from the tokens already produced."""

    def __init__(self, msg: str, tokens_so_far=None):
        super().__init__(msg)
        self.tokens_so_far = list(tokens_so_far or [])


class _Pending:
    """A request in flight: the caller parks on ``event`` while the
    drain thread decodes."""

    __slots__ = ("req", "tenant", "event", "t_submit", "t_done",
                 "trace", "t_submit_epoch", "failed")

    def __init__(self, req, tenant, trace=None):
        self.req = req
        self.tenant = tenant
        self.event = threading.Event()
        self.t_submit = time.monotonic()
        self.t_done = None
        # set when the replica abandons the request (drain/close) before
        # the engine finishes it: wait() then raises ReplicaUnavailable
        self.failed = False
        # traceparent of the admitting request, if it carried one; spans
        # use wall time, hence the epoch twin of t_submit
        self.trace = trace
        self.t_submit_epoch = time.time()


def engine_context(engine):
    """The context every engine call runs in: autograd off, and on a CUDA
    engine its card as the current device (both are per thread)."""
    import torch

    stack = contextlib.ExitStack()
    stack.enter_context(torch.no_grad())
    if engine.device.type == "cuda":
        stack.enter_context(torch.cuda.device(engine.device))
    return stack


class ServingGateway:
    """Admission control and a drain loop around one decode engine.

    ``admission=False`` turns checks 1, 2 and 4 off (the noisy-neighbour
    baseline: everything is admitted). The queue cap stays on in both
    arms: an unbounded queue is an OOM, not a policy.
    """

    def __init__(self, engine, *, policies: dict | None = None,
                 default_policy: TenantPolicy | None = None,
                 max_queue: int = 64, admission: bool = True,
                 clock=None):
        self.engine = engine
        self.policies = dict(policies or {})
        self.default_policy = default_policy or TenantPolicy()
        self.max_queue = max_queue
        self.admission = admission
        self._clock = clock or time.monotonic
        self._lock = make_lock("serving.gateway")  # engine + pending
        self._rate_buckets: dict[str, TokenBucket] = {}
        self._token_buckets: dict[str, TokenBucket] = {}
        self._pending: list[_Pending] = []
        # per-tenant latency windows for p95 reporting, the EMA the SLO
        # projection sheds on, and each tenant's slowest traced request
        self._lat_windows: dict[str, list[float]] = {}
        self._exemplars: dict[str, dict] = {}
        self._ema_ms: float | None = None
        self.shed_counts: dict[str, int] = {}
        self.draining = False
        self._stop = threading.Event()
        cp_metrics.SERVING_SLOT_CAPACITY.set(engine.slots)
        self._thread = threading.Thread(target=self._drain, daemon=True,
                                        name="serving-gateway-drain")
        self._thread.start()

    # -- policy plumbing ---------------------------------------------------

    def _policy(self, tenant: str) -> TenantPolicy:
        return self.policies.get(tenant, self.default_policy)

    def _buckets(self, tenant: str) -> tuple[TokenBucket, TokenBucket]:
        if tenant not in self._rate_buckets:
            pol = self._policy(tenant)
            self._rate_buckets[tenant] = TokenBucket(
                pol.qps, pol.burst, clock=self._clock)
            self._token_buckets[tenant] = TokenBucket(
                pol.tokens_per_s, pol.token_burst, clock=self._clock)
        return self._rate_buckets[tenant], self._token_buckets[tenant]

    # -- admission ---------------------------------------------------------

    def _shed(self, tenant: str, reason: str, span) -> tuple[None, str]:
        cp_metrics.SERVING_SHED_TOTAL.labels(tenant, reason).inc()
        cp_metrics.SERVING_REQUESTS_TOTAL.labels(tenant, "shed").inc()
        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1
        span.set_attr("shed", reason)
        return None, reason

    def try_submit(self, tenant: str, prompt: list[int], *,
                   max_new_tokens: int, eos_id: int | None = None,
                   slo_class: str | None = None,
                   speculative: bool = False, chain=None
                   ) -> tuple[_Pending | None, str | None]:
        """Admit or shed: (pending, None) on admit, (None, reason) on
        shed, reason one of rate|tokens|queue|slo|draining. ``slo_class``
        overrides the tenant policy's engine queue. ``chain`` is an
        exported prefix chain (a prefill replica's or the global
        store's): the engine seats it through ``install_chain`` and skips
        prefill. ``speculative`` takes the fused speculative path
        (batch/best_effort only). A request the engine cannot hold
        raises ``ValueError``."""
        pol = self._policy(tenant)
        trace = tracing.current_traceparent()
        with tracing.start_span_if_active(
                "serving.admit", attrs={"tenant": tenant}) as sp:
            if self.draining:
                return self._shed(tenant, "draining", sp)
            if self.admission:
                rate, budget = self._buckets(tenant)
                if not rate.try_acquire(1.0):
                    return self._shed(tenant, "rate", sp)
                if not budget.try_acquire(float(max_new_tokens)):
                    return self._shed(tenant, "tokens", sp)
            with self._lock:
                # re-checked under the lock: a drain or close that began
                # after the check above must not let this request enqueue
                # onto a stopping replica (never drained, never failed)
                if self.draining:
                    return self._shed(tenant, "draining", sp)
                depth = self.engine.queue_depth
                if depth >= self.max_queue:
                    return self._shed(tenant, "queue", sp)
                if self.admission and self._ema_ms is not None:
                    projected = (depth / self.engine.slots + 1.0) \
                        * self._ema_ms
                    if projected > pol.slo_p95_ms:
                        return self._shed(tenant, "slo", sp)
                with engine_context(self.engine):
                    if chain is not None:
                        req = self.engine.install_chain(
                            chain, max_new_tokens=max_new_tokens,
                            eos_id=eos_id,
                            slo_class=slo_class or pol.slo_class)
                    else:
                        req = self.engine.submit(
                            prompt, max_new_tokens=max_new_tokens,
                            eos_id=eos_id,
                            slo_class=slo_class or pol.slo_class,
                            speculative=speculative)
                pending = _Pending(req, tenant, trace=trace)
                self._pending.append(pending)
                cp_metrics.SERVING_QUEUE_DEPTH.set(self.engine.queue_depth)
        return pending, None

    # -- disaggregated-serving surface -------------------------------------
    # A prefill replica runs ``prefill_chain`` (compute and export, no
    # decode slot); decode replicas ``adopt_chain`` (seat a store-served
    # chain in the local pool) or install one per request through
    # ``try_submit(chain=...)``. All hold the gateway lock: they touch the
    # engine the drain thread steps.

    def prefill_chain(self, prompt: list[int]):
        """Prefill into cache blocks and export the chain
        (``models.paging.export_chain``). None when draining, not paged,
        or the pool is too full to hold it."""
        with self._lock:
            if self.draining or not self.engine.paged:
                return None
            with engine_context(self.engine):
                return self.engine.prefill_chain(prompt)

    def adopt_chain(self, chain) -> int:
        """Seat an exported chain in the local block pool (no request).
        Returns the blocks imported (0: already local, pool full, or
        draining)."""
        with self._lock:
            if self.draining or not self.engine.paged:
                return 0
            with engine_context(self.engine):
                return self.engine.adopt_chain(chain)

    def chain_coverage(self, prompt: list[int]) -> int:
        """Tokens of ``prompt`` the local prefix blocks already cover."""
        with self._lock:
            if not self.engine.paged:
                return 0
            return self.engine.chain_coverage(prompt)

    def wait(self, pending: _Pending, timeout_s: float = 300.0
             ) -> list[int]:
        if not pending.event.wait(timeout_s):
            raise TimeoutError("generation timed out")
        if pending.failed and not pending.req.done:
            raise ReplicaUnavailable(
                "replica gave up this request mid-flight "
                "(drain or shutdown) — resubmit elsewhere",
                tokens_so_far=pending.req.tokens)
        lat_s = pending.t_done - pending.t_submit
        tenant = pending.tenant
        cp_metrics.SERVING_REQUESTS_TOTAL.labels(tenant, "ok").inc()
        cp_metrics.SERVING_REQUEST_LATENCY_SECONDS.labels(tenant).observe(
            lat_s)
        cp_metrics.SERVING_GENERATED_TOKENS_TOTAL.labels(tenant).inc(
            len(pending.req.tokens))
        return pending.req.tokens

    # -- drain loop --------------------------------------------------------

    def _publish_engine_locked(self) -> None:
        stats = self.engine.stats()
        cp_metrics.SERVING_QUEUE_DEPTH.set(stats["queue_depth"])
        cp_metrics.SERVING_ACTIVE_SLOTS.set(stats["active_slots"])
        cp_metrics.SERVING_BATCH_OCCUPANCY.set(stats["batch_occupancy"])
        for c, d in stats.get("queue_depth_by_class", {}).items():
            cp_metrics.SERVING_CLASS_QUEUE_DEPTH.labels(c).set(d)
        if stats.get("paged"):
            cp_metrics.SERVING_FREE_BLOCK_FRACTION.set(
                stats["free_block_fraction"])
            if stats.get("prompt_tokens"):
                hr = stats["prefix_hit_ratio"]
                cp_metrics.SERVING_PREFIX_HIT_RATIO.set(hr)
                cp_metrics.SERVING_PREFIX_MISS_RATIO.set(1.0 - hr)

    def _finish(self, p: _Pending, now: float) -> None:
        p.t_done = now
        lat_ms = (p.t_done - p.t_submit) * 1e3
        window = self._lat_windows.setdefault(p.tenant, [])
        window.append(lat_ms)
        del window[:-256]
        self._ema_ms = (lat_ms if self._ema_ms is None else
                        0.8 * self._ema_ms + 0.2 * lat_ms)
        if p.trace is not None:
            # a span measured here, parented on the admitting request so
            # that prefill and decode join its trace
            tracing.record_span(
                "serving.decode", start=p.t_submit_epoch, end=time.time(),
                parent=p.trace,
                attrs={"tenant": p.tenant, "tokens": len(p.req.tokens)})
            ctx = tracing.parse_traceparent(p.trace)
            ex = self._exemplars.get(p.tenant)
            if ctx is not None and (ex is None
                                    or lat_ms > ex["latency_ms"]):
                self._exemplars[p.tenant] = {
                    "trace_id": ctx.trace_id,
                    "latency_ms": round(lat_ms, 3)}
        p.event.set()

    def _drain(self) -> None:
        import torch

        if self.engine.device.type == "cuda":
            torch.cuda.set_device(self.engine.device)
        while not self._stop.is_set():
            ready = []
            with self._lock:
                busy = self.engine.queue_depth or self.engine.active_slots
                if busy:
                    with engine_context(self.engine):
                        finished = self.engine.step()
                    self._publish_engine_locked()
                    if finished:
                        now = time.monotonic()
                        ready = [p for p in self._pending if p.req.done]
                        self._pending = [p for p in self._pending
                                         if not p.req.done]
            for p in ready:
                self._finish(p, now)
            if not busy:
                self._stop.wait(0.001)

    def start_drain(self) -> list[_Pending]:
        """Begin pulling this replica out of rotation: new submits shed
        with reason ``draining`` (healthz flips 503), QUEUED requests
        are evicted and handed back for re-routing (their ``wait``
        raises ``ReplicaUnavailable``), and requests already holding a
        decode slot finish here. Returns the evicted pendings."""
        with self._lock:
            self.draining = True
            evicted_reqs = {id(r) for r in self.engine.evict_queued()}
            evicted = [p for p in self._pending
                       if id(p.req) in evicted_reqs]
            self._pending = [p for p in self._pending
                             if id(p.req) not in evicted_reqs]
            cp_metrics.SERVING_QUEUE_DEPTH.set(self.engine.queue_depth)
        for p in evicted:
            p.failed = True
            p.t_done = time.monotonic()
            p.event.set()
        return evicted

    def close(self) -> None:
        """Stop the drain thread and fail every request still pending (a
        request the engine DID finish stays ok: ``wait`` checks
        ``req.done`` first)."""
        with self._lock:
            # draining first, so a submit racing with close sheds
            # instead of enqueueing onto the stopped drain thread
            self.draining = True
            orphans = list(self._pending)
            self._pending = []
        self._stop.set()
        self._thread.join(timeout=5)
        for p in orphans:
            p.failed = True
            p.t_done = time.monotonic()
            p.event.set()

    # -- observability -----------------------------------------------------

    def tenant_latency(self, tenant: str) -> dict:
        window = sorted(self._lat_windows.get(tenant, []))
        if not window:
            return {"count": 0, "p50_ms": None, "p95_ms": None,
                    "slowest_trace": self._exemplars.get(tenant)}
        return {
            "count": len(window),
            "p50_ms": window[int(0.50 * (len(window) - 1))],
            "p95_ms": window[int(0.95 * (len(window) - 1))],
            # the slowest TRACED request seen for this tenant
            "slowest_trace": self._exemplars.get(tenant),
        }

    def snapshot(self) -> dict:
        stats = self.engine.stats()
        return {
            "admission": self.admission,
            "draining": self.draining,
            "paged": stats.get("paged", False),
            "queue_depth_by_class": stats.get("queue_depth_by_class"),
            "prefix_hit_ratio": stats.get("prefix_hit_ratio"),
            "free_block_fraction": stats.get("free_block_fraction"),
            "cow_forks": stats.get("cow_forks"),
            "queue_depth": stats["queue_depth"],
            "active_slots": stats["active_slots"],
            "slot_capacity": stats["slots"],
            "batch_occupancy": stats["batch_occupancy"],
            "decode_steps": stats["decode_steps"],
            "finished_total": stats["finished_total"],
            "shed": dict(self.shed_counts),
            "ema_service_ms": self._ema_ms,
            "tenants": {t: self.tenant_latency(t)
                        for t in sorted(self._lat_windows)},
        }


# -- the standard-library WSGI surface (shared with serving_fleet) -------

#: every status's reason phrase (the web apps answer 401, 403, 409, 422
#: and 500 beside the gateway's 200/400/404/405/429/503)
REASONS = {s.value: s.phrase for s in http.HTTPStatus}


class HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def respond(start_response, status: int, body, *,
            content_type: str = "application/json", headers=()):
    """Answer a WSGI request: ``body`` is bytes, or JSON-encoded."""
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    start_response(f"{status} {REASONS[status]}",
                   [("Content-Type", content_type),
                    ("Content-Length", str(len(data))), *headers])
    return [data]


def shed_response(start_response, reason: str):
    """A shed request: 429 for the tenant's own rate or budget (back
    off), 503 for replica pressure (retry elsewhere); ``Retry-After``."""
    status = 429 if reason in ("rate", "tokens") else 503
    return respond(start_response, status,
                   {"error": "shed", "reason": reason},
                   headers=[("Retry-After", "1")])


def read_json(environ):
    """The request body as JSON, whatever its content type."""
    try:
        n = int(environ.get("CONTENT_LENGTH") or 0)
    except ValueError:
        raise HTTPError(400, "bad Content-Length") from None
    raw = environ["wsgi.input"].read(n) if n > 0 else b""
    try:
        return json.loads(raw)
    except ValueError as e:
        raise HTTPError(400, f"body is not JSON: {e}") from None


def require_method(environ, method: str) -> None:
    if environ.get("REQUEST_METHOD", "GET") != method:
        raise HTTPError(405, f"use {method}")


def parse_generate(body, cfg) -> dict:
    """The fields of a ``/generate`` body that both front doors share,
    checked as the JAX apps check them (400 on any)."""
    from kubeflow_rm_tpu_torch.models.generate import SLO_CLASSES

    if not isinstance(body, dict):
        raise HTTPError(400, "body must be a JSON object")
    prompt = body.get("prompt")
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) and 0 <= t < cfg.vocab_size
                       for t in prompt)):
        raise HTTPError(400, "prompt must be a non-empty list of token "
                             f"ids in [0, {cfg.vocab_size})")
    max_new = body.get("max_new_tokens", 16)
    if not isinstance(max_new, int) or not 1 <= max_new <= 4096:
        raise HTTPError(400, "max_new_tokens must be an int in [1, 4096]")
    slo_class = body.get("slo_class")
    if slo_class is not None and slo_class not in SLO_CLASSES:
        raise HTTPError(400, "slo_class must be one of "
                             "interactive|batch|best_effort")
    speculative = body.get("speculative", False)
    if not isinstance(speculative, bool):
        raise HTTPError(400, "speculative must be a bool")
    return dict(prompt=prompt, max_new_tokens=max_new, slo_class=slo_class,
                speculative=speculative)


def tenant_of(body: dict, environ) -> str:
    return body.get("tenant") or environ.get("HTTP_X_TENANT") or "default"


def make_serving_app(gateway: ServingGateway, cfg):
    """The tenant-facing WSGI app over a gateway (standard library only).

    Requests carry a ``tenant`` field (or an ``X-Tenant`` header); sheds
    map to 429 (the tenant's rate or budget) or 503 (the gateway's queue,
    SLO or drain); a request the engine cannot hold is a 400.
    """

    def app(environ, start_response):
        # a request with a trace context joins its caller's trace
        # (admission and the parked wait happen inside; the drain thread
        # stamps the decode span)
        if tracing.enabled():
            parent = tracing.parse_traceparent(
                environ.get("HTTP_TRACEPARENT"))
            if parent is not None:
                with tracing.start_span(
                        f"{environ.get('REQUEST_METHOD', 'GET')} "
                        f"{environ.get('PATH_INFO', '/')}",
                        kind="server", parent=parent,
                        attrs={"component": "serving"}):
                    return _app_inner(environ, start_response)
        return _app_inner(environ, start_response)

    def _app_inner(environ, start_response):
        path = environ.get("PATH_INFO", "")
        try:
            if path == "/healthz":
                # a draining replica fails its health check BEFORE its
                # queue is severed, so routers stop sending new work
                # while in-flight requests still finish here
                if gateway.draining:
                    return respond(start_response, 503,
                                   {"ok": False, "state": "draining"})
                return respond(start_response, 200,
                               {"ok": True, "state": "ready"})
            if path == "/metrics":
                return respond(start_response, 200, cp_metrics.scrape(),
                               content_type="text/plain; version=0.0.4")
            if path == "/api/metrics":
                return respond(start_response, 200,
                               {"serving": gateway.snapshot()})
            if path != "/generate":
                raise HTTPError(404, f"no route {path}")
            require_method(environ, "POST")
            body = read_json(environ)
            req = parse_generate(body, cfg)
            tenant = tenant_of(body, environ)
            if not isinstance(tenant, str) or len(tenant) > 64:
                raise HTTPError(400, "tenant must be a short string")
            eos_id = body.get("eos_id")
            if eos_id is not None and not isinstance(eos_id, int):
                raise HTTPError(400, "eos_id must be an int")
            try:
                pending, reason = gateway.try_submit(
                    tenant, req["prompt"],
                    max_new_tokens=req["max_new_tokens"], eos_id=eos_id,
                    slo_class=req["slo_class"],
                    speculative=req["speculative"])
            except ValueError as e:   # the request cannot fit a slot
                raise HTTPError(400, str(e)) from None
            if pending is None:
                return shed_response(start_response, reason)
            tokens = gateway.wait(pending)
            lat_ms = (pending.t_done - pending.t_submit) * 1e3
            return respond(start_response, 200,
                           {"tokens": tokens, "latency_ms": lat_ms})
        except HTTPError as e:
            return respond(start_response, e.status, {"error": str(e)})

    app.gateway = gateway
    return app
