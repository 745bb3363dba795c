"""Shared web-app kit — the ``crud_backend`` library of this framework
(the port's copy of ``kubeflow_rm_tpu/controlplane/webapps/core.py``).

The reference factors authn/authz/CSRF/probes/error envelopes into a
Flask library every web app builds on
(``crud-web-apps/common/backend/kubeflow/kubeflow/crud_backend/__init__.py:16-35``).
This is the same factoring on the standard library's WSGI alone (the
card's machine has no werkzeug), over the port's WSGI surface
(:mod:`.serving`: ``HTTPError``, ``respond``), talking to the apiserver
through the verb surface a kubernetes client would offer:

- **authn** (``authn.py:12-67``): identity arrives as a trusted
  ``kubeflow-userid`` header stamped by the mesh's auth proxy; the
  optional prefix (``:``) is stripped. Routes opt out with
  ``no_auth=True``; ``disable_auth`` handles dev mode.
- **authz** (``authz.py:101-133``): every mutating/list route declares
  the k8s verb+resource it performs; the app submits an access review
  to the apiserver (SubjectAccessReview equivalent) and 403s with the
  reference's message shape.
- **CSRF** (``csrf.py``): double-submit cookie — index sets a random
  ``XSRF-TOKEN`` cookie, unsafe methods must echo it in
  ``X-XSRF-TOKEN``; GET/HEAD/OPTIONS/TRACE are exempt.
- **probes** (``probes.py``): ``/healthz`` + ``/readyz``.
- **envelopes** (``api/utils.py:7-30``): ``{"status", "success",
  "user", <data_field>}`` on success, ``{"success": False, "log",
  "status", "user"}`` on failure — the Angular frontends key on these.

The router is werkzeug's grammar cut to what the apps use: a rule is a
path whose ``<name>`` parts each match one non-empty path segment and
whose ``<path:name>`` parts match one or more segments, slashes
included, with its own methods (HEAD rides on GET); no rule gives 404
and a rule without the request's method 405, each with werkzeug's stock
text as the envelope's ``log``. A query parameter is the first of its
values.
"""

from __future__ import annotations

import json
import logging
import os
import re
import secrets
import time
import traceback
from typing import Any, Callable
from urllib.parse import parse_qs

from kubeflow_rm_tpu_torch.controlplane import tracing
from kubeflow_rm_tpu_torch.controlplane.apiserver import (
    AdmissionDenied, AlreadyExists, APIServer, Invalid, NotFound,
)
from kubeflow_rm_tpu_torch.controlplane.webapps.serving import (
    HTTPError, respond,
)

log = logging.getLogger("kubeflow_rm_tpu_torch.webapps")

USER_HEADER = "kubeflow-userid"
USER_PREFIX = ":"
CSRF_COOKIE = "XSRF-TOKEN"
CSRF_HEADER = "X-XSRF-TOKEN"
SAFE_METHODS = ("GET", "HEAD", "OPTIONS", "TRACE")

#: werkzeug's descriptions of a missing route and a wrong method, which
#: the failure envelope carries as its ``log``
NOT_FOUND_TEXT = ("The requested URL was not found on the server. If you "
                  "entered the URL manually please check your spelling "
                  "and try again.")
METHOD_NOT_ALLOWED_TEXT = "The method is not allowed for the requested URL."

JSON_TYPE = "application/json"
TEXT_TYPE = "text/plain; charset=utf-8"


class Request:
    """One WSGI request: ``method``, ``path``, ``headers.get(name)``,
    ``args.get(name)`` (the first value), ``cookies`` and
    :meth:`get_data`."""

    def __init__(self, environ: dict):
        self.environ = environ
        self.method = environ.get("REQUEST_METHOD", "GET").upper()
        self.path = environ.get("PATH_INFO") or "/"
        self.headers = _Headers(environ)
        self.args = _Args(parse_qs(environ.get("QUERY_STRING", ""),
                                   keep_blank_values=True))
        self.cookies = _parse_cookies(environ.get("HTTP_COOKIE", ""))
        self._data: bytes | None = None

    def get_data(self, as_text: bool = False):
        if self._data is None:
            try:
                n = int(self.environ.get("CONTENT_LENGTH") or 0)
            except ValueError:
                n = 0
            stream = self.environ.get("wsgi.input")
            self._data = stream.read(n) if n > 0 and stream else b""
        return self._data.decode("utf-8", "replace") if as_text \
            else self._data


class _Headers:
    def __init__(self, environ: dict):
        self._environ = environ

    def get(self, name: str, default=None):
        key = name.upper().replace("-", "_")
        if key not in ("CONTENT_TYPE", "CONTENT_LENGTH"):
            key = "HTTP_" + key
        return self._environ.get(key, default)


class _Args:
    def __init__(self, values: dict[str, list[str]]):
        self._values = values

    def get(self, name: str, default=None):
        got = self._values.get(name)
        return got[0] if got else default


def _parse_cookies(header: str) -> dict[str, str]:
    out: dict[str, str] = {}
    for part in header.split(";"):
        name, eq, value = part.strip().partition("=")
        if not eq or not name:
            continue
        value = value.strip()
        if len(value) >= 2 and value[0] == value[-1] == '"':
            value = value[1:-1]
        out.setdefault(name.strip(), value)
    return out


class Response:
    """A handler's own response: a body (bytes or text), a status, a
    content type and extra headers (``Set-Cookie`` among them)."""

    def __init__(self, body, status: int = 200, *,
                 content_type: str = JSON_TYPE):
        self.body = body if isinstance(body, bytes) else str(body).encode()
        self.status = status
        self.content_type = content_type
        self.headers: list[tuple[str, str]] = []

    def __call__(self, environ, start_response):
        body = b"" if environ.get("REQUEST_METHOD") == "HEAD" else self.body
        return respond(start_response, self.status, body,
                       content_type=self.content_type, headers=self.headers)


#: what a ``<name>`` and a ``<path:name>`` part of a rule match
_CONVERTERS = {None: "[^/]+", "path": "[^/].*?"}


class _Rule:
    __slots__ = ("rule", "pattern", "methods", "endpoint")

    def __init__(self, rule: str, methods, endpoint: str):
        self.rule = rule
        regex, at = "", 0
        for m in re.finditer(r"<(?:(path):)?(\w+)>", rule):
            regex += (re.escape(rule[at:m.start()])
                      + f"(?P<{m[2]}>{_CONVERTERS[m[1]]})")
            at = m.end()
        self.pattern = re.compile(regex + re.escape(rule[at:]) + r"\Z")
        self.methods = {m.upper() for m in methods}
        if "GET" in self.methods:
            self.methods.add("HEAD")
        self.endpoint = endpoint


class WebApp:
    """A WSGI app with the crud_backend request pipeline.

    Handlers take ``(req, **url_params)`` and return a dict (JSON
    envelope added), a :class:`Response`, or ``(dict, status)``.
    """

    def __init__(self, name: str, api: APIServer, *, prefix: str = "",
                 disable_auth: bool = False, secure_cookies: bool = True,
                 user_header: str = USER_HEADER,
                 user_prefix: str = USER_PREFIX,
                 authz_cache_ttl: float | None = None):
        self.name = name
        self.api = api
        self.prefix = prefix.rstrip("/")
        self.disable_auth = disable_auth
        self.secure_cookies = secure_cookies
        self.user_header = user_header
        self.user_prefix = user_prefix
        # SubjectAccessReview decision cache: kube-apiserver's webhook
        # authorizer caches decisions (allow 5 min / deny 30 s by
        # default); a short symmetric TTL here keeps a polling SPA from
        # turning every status refresh into a live SAR round-trip.
        # Env override KFRM_AUTHZ_CACHE_TTL; 0 disables (tests that
        # flip RBAC mid-flight want instant effect).
        if authz_cache_ttl is None:
            authz_cache_ttl = float(
                os.environ.get("KFRM_AUTHZ_CACHE_TTL", "2.0"))
        self.authz_cache_ttl = authz_cache_ttl
        self._authz_cache: dict[tuple, tuple[bool, float]] = {}
        self._rules: list[_Rule] = []
        self._handlers: dict[str, Callable] = {}
        self._no_auth: set[str] = set()
        self._no_csrf: set[str] = set()
        self.route("/healthz", no_auth=True, no_csrf=True)(_healthz)
        self.route("/readyz", no_auth=True, no_csrf=True)(_healthz)
        self.route("/metrics", no_auth=True, no_csrf=True)(_metrics)

    # ---- routing -----------------------------------------------------
    def route(self, rule: str, methods=("GET",), *, no_auth: bool = False,
              no_csrf: bool = False):
        def deco(fn):
            endpoint = f"{fn.__module__}.{fn.__qualname__}:{rule}"
            self._rules.append(_Rule(self.prefix + rule, methods, endpoint))
            self._handlers[endpoint] = fn
            if no_auth:
                self._no_auth.add(endpoint)
            if no_csrf:
                self._no_csrf.add(endpoint)
            return fn
        return deco

    def _match(self, method: str, path: str) -> tuple[str, dict]:
        wrong_method = False
        for rule in self._rules:
            m = rule.pattern.match(path)
            if m is None:
                continue
            if method in rule.methods:
                return rule.endpoint, m.groupdict()
            wrong_method = True
        if wrong_method:
            raise HTTPError(405, METHOD_NOT_ALLOWED_TEXT)
        raise HTTPError(404, NOT_FOUND_TEXT)

    # ---- identity ----------------------------------------------------
    def username(self, req: Request) -> str | None:
        raw = req.headers.get(self.user_header)
        if raw is None:
            return None
        if raw.startswith(self.user_prefix):
            raw = raw[len(self.user_prefix):]
        return raw

    def ensure_authorized(self, req: Request, verb: str, resource: str,
                          namespace: str | None = None) -> None:
        if self.disable_auth:
            return
        user = self.username(req)
        if user is None:
            raise HTTPError(401, "No user credentials were found!")
        if not self._access_review_cached(user, verb, resource,
                                          namespace):
            msg = f"User '{user}' is not authorized to {verb} {resource}"
            if namespace is not None:
                msg += f" in namespace '{namespace}'"
            raise HTTPError(403, msg)

    def _access_review_cached(self, user: str, verb: str, resource: str,
                              namespace: str | None) -> bool:
        if self.authz_cache_ttl <= 0:
            return self.api.access_review(user, verb, resource, namespace)
        key = (user, verb, resource, namespace)
        hit = self._authz_cache.get(key)
        now = time.monotonic()
        if hit is not None and hit[1] > now:
            return hit[0]
        allowed = self.api.access_review(user, verb, resource, namespace)
        self._authz_cache[key] = (allowed, now + self.authz_cache_ttl)
        if len(self._authz_cache) > 4096:  # bound a hostile user sweep
            # snapshot first: other server threads insert concurrently
            self._authz_cache = {k: v for k, v in
                                 list(self._authz_cache.items())
                                 if v[1] > now}
        return allowed

    # ---- envelopes ---------------------------------------------------
    def success(self, req: Request, data_field: str | None = None,
                data: Any = None, status: int = 200) -> Response:
        body = {"status": status, "success": True,
                "user": self.username(req)}
        if data_field is not None:
            body[data_field] = data
        return _json_response(body, status)

    def failed(self, req: Request, msg: str, status: int) -> Response:
        body = {"success": False, "log": msg, "status": status,
                "user": self.username(req)}
        return _json_response(body, status)

    # ---- CSRF --------------------------------------------------------
    def set_csrf_cookie(self, resp: Response) -> None:
        """A fresh ``XSRF-TOKEN``: ``SameSite=Strict``, readable by the
        SPA's script (not ``HttpOnly``), ``Secure`` unless
        ``secure_cookies=False``; werkzeug's attribute order."""
        secure = "Secure; " if self.secure_cookies else ""
        resp.headers += [
            ("Set-Cookie", f"{CSRF_COOKIE}={secrets.token_urlsafe(32)}; "
                           f"{secure}Path={self.prefix or '/'}; "
                           "SameSite=Strict"),
            ("Cache-Control",
             "no-cache, no-store, must-revalidate, max-age=0")]

    def _check_csrf(self, req: Request) -> None:
        if req.method in SAFE_METHODS:
            return
        cookie = req.cookies.get(CSRF_COOKIE)
        if cookie is None:
            raise HTTPError(403, f"Could not find CSRF cookie {CSRF_COOKIE} "
                                 "in the request.")
        header = req.headers.get(CSRF_HEADER)
        if header is None:
            raise HTTPError(403, "Could not detect CSRF protection header "
                                 f"{CSRF_HEADER}.")
        if header != cookie:
            raise HTTPError(403, "CSRF check failed. Token in cookie "
                                 f"{CSRF_COOKIE} doesn't match token in "
                                 f"header {CSRF_HEADER}.")

    # ---- WSGI --------------------------------------------------------
    def __call__(self, environ, start_response):
        # server-span boundary for context-bearing requests: a client
        # that sends ``traceparent`` (the conformance harness around a
        # notebook POST) gets the whole handler — auth, CSRF, apiserver
        # writes, downstream kube calls — recorded as one server hop of
        # ITS trace. Header-less traffic takes the plain path.
        if tracing.enabled():
            parent = tracing.parse_traceparent(
                environ.get("HTTP_TRACEPARENT"))
            if parent is not None:
                with tracing.start_span(
                        f"{environ.get('REQUEST_METHOD', 'GET')} "
                        f"{environ.get('PATH_INFO', '/')}",
                        kind="server", parent=parent,
                        attrs={"component": self.name}):
                    return self._call_inner(environ, start_response)
        return self._call_inner(environ, start_response)

    def _call_inner(self, environ, start_response):
        req = Request(environ)
        try:
            endpoint, args = self._match(req.method, req.path)
            if not self.disable_auth and endpoint not in self._no_auth:
                if self.username(req) is None:
                    raise HTTPError(401, "No user detected.")
            if endpoint not in self._no_csrf:
                self._check_csrf(req)
            rv = self._handlers[endpoint](req, **args)
            resp = self._to_response(req, rv)
        except HTTPError as e:
            resp = self.failed(req, str(e), e.status)
        except NotFound as e:
            resp = self.failed(
                req, "The requested resource could not be found in the "
                f"API Server: {e}", 404)
        except AlreadyExists as e:
            resp = self.failed(req, str(e), 409)
        except (Invalid, AdmissionDenied) as e:
            resp = self.failed(req, str(e), 422)
        except Exception as e:
            log.error("unhandled exception on %s: %s\n%s", req.path, e,
                      traceback.format_exc())
            resp = self.failed(req, "An error occured in the backend.", 500)
        return resp(environ, start_response)

    def _to_response(self, req: Request, rv) -> Response:
        if isinstance(rv, Response):
            return rv
        if isinstance(rv, tuple):
            body, status = rv
            return _json_response(body, status)
        if rv is None:
            return self.success(req)
        if isinstance(rv, dict):
            if "success" not in rv:
                rv = {"status": 200, "success": True,
                      "user": self.username(req), **rv}
            return _json_response(rv, rv.get("status", 200))
        raise TypeError(f"handler returned {type(rv)}")

    # ---- testing -----------------------------------------------------
    def test_client(self, user: str | None = "user@example.com"):
        """A client calling this app in process, with identity + CSRF
        pre-wired, the way Istio's auth proxy and the SPA would present
        them. ``client._client`` is the same client without the
        standing headers (its cookie jar still holds the CSRF cookie)."""
        headers = []
        if user is not None:
            headers.append((self.user_header, self.user_prefix + user))
        token = secrets.token_urlsafe(16)
        client = Client(self)
        client.set_cookie(CSRF_COOKIE, token)
        headers.append((CSRF_HEADER, token))
        return _ClientProxy(client, headers)


class TestResponse:
    """What :class:`Client` returns: ``status_code``, ``headers`` (a
    dict; repeated names joined by ``, ``), the body (``data``,
    :meth:`get_data`) and its JSON (``json``, :meth:`get_json`)."""

    __test__ = False  # not a pytest class

    def __init__(self, status: str, headers: list, data: bytes):
        self.status_code = int(status.split(" ", 1)[0])
        self.headers: dict[str, str] = {}
        for k, v in headers:
            self.headers[k] = (f"{self.headers[k]}, {v}" if k in self.headers
                               else v)
        self.data = data

    def get_data(self, as_text: bool = False):
        return self.data.decode() if as_text else self.data

    @property
    def mimetype(self) -> str:
        """The content type without its parameters (werkzeug's)."""
        return self.headers.get("Content-Type", "").split(";")[0].strip()

    def get_json(self):
        return json.loads(self.data)

    @property
    def json(self):
        return self.get_json()


class Client:
    """Calls a WSGI app in process, werkzeug's test client cut to what
    the apps' callers use: ``open(path, method=, data=, headers=)`` (a
    ``?query`` in the path) and a cookie jar that sends every cookie
    and keeps what a response sets."""

    def __init__(self, app):
        self.app = app
        self.cookies: dict[str, str] = {}

    def set_cookie(self, name: str, value: str) -> None:
        self.cookies[name] = value

    def open(self, path: str, method: str = "GET", data=None,
             headers=None) -> TestResponse:
        import io

        body = (data.encode() if isinstance(data, str) else data) or b""
        path, _, query = path.partition("?")
        environ = {
            "REQUEST_METHOD": method.upper(), "SCRIPT_NAME": "",
            "PATH_INFO": path, "QUERY_STRING": query,
            "SERVER_NAME": "localhost", "SERVER_PORT": "80",
            "SERVER_PROTOCOL": "HTTP/1.1", "wsgi.url_scheme": "http",
            "wsgi.input": io.BytesIO(body), "wsgi.errors": io.StringIO(),
            "wsgi.version": (1, 0), "wsgi.multithread": True,
            "wsgi.multiprocess": False, "wsgi.run_once": False,
            "CONTENT_LENGTH": str(len(body)),
        }
        if self.cookies:
            environ["HTTP_COOKIE"] = "; ".join(
                f"{k}={v}" for k, v in self.cookies.items())
        for k, v in headers or []:
            key = k.upper().replace("-", "_")
            if key not in ("CONTENT_TYPE", "CONTENT_LENGTH"):
                key = "HTTP_" + key
            environ[key] = v
        started: list = []

        def start_response(status, response_headers, exc_info=None):
            started[:] = [status, response_headers]

        out = b"".join(self.app(environ, start_response))
        status, response_headers = started
        for k, v in response_headers:
            if k.lower() == "set-cookie":
                name, _, rest = v.partition("=")
                self.cookies[name] = rest.split(";", 1)[0]
        return TestResponse(status, response_headers, out)

    def get(self, *a, **kw):
        return self.open(*a, method="GET", **kw)

    def post(self, *a, **kw):
        return self.open(*a, method="POST", **kw)

    def patch(self, *a, **kw):
        return self.open(*a, method="PATCH", **kw)

    def delete(self, *a, **kw):
        return self.open(*a, method="DELETE", **kw)


class _ClientProxy:
    """Adds standing headers to every request of a :class:`Client`."""

    def __init__(self, client: Client, headers):
        self._client = client
        self._headers = headers

    def open(self, *args, **kwargs):
        headers = list(kwargs.pop("headers", []) or [])
        merged = {k: v for k, v in self._headers}
        for k, v in headers:
            merged[k] = v
        kwargs["headers"] = list(merged.items())
        return self._client.open(*args, **kwargs)

    def get(self, *a, **kw):
        return self.open(*a, method="GET", **kw)

    def post(self, *a, **kw):
        return self.open(*a, method="POST", **kw)

    def patch(self, *a, **kw):
        return self.open(*a, method="PATCH", **kw)

    def delete(self, *a, **kw):
        return self.open(*a, method="DELETE", **kw)


def _json_response(body: dict, status: int = 200) -> Response:
    return Response(json.dumps(body), status)


def _healthz(req: Request):
    return {"status": 200, "success": True, "alive": True}


def _metrics(req: Request):
    """Prometheus exposition (the reference serves :8080/metrics from
    every controller — pkg/metrics/metrics.go, kfam/monitoring.go)."""
    from kubeflow_rm_tpu_torch.controlplane import metrics
    return Response(metrics.scrape(), content_type=TEXT_TYPE)


def json_body(req: Request) -> dict:
    try:
        return json.loads(req.get_data(as_text=True) or "{}")
    except json.JSONDecodeError as e:
        raise HTTPError(400, f"bad JSON body: {e}") from None
