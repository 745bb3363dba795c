"""HTTPS admission server: AdmissionReview v1 in, JSONPatch out.

The reference runs two admission processes — the PodDefault webhook's
plain net/http server (``admission-webhook/main.go:755-773``) and the
ODH notebook webhook inside controller-runtime's webhook server
(``odh-notebook-controller/main.go:107-150``). This server wraps the
SAME three webhook classes the in-memory apiserver chains
(``webhook/notebook.py``, ``webhook/poddefault.py``,
``webhook/gpu_inject.py``) behind kube's AdmissionReview v1 protocol:

- ``POST /mutate-notebook`` — NotebookWebhook (lock/image/CA/oauth +
  no-restart guard)
- ``POST /mutate-pod``      — PodDefaultWebhook then GpuInjectWebhook,
  in that order (PodDefault merge first, so the slice's rendezvous env wins
  conflicts — the same order ``make_control_plane`` registers them)
- ``POST /convert``         — apiextensions ConversionReview for the
  multi-version Notebook CRD (``api/conversion.py``; the reference's
  ``api/*/notebook_conversion.go`` equivalents)

The mutation is returned as an RFC 6902 JSONPatch computed by diffing
the incoming object against the webhook chain's output, exactly how
controller-runtime's admission.PatchResponse works. ``AdmissionDenied``
becomes ``allowed: false`` with the message in ``status``.

TLS: pass ``certfile``/``keyfile`` (mounted from the webhook Secret in
the manifests); without them the server is plain HTTP for tests.

(The port's copy of
``kubeflow_rm_tpu/controlplane/deploy/webhook_server.py``: the pod chain
ends in the port's card-slice injector, and :meth:`WebhookServer.stop`
also releases the listening socket, so a server restarted on the same
port binds at once.)
"""

from __future__ import annotations

import base64
import copy
import http.server
import json
import logging
import ssl
import threading

from kubeflow_rm_tpu_torch.controlplane.apiserver import AdmissionDenied

log = logging.getLogger("kubeflow_rm_tpu_torch.webhook")


# ---- RFC 6902 diff ---------------------------------------------------

def _escape(token: str) -> str:
    return token.replace("~", "~0").replace("/", "~1")


def json_patch(old, new, path: str = "") -> list[dict]:
    """Minimal JSONPatch diff: replace/add/remove on dict keys, whole-
    value replace on list or scalar changes. Lists are replaced
    wholesale — admission mutations append containers/env/volumes, and
    whole-list replace is both correct and what kube applies
    atomically."""
    if type(old) is not type(new):
        return [{"op": "replace", "path": path or "/", "value": new}]
    if isinstance(old, dict):
        ops: list[dict] = []
        for k in old:
            if k not in new:
                ops.append({"op": "remove",
                            "path": f"{path}/{_escape(k)}"})
            elif old[k] != new[k]:
                ops.extend(json_patch(old[k], new[k],
                                      f"{path}/{_escape(k)}"))
        for k in new:
            if k not in old:
                ops.append({"op": "add", "path": f"{path}/{_escape(k)}",
                            "value": new[k]})
        return ops
    if old != new:
        return [{"op": "replace", "path": path or "/", "value": new}]
    return []


# ---- AdmissionReview handling ----------------------------------------

class AdmissionHandler:
    """One path -> ordered chain of webhook callables
    (``fn(op, obj, old) -> mutated | None``)."""

    def __init__(self, chains: dict[str, list]):
        self.chains = chains

    def review(self, path: str, review: dict) -> dict:
        request = review.get("request") or {}
        uid = request.get("uid", "")
        op = request.get("operation", "CREATE")
        obj = request.get("object") or {}
        old = request.get("oldObject") or None
        response: dict = {"uid": uid, "allowed": True}
        try:
            mutated = copy.deepcopy(obj)
            for hook in self.chains.get(path, []):
                out = hook(op, mutated, old)
                if out is not None:
                    mutated = out
            ops = json_patch(obj, mutated)
            if ops:
                response["patchType"] = "JSONPatch"
                response["patch"] = base64.b64encode(
                    json.dumps(ops).encode()).decode()
        except AdmissionDenied as e:
            response["allowed"] = False
            response["status"] = {"code": 403, "message": str(e)}
        except Exception as e:  # fail closed, surface the reason
            log.exception("webhook %s failed", path)
            response["allowed"] = False
            response["status"] = {"code": 500, "message": str(e)}
        return {"apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview", "response": response}


class WebhookServer:
    """Serves AdmissionHandler over HTTP(S) with /healthz + /readyz."""

    def __init__(self, handler: AdmissionHandler, *, port: int = 8443,
                 certfile: str | None = None, keyfile: str | None = None):
        self.handler = handler
        self.port = port
        self.certfile, self.keyfile = certfile, keyfile
        self._httpd: http.server.ThreadingHTTPServer | None = None

    def start(self) -> int:
        """Bind and serve in a daemon thread; returns the bound port."""
        handler = self.handler

        class H(http.server.BaseHTTPRequestHandler):
            def _send(self, code: int, body: dict):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802
                if self.path in ("/healthz", "/readyz"):
                    self._send(200, {"ok": True})
                else:
                    self._send(404, {"error": "not found"})

            def do_POST(self):  # noqa: N802
                length = int(self.headers.get("Content-Length", "0"))
                try:
                    review = json.loads(self.rfile.read(length))
                except Exception:
                    log.warning("rejecting undecodable AdmissionReview",
                                exc_info=True)
                    self._send(400, {"error": "bad AdmissionReview"})
                    return
                if self.path == "/convert":
                    # apiextensions ConversionReview (multi-version
                    # CRDs; strategy: Webhook in the Notebook CRD)
                    from kubeflow_rm_tpu_torch.controlplane.api import (
                        conversion,
                    )
                    convert_review = conversion.convert_review
                    self._send(200, convert_review(review))
                    return
                if self.path not in handler.chains:
                    self._send(404, {"error": f"no webhook at "
                                              f"{self.path}"})
                    return
                self._send(200, handler.review(self.path, review))

            def log_message(self, *a):  # quiet
                pass

        self._httpd = http.server.ThreadingHTTPServer(
            ("0.0.0.0", self.port), H)
        if self.certfile:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(self.certfile, self.keyfile)
            self._httpd.socket = ctx.wrap_socket(
                self._httpd.socket, server_side=True)
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self._httpd.server_address[1]

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()


def make_admission_handler(api) -> AdmissionHandler:
    """The production chain wiring (same order as
    ``make_control_plane``): Notebook mutations on /mutate-notebook,
    Pod mutations on /mutate-pod."""
    from kubeflow_rm_tpu_torch.controlplane.webhook.notebook import (
        NotebookWebhook,
    )
    from kubeflow_rm_tpu_torch.controlplane.webhook.poddefault import (
        PodDefaultWebhook,
    )
    from kubeflow_rm_tpu_torch.controlplane.webhook.gpu_inject import (
        GpuInjectWebhook,
    )
    return AdmissionHandler({
        "/mutate-notebook": [NotebookWebhook(api)],
        "/mutate-pod": [PodDefaultWebhook(api), GpuInjectWebhook(api)],
    })
