"""Shared pieces of the serving-fleet parity tests
(``tests/test_torch_serving*.py``, ``test_torch_chain_transfer.py``,
``test_torch_lockgraph.py``): the tiny model in both packages on the same
numpy-seeded weights, the smoke's ``StepGate`` (it holds a replica's
engine at a chosen step, so a kill lands mid-flight without any sleep;
it works on either package's gateway, both of which step their engine
under ``gw._lock``), and an in-process WSGI call for either package's
app.
"""

from __future__ import annotations

import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import StepGate  # noqa: F401 - re-exported for the tests
from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu_torch.models import llama as tllama
from kubeflow_rm_tpu_torch.models.params import from_numpy_params

JOIN_S = 120.0      # every join and wait is bounded by this


def numpy_weights(seed: int = 0) -> dict:
    """The tiny Llama's tree drawn by ``numpy.random.default_rng(seed)``:
    each leaf a normal of the scale JAX's initializer gives it (norm
    scales, which JAX sets to one, stay one)."""
    cfg = jllama.LlamaConfig.tiny()
    ref = jax.tree.map(np.asarray,
                       jllama.init_params(cfg, jax.random.key(0)))
    rng = np.random.default_rng(seed)

    def draw(x):
        std = float(x.std())
        if std == 0.0:
            return x.copy()
        return (rng.standard_normal(x.shape) * std).astype(x.dtype)

    return jax.tree.map(draw, ref)


def both_models(seed: int = 0):
    """(jcfg, jparams, tcfg, tparams) on the same numpy weights."""
    tree = numpy_weights(seed)
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jax.tree.map(jnp.asarray, tree)
    tcfg = tllama.LlamaConfig.tiny()
    tparams = from_numpy_params(tree, tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


def solo_jax(jparams, jcfg, prompt, n, max_len):
    from kubeflow_rm_tpu.models.generate import generate_fused

    out = generate_fused(jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                         max_new_tokens=n, max_len=max_len)
    return np.asarray(out)[0, len(prompt):].tolist()


def solo_torch(tparams, tcfg, prompt, n, max_len):
    from kubeflow_rm_tpu_torch.models.generate import generate_fused

    out = generate_fused(tparams, tcfg,
                         torch.tensor([prompt], dtype=torch.int32),
                         max_new_tokens=n, max_len=max_len)
    return out[0, len(prompt):].tolist()


def start_all(fns) -> list[threading.Thread]:
    ts = [threading.Thread(target=f) for f in fns]
    for t in ts:
        t.start()
    return ts


def join_all(ts) -> None:
    for t in ts:
        t.join(JOIN_S)
        assert not t.is_alive(), "a request thread hung"


def wsgi(app, method: str, path: str, body=None, headers=None):
    """Call a WSGI ``app`` in process: (status, headers, body bytes)."""
    data = (body if isinstance(body, bytes) else
            b"" if body is None else json.dumps(body).encode())
    environ = {
        "REQUEST_METHOD": method, "PATH_INFO": path,
        "CONTENT_LENGTH": str(len(data)),
        "CONTENT_TYPE": "application/json",
        "wsgi.input": io.BytesIO(data), "wsgi.errors": io.StringIO(),
        "wsgi.url_scheme": "http", "wsgi.version": (1, 0),
        "wsgi.multithread": True, "wsgi.multiprocess": False,
        "wsgi.run_once": False,
        "SERVER_NAME": "localhost", "SERVER_PORT": "80",
        "SERVER_PROTOCOL": "HTTP/1.1", "QUERY_STRING": "",
        "SCRIPT_NAME": "",
    }
    for k, v in (headers or {}).items():
        environ["HTTP_" + k.upper().replace("-", "_")] = v
    got = {}

    def start_response(status, hdrs, exc_info=None):
        got["status"] = int(status.split()[0])
        got["headers"] = dict(hdrs)

    out = b"".join(app(environ, start_response))
    return got["status"], got["headers"], out


def wsgi_json(app, method, path, body=None, headers=None):
    """(status, decoded JSON body or None) of ``wsgi``."""
    status, _, out = wsgi(app, method, path, body, headers)
    try:
        return status, json.loads(out)
    except ValueError:
        return status, None
