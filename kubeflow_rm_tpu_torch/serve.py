"""Serve a Llama over HTTP (counterpart of ``examples/serve_llama.py``).

A small WSGI server around ``generate_fused``, written against the
standard library only (``json``, ``wsgiref``): the same API and the
same 400 rules as the JAX example, without werkzeug.

- **Micro-batching.** Requests arriving within a batching window are
  left-padded into one ``generate_fused`` call — decode is bound by
  weight bytes, so more rows per step cost little.
- **Shape buckets.** Prompts pad up to power-of-two lengths and the
  batch up to a power-of-two row count, and ``max_new_tokens`` is fixed
  by the server.
- **Token ids in/out.** ``POST /generate {"prompt": [ids...],
  "temperature"?: t, "top_k"?: k}`` -> ``{"tokens": [ids...]}``;
  ``GET /healthz``. Temperature snaps to a 0.05 grid and top_k to a
  small allowed set, as in the JAX server. With a server-side tokenizer
  (``--hf-tokenizer``, or ``make_app(tokenizer=...)``) a client may send
  ``{"text": ...}`` and gets ``"text"`` back beside the tokens.
- **Quantized weights** (``--int8``, ``--int4``): weight-only
  ``quantize_params`` after load. ``make_app`` unpacks packed int4 to
  int8 groups once, at construction (``unpack_int4_params``), so no
  request pays for it; each decode step then dequantizes the int8.
- **Checkpoints** (``--hf-model DIR``): a local directory that
  ``save_pretrained`` wrote, read by ``models.convert.load_hf_dir``;
  without it the weights are random from a fixed seed.

- **Speculative decoding** (``--speculative``). A solo greedy request
  runs unpadded, at its exact length, and a prompt longer than
  ``LOOKUP_N`` goes through ``generate_speculative_fused`` (repetitive
  text decodes in fewer model calls); ``app.stats`` counts them. Every
  other request keeps the batched path.

- **Mesh** (``--tp``, ``--fsdp``; ``make_app(..., mesh=)``): under
  torchrun every rank holds its shards (``shard_params``); rank 0
  serves HTTP and broadcasts each batch (``broadcast_object_list``),
  every rank runs the sharded ``make_generate_step``, and rank 0
  answers (the other ranks run ``follow``). Batches are padded to a
  multiple of the mesh's dp·fsdp rows. ``--speculative`` is
  single-device only: on a mesh it warns and the fused path serves.

    torchrun --nproc-per-node 2 -m kubeflow_rm_tpu_torch.serve \
        --preset llama2_7b --tp 2

    python -m kubeflow_rm_tpu_torch.serve --preset llama2_7b --port 8000
    python -m kubeflow_rm_tpu_torch.serve --preset tiny --device cpu --selftest
    python -m kubeflow_rm_tpu_torch.serve --preset tiny --device cpu \
        --speculative --selftest
    python -m kubeflow_rm_tpu_torch.serve --preset tiny --device cpu \
        --int4 --selftest
    python -m kubeflow_rm_tpu_torch.serve --hf-model ./llama-dir --int8 \
        --hf-tokenizer ./llama-dir
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import queue
import socketserver
import sys
import threading
import time
from dataclasses import replace
from wsgiref.simple_server import WSGIServer, make_server

import numpy as np
import torch

# top_k values the API serves; requests snap to the nearest member
TOP_K_CHOICES = (1, 5, 10, 20, 50, 100)
# n-gram length of the speculative decoder's prompt lookup
LOOKUP_N = 3
# distinct exact lengths a solo request may run at before it is bucketed
# like the rest (the JAX server's bound on compiled programs)
EXACT_LENS_MAX = 16

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 500: "Internal Server Error"}


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class Batcher:
    """Collects concurrent generate requests into padded batches.

    One background thread drains the queue: it waits for the first
    request, then up to ``window_ms`` for more (at most ``max_batch``,
    same sampling parameters), left-pads the prompts with ``pad_id``
    into the smallest power-of-two length bucket, and runs ONE
    generation for the batch. Each waiter gets its row back, trimmed of
    padding.

    ``exact_solo``: a lone greedy request runs at its exact length (no
    padding), for the speculative decoder, whose lookup reads the
    prompt as given — for at most ``EXACT_LENS_MAX`` distinct lengths,
    the JAX server's bound; past it, solo requests are bucketed too.
    """

    def __init__(self, step_fn, *, pad_id: int = 0, window_ms: float = 5.0,
                 max_batch: int = 8, exact_solo: bool = False,
                 rows_multiple: int = 1):
        # step_fn: (ids (B,T) int32, pad_counts (B,) int32, temperature,
        #           top_k) -> (B, T+new)
        self.step_fn = step_fn
        self.pad_id = pad_id
        self.window_ms = window_ms
        self.max_batch = max_batch
        self.exact_solo = exact_solo
        # a sharded batch must divide the mesh's data axes: the batch is
        # bucketed in units of this many rows (dummy rows fill it)
        self.rows_multiple = rows_multiple
        self._exact_lens: set[int] = set()
        self.q: queue.Queue = queue.Queue()
        self.batches_run = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, prompt: list[int], temperature: float = 0.0,
               top_k: int | None = None) -> list[int]:
        """Blocking: returns prompt + continuation token ids."""
        if self._stop.is_set():
            raise RuntimeError("batcher is closed")
        done = threading.Event()
        box: dict = {"prompt": prompt, "temperature": temperature,
                     "top_k": top_k, "done": done}
        self.q.put(box)
        # wake periodically: a request queued behind close() would
        # otherwise wait forever for a drain thread that has exited
        while not done.wait(timeout=1.0):
            if self._stop.is_set() and not self._thread.is_alive():
                if done.is_set():
                    break
                raise RuntimeError("batcher closed with request pending")
        if "error" in box:
            raise RuntimeError(box["error"])
        return box["result"]

    def close(self):
        self._stop.set()
        self.q.put(None)
        self._thread.join(timeout=5)
        while True:
            try:
                box = self.q.get_nowait()
            except queue.Empty:
                break
            if box is not None:
                box["error"] = "batcher closed"
                box["done"].set()

    def _run(self):
        while not self._stop.is_set():
            first = self.q.get()
            if first is None:
                continue
            batch = [first]
            deadline = time.monotonic() + self.window_ms / 1e3
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self.q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    break
                if (nxt["temperature"] == first["temperature"]
                        and nxt["top_k"] == first["top_k"]):
                    batch.append(nxt)
                else:
                    self.q.put(nxt)
                    break
            # everything per batch lives under try: a failed batch must
            # fail its waiters, never kill this thread
            try:
                lens = [len(b["prompt"]) for b in batch]
                if (self.exact_solo and len(batch) == 1
                        and first["temperature"] <= 0
                        and (lens[0] in self._exact_lens
                             or len(self._exact_lens) < EXACT_LENS_MAX)):
                    self._exact_lens.add(lens[0])
                    T = lens[0]
                else:
                    T = _bucket(max(lens))
                units = -(-len(batch) // self.rows_multiple)
                B = _bucket(units, lo=1) * self.rows_multiple
                ids = np.full((B, T), self.pad_id, np.int32)
                for i, b in enumerate(batch):
                    ids[i, T - lens[i]:] = b["prompt"]   # left-pad
                for i in range(len(batch), B):           # dummy rows
                    ids[i] = ids[0]
                pads = np.asarray([T - n for n in lens]
                                  + [T - lens[0]] * (B - len(batch)),
                                  np.int32)
                out = np.asarray(self.step_fn(
                    ids, pads, first["temperature"], first["top_k"]))
                self.batches_run += 1
                for i, b in enumerate(batch):
                    b["result"] = out[i, T - lens[i]:].tolist()
                    b["done"].set()
            except Exception as e:  # noqa: BLE001 - reported to every waiter
                for b in batch:
                    b["error"] = repr(e)
                    b["done"].set()


class _HTTPError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def _parse_request(body: bytes, cfg, max_new_tokens: int, tokenizer=None):
    """Validate a /generate body -> (prompt, temperature, top_k), or
    raise ``_HTTPError(400)`` — the JAX server's rules. With a
    ``tokenizer``, ``{"text": ...}`` is encoded into the prompt."""
    try:
        req = json.loads(body)
    except (ValueError, UnicodeDecodeError):
        raise _HTTPError(400, "body must be JSON") from None
    if not isinstance(req, dict):
        raise _HTTPError(400, "body must be a JSON object")
    if tokenizer is not None and "text" in req:
        if not isinstance(req["text"], str):
            raise _HTTPError(400, "text must be a string")
        prompt = list(tokenizer.encode(req["text"]))
    else:
        prompt = req.get("prompt")
    if (not isinstance(prompt, list) or not prompt
            or not all(isinstance(t, int) and 0 <= t < cfg.vocab_size
                       for t in prompt)):
        raise _HTTPError(400, "prompt must be a non-empty list of token "
                              f"ids in [0, {cfg.vocab_size}) (or pass "
                              "text with a server-side tokenizer)")
    if len(prompt) > cfg.max_seq_len - max_new_tokens:
        raise _HTTPError(400, f"prompt too long ({len(prompt)}); limit "
                              f"{cfg.max_seq_len - max_new_tokens}")
    temp = req.get("temperature", 0.0)
    if not isinstance(temp, (int, float)) or not 0 <= temp <= 10:
        raise _HTTPError(400, "temperature must be a number in [0, 10]")
    temp = round(float(temp) * 20) / 20
    top_k = req.get("top_k")
    if top_k is not None and (not isinstance(top_k, int)
                              or not 1 <= top_k <= cfg.vocab_size):
        raise _HTTPError(400, f"top_k must be an int in [1, "
                              f"{cfg.vocab_size}]")
    if top_k is not None:
        choices = [c for c in TOP_K_CHOICES if c <= cfg.vocab_size] or [1]
        top_k = min(choices, key=lambda c: abs(c - top_k))
    return prompt, temp, top_k


def _mesh_generate(cfg, params, mesh, max_new_tokens: int, device):
    """``run(ids, pad_counts, temperature, top_k, seed) -> tokens`` on a
    mesh: the sharded generation every rank runs for one batch (the
    sampler seeded alike on every rank)."""
    from kubeflow_rm_tpu_torch.models.generate import make_generate_step

    def run(ids, pad_counts, temperature, top_k, seed):
        step = make_generate_step(
            params, cfg, mesh, max_new_tokens=max_new_tokens,
            total_len=ids.shape[1] + max_new_tokens,
            temperature=temperature, top_k=top_k)
        gen = None
        if temperature > 0:
            gen = torch.Generator(device=device).manual_seed(seed)
        with (torch.cuda.device(device) if device.type == "cuda"
              else contextlib.nullcontext()):
            out = step(params, torch.from_numpy(ids).to(device), gen,
                       torch.from_numpy(pad_counts).to(device))
        return out.cpu().numpy()

    return run


def _local_device(device) -> torch.device:
    """``device`` with the card's index made explicit (the batcher thread
    does not inherit the main thread's current card)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def follow(cfg, params, mesh, *, max_new_tokens: int = 64,
           device: str | torch.device | None = None) -> int:
    """A non-zero rank of a mesh server: run every batch rank 0
    broadcasts, until it closes. ``params`` is the global tree or this
    rank's (sliced here as ``make_app`` does; local leaves pass
    through). Returns the number of batches run."""
    import torch.distributed as dist

    from kubeflow_rm_tpu_torch.device import default_device
    from kubeflow_rm_tpu_torch.parallel.sharding import shard_params

    device = _local_device(default_device(device))
    run = _mesh_generate(cfg, shard_params(params, mesh), mesh,
                         max_new_tokens, device)
    n = 0
    while True:
        msg = [None]
        dist.broadcast_object_list(msg, src=0)
        if msg[0] is None:
            return n
        run(*msg[0])
        n += 1


def make_app(cfg, params, *, max_new_tokens: int = 64,
             window_ms: float = 5.0, max_batch: int = 8,
             speculative: bool = False, tokenizer=None,
             device: str | torch.device | None = None, mesh=None):
    """WSGI app + its Batcher (``app.batcher``) and counters
    (``app.stats``), serving ``params`` on ``device`` (the card unless
    told otherwise). ``speculative`` routes solo, greedy, unpadded
    requests with a prompt longer than ``LOOKUP_N`` through
    ``generate_speculative_fused``. ``tokenizer`` (``encode``/``decode``)
    lets clients send text. Packed-int4 weights are unpacked once, here
    (the app serves the unpacked tree). Sampled requests draw from one
    ``torch.Generator`` with a non-deterministic seed; only the batcher
    thread uses it.

    ``mesh``: rank 0's app over the global ``params`` or rank 0's slices
    (``shard_params``: local leaves pass through); each batch is
    broadcast to the other ranks, which run ``follow``.
    Packed int4 stays packed on a mesh (each step dequantizes it).
    ``app.close()`` stops the batcher and releases the followers."""
    from kubeflow_rm_tpu_torch.device import default_device
    from kubeflow_rm_tpu_torch.models.generate import (
        generate_fused, generate_speculative_fused,
    )
    from kubeflow_rm_tpu_torch.models.quantize import unpack_int4_params

    device = default_device(device)
    if mesh is not None:
        device = _local_device(device)
    sampler = torch.Generator(device=device)
    sampler.seed()
    app_stats = {"speculative_requests": 0}
    rows = 1
    if mesh is None:
        params = unpack_int4_params(params)
    else:
        import torch.distributed as dist

        from kubeflow_rm_tpu_torch.parallel.mesh import axis_size
        from kubeflow_rm_tpu_torch.parallel.sharding import shard_params

        if speculative:
            print("warning: --speculative is single-device only "
                  "(batch-1 lookup decoding); sharded requests take "
                  "the fused path", flush=True)
            speculative = False
        rows = axis_size(mesh, ("dp", "fsdp"))
        run = _mesh_generate(cfg, shard_params(params, mesh), mesh,
                             max_new_tokens, device)

        def mesh_step(ids, pad_counts, temperature, top_k):
            # every rank runs this batch, its sampler seeded alike
            seed = int(torch.randint(0, 2**62, (), generator=sampler,
                                     device=device))
            msg = [(ids, pad_counts, temperature, top_k, seed)]
            dist.broadcast_object_list(msg, src=0)
            return run(*msg[0])

    def step_fn(ids, pad_counts, temperature, top_k):
        B, T = ids.shape
        if (speculative and B == 1 and temperature <= 0
                and int(pad_counts[0]) == 0 and T > LOOKUP_N):
            app_stats["speculative_requests"] += 1
            out = generate_speculative_fused(
                params, cfg, torch.from_numpy(ids).to(device),
                max_new_tokens=max_new_tokens, lookup_n=LOOKUP_N)
            return out.cpu().numpy()
        out = generate_fused(
            params, cfg, torch.from_numpy(ids).to(device),
            max_new_tokens=max_new_tokens,
            generator=sampler if temperature > 0 else None,
            temperature=temperature, top_k=top_k, max_len=T + max_new_tokens,
            pad_counts=torch.from_numpy(pad_counts).to(device))
        return out.cpu().numpy()

    batcher = Batcher(mesh_step if mesh is not None else step_fn,
                      window_ms=window_ms, max_batch=max_batch,
                      exact_solo=speculative, rows_multiple=rows)

    def close():
        batcher.close()
        if mesh is not None:
            dist.broadcast_object_list([None], src=0)

    def respond(start_response, status: int, payload: dict):
        data = json.dumps(payload).encode()
        start_response(f"{status} {_REASONS[status]}",
                       [("Content-Type", "application/json"),
                        ("Content-Length", str(len(data)))])
        return [data]

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "")
        method = environ.get("REQUEST_METHOD", "GET")
        try:
            if path == "/healthz":
                return respond(start_response, 200, {"ok": True})
            if path != "/generate":
                raise _HTTPError(404, f"no route {path}")
            if method != "POST":
                raise _HTTPError(405, "use POST /generate")
            try:
                n = int(environ.get("CONTENT_LENGTH") or 0)
            except ValueError:
                raise _HTTPError(400, "bad Content-Length") from None
            body = environ["wsgi.input"].read(n) if n > 0 else b""
            prompt, temp, top_k = _parse_request(body, cfg, max_new_tokens,
                                                 tokenizer)
            try:
                tokens = batcher.submit(prompt, temp, top_k)
            except RuntimeError as e:
                raise _HTTPError(500, str(e)) from None
            out = {"tokens": tokens}
            if tokenizer is not None:
                try:  # HF tokenizers: strip <s>/</s> markers
                    out["text"] = tokenizer.decode(
                        tokens, skip_special_tokens=True)
                except TypeError:  # minimal tokenizers
                    out["text"] = tokenizer.decode(tokens)
            return respond(start_response, 200, out)
        except _HTTPError as e:
            return respond(start_response, e.status, {"error": str(e)})

    app.batcher = batcher
    app.stats = app_stats
    app.close = close
    return app


def request(app, method: str, path: str, body=None) -> tuple[int, dict]:
    """Call ``app`` in-process as a WSGI server would: returns
    (status, decoded JSON). ``body`` is JSON-encoded unless it is
    bytes."""
    data = body if isinstance(body, bytes) else (
        b"" if body is None else json.dumps(body).encode())
    environ = {
        "REQUEST_METHOD": method, "PATH_INFO": path,
        "CONTENT_LENGTH": str(len(data)),
        "CONTENT_TYPE": "application/json",
        "wsgi.input": io.BytesIO(data),
        "SERVER_NAME": "localhost", "SERVER_PORT": "0",
        "wsgi.url_scheme": "http",
    }
    status = []

    def start_response(s, headers):
        status.append(int(s.split()[0]))

    payload = b"".join(app(environ, start_response))
    return status[0], json.loads(payload)


class _ThreadingWSGIServer(socketserver.ThreadingMixIn, WSGIServer):
    daemon_threads = True


def main(argv=None) -> int:
    from kubeflow_rm_tpu_torch.device import default_device
    from kubeflow_rm_tpu_torch.models.convert import load_hf_dir
    from kubeflow_rm_tpu_torch.models import init_params
    from kubeflow_rm_tpu_torch.models.llama import PRESETS, LlamaConfig
    from kubeflow_rm_tpu_torch.models.quantize import (
        init_params_quantized, quantize_params,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tiny", choices=PRESETS)
    ap.add_argument("--hf-model", default=None, metavar="DIR",
                    help="local directory written by save_pretrained "
                         "(config.json + safetensors or .bin weights); "
                         "default: random weights of --preset")
    quant = ap.add_mutually_exclusive_group()
    quant.add_argument("--int8", action="store_true",
                       help="weight-only int8 quantize before serving")
    quant.add_argument("--int4", action="store_true",
                       help="weight-only int4 quantize with per-group "
                            "scales (served unpacked to int8 groups)")
    ap.add_argument("--hf-tokenizer", default=None,
                    help="HF tokenizer id or path (needs transformers): "
                         'lets clients pass {"text": ...} and get text '
                         "back")
    ap.add_argument("--max-new-tokens", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--speculative", action="store_true",
                    help="route solo greedy requests through the "
                         "prompt-lookup speculative decoder")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--fsdp", type=int, default=0,
                    help="0 = world // tp (one process: no mesh unless "
                         "--tp/--fsdp ask for one)")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the host)")
    ap.add_argument("--selftest", action="store_true",
                    help="serve in-process, run one round trip, exit")
    args = ap.parse_args(argv)

    from kubeflow_rm_tpu_torch.parallel import distributed
    from kubeflow_rm_tpu_torch.parallel.mesh import MeshConfig, make_mesh
    from kubeflow_rm_tpu_torch.parallel.sharding import shard_params

    distributed.initialize(device=args.device)
    device = default_device(args.device)
    world = distributed.world_size()
    mesh = None
    if world > 1 or args.tp > 1 or args.fsdp > 1:
        fsdp = args.fsdp or max(1, world // args.tp)
        mesh = make_mesh(MeshConfig(fsdp=fsdp, tp=args.tp), device)
    # weights are stored in the compute dtype: serving never trains, and
    # an fp32 copy would re-cast every weight on every decode step. On a
    # mesh every rank holds only its slices: drawn weights are cut as
    # they are drawn, a checkpoint is read into host memory and each
    # rank takes its slices to the card
    bits = 4 if args.int4 else 8 if args.int8 else None
    if args.hf_model:
        cfg, params = load_hf_dir(
            args.hf_model, device=device if mesh is None else "cpu",
            param_dtype=LlamaConfig.dtype)
    else:
        cfg, params = getattr(LlamaConfig, args.preset)(), None
    cfg = replace(cfg, param_dtype=cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(0)
    if params is None and bits:
        params = init_params_quantized(cfg, gen, device, bits=bits,
                                       mesh=mesh)
    else:
        if params is None:
            params = init_params(cfg, gen, device, mesh=mesh)
        if bits:
            params = quantize_params(params, bits=bits)
        if mesh is not None:
            params = shard_params(params, mesh, device)

    tokenizer = None
    if args.hf_tokenizer:
        from transformers import AutoTokenizer
        tokenizer = AutoTokenizer.from_pretrained(args.hf_tokenizer)
        if len(tokenizer) > cfg.vocab_size:
            print(f"warning: tokenizer vocab ({len(tokenizer)}) exceeds "
                  f"model vocab_size ({cfg.vocab_size}) — text requests "
                  "producing out-of-range ids will be rejected",
                  flush=True)

    if distributed.rank() != 0:
        n = follow(cfg, params, mesh, max_new_tokens=args.max_new_tokens,
                   device=device)
        print(f"rank {distributed.rank()}: {n} batch(es) run", flush=True)
        return 0
    app = make_app(cfg, params, max_new_tokens=args.max_new_tokens,
                   max_batch=args.max_batch,
                   speculative=args.speculative, tokenizer=tokenizer,
                   device=device, mesh=mesh)
    del params      # the app holds its own tree (int4 unpacked, or shards)

    if args.selftest:
        status, out = request(app, "POST", "/generate",
                              {"prompt": [1, 2, 3]})
        app.close()
        if status != 200 or len(out["tokens"]) != 3 + args.max_new_tokens:
            print(f"selftest failed: {status} {out}", file=sys.stderr)
            return 1
        print(f"selftest ok: {len(out['tokens'])} tokens, "
              f"{app.batcher.batches_run} batch(es) on {device}")
        return 0

    httpd = make_server("0.0.0.0", args.port, app,
                        server_class=_ThreadingWSGIServer)
    print(f"serving {args.preset} on :{args.port} ({device})", flush=True)
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        app.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
