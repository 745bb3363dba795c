"""Rank bodies of the port's multi-process tests (``test_torch_mesh.py``,
``test_torch_sp.py``, ``test_torch_mesh_train.py``).

``start_worlds`` spawns, for each world size, that many processes that join
one gloo process group (a ``file://`` rendezvous in the caller's
directory, so concurrent test workers never share one) and run a list of
cases, each a function of
this module called by name with numpy inputs. Every rank returns its own
results; the test process compares them with the JAX package's sharded
functions on its virtual CPU devices.

This module imports no JAX: ``spawn`` re-imports it in every child.
"""

from __future__ import annotations

import datetime
import os
import pickle
import traceback
from dataclasses import replace

import numpy as np
import torch
import torch.distributed as dist

#: a case whose collective never completes fails after this long
COLLECTIVE_TIMEOUT_S = 120


class Worlds:
    """Gloo worlds running in the background: ``start_worlds`` spawns
    them and returns at once, so the test process can compute its JAX
    references meanwhile; ``results()`` waits for them (once)."""

    def __init__(self, worlds: dict, workdir, timeout: float):
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.worlds, self.workdir, self.timeout = worlds, workdir, timeout
        self._results = None
        saved = os.environ.get("OMP_NUM_THREADS")
        os.environ["OMP_NUM_THREADS"] = "1"
        self.procs = []
        try:
            for n, cases in worlds.items():
                d = f"{workdir}/world{n}"
                os.makedirs(d, exist_ok=True)
                for r in range(n):
                    p = ctx.Process(target=_rank_main,
                                    args=(r, n, f"file://{d}/rendezvous",
                                          cases, d))
                    p.start()
                    self.procs.append(p)
        finally:
            if saved is None:
                del os.environ["OMP_NUM_THREADS"]
            else:
                os.environ["OMP_NUM_THREADS"] = saved

    def results(self) -> dict:
        """``{world size: {case name: [rank 0's result, ...]}}``; a case
        that raised gives ``{"error": traceback}`` on that rank."""
        if self._results is None:
            self._results = self._collect()
        return self._results

    def _collect(self) -> dict:
        for p in self.procs:
            p.join(self.timeout)
        hung = [p.pid for p in self.procs if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        if hung:
            raise RuntimeError(f"rank processes {hung} hung")
        bad = [(p.pid, p.exitcode) for p in self.procs if p.exitcode]
        if bad:
            raise RuntimeError(f"rank processes exited non-zero: {bad}")
        out = {}
        for n, cases in self.worlds.items():
            per_rank = []
            for r in range(n):
                with open(f"{self.workdir}/world{n}/rank{r}.pkl", "rb") as f:
                    per_rank.append(pickle.load(f))
            out[n] = {name: [res[name] for res in per_rank]
                      for name, _, _ in cases}
        return out


def start_worlds(worlds: dict, workdir, timeout: float = 600) -> Worlds:
    """Spawn ``{world size: cases}`` — each case ``(name, function name,
    kwargs)`` — as gloo worlds of those sizes, all at once."""
    return Worlds(worlds, workdir, timeout)


def _rank_main(rank, world, init, cases, workdir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    out = {}
    try:
        for name, fn, kwargs in cases:
            try:
                out[name] = globals()[fn](**kwargs)
            except Exception:  # noqa: BLE001 - reported to the test
                out[name] = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
    with open(f"{workdir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _mesh(**axes):
    from kubeflow_rm_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    return make_mesh(MeshConfig(**{"fsdp": 1, **axes}), device="cpu")


def _gather_global(t: torch.Tensor, spec, mesh) -> np.ndarray:
    from kubeflow_rm_tpu_torch.parallel.sharding import gather_tensor

    return _np(gather_tensor(t.detach().contiguous(), spec, mesh))


# ---------------------------------------------------------------------
# mesh plumbing and collectives
# ---------------------------------------------------------------------

def mesh_layout(axes: dict) -> dict:
    """This rank's coordinates and the groups' sizes and ranks."""
    from kubeflow_rm_tpu_torch.parallel.mesh import (
        AXES, axis_group, axis_index, axis_size, mesh_shape,
    )

    mesh = _mesh(**axes)
    multi = [("dp", "fsdp"), ("dp", "fsdp", "sp")]
    return {
        "shape": mesh_shape(mesh),
        "index": {a: axis_index(mesh, a) for a in AXES},
        "multi_index": {"/".join(m): axis_index(mesh, m) for m in multi},
        "multi_size": {"/".join(m): axis_size(mesh, m) for m in multi},
        "multi_group_size": {"/".join(m): dist.get_world_size(
            axis_group(mesh, m)) for m in multi},
        "multi_group_rank": {"/".join(m): dist.get_rank(
            axis_group(mesh, m)) for m in multi},
    }


def mesh_errors() -> dict:
    """The refusals of ``make_mesh`` / ``make_hybrid_mesh``."""
    from kubeflow_rm_tpu_torch.parallel.mesh import (
        MeshConfig, make_hybrid_mesh, make_mesh,
    )

    out = {}
    for name, fn in (
            ("not_covering", lambda: make_mesh(MeshConfig(fsdp=3),
                                               device="cpu")),
            ("hybrid_dp", lambda: make_hybrid_mesh(
                MeshConfig(dp=1, fsdp=-1), n_slices=2, device="cpu"))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    mesh = make_hybrid_mesh(MeshConfig(dp=-1, fsdp=1), n_slices=2,
                            device="cpu")
    from kubeflow_rm_tpu_torch.parallel.mesh import mesh_shape
    out["hybrid_shape"] = mesh_shape(mesh)
    return out


def collectives(x: np.ndarray, g: np.ndarray) -> dict:
    """Each autograd collective over the world on this rank's row ``x``
    of the (world, ...) inputs, with cotangent ``g``'s row: outputs and
    input gradients."""
    from kubeflow_rm_tpu_torch.parallel import collectives as c

    group = dist.group.WORLD
    r = dist.get_rank()
    out = {}
    ops = {
        "all_gather": lambda t: c.all_gather(t, group, 1),
        "reduce_scatter": lambda t: c.reduce_scatter(t, group, 1),
        "all_reduce": lambda t: c.all_reduce(t, group),
        "copy_to_group": lambda t: c.copy_to_group(t, group),
        "gather_from_group": lambda t: c.gather_from_group(t, group, 1),
        "split_to_group": lambda t: c.split_to_group(t, group, 1),
        "ppermute": lambda t: c.ppermute(t, group, 1),
        "all_to_all": lambda t: c.all_to_all(t, group, 1, 0),
    }
    for name, op in ops.items():
        t = torch.from_numpy(x[r]).clone().requires_grad_(True)
        y = op(t)
        cot = torch.from_numpy(g[r]).reshape(-1)[:y.numel()].reshape(y.shape)
        (y * cot).sum().backward()
        out[name] = {"y": _np(y), "grad": _np(t.grad)}
    return out


# ---------------------------------------------------------------------
# sequence-parallel attention
# ---------------------------------------------------------------------

def sp_attention(kind: str, q, k, v, cot=None, causal: bool = True,
                 segments=None, positions=None) -> dict:
    """``kind`` ("ring", "zigzag", "ulysses") on this rank's contiguous
    chunk of the global (B, T, ...) inputs at sp = world: the local
    output, and with a cotangent the local input gradients."""
    from kubeflow_rm_tpu_torch.parallel.ring_attention import (
        ring_self_attention,
    )
    from kubeflow_rm_tpu_torch.parallel.ulysses import (
        ulysses_self_attention,
    )
    from kubeflow_rm_tpu_torch.parallel.zigzag_ring import (
        zigzag_ring_self_attention,
    )

    n, r = dist.get_world_size(), dist.get_rank()
    mesh = _mesh(sp=n)
    c = q.shape[1] // n
    mine = slice(r * c, (r + 1) * c)
    qs, ks, vs = (torch.from_numpy(np.ascontiguousarray(a[:, mine]))
                  .requires_grad_(cot is not None) for a in (q, k, v))
    kw = {}
    if segments is not None:
        kw["segments"] = torch.from_numpy(np.ascontiguousarray(
            segments[:, mine]))
    if positions is not None:
        kw["positions"] = torch.from_numpy(np.ascontiguousarray(
            positions[:, mine]))
    fn = {"ring": ring_self_attention, "zigzag": zigzag_ring_self_attention,
          "ulysses": ulysses_self_attention}[kind]
    try:
        out = fn(qs, ks, vs, mesh, causal=causal, **kw)
    except ValueError as e:
        return {"value_error": str(e)}
    res = {"out": _np(out)}
    if cot is not None:
        (out * torch.from_numpy(np.ascontiguousarray(cot[:, mine]))
         ).sum().backward()
        res.update(dq=_np(qs.grad), dk=_np(ks.grad), dv=_np(vs.grad))
    return res


# ---------------------------------------------------------------------
# the model on a mesh
# ---------------------------------------------------------------------

def _model_cfg(family: str, overrides: dict):
    from kubeflow_rm_tpu_torch.models.llama import LlamaConfig
    from kubeflow_rm_tpu_torch.models.mixtral import MixtralConfig

    moe = overrides.pop("moe", None)
    if family == "moe":
        cfg = MixtralConfig.tiny_moe(**overrides)
        if moe:
            cfg = replace(cfg, moe=replace(cfg.moe, **moe))
        return cfg
    return LlamaConfig.tiny(**overrides)


def _train_cfg(family, overrides, optim):
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.train import TrainConfig

    return TrainConfig(model=_model_cfg(family, dict(overrides)),
                       optim=OptimConfig(**optim))


def model_grads(axes: dict, params, batch: dict, family: str = "dense",
                overrides: dict | None = None,
                optim: dict | None = None) -> dict:
    """The loss, the logits and every trainable leaf's gradient of
    ``loss_fn`` on a mesh of ``axes``, gathered to global arrays."""
    from kubeflow_rm_tpu_torch.models import forward_with_aux
    from kubeflow_rm_tpu_torch.models.params import from_numpy_params
    from kubeflow_rm_tpu_torch.parallel.sharding import (
        leaf_spec, shard_params,
    )
    from kubeflow_rm_tpu_torch.training.optim import leaf_paths
    from kubeflow_rm_tpu_torch.training.train import (
        loss_fn, reduce_grads, shard_batch, trainable_paths,
    )

    tcfg = _train_cfg(family, overrides or {}, optim or {})
    mesh = _mesh(**axes)
    local = shard_params(from_numpy_params(params, tcfg.model, "cpu"), mesh)
    lb = shard_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                     mesh)
    flat = leaf_paths(local)
    paths = trainable_paths(tcfg, local)
    for p in paths:
        flat[p].requires_grad_(True)
    loss, aux = loss_fn(local, lb, tcfg, mesh)
    grads = dict(zip(paths, torch.autograd.grad(loss, [flat[p]
                                                       for p in paths])))
    grads = reduce_grads(grads, flat, mesh)
    with torch.no_grad():
        seg = lb.get("segments")
        logits, _ = forward_with_aux(
            local, lb["tokens"], tcfg.model, positions=lb.get("positions"),
            segments=seg, packed=seg is not None, mesh=mesh)
    return {
        "loss": float(loss), "aux": {k: float(v) for k, v in aux.items()},
        "logits": _gather_global(logits, (("dp", "fsdp"), "sp", None), mesh),
        "grads": {p: _gather_global(g, leaf_spec(p, flat[p]), mesh)
                  for p, g in grads.items()},
    }


def fit_losses(axes: dict, params, batches: list, optim: dict,
               family: str = "dense", overrides: dict | None = None,
               grad_accum: int = 1) -> dict:
    """``fit`` on a mesh from the global ``params``: each step's loss and
    grad norm, and the final parameters gathered."""
    from kubeflow_rm_tpu_torch.models.params import from_numpy_params
    from kubeflow_rm_tpu_torch.parallel.sharding import gather_params
    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit
    from kubeflow_rm_tpu_torch.training.optim import leaf_paths
    from kubeflow_rm_tpu_torch.training.train import init_train_state

    tcfg = _train_cfg(family, overrides or {}, optim)
    mesh = _mesh(**axes)
    state = init_train_state(
        tcfg, params=from_numpy_params(params, tcfg.model, "cpu"))
    state, history = fit(tcfg, iter(batches),
                         LoopConfig(total_steps=len(batches), log_every=1,
                                    grad_accum=grad_accum),
                         state=state, mesh=mesh)
    full = gather_params(state.params, mesh)
    return {"losses": [h.loss for h in history],
            "grad_norms": [h.grad_norm for h in history],
            "params": None if full is None else {
                p: _np(t) for p, t in leaf_paths(full).items()}}


def checkpoint_round_trip(params, batch: dict, optim: dict,
                          directory: str) -> dict:
    """One step at fsdp=2, a sharded save; then a restore at tp=2 whose
    shards, gathered, must equal the saved state."""
    from kubeflow_rm_tpu_torch.models.params import from_numpy_params
    from kubeflow_rm_tpu_torch.parallel.sharding import SPEC_ATTR
    from kubeflow_rm_tpu_torch.training.checkpoint import Checkpointer
    from kubeflow_rm_tpu_torch.training.optim import leaf_paths
    from kubeflow_rm_tpu_torch.training.train import (
        gather_state, init_train_state, make_train_step, shard_batch,
        shard_state,
    )

    tcfg = _train_cfg("dense", {}, optim)
    fsdp = _mesh(fsdp=dist.get_world_size())
    state = shard_state(init_train_state(
        tcfg, params=from_numpy_params(params, tcfg.model, "cpu")), fsdp)
    step = make_train_step(tcfg, state, mesh=fsdp)
    state, _ = step(state, shard_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()}, fsdp))
    ck = Checkpointer(directory)
    wrote = ck.save(state, mesh=fsdp)
    again = ck.save(state, mesh=fsdp)          # the step exists: no write
    saved = gather_state(state, fsdp)
    tp = _mesh(tp=dist.get_world_size())
    back = ck.restore(tcfg, tp, device="cpu")
    local_shapes = {p: tuple(t.shape)
                    for p, t in leaf_paths(back.params).items()}
    specs_kept = all(hasattr(t, SPEC_ATTR)
                     for t in leaf_paths(back.params).values())
    whole = gather_state(back, tp)
    out = {"wrote": wrote, "again": again, "step": back.step,
           "local_shapes": local_shapes, "specs_kept": specs_kept}
    if whole is not None:
        a, b = leaf_paths(saved.params), leaf_paths(whole.params)
        out["params_equal"] = all(torch.equal(a[p], b[p]) for p in a)
        out["mu_equal"] = all(torch.equal(saved.opt_state.mu[p],
                                          whole.opt_state.mu[p])
                              for p in saved.opt_state.mu)
        out["nu_equal"] = all(torch.equal(saved.opt_state.nu[p],
                                          whole.opt_state.nu[p])
                              for p in saved.opt_state.nu)
        out["saved_params"] = {p: _np(t) for p, t in a.items()}
    return out


def generate_tokens(axes: dict, params, prompt, pad_counts,
                    max_new_tokens: int, family: str = "dense",
                    overrides: dict | None = None) -> dict:
    """``make_generate_step`` on a mesh of ``axes`` (and, for
    comparison, ``make_decode_step``'s prefill logits)."""
    from kubeflow_rm_tpu_torch.models.generate import (
        cache_shardings, init_cache, make_decode_step, make_generate_step,
    )
    from kubeflow_rm_tpu_torch.models.params import from_numpy_params
    from kubeflow_rm_tpu_torch.parallel.mesh import axis_size
    from kubeflow_rm_tpu_torch.parallel.sharding import (
        shard_params, shard_tensor,
    )

    cfg = _model_cfg(family, dict(overrides or {}))
    mesh = _mesh(**axes)
    local = shard_params(from_numpy_params(params, cfg, "cpu"), mesh)
    prompt = torch.from_numpy(prompt)
    pads = None if pad_counts is None else torch.from_numpy(pad_counts)
    B, T = prompt.shape
    step = make_generate_step(local, cfg, mesh, max_new_tokens=max_new_tokens,
                              total_len=T + max_new_tokens)
    tokens = step(local, prompt, None, pads)
    rows = B // axis_size(mesh, ("dp", "fsdp"))
    cache = init_cache(cfg, rows, T + 1, "cpu",
                       kv_heads=cfg.n_kv_heads // axis_size(mesh, "tp"))
    decode = make_decode_step(local, cfg, mesh)
    spec = cache_shardings(cfg, mesh)
    logits, cache = decode(local, cache, shard_tensor(
        prompt, spec.positions, mesh))
    return {"tokens": tokens.numpy(), "prefill_logits_local": _np(logits),
            "cache_offset": cache.offset}


def serve_round_trip(params, prompt: list, max_new_tokens: int,
                     axes: dict) -> dict:
    """``make_app(..., mesh=)`` on rank 0 answering one ``/generate``
    while the other ranks ``follow``; rank 0 closes the app."""
    from kubeflow_rm_tpu_torch import serve
    from kubeflow_rm_tpu_torch.models.params import from_numpy_params

    cfg = _model_cfg("dense", {})
    mesh = _mesh(**axes)
    tree = from_numpy_params(params, cfg, "cpu")
    if dist.get_rank() != 0:
        return {"followed": serve.follow(cfg, tree, mesh,
                                         max_new_tokens=max_new_tokens,
                                         device="cpu")}
    app = serve.make_app(cfg, tree, max_new_tokens=max_new_tokens,
                         device="cpu", mesh=mesh, window_ms=1.0)
    try:
        status, body = serve.request(app, "POST", "/generate",
                                     {"prompt": prompt})
        rows = app.batcher.rows_multiple
    finally:
        app.close()
    return {"status": status, "body": body, "rows_multiple": rows}


def sharded_init(axes: dict, family: str = "dense", bits: int | None = None,
                 lora: bool = False, fit_steps: int = 0) -> dict:
    """``init_params(..., mesh=)`` (``init_params_quantized`` with
    ``bits``; then ``add_lora(..., mesh=)``) against ``shard_params`` of
    the one-device draw from the same seed; the shape of every draw it
    made; and with ``fit_steps`` the local shapes of the state that
    ``fit(state=None, mesh=)`` draws and trains on."""
    from kubeflow_rm_tpu_torch.models import init_params, llama
    from kubeflow_rm_tpu_torch.models.lora import add_lora
    from kubeflow_rm_tpu_torch.models.quantize import (
        init_params_quantized, quantize_params,
    )
    from kubeflow_rm_tpu_torch.parallel.sharding import (
        SPEC_ATTR, shard_params,
    )
    from kubeflow_rm_tpu_torch.training.data import synthetic_batches
    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit
    from kubeflow_rm_tpu_torch.training.optim import leaf_paths

    cfg = _model_cfg(family, {})
    mesh = _mesh(**axes)

    def gen(seed):
        return torch.Generator().manual_seed(seed)

    def build(m):
        if bits is None:
            p = init_params(cfg, gen(0), "cpu", mesh=m)
        else:
            p = init_params_quantized(cfg, gen(0), "cpu", bits=bits, mesh=m)
        return p if not lora else add_lora(p, 4, generator=gen(1), mesh=m)

    drawn, real = [], llama.init_leaf

    def spy(cfg_, name, shape, generator, device):
        drawn.append(tuple(shape))
        return real(cfg_, name, shape, generator, device)

    llama.init_leaf = spy
    try:
        local = build(mesh)
        state = None
        if fit_steps:
            tcfg = _train_cfg(family, {}, {"learning_rate": 1e-2})
            state, history = fit(
                tcfg, synthetic_batches(4, 16, cfg.vocab_size),
                LoopConfig(total_steps=fit_steps, log_every=1), mesh=mesh,
                device="cpu")
    finally:
        llama.init_leaf = real
    if bits is None:
        whole = init_params(cfg, gen(0), "cpu")
    else:
        whole = quantize_params(init_params(cfg, gen(0), "cpu"), bits=bits)
    if lora:
        whole = add_lora(whole, 4, generator=gen(1))
    want = leaf_paths(shard_params(whole, mesh))
    got = leaf_paths(local)
    out = {
        "drawn": drawn,
        "keys_equal": sorted(got) == sorted(want),
        "unequal": [p for p in want
                    if p not in got or not torch.equal(got[p], want[p])],
        "spec_differs": [p for p in want if p in got and getattr(
            got[p], SPEC_ATTR, None) != getattr(want[p], SPEC_ATTR)],
        "local_shapes": {p: tuple(t.shape) for p, t in got.items()},
    }
    if state is not None:
        out["fit_param_shapes"] = {
            p: tuple(t.shape) for p, t in leaf_paths(state.params).items()}
        out["fit_moment_shapes"] = {
            p: tuple(t.shape) for p, t in state.opt_state.mu.items()}
        out["fit_losses"] = [h.loss for h in history]
    return out
