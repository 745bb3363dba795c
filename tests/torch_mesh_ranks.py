"""Rank bodies of the port's multi-process tests (``test_torch_mesh.py``,
``test_torch_sp.py``, ``test_torch_mesh_train.py``,
``test_torch_pipeline.py``, ``test_torch_mesh_optim.py``,
``test_torch_mesh_heads.py``, ``test_torch_repairs_c7_c8.py``).

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

    def __init__(self, worlds: dict, workdir, timeout: float,
                 collective_timeout: float = COLLECTIVE_TIMEOUT_S):
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
                                          cases, d, collective_timeout))
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


def start_worlds(worlds: dict, workdir, timeout: float = 600,
                 collective_timeout: float = COLLECTIVE_TIMEOUT_S) -> Worlds:
    """Spawn ``{world size: cases}`` — each case ``(name, function name,
    kwargs)`` — as gloo worlds of those sizes, all at once. A world
    still running after ``timeout`` seconds is killed and fails its
    tests; a collective that waits ``collective_timeout`` seconds fails
    its case."""
    return Worlds(worlds, workdir, timeout, collective_timeout)


def _rank_main(rank, world, init, cases, workdir,
               collective_timeout=COLLECTIVE_TIMEOUT_S):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=collective_timeout))
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
    cache = init_cache(cfg, rows, T + 1, "cpu", mesh=mesh)
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


# ---------------------------------------------------------------------
# the GPipe schedule
# ---------------------------------------------------------------------

def _local_tree(cfg, params, mesh):
    from kubeflow_rm_tpu_torch.models.params import from_numpy_params
    from kubeflow_rm_tpu_torch.parallel.sharding import shard_params

    return shard_params(from_numpy_params(params, cfg, "cpu"), mesh)


def pipeline_case(axes: dict, params, batch: dict, n_microbatches=None,
                  family: str = "dense", overrides: dict | None = None,
                  grads: bool = False, raw_params: bool = False) -> dict:
    """``pipeline_forward_with_aux`` on a mesh of ``axes``: the logits
    (rows gathered) and the router aux; with ``grads`` also the loss of
    ``tests/test_pipeline.py`` (the global mean NLL of the labels) and
    every leaf's gradient, gathered on every rank from its own stage's
    shards. ``raw_params``: the global tree unsharded (the divisibility
    refusals come before any slicing)."""
    from kubeflow_rm_tpu_torch.models.params import from_numpy_params
    from kubeflow_rm_tpu_torch.ops.losses import softmax_cross_entropy
    from kubeflow_rm_tpu_torch.parallel.collectives import all_reduce
    from kubeflow_rm_tpu_torch.parallel.mesh import axis_group
    from kubeflow_rm_tpu_torch.parallel.pipeline import (
        pipeline_forward_with_aux,
    )
    from kubeflow_rm_tpu_torch.parallel.sharded import DATA_AXES
    from kubeflow_rm_tpu_torch.parallel.sharding import leaf_spec
    from kubeflow_rm_tpu_torch.training.optim import leaf_paths
    from kubeflow_rm_tpu_torch.training.train import (
        reduce_grads, shard_batch,
    )

    cfg = _model_cfg(family, dict(overrides or {}))
    mesh = _mesh(**axes)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    if raw_params:
        local = from_numpy_params(params, cfg, "cpu")
    else:
        local = _local_tree(cfg, params, mesh)
        b = shard_batch(b, mesh)
    flat = leaf_paths(local)
    for t in flat.values():
        t.requires_grad_(grads)
    try:
        with torch.set_grad_enabled(grads):
            logits, aux = pipeline_forward_with_aux(
                local, b["tokens"], cfg, mesh,
                n_microbatches=n_microbatches,
                positions=b.get("positions"), segments=b.get("segments"),
                packed="segments" in b)
    except ValueError as e:
        return {"value_error": str(e)}
    out = {"logits": _gather_global(logits, (("dp", "fsdp"), None, None),
                                    mesh),
           "aux": None if aux is None else float(aux)}
    if grads:
        group = axis_group(mesh, DATA_AXES)
        loss, _ = softmax_cross_entropy(
            logits, b["labels"], total=lambda t: all_reduce(t, group))
        g = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
        g = reduce_grads(g, flat, mesh)
        out["loss"] = float(loss)
        out["grads"] = {p: _gather_global(t, leaf_spec(p, flat[p]), mesh)
                        for p, t in g.items()}
    return out


def train_step_metrics(axes: dict, params, batch: dict, optim: dict,
                       n_microbatches=None, overrides: dict | None = None
                       ) -> dict:
    """One ``make_train_step`` step on a mesh of ``axes`` (the GPipe
    schedule at pp > 1): its loss and grad norm."""
    from kubeflow_rm_tpu_torch.models.params import from_numpy_params
    from kubeflow_rm_tpu_torch.training.train import (
        init_train_state, make_train_step, shard_batch,
    )

    tcfg = _train_cfg("dense", overrides or {}, optim)
    mesh = _mesh(**axes)
    state = init_train_state(
        tcfg, params=from_numpy_params(params, tcfg.model, "cpu"),
        mesh=mesh)
    step = make_train_step(tcfg, state, mesh=mesh,
                           n_microbatches=n_microbatches)
    _, m = step(state, shard_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()}, mesh))
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def pp_checkpoint(params, batches: list, optim: dict, directory: str,
                  restore_axes: dict) -> dict:
    """``fit`` on pp=2 × fsdp=2 (checkpointing at its end), then a
    restore at ``restore_axes``: whether the restored shards, gathered,
    equal the state the pp mesh saved, and the local shapes there."""
    from kubeflow_rm_tpu_torch.models.params import from_numpy_params
    from kubeflow_rm_tpu_torch.training.checkpoint import Checkpointer
    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit
    from kubeflow_rm_tpu_torch.training.optim import leaf_paths
    from kubeflow_rm_tpu_torch.training.train import (
        gather_state, init_train_state,
    )

    tcfg = _train_cfg("dense", {"n_layers": 4}, optim)
    pp = _mesh(pp=2, fsdp=2)
    state = init_train_state(
        tcfg, params=from_numpy_params(params, tcfg.model, "cpu"), mesh=pp)
    pp_shapes = {p: tuple(t.shape)
                 for p, t in leaf_paths(state.params).items()}
    state, history = fit(tcfg, iter(batches),
                         LoopConfig(total_steps=len(batches), log_every=1,
                                    checkpoint_dir=directory),
                         state=state, mesh=pp)
    saved = gather_state(state, pp)
    other = _mesh(**restore_axes)
    back = Checkpointer(directory).restore(tcfg, other, device="cpu")
    whole = gather_state(back, other)
    out = {"losses": [h.loss for h in history], "step": back.step,
           "pp_shapes": pp_shapes,
           "local_shapes": {p: tuple(t.shape)
                            for p, t in leaf_paths(back.params).items()}}
    if whole is not None:
        a, b = leaf_paths(saved.params), leaf_paths(whole.params)
        out["params_equal"] = all(torch.equal(a[p], b[p]) for p in a)
        out["moments_equal"] = all(
            torch.equal(getattr(saved.opt_state, f)[p],
                        getattr(whole.opt_state, f)[p])
            for f in ("mu", "nu") for p in saved.opt_state.mu)
        out["saved_params"] = {p: _np(t) for p, t in a.items()}
    return out


# ---------------------------------------------------------------------
# adafactor and the host-offload arm on a mesh
# ---------------------------------------------------------------------

def optimizer_arms(axes: dict, params, batches: list, optim: dict,
                   grad_accum: int = 1, arms=("none", "optimizer")) -> dict:
    """``make_train_step`` on a mesh of ``axes`` for each arm (the
    on-card one and the host-offload one), from the same global state:
    per arm each step's loss and grad norm, the offload metrics, the
    final parameters gathered, and whether the host state is in host
    memory."""
    from kubeflow_rm_tpu_torch.models.params import from_numpy_params
    from kubeflow_rm_tpu_torch.parallel.sharding import gather_params
    from kubeflow_rm_tpu_torch.training.optim import leaf_paths
    from kubeflow_rm_tpu_torch.training.train import (
        init_train_state, make_train_step, shard_batch,
    )

    mesh = _mesh(**axes)
    out = {}
    for arm in arms:
        tcfg = _train_cfg("dense", {}, dict(optim, offload=arm))
        state = init_train_state(
            tcfg, params=from_numpy_params(params, tcfg.model, "cpu"),
            mesh=mesh)
        step = make_train_step(tcfg, state, grad_accum=grad_accum,
                               mesh=mesh)
        losses, norms, extra = [], [], []
        for b in batches:
            state, m = step(state, shard_batch(
                {k: torch.from_numpy(v) for k, v in b.items()}, mesh))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            extra.append({k: float(m[k]) for k in m
                          if k.startswith("offload_")})
        full = gather_params(state.params, mesh)
        res = {"losses": losses, "grad_norms": norms, "metrics": extra,
               "params": None if full is None else {
                   p: _np(t) for p, t in leaf_paths(full).items()}}
        if arm == "optimizer":
            res["host"] = all(
                t.device.type == "cpu" for s in state.opt_state.values()
                for f in s.__dataclass_fields__ if f != "count"
                for t in getattr(s, f).values())
        out[arm] = res
    return out


def offload_checkpoint(params, batch: dict, optim: dict, directory: str
                       ) -> dict:
    """One offload step at fsdp=2 × tp=2 and a sharded save; a restore
    at fsdp=4: the host state's slices, gathered, equal the saved one's,
    and it stays in host memory."""
    from kubeflow_rm_tpu_torch.models.params import from_numpy_params
    from kubeflow_rm_tpu_torch.training.checkpoint import Checkpointer
    from kubeflow_rm_tpu_torch.training.train import (
        gather_state, init_train_state, make_train_step, shard_batch,
    )

    tcfg = _train_cfg("dense", {}, dict(optim, offload="optimizer"))
    mesh = _mesh(fsdp=2, tp=2)
    state = init_train_state(
        tcfg, params=from_numpy_params(params, tcfg.model, "cpu"),
        mesh=mesh)
    step = make_train_step(tcfg, state, mesh=mesh)
    state, _ = step(state, shard_batch(
        {k: torch.from_numpy(v) for k, v in batch.items()}, mesh))
    ck = Checkpointer(directory)
    ck.save(state, mesh=mesh)
    saved = gather_state(state, mesh)
    other = _mesh(fsdp=4)
    back = Checkpointer(directory).restore(tcfg, other, device="cpu")
    host = all(t.device.type == "cpu" for s in back.opt_state.values()
               for f in s.__dataclass_fields__ if f != "count"
               for t in getattr(s, f).values())
    whole = gather_state(back, other)
    out = {"host": host, "keys_equal": set(back.opt_state) ==
           set(state.opt_state)}
    if whole is not None:
        out["opt_equal"] = all(
            torch.equal(getattr(saved.opt_state[k], f)["leaf"],
                        getattr(whole.opt_state[k], f)["leaf"])
            and saved.opt_state[k].count == whole.opt_state[k].count
            for k in saved.opt_state
            for f in saved.opt_state[k].__dataclass_fields__
            if f != "count")
        out["saved_opt"] = {k: {f: _np(getattr(s, f)["leaf"])
                                for f in s.__dataclass_fields__
                                if f != "count"}
                            for k, s in saved.opt_state.items()}
    return out


def offload_refusals(optim: dict) -> dict:
    """The host-offload arm's refusals on a mesh: pp > 1 (JAX's words)
    and ``train_only``."""
    from kubeflow_rm_tpu_torch.training.train import (
        init_train_state, make_train_step,
    )

    out = {}
    tcfg = _train_cfg("dense", {"n_layers": 2},
                      dict(optim, offload="optimizer"))
    mesh = _mesh(pp=2, fsdp=dist.get_world_size() // 2)
    state = init_train_state(tcfg, torch.Generator().manual_seed(0),
                             device="cpu", mesh=mesh)
    try:
        make_train_step(tcfg, state, mesh=mesh)
        out["pp"] = None
    except ValueError as e:
        out["pp"] = str(e)
    lcfg = _train_cfg("dense", {}, dict(optim, offload="optimizer",
                                       train_only="lora"))
    try:
        init_train_state(lcfg, torch.Generator().manual_seed(0),
                         device="cpu", mesh=_mesh(fsdp=dist.get_world_size()))
        out["train_only"] = None
    except ValueError as e:
        out["train_only"] = str(e)
    return out


def fit_offload_metrics(axes: dict, batches: list, optim: dict) -> dict:
    """``fit`` with ``LoopConfig(offload="optimizer")`` on a mesh of
    ``axes`` from a fresh draw: the records' steps, losses and offload
    metrics."""
    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit

    tcfg = _train_cfg("dense", {}, dict(optim, offload="optimizer"))
    mesh = _mesh(**axes)
    state, history = fit(tcfg, iter(batches),
                         LoopConfig(total_steps=len(batches),
                                    log_every=len(batches),
                                    offload="optimizer"),
                         mesh=mesh, device="cpu")
    return {"step": state.step,
            "records": [{"loss": h.loss, "transfer_ms":
                         h.offload_transfer_ms,
                         "overlap": h.offload_overlap_frac}
                        for h in history]}


# ---------------------------------------------------------------------
# the vocabulary on tp
# ---------------------------------------------------------------------

def vocab_parallel_loss(logits, labels, z_loss: float) -> dict:
    """``softmax_cross_entropy`` of this rank's vocabulary columns of the
    global (B, T, V) ``logits`` over the world (``vocab_group``) against
    the same loss of the whole logits: both losses and aux terms, and
    each one's gradient in this rank's columns."""
    from kubeflow_rm_tpu_torch.ops.losses import softmax_cross_entropy

    n, r = dist.get_world_size(), dist.get_rank()
    V = logits.shape[-1] // n
    lab = torch.from_numpy(labels)
    whole = torch.from_numpy(logits).requires_grad_(True)
    local = torch.from_numpy(np.ascontiguousarray(
        logits[..., r * V:(r + 1) * V])).requires_grad_(True)
    out = {}
    for name, x, kw in (("gathered", whole, {}),
                        ("parallel", local,
                         {"vocab_group": dist.group.WORLD})):
        loss, aux = softmax_cross_entropy(x, lab, z_loss=z_loss, **kw)
        (g,) = torch.autograd.grad(loss, [x])
        if name == "gathered":
            g = g[..., r * V:(r + 1) * V]
        out[name] = {"loss": float(loss),
                     "aux": {k: float(v) for k, v in aux.items()},
                     "grad": _np(g)}
    return out


def loss_gathers(axes: dict, params, batch: dict) -> dict:
    """How many times ``loss_fn`` on a mesh of ``axes`` gathers logits
    over tp (``MeshView.head``'s ``gather_from_group``), and how many
    times the public ``forward`` does."""
    from kubeflow_rm_tpu_torch.models import forward_with_aux
    from kubeflow_rm_tpu_torch.parallel import sharded
    from kubeflow_rm_tpu_torch.training.train import loss_fn, shard_batch

    tcfg = _train_cfg("dense", {}, {})
    mesh = _mesh(**axes)
    local = _local_tree(tcfg.model, params, mesh)
    b = shard_batch({k: torch.from_numpy(v) for k, v in batch.items()},
                    mesh)
    calls = []
    real = sharded.gather_from_group

    def spy(x, group, dim):
        calls.append(tuple(x.shape))
        return real(x, group, dim)

    sharded.gather_from_group = spy
    try:
        loss_fn(local, b, tcfg, mesh)
        in_loss = len(calls)
        with torch.no_grad():
            forward_with_aux(local, b["tokens"], tcfg.model, mesh=mesh)
    finally:
        sharded.gather_from_group = real
    return {"in_loss": in_loss, "in_forward": len(calls) - in_loss}


def stacked_slice_arms(axes: dict, params, batch: dict, n_microbatches,
                       overrides: dict | None = None) -> dict:
    """``pipeline_case`` with gradients twice: through the training
    forwards' ``llama.layer_slices`` and through the per-layer select
    (``leaf[i]``) it replaced. Whether every gathered gradient is equal,
    and both losses."""
    from kubeflow_rm_tpu_torch.models import llama

    def run():
        return pipeline_case(axes, params, batch, n_microbatches,
                             overrides=overrides, grads=True)

    class selects:
        """``leaf[i]`` made afresh each time a loop reaches layer i."""

        def __init__(self, blocks):
            self.blocks = blocks

        def __iter__(self):
            return (llama.layer_params(self.blocks, i)
                    for i in range(llama.stacked_layers(self.blocks)))

    new = run()
    real = llama.layer_slices
    llama.layer_slices = selects
    try:
        old = run()
    finally:
        llama.layer_slices = real
    return {"loss_new": new["loss"], "loss_old": old["loss"],
            "leaves": len(new["grads"]),
            "equal": set(new["grads"]) == set(old["grads"]) and all(
                np.array_equal(new["grads"][k], old["grads"][k])
                for k in new["grads"])}
