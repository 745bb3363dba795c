"""The training step (counterpart of ``kubeflow_rm_tpu/training/train.py``).

``make_train_step`` returns ``step(state, batch) -> (state,
metrics)``, which differentiates the loss with ``torch.autograd.grad``,
accumulates over ``grad_accum`` interleaved microbatches, and applies
``training.optim``'s chain in place — the port's counterpart of buffer
donation: the returned state is the one passed in, its tensors updated.
With ``offload="optimizer"`` it returns the streamed host-offload arm
instead (``_build_offload_step``): the optimizer state lives in host
memory and the update runs there.

For a MoE family the loss adds ``cfg.model.moe.router_aux_weight`` times
the router aux loss, which the metrics report as ``router_aux``.

The step names its parts as spans (``utils.profiling.annotate``):
``train.forward``, ``loss`` inside it, ``train.backward`` and
``train.optimizer`` (the global norm and the update);
``init_train_state`` is one too.

With ``OptimConfig(train_only="lora")`` the frozen leaves are set to
``requires_grad=False``: the backward computes no base-weight gradient
and the optimizer keeps no moments for them. That includes the int8 and
float32 arrays of a quantized base (QLoRA); full fine-tuning of a
quantized base raises, since int8 weights take no gradient.

On a mesh (``make_train_step(..., mesh=)``) every rank runs the step on
its shards (``shard_state``) and its (dp, fsdp) rows and sp columns of
the global batch (``shard_batch``). The loss is the global token mean:
the masked sums and the count are all-reduced over the data axes (dp,
fsdp, sp). Gradients of a leaf replicated over a data axis are then
all-reduced over it (an fsdp-sharded leaf's came through its gather's
reduce-scatter), and the clip norm counts each shard once. The logits
stay split over ``tp`` into the loss (``softmax_cross_entropy(...,
vocab_group=)``). On a mesh with pp > 1 the forward runs the GPipe
schedule (``parallel.pipeline``, ``n_microbatches`` default pp): a
stage's leaves take their gradients from its own layers, and the
pp-replicated leaves (embedding, final norm, head) hold the same
gradient on every stage, so nothing is summed over pp. Adafactor updates
a rank's shards with the whole leaf's statistics (``optim.LeafLayout``),
and the host-offload arm runs on each rank's shards, its host state
pinned on every rank; it refuses pp > 1, as JAX's does.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import torch
import torch.distributed as dist

from kubeflow_rm_tpu_torch.analysis.torchcheck import hostsync as _hostsync
from kubeflow_rm_tpu_torch.models import forward_with_aux, init_params
from kubeflow_rm_tpu_torch.models.llama import LlamaConfig
from kubeflow_rm_tpu_torch.models.lora import is_lora_name
from kubeflow_rm_tpu_torch.ops.losses import softmax_cross_entropy
from kubeflow_rm_tpu_torch.parallel.collectives import all_reduce
from kubeflow_rm_tpu_torch.parallel.mesh import (
    axis_group, axis_size, comm_device,
)
from kubeflow_rm_tpu_torch.parallel.sharded import DATA_AXES
from kubeflow_rm_tpu_torch.parallel.sharding import (
    SPEC_ATTR, batch_pspec, gather_params, gather_tensor, leaf_spec,
    local_slices, param_shardings, shard_params, shard_tensor,
)
from kubeflow_rm_tpu_torch.utils.profiling import annotate
from kubeflow_rm_tpu_torch.training.optim import (
    AdamState, FactoredState, OptimConfig, global_norm, host_put, leaf_key,
    leaf_paths, make_offload_optimizer, make_optimizer,
)


@dataclass(frozen=True)
class TrainConfig:
    model: LlamaConfig = field(default_factory=LlamaConfig.tiny)
    optim: OptimConfig = field(default_factory=OptimConfig)
    z_loss: float = 1e-4


@dataclass
class TrainState:
    step: int
    params: dict
    # AdamState | FactoredState, or under offload="optimizer" the host
    # layout {leaf key: per-leaf state}
    opt_state: AdamState | FactoredState | dict


def trainable_paths(cfg: TrainConfig, params: dict) -> list[str]:
    """Leaf paths the step differentiates: every leaf, or only the
    adapters under ``train_only="lora"``. A quantized leaf's arrays are
    leaves of their own (``blocks/wq/q``, ``blocks/wq/s``)."""
    flat = leaf_paths(params)
    paths = list(flat)
    if cfg.optim.train_only is None:
        quantized = [p for p, t in flat.items()
                     if not t.dtype.is_floating_point]
        if quantized:
            raise ValueError(
                f"full fine-tuning of a quantized base ({quantized[0]}, "
                "...) is not possible: int8 weights take no gradient. "
                "Train LoRA adapters over it (QLoRA: add_lora, "
                "train_only='lora') or start from unquantized weights")
        return paths
    if cfg.optim.train_only != "lora":
        raise ValueError(f"unknown train_only={cfg.optim.train_only!r} "
                         "(only 'lora')")
    train = [p for p in paths if is_lora_name(p.rsplit("/", 1)[-1])]
    if not train:
        raise ValueError("train_only matched no parameters")
    return train


def init_train_state(cfg: TrainConfig, generator: torch.Generator | None = None,
                     params: dict | None = None,
                     device: str | torch.device | None = None, *,
                     mesh=None) -> TrainState:
    """Fresh state; pass ``params`` to start from existing weights (an
    ``add_lora`` output for adapter training), else they are drawn from
    ``generator`` on ``device``. Under ``offload="optimizer"`` the
    optimizer state is built leaf by leaf in host memory
    (``OffloadOptimizer.init``); it never touches the card.

    ``mesh``: the state is this rank's. Drawn parameters are cut to the
    rank's slices as they are drawn (``models.init_params(mesh=)``),
    given ones are sliced (``shard_params``; local ones pass through),
    and the moments are built on the slices."""
    with annotate("init_train_state"):
        if params is None:
            params = init_params(cfg.model, generator, device, mesh=mesh)
        elif mesh is not None:
            params = shard_params(params, mesh)
        flat = leaf_paths(params)
        train = {p: flat[p] for p in trainable_paths(cfg, params)}
        if cfg.optim.offload == "optimizer":
            opt_state = make_offload_optimizer(cfg.optim, params,
                                               mesh=mesh).init(params)
        else:
            opt_state = make_optimizer(cfg.optim, mesh=mesh).init(train)
        return TrainState(step=0, params=params, opt_state=opt_state)


def loss_fn(params: dict, batch: dict, cfg: TrainConfig, mesh=None,
            n_microbatches: int | None = None):
    """Masked-mean cross-entropy (+ z-loss) of the model on ``batch``:
    "tokens" and "labels", plus "positions" and "segments" for packed
    documents (then ``packed=True``: the ``pack_documents`` layout keeps
    attention on the flash kernel). On a mesh ``params`` and ``batch``
    are this rank's shares, the mean is over the global batch and the
    logits stay split over tp; with pp > 1 the forward is the GPipe
    schedule over ``n_microbatches`` (default pp)."""
    segments = batch.get("segments")
    kwargs = dict(positions=batch.get("positions"), segments=segments,
                  packed=segments is not None)
    total = vocab = None
    if mesh is None:
        logits, router_aux = forward_with_aux(params, batch["tokens"],
                                              cfg.model, **kwargs)
    else:
        if axis_size(mesh, "pp") > 1:
            from kubeflow_rm_tpu_torch.parallel.pipeline import (
                pipeline_forward_with_aux,
            )

            logits, router_aux = pipeline_forward_with_aux(
                params, batch["tokens"], cfg.model, mesh,
                n_microbatches=n_microbatches, local_vocab=True, **kwargs)
        else:
            logits, router_aux = forward_with_aux(
                params, batch["tokens"], cfg.model, mesh=mesh,
                local_vocab=True, **kwargs)
        group = axis_group(mesh, DATA_AXES)
        vocab = axis_group(mesh, "tp")

        def total(t):
            return all_reduce(t, group)
    with annotate("loss"):
        loss, aux = softmax_cross_entropy(logits, batch["labels"],
                                          z_loss=cfg.z_loss, total=total,
                                          vocab_group=vocab)
        if router_aux is not None:
            aux = dict(aux, router_aux=router_aux)
            loss = loss + cfg.model.moe.router_aux_weight * router_aux
    return loss, aux


def shard_batch(batch: dict, mesh) -> dict:
    """This rank's (dp, fsdp) rows and sp columns (``batch_pspec``) of
    a global batch of (B, T) arrays (numpy or tensors), every rank
    holding the same global batch."""
    spec = batch_pspec()
    return {k: (shard_tensor(v, spec, mesh) if isinstance(v, torch.Tensor)
                else v[local_slices(v.shape, spec, mesh)])
            for k, v in batch.items()}


def _slot_spec(t, spec: tuple, shape: tuple) -> tuple:
    """A state tensor shaped like its (global) leaf follows the leaf's
    spec; any other (adafactor's row and column statistics,
    placeholders) is replicated."""
    return spec if tuple(t.shape) == shape else (None,) * t.dim()


def _state_specs(opt_state, param_specs: dict, shapes: dict):
    """The spec tree of an optimizer state: {slot: {path: spec}} of an
    on-card state, or for the host-offload layout {key: state of
    {slot: {"leaf": spec}}} (``count`` ``()``)."""
    if isinstance(opt_state, dict):
        path = {leaf_key(p): p for p in param_specs}
        return {key: type(s)(count=(), **{
            slot: {"leaf": _slot_spec(getattr(s, slot)["leaf"],
                                      param_specs[path[key]],
                                      shapes[path[key]])}
            for slot in s.__dataclass_fields__ if slot != "count"})
            for key, s in opt_state.items()}
    out = {}
    for slot in opt_state.__dataclass_fields__:
        if slot == "count":
            continue
        out[slot] = {p: _slot_spec(t, param_specs[p], shapes[p])
                     for p, t in getattr(opt_state, slot).items()}
    return type(opt_state)(count=(), **out)


def state_shardings(cfg: TrainConfig, state: TrainState, mesh) -> TrainState:
    """The spec tree of a global ``TrainState`` on ``mesh``: the params'
    effective specs (``param_shardings``); moments follow their leaf,
    adafactor's factored row and column vectors stay replicated, and the
    scalars (``step``, ``count``) are replicated (``()``). The
    host-offload layout keeps its shape, each slot specified alike."""
    pspecs = param_shardings(state.params, mesh)
    specs = leaf_paths(pspecs)
    shapes = {p: tuple(t.shape) for p, t in leaf_paths(state.params).items()}
    return TrainState(step=(), params=pspecs,
                      opt_state=_state_specs(state.opt_state, specs, shapes))


def make_train_step(cfg: TrainConfig, state: TrainState,
                    grad_accum: int = 1,
                    offload: str | None = None, *, mesh=None,
                    n_microbatches: int | None = None) -> Callable:
    """Return ``step(state, batch) -> (state, metrics)``.

    ``batch`` maps names to (B, T) integer tensors on the parameters'
    device. ``grad_accum`` > 1 splits it into that many microbatches,
    microbatch m taking rows m, K+m, 2K+m, … (JAX's interleaved fold),
    and averages their gradients before ONE optimizer update. Metrics
    are 0-dim tensors (``loss``, ``grad_norm`` and the loss's aux
    terms), read by the caller when it chooses to sync.

    ``offload="optimizer"`` (default: ``cfg.optim.offload``) returns the
    streamed host-offload arm (``_build_offload_step``); it never falls
    back to the on-card arm.

    ``mesh``: ``state`` is this rank's (``shard_state``) and each batch
    its share of the global batch (``shard_batch``); the metrics are the
    global ones, alike on every rank. On a mesh with pp > 1 the forward
    runs the GPipe schedule; ``n_microbatches`` (default: pp) sets the
    bubble fraction (pp-1)/(n_microbatches+pp-1), and ``grad_accum``
    microbatches each run the whole schedule.
    """
    if offload is None:
        offload = cfg.optim.offload
    if offload not in ("none", "optimizer"):
        raise ValueError(f"unknown offload={offload!r} "
                         "(expected 'none' or 'optimizer')")
    if (offload == "optimizer" and mesh is not None
            and axis_size(mesh, "pp") > 1):
        raise ValueError("offload='optimizer' targets the single-chip "
                         "memory wall; pp meshes keep the update "
                         "on-chip (state is already sharded)")
    train_paths = trainable_paths(cfg, state.params)
    train_set = set(train_paths)
    for path, leaf in leaf_paths(state.params).items():
        leaf.requires_grad_(path in train_set)

    def grads_of(params, batch):
        flat = leaf_paths(params)
        leaves = [flat[p] for p in train_paths]
        with annotate("train.forward"):
            (loss, aux) = (loss_fn(params, batch, cfg) if mesh is None
                           else loss_fn(params, batch, cfg, mesh,
                                        n_microbatches))
        with annotate("train.backward"):
            grads = torch.autograd.grad(loss, leaves)
        grads = dict(zip(train_paths, grads))
        if mesh is not None:
            grads = reduce_grads(grads, flat, mesh)
        return loss.detach(), {k: a.detach() for k, a in aux.items()}, grads

    def compute_grads(params, batch):
        if grad_accum == 1:
            return grads_of(params, batch)
        rows = batch["tokens"].shape[0]
        if rows % grad_accum:
            raise ValueError(f"batch {rows} not divisible by "
                             f"grad_accum={grad_accum}")
        grads, losses, auxes = None, [], []
        for m in range(grad_accum):
            # a named region: the profiler's trace shows each
            # microbatch, and the cost model counts the rest of an
            # accumulation from one (analysis.torchcheck.memplan)
            with annotate("train.microbatch"):
                micro = {k: v[m::grad_accum] for k, v in batch.items()}
                loss_m, aux_m, g = grads_of(params, micro)
                losses.append(loss_m)
                auxes.append(aux_m)
                # the sum is added into in place: two gradient trees at
                # the peak (the sum and a microbatch's), as JAX's scan
                # aliases its carry
                if grads is None:
                    grads = _owned(g)
                else:
                    for k, t in grads.items():
                        t.add_(g[k])
                del g
        for t in grads.values():
            t.div_(grad_accum)
        loss = torch.stack(losses).mean()
        aux = {k: torch.stack([a[k] for a in auxes]).mean()
               for k in auxes[0]}
        return loss, aux, grads

    def norm_of(grads, params):
        return (global_norm(grads) if mesh is None
                else mesh_global_norm(grads, params, mesh))

    if offload == "optimizer":
        return _build_offload_step(cfg, state, compute_grads, norm_of, mesh)

    if isinstance(state.opt_state, dict):
        raise ValueError("state.opt_state is the host-offload layout; the "
                         "on-card arm needs make_optimizer's state")
    opt = make_optimizer(cfg.optim, mesh=mesh)

    def step(state: TrainState, batch: dict):
        loss, aux, grads = compute_grads(state.params, batch)
        flat = leaf_paths(state.params)
        with annotate("train.optimizer"):
            gnorm = norm_of(grads, flat)
            opt.update(grads, state.opt_state,
                       {p: flat[p] for p in train_paths}, gnorm)
        metrics = {"loss": loss, "grad_norm": gnorm, **aux}
        state.step += 1
        return state, metrics

    return step


def _owned(grads: dict) -> dict:
    """The first microbatch's gradients, safe to add into in place:
    autograd may hand one tensor to two leaves (both inputs of an add)
    or an expanded one (a sum's backward), and each of those is
    copied. Any other gradient is kept as it is."""
    seen, out = set(), {}
    for k, g in grads.items():
        base = g if g._base is None else g._base
        if id(base) in seen or any(s == 0 and n > 1
                                   for s, n in zip(g.stride(), g.shape)):
            g = g.clone()
        seen.add(id(base))
        out[k] = g
    return out


def reduce_grads(grads: dict, params: dict, mesh) -> dict:
    """Sum each local gradient over the data axes its leaf is
    replicated on: every rank's loss covered only its own tokens. (An
    fsdp-sharded leaf's gradient was reduce-scattered over fsdp by its
    gather's backward.)"""
    out = {}
    for p, g in grads.items():
        spec = leaf_spec(p, params[p])
        axes = tuple(a for a in DATA_AXES if a not in spec)
        # a low-precision gradient sums in float32, rounded once after
        out[p] = (all_reduce(g.float(), axis_group(mesh, axes)).to(g.dtype)
                  if axes else g)
    return out


def mesh_global_norm(grads: dict, params: dict, mesh) -> torch.Tensor:
    """``global_norm`` of the global gradients from every rank's shards:
    each leaf's sum of squares divided by the number of ranks that hold
    the same shard, summed over the world, so each shard counts once."""
    world = mesh.size()
    total = 0
    for p, g in grads.items():
        shards = math.prod(axis_size(mesh, a)
                           for a in leaf_spec(p, params[p]) if a is not None)
        total = total + (g * g).sum() / (world // shards)
    return torch.sqrt(all_reduce(total, dist.group.WORLD))


def shard_state(state: TrainState, mesh) -> TrainState:
    """A global ``TrainState`` -> this rank's: the parameters by
    ``shard_params``, each moment by its leaf's spec, adafactor's
    statistics whole (``state_shardings``); a host-offload state stays
    in host memory. A state whose parameters are already this rank's
    (they carry their spec) is returned as is."""
    if all(hasattr(t, SPEC_ATTR) for t in leaf_paths(state.params).values()):
        return state
    specs = state_shardings(None, state, mesh).opt_state
    opt = state.opt_state

    def slots(s, spec, put=lambda t: t):
        return type(s)(count=s.count, **{
            f: {k: put(shard_tensor(t, getattr(spec, f)[k], mesh))
                for k, t in getattr(s, f).items()}
            for f in s.__dataclass_fields__ if f != "count"})

    opt = ({key: slots(s, specs[key], host_put) for key, s in opt.items()}
           if isinstance(opt, dict) else slots(opt, specs))
    return TrainState(step=state.step,
                      params=shard_params(state.params, mesh),
                      opt_state=opt)


def gather_state(state: TrainState, mesh):
    """This rank's ``TrainState`` -> the global one in host memory on
    rank 0 (None on the others); every rank calls. A host-offload
    state's tensors go through the card one at a time (NCCL gathers no
    host tensor)."""
    opt = state.opt_state
    flat = leaf_paths(state.params)
    params = gather_params(state.params, mesh)
    lead = dist.get_rank() == 0
    dev = comm_device(mesh)

    def whole(t, path):
        spec = (leaf_spec(path, flat[path]) if t.shape == flat[path].shape
                else (None,) * t.dim())
        full = gather_tensor(t.to(dev), spec, mesh)
        return full.cpu() if lead else None

    def slots(s, path_of):
        return type(s)(count=s.count, **{
            f: {k: whole(t, path_of(k)) for k, t in getattr(s, f).items()}
            for f in s.__dataclass_fields__ if f != "count"})

    if isinstance(opt, dict):
        path = {leaf_key(p): p for p in flat}
        opt = {key: slots(s, lambda _, key=key: path[key])
               for key, s in opt.items()}
    else:
        opt = slots(opt, lambda p: p)
    if not lead:
        return None
    return TrainState(step=state.step, params=params, opt_state=opt)


#: transfer chunks dispatched beyond the one being consumed: chunk k's
#: update runs while chunks k+1..k+2 are in flight
_STREAM_LOOKAHEAD = 2


class _HostStream:
    """Device-to-host copies on a side ``torch.cuda.Stream`` into pinned
    buffers, each chunk with an event to wait on; on a CPU device every
    copy is done when it is issued."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def start(self) -> None:
        """Order the side stream after the work queued so far (the
        grad phase)."""
        if self.cuda:
            self.stream.wait_stream(torch.cuda.current_stream())

    def copy(self, dst: torch.Tensor, src: torch.Tensor):
        """``dst.copy_(src)`` on the side stream; returns the event that
        marks it done (None on the CPU)."""
        if not self.cuda:
            dst.copy_(src)
            return None
        with torch.cuda.stream(self.stream):
            dst.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
        return ev

    def finish(self) -> None:
        """Order later work on the current stream after every copy."""
        if self.cuda:
            torch.cuda.current_stream().wait_stream(self.stream)


def _build_offload_step(cfg: TrainConfig, state: TrainState,
                        compute_grads, norm_of, mesh=None) -> Callable:
    """The streamed host-offload arm of ``make_train_step``.

    1. **Grad phase (card).** The grad-accum fold and the global norm,
       the on-card arm's code (on a mesh: the rank's shards, the
       gradients summed by ``reduce_grads``, ``mesh_global_norm``).
    2. **Streaming phase (host).** Gradient and parameter leaves go
       host-ward on a side CUDA stream into pinned buffers, stacked
       ``(L, ...)`` leaves in slices of ``offload_chunk_layers`` layers,
       ``_STREAM_LOOKAHEAD`` chunks in flight beyond the one being
       consumed. Once a leaf is whole on the host, its update
       (``OffloadOptimizer.update_leaf``, the on-card chain's arithmetic)
       runs on the CPU, the new leaf goes back with a ``non_blocking``
       copy into the parameter on the card (in place, as the on-card arm
       updates), and the leaf's device gradient is freed.

    The update is per leaf while the transfers are per chunk: adafactor's
    block-RMS clips reduce over whole leaves. On a mesh every rank
    streams its own shards into its own pinned buffers; adafactor's
    cross-rank sums (row and column means, the block RMS) take the small
    host vectors to the card, all-reduce them there and bring them back
    (``optim.LeafLayout``). Metrics add ``offload_transfer_ms`` (time the
    host spent blocked on transfers, those sums included),
    ``offload_collective_ms`` (the sums alone) and
    ``offload_overlap_frac`` (the share of the streaming phase not
    blocked).
    """
    opt = make_offload_optimizer(cfg.optim, state.params, mesh=mesh)
    keys = opt.keys
    if not (isinstance(state.opt_state, dict)
            and set(state.opt_state) == set(keys)):
        raise ValueError(
            "state.opt_state is not the host-offload layout; build the "
            "state with OptimConfig(offload='optimizer') so "
            "init_train_state lays it out in host memory")
    flat = leaf_paths(state.params)
    shapes = [tuple(flat[p].shape) for p in opt.paths]
    chunk_layers = max(1, cfg.optim.offload_chunk_layers)
    # stacked (L, ...) leaves stream in layer groups; flat leaves whole
    chunks = [[(a, min(a + chunk_layers, shp[0]))
               for a in range(0, shp[0], chunk_layers)]
              if len(shp) >= 3 and shp[0] > 1 else None for shp in shapes]
    work = [(i, r) for i, c in enumerate(chunks) for r in (c or [None])]
    # pinned host buffers, one gradient and one parameter per leaf, made
    # at the first step and reused
    bufs: dict = {}

    def grad_phase(params: dict, batch: dict):
        """The step's work on the card: the gradients and their global
        norm (what the cost model walks for the on-card peak)."""
        loss, aux, grads = compute_grads(params, batch)
        return loss, aux, grads, norm_of(grads, leaf_paths(params))

    def step(state: TrainState, batch: dict):
        loss, aux, grads, gnorm = grad_phase(state.params, batch)
        params = leaf_paths(state.params)
        g_leaves = [grads.pop(p) for p in opt.paths]
        p_leaves = [params[p] for p in opt.paths]
        if not bufs:
            pin = torch.cuda.is_available()
            bufs.update(**{k: [torch.empty(shp, dtype=t.dtype, pin_memory=pin)
                               for shp, t in zip(shapes, p_leaves)]
                           for k in ("g", "p")})
        gh, ph = bufs["g"], bufs["p"]
        hs = _HostStream(p_leaves[0].device)
        blocked = 0.0
        opt.clock[0] = 0.0
        t_stream = time.perf_counter()
        inflight: deque = deque()
        pos = 0

        def dispatch_next():
            nonlocal pos
            i, r = work[pos]
            pos += 1
            sl = slice(None) if r is None else slice(*r)
            hs.copy(gh[i][sl], g_leaves[i].detach()[sl])
            inflight.append(hs.copy(ph[i][sl], p_leaves[i].detach()[sl]))

        # the transfers and the host's update ARE this arm: the probe
        # tallies their syncs under the site instead of witnessing them
        with _hostsync.sanctioned("train.offload_stream"), torch.no_grad():
            hs.start()
            for _ in range(min(1 + _STREAM_LOOKAHEAD, len(work))):
                dispatch_next()
            t1 = time.perf_counter()
            gnorm_host = gnorm.to("cpu")
            blocked += time.perf_counter() - t1
            for i, key in enumerate(keys):
                for _ in range(1 if chunks[i] is None else len(chunks[i])):
                    ev = inflight.popleft()
                    if ev is not None:
                        t1 = time.perf_counter()
                        ev.synchronize()
                        blocked += time.perf_counter() - t1
                    if pos < len(work):
                        dispatch_next()
                # the leaf is whole on the host: its device gradient goes
                g_leaves[i] = None
                opt.update_leaf(key, state.opt_state[key], gh[i], ph[i],
                                gnorm_host)
                # back to the card behind this leaf's own transfers
                hs.copy(p_leaves[i].detach(), ph[i])
            hs.finish()
        stream_wall = time.perf_counter() - t_stream
        blocked += opt.clock[0]
        metrics = {
            "loss": loss, "grad_norm": gnorm, **aux,
            "offload_transfer_ms": blocked * 1e3,
            "offload_collective_ms": opt.clock[0] * 1e3,
            "offload_overlap_frac": (max(0.0, 1.0 - blocked / stream_wall)
                                     if stream_wall > 0 else 0.0),
        }
        state.step += 1
        return state, metrics

    step.chunk_plan = dict(zip(keys, chunks))
    step.offload = "optimizer"
    step.grad_phase = grad_phase
    # the card holds no staging buffer of the stream: the transfers land
    # in pinned host memory and the new leaf goes straight into the
    # parameter
    step.stream_slot_bytes = 0
    return step
