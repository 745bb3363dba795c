"""The optimizer (counterpart of ``kubeflow_rm_tpu/training/optim.py``).

``make_optimizer`` is the JAX package's optax chain, term for term and
in its order:

1. ``clip_by_global_norm(grad_clip)``;
2. the scaler: ``scale_by_adam(b1, b2, eps=1e-8, eps_root=0)`` with
   ``mu`` stored in ``mu_dtype`` and ``nu`` in the parameter's dtype;
   or with ``factored=True`` adafactor's three terms,
   ``scale_by_factored_rms(decay_rate=b2, min_dim_size_to_factor=
   factored_min_dim)``, ``clip_by_block_rms(1.0)`` and
   ``scale_by_param_block_rms()``;
3. ``add_decayed_weights(weight_decay)``, masked off every leaf whose
   path holds ``norm`` or starts with ``embed``;
4. ``scale_by_schedule(-warmup_cosine_decay_schedule)``, where the decay
   length includes the warmup.

It follows optax 0.2.6's arithmetic, including where it rounds: the
bias-corrected update is computed from the un-rounded first moment, and
``mu`` is cast to ``mu_dtype`` only after that; a Python scalar meets a
tensor in the tensor's dtype (JAX's weak typing), so the port rounds
every scalar to the tensor's dtype first, while a float32 array (the
adafactor decay) promotes a bf16 operand to float32; a mean of a bf16
tensor accumulates in float32 and rounds once. It is not
``torch.optim.AdamW``, whose eps placement and decay rounding differ.

The port updates in place (JAX returns new arrays): ``update`` writes
the parameters and the optimizer state under ``torch.no_grad``. Every
term after the global-norm clip is leaf-local, so one function,
``Optimizer.update_leaf``, updates a leaf given the global norm; the
on-card chain and the host-offload policy (``OffloadOptimizer``, below)
both run it, which keeps the two arms' arithmetic identical.

On a mesh (``make_optimizer(cfg, mesh=)``) each rank updates its shards
with the arithmetic of the whole leaf, as optax does on JAX's global
arrays. Adam is elementwise. Adafactor reads the leaf's global shape and
spec (``LeafLayout``): ``factored_dims`` come from the global shape, the
row and column means are float32 partial sums summed over the ranks that
hold the leaf's shards and kept whole on every rank (JAX's state keeps
them replicated), and the block-RMS clips sum the leaf's squares over
the axes of its spec only, so a leaf replicated on an axis counts once.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    mu_dtype: str = "bfloat16"
    # adafactor: a factored second moment (row/col RMS vectors), no first
    # moment
    factored: bool = False
    # dims below this stay unfactored (optax's default; tests lower it)
    factored_min_dim: int = 128
    # "lora": train only adapter leaves; frozen leaves get neither
    # gradients nor moments
    train_only: str | None = None
    # "optimizer": the state lives in host memory and the update runs on
    # the host (training.train's streamed arm)
    offload: str = "none"
    # layer-group size of the streamed transfers of stacked (L, ...) leaves
    offload_chunk_layers: int = 4


def leaf_paths(params: dict, prefix: str = "") -> dict:
    """Flatten a nested parameter dict to ``{"blocks/wq": tensor, ...}``
    (JAX's "/"-joined key path), in insertion order."""
    out = {}
    for name, leaf in params.items():
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(leaf, dict):
            out.update(leaf_paths(leaf, path))
        else:
            out[path] = leaf
    return out


def decays(path: str) -> bool:
    """``_decay_mask``: weight decay for every leaf except norms and the
    embedding."""
    return not ("norm" in path or path.startswith("embed"))


def schedule(cfg: OptimConfig, count: int) -> float:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
    warmup + 1), lr / 10)`` at ``count``, in float32 as optax computes
    it."""
    f32 = np.float32
    peak = f32(cfg.learning_rate)
    warmup = cfg.warmup_steps
    if count < warmup:
        frac = f32(1) - f32(min(max(count, 0), warmup)) / f32(warmup)
        return float((f32(0) - peak) * frac + peak)
    decay_steps = max(cfg.total_steps, warmup + 1) - warmup
    end = cfg.learning_rate * 0.1
    alpha = 0.0 if cfg.learning_rate == 0 else end / cfg.learning_rate
    t = f32(min(count - warmup, decay_steps))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t / f32(decay_steps),
                                         dtype=f32))
    return float(peak * (f32(1 - alpha) * cosine + f32(alpha)))


def _weak(x: float, t: torch.Tensor) -> float:
    """The Python scalar ``x`` as JAX's weak typing uses it against
    ``t``: rounded to ``t``'s dtype, as ``torch.tensor(x, dtype).item()``
    rounds it (through float32 for the 16-bit types), on the host
    without making or reading a tensor: the optimizer calls it for every
    leaf of every step, inside the training loop's hot region."""
    if t.dtype == torch.float64:
        return float(x)
    with np.errstate(over="ignore"):
        f = np.float32(x)
    if t.dtype == torch.float32:
        return float(f)
    if np.isnan(f):
        # torch's 16-bit casts drop a NaN's payload: float16 keeps the
        # sign, bfloat16 gives the positive quiet NaN
        return math.copysign(math.nan, f) if t.dtype == torch.float16 \
            else math.nan
    if t.dtype == torch.float16:
        with np.errstate(over="ignore"):
            return float(np.float16(f))
    # round to nearest even on the upper 16 bits; inf stays inf
    bits = int(f.view(np.uint32))
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return float(np.uint32(bits).view(np.float32))


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False):
    """``jnp.mean``: a bf16 (or f16) mean accumulates in float32 and is
    rounded to the input's dtype once."""
    if dim is None:
        return x.mean(dtype=torch.float32).to(x.dtype)
    return x.mean(dim=dim, keepdim=keepdim, dtype=torch.float32).to(x.dtype)


def factored_dims(shape, min_dim: int):
    """optax's ``_factored_dims``: the two largest axes ``(d1, d0)`` (by
    ``numpy.argsort``, as optax sorts), or None for a leaf of fewer than
    two axes or whose second largest axis is below ``min_dim``."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


class LeafLayout:
    """Where one leaf's shards lie on a mesh: its global ``shape``, its
    ``spec`` (``sharding.leaf_spec``) and the ranks that hold its other
    shards (the group over the spec's axes). ``allsum`` is adafactor's
    one collective. It runs on the mesh's device: a host tensor (the
    offload arm's) goes to the card and back, since NCCL reduces no CPU
    tensor; ``clock`` (a one-element list, if given) adds the seconds
    that took."""

    def __init__(self, mesh, spec, shape, clock: list | None = None):
        from kubeflow_rm_tpu_torch.parallel.mesh import (
            AXES, axis_size, comm_device,
        )

        self.mesh, self.spec, self.shape = mesh, tuple(spec), tuple(shape)
        named = set()
        for ax in self.spec:
            if ax is not None:
                named.update((ax,) if isinstance(ax, str) else ax)
        #: the axes that split the leaf, in mesh order (one-rank axes
        #: left out); none: this rank holds the whole leaf
        self.axes = tuple(a for a in AXES
                          if a in named and axis_size(mesh, a) > 1)
        self.device = comm_device(mesh)
        self.clock = clock

    def allsum(self, t: torch.Tensor, spec: tuple = ()) -> torch.Tensor:
        """The sum over the ranks holding this leaf's shards of ``t``,
        this rank's part (under ``spec``) of a global float32 tensor, each
        part placed at its slice: the global tensor, alike on those
        ranks, on ``t``'s device. A partial sum over a split dim and a
        gather of the kept dims in one all-reduce."""
        import torch.distributed as dist

        from kubeflow_rm_tpu_torch.parallel.mesh import axis_group
        from kubeflow_rm_tpu_torch.parallel.sharding import (
            global_shape_of, local_slices,
        )

        if not self.axes:
            return t
        t0 = time.perf_counter()
        full = global_shape_of(t.shape, spec, self.mesh)
        buf = torch.zeros(full, dtype=t.dtype, device=self.device)
        buf[local_slices(full, spec, self.mesh)] = t.to(self.device)
        dist.all_reduce(buf, group=axis_group(self.mesh, self.axes))
        out = buf.to(t.device)
        if self.clock is not None:
            self.clock[0] += time.perf_counter() - t0
        return out

    def local(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's slice of the global ``t`` under ``spec``."""
        from kubeflow_rm_tpu_torch.parallel.sharding import local_slices

        return t[local_slices(t.shape, spec, self.mesh)]


def leaf_layouts(params: dict, mesh, clock: list | None = None) -> dict:
    """``{path: LeafLayout}`` of a rank's local tree on ``mesh``."""
    from kubeflow_rm_tpu_torch.parallel.sharding import (
        global_shape_of, leaf_spec,
    )

    out = {}
    for path, t in leaf_paths(params).items():
        spec = leaf_spec(path, t)
        out[path] = LeafLayout(mesh, spec,
                               global_shape_of(t.shape, spec, mesh), clock)
    return out


def _drop(spec: tuple, d: int) -> tuple:
    return spec[:d] + spec[d + 1:]


@dataclass
class AdamState:
    count: int       # updates applied so far (optax's step count)
    mu: dict         # {path: first moment}, mu_dtype
    nu: dict         # {path: second moment}, the parameter's dtype


@dataclass
class FactoredState:
    """Adafactor's state: per path the row and column statistics of a
    factored leaf (``v`` a (1,) placeholder), or the full second moment
    ``v`` of an unfactored one (``v_row``/``v_col`` placeholders), all
    in the parameter's dtype — optax's ``FactoredState`` layout."""
    count: int
    v_row: dict
    v_col: dict
    v: dict


class Optimizer:
    """The chain of ``make_optimizer`` over a flat ``{path: tensor}``
    dict of trainable leaves (on a mesh, a rank's shards)."""

    def __init__(self, cfg: OptimConfig, mesh=None):
        self.cfg, self.mesh = cfg, mesh
        self.mu_dtype = getattr(torch, cfg.mu_dtype)
        self.state_type = FactoredState if cfg.factored else AdamState
        self._layouts: dict = {}

    @property
    def slots(self) -> tuple[str, ...]:
        """The per-leaf tensors of the state."""
        return ("v_row", "v_col", "v") if self.cfg.factored else ("mu", "nu")

    def layout(self, path: str, p: torch.Tensor) -> LeafLayout | None:
        """The leaf's ``LeafLayout`` where adafactor needs one (a mesh),
        else None; made once per path."""
        if self.mesh is None or not self.cfg.factored:
            return None
        if path not in self._layouts:
            self._layouts.update(leaf_layouts({path: p}, self.mesh))
        return self._layouts[path]

    def init_leaf(self, p: torch.Tensor,
                  layout: LeafLayout | None = None) -> dict:
        """One leaf's state tensors (``slots``), zeros beside ``p``; the
        factored statistics are the whole leaf's (``layout``'s global
        shape), the rest follow ``p``."""
        if not self.cfg.factored:
            return {"mu": torch.zeros_like(p, dtype=self.mu_dtype),
                    "nu": torch.zeros_like(p)}
        one = p.new_zeros((1,))
        shape = list(p.shape if layout is None else layout.shape)
        dims = factored_dims(tuple(shape), self.cfg.factored_min_dim)
        if dims is None:
            return {"v_row": one, "v_col": one.clone(),
                    "v": torch.zeros_like(p)}
        d1, d0 = dims
        row = shape[:d0] + shape[d0 + 1:]
        col = shape[:d1] + shape[d1 + 1:]
        return {"v_row": p.new_zeros(row), "v_col": p.new_zeros(col),
                "v": one}

    def init(self, params: dict):
        per = {k: self.init_leaf(p, self.layout(k, p))
               for k, p in params.items()}
        return self.state_type(0, **{s: {k: d[s] for k, d in per.items()}
                                     for s in self.slots})

    @torch.no_grad()
    def update_leaf(self, path: str, slots: dict, g: torch.Tensor,
                    p: torch.Tensor, gnorm: torch.Tensor,
                    count: int, layout: LeafLayout | None = None) -> None:
        """The whole chain on one leaf, in place: ``p`` and its state
        tensors ``slots`` are updated. ``gnorm`` is the global norm of
        all the gradients (a 0-dim tensor on ``g``'s device) and
        ``count`` the updates applied so far. ``layout``: where ``p`` is
        one rank's shard, the leaf's (adafactor's whole-leaf
        statistics)."""
        cfg = self.cfg
        # clip_by_global_norm: select(trigger, g, g / ‖g‖ · max_norm)
        g = torch.where(gnorm < cfg.grad_clip, g,
                        g / gnorm.to(g.dtype) * _weak(cfg.grad_clip, g))
        if cfg.factored:
            u = self._adafactor(slots, g, p, count, layout)
        else:
            u = self._adam(slots, g, count)
        # add_decayed_weights (masked)
        if decays(path):
            u = u + _weak(cfg.weight_decay, p) * p
        # scale_by_schedule, then apply_updates in the param's dtype
        u = _weak(-schedule(cfg, count), u) * u
        p.copy_((p + u).to(p.dtype))

    def _adam(self, slots, g, count):
        cfg = self.cfg
        n = count + 1
        bc1 = np.float32(1) - np.float32(cfg.b1) ** np.float32(n)
        bc2 = np.float32(1) - np.float32(cfg.b2) ** np.float32(n)
        mu_prev, nu_prev = slots["mu"], slots["nu"]
        mu = _weak(1 - cfg.b1, g) * g + _weak(cfg.b1, mu_prev) * mu_prev
        g2 = g * g
        nu = _weak(1 - cfg.b2, g2) * g2 + _weak(cfg.b2, nu_prev) * nu_prev
        mu_hat = mu / _weak(float(bc1), mu)
        nu_hat = nu / _weak(float(bc2), nu)
        u = mu_hat / (torch.sqrt(nu_hat) + _weak(1e-8, nu_hat))
        mu_prev.copy_(mu.to(self.mu_dtype))
        nu_prev.copy_(nu)
        return u

    def _adafactor(self, slots, g, p, count, layout=None):
        cfg = self.cfg
        dtype = p.dtype
        split = layout is not None and bool(layout.axes)
        # scale_by_factored_rms: optax's decay_rate is an exponent,
        # beta2_t = 1 - (t + 1)^-decay_rate, a float32 array; filled on
        # the leaf's device (a kernel, not a copy from the host)
        t = torch.full((), count + 1, dtype=torch.float32, device=g.device)
        decay = 1.0 - t ** -cfg.b2
        keep = 1.0 - decay
        g2 = g * g + _weak(1e-30, g)
        shape = tuple(p.shape) if layout is None else layout.shape

        def mean(x, d):
            # jnp.mean over dim d of the whole leaf, rounded to x's dtype
            if not split:
                return _mean(x, d)
            part = x.sum(dim=d, dtype=torch.float32)
            whole = layout.allsum(part, _drop(layout.spec, d))
            return (whole / shape[d]).to(x.dtype)

        def mean_all(x):
            if not split:
                return _mean(x)
            whole = layout.allsum(x.sum(dtype=torch.float32))
            return (whole / math.prod(shape)).to(x.dtype)

        dims = factored_dims(shape, cfg.factored_min_dim)
        if dims is not None:
            d1, d0 = dims
            v_row = (decay * slots["v_row"].float()
                     + keep * mean(g2, d0).float()).to(dtype)
            v_col = (decay * slots["v_col"].float()
                     + keep * mean(g2, d1).float()).to(dtype)
            reduced_d1 = d1 - 1 if d1 > d0 else d1
            row_col_mean = _mean(v_row, reduced_d1, keepdim=True)
            row_factor = (v_row / row_col_mean) ** -0.5
            col_factor = v_col ** -0.5
            if split:
                # the statistics are whole: this shard's rows and columns
                row_factor = layout.local(row_factor, _drop(layout.spec, d0))
                col_factor = layout.local(col_factor, _drop(layout.spec, d1))
            u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            slots["v_row"].copy_(v_row)
            slots["v_col"].copy_(v_col)
        else:
            v = (decay * slots["v"].float() + keep * g2.float()).to(dtype)
            u = g * v ** -0.5
            slots["v"].copy_(v)
        # clip_by_block_rms(1.0)
        rms = torch.sqrt(mean_all(u * u)) / _weak(1.0, u)
        u = u / torch.maximum(torch.ones_like(rms), rms)
        # scale_by_param_block_rms(min_scale=1e-3)
        p_rms = torch.sqrt(mean_all(p * p))
        return u * torch.where(p_rms <= _weak(1e-3, p), _weak(1e-3, p),
                               p_rms)

    @torch.no_grad()
    def update(self, grads: dict, state, params: dict,
               gnorm: torch.Tensor | None = None) -> None:
        """One step: ``params`` and ``state`` are updated in place.
        ``gnorm``: the global norm, where the caller computed it (on a
        mesh, over every rank's shards); default ``global_norm(grads)``."""
        if gnorm is None:
            gnorm = global_norm(grads)
        for k, g in grads.items():
            self.update_leaf(k, {s: getattr(state, s)[k]
                                 for s in self.slots},
                             g, params[k], gnorm, state.count,
                             self.layout(k, params[k]))
        state.count += 1


def global_norm(tensors: dict) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of every leaf's sum of
    squares (each leaf summed in its own dtype)."""
    total = sum((t * t).sum() for t in tensors.values())
    return torch.sqrt(total)


def make_optimizer(cfg: OptimConfig, *, mesh=None) -> Optimizer:
    """The chain; ``mesh``: it updates a rank's shards of each leaf
    (``LeafLayout``)."""
    return Optimizer(cfg, mesh)


# ---------------------------------------------------------------------
# host-offload policy: per-leaf chains + host placement
# ---------------------------------------------------------------------

def host_zeros(shape, dtype: torch.dtype) -> torch.Tensor:
    """Zeros in host memory: page-locked (``pin_memory``) where a CUDA
    device exists, so transfers to and from the card are asynchronous
    DMA (JAX's ``pinned_host``); plain CPU memory on a host without
    one."""
    return torch.zeros(shape, dtype=dtype,
                       pin_memory=torch.cuda.is_available())


def host_put(t: torch.Tensor) -> torch.Tensor:
    """``t`` in host memory (see ``host_zeros``); a tensor already there
    is returned as is."""
    if t.device.type == "cpu" and (t.is_pinned()
                                   or not torch.cuda.is_available()):
        return t
    out = torch.empty(t.shape, dtype=t.dtype,
                      pin_memory=torch.cuda.is_available())
    out.copy_(t)
    return out


def leaf_key(path: str) -> str:
    """The offload state's key of a leaf: its path joined with "."."""
    return path.replace("/", ".")


class OffloadOptimizer:
    """The ``make_optimizer`` chain, decomposed for streaming.

    Everything after the global-norm clip is leaf-local, so each leaf
    gets its own chain state (``{key: AdamState | FactoredState}`` over
    the one entry ``"leaf"``, keyed by the "."-joined leaf path) that
    is updated the moment that leaf's gradient lands on the host. The
    clip's one cross-leaf input, the global norm, is computed on the
    card and threaded through ``update_leaf``, which runs
    ``Optimizer.update_leaf`` — the on-card chain's arithmetic exactly.

    On a mesh each rank keeps the state of its shards (adafactor's row
    and column statistics whole, as on the card) and updates them on its
    host; adafactor's cross-rank sums go through the card
    (``LeafLayout.allsum``), their seconds in ``clock[0]``.
    """

    def __init__(self, cfg: OptimConfig, params: dict, mesh=None):
        self.cfg = cfg
        self.opt = Optimizer(cfg)
        self.paths = tuple(leaf_paths(params))
        self.keys = tuple(leaf_key(p) for p in self.paths)
        if len(set(self.keys)) != len(self.keys):
            raise ValueError("param leaf paths do not join uniquely")
        self._path = dict(zip(self.keys, self.paths))
        self.clock = [0.0]
        # from the parameters on the card, which record their specs (the
        # host buffers the update runs on do not)
        self.layouts = (leaf_layouts(params, mesh, self.clock)
                        if mesh is not None and cfg.factored else {})

    def init(self, params: dict) -> dict:
        """Host-resident state: ``{key: per-leaf chain state}`` in
        parameter order, built leaf by leaf in host memory."""
        flat = leaf_paths(params)
        out = {}
        for key, path in zip(self.keys, self.paths):
            # the layout from a shape-only (meta) leaf: no copy of the
            # parameter is made anywhere
            meta = torch.empty(flat[path].shape, dtype=flat[path].dtype,
                               device="meta")
            out[key] = self.opt.state_type(0, **{
                s: {"leaf": host_zeros(t.shape, t.dtype)}
                for s, t in self.opt.init_leaf(
                    meta, self.layouts.get(path)).items()})
        return out

    def update_leaf(self, key: str, leaf_state, grad: torch.Tensor,
                    param: torch.Tensor, gnorm: torch.Tensor) -> None:
        """One leaf's whole update, in place on ``param`` and
        ``leaf_state``: the global-norm clip against the precomputed
        ``gnorm``, the leaf's chain, then the update applied."""
        path = self._path[key]
        self.opt.update_leaf(
            path, {s: getattr(leaf_state, s)["leaf"]
                   for s in self.opt.slots},
            grad, param, gnorm, leaf_state.count, self.layouts.get(path))
        leaf_state.count += 1


def make_offload_optimizer(cfg: OptimConfig, params: dict, *,
                           mesh=None) -> OffloadOptimizer:
    if cfg.offload != "optimizer":
        raise ValueError(f"offload policy is {cfg.offload!r}, expected "
                         "'optimizer'")
    if cfg.train_only is not None:
        raise ValueError("offload='optimizer' does not compose with "
                         "train_only (LoRA states are small enough to "
                         "stay on the card)")
    return OffloadOptimizer(cfg, params, mesh)
