"""The optimizer (counterpart of ``kubeflow_rm_tpu/training/optim.py``).

``make_optimizer`` is the JAX package's optax chain, term for term and
in its order:

1. ``clip_by_global_norm(grad_clip)``;
2. ``scale_by_adam(b1, b2, eps=1e-8, eps_root=0)`` with ``mu`` stored in
   ``mu_dtype`` and ``nu`` in the parameter's dtype;
3. ``add_decayed_weights(weight_decay)``, masked off every leaf whose
   path holds ``norm`` or starts with ``embed``;
4. ``scale_by_schedule(-warmup_cosine_decay_schedule)``, where the decay
   length includes the warmup.

It follows optax 0.2.6's arithmetic, including where it rounds: the
bias-corrected update is computed from the un-rounded first moment, and
``mu`` is cast to ``mu_dtype`` only after that; a Python scalar meets a
tensor in the tensor's dtype (JAX's weak typing), so the port rounds
every scalar to the tensor's dtype first. It is not
``torch.optim.AdamW``, whose eps placement and decay rounding differ.

The port updates in place (JAX returns new arrays): ``update`` writes
the parameters and the moments under ``torch.no_grad``.
"""

from __future__ import annotations

import math
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
    # adafactor (factored second moment): not ported yet
    factored: bool = False
    factored_min_dim: int = 128
    # "lora": train only adapter leaves; frozen leaves get neither
    # gradients nor moments
    train_only: str | None = None
    # "optimizer": host-offloaded optimizer state: not ported yet
    offload: str = "none"
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
    ``t``: rounded to ``t``'s dtype."""
    return torch.tensor(x, dtype=t.dtype).item()


@dataclass
class AdamState:
    count: int       # updates applied so far (optax's step count)
    mu: dict         # {path: first moment}, mu_dtype
    nu: dict         # {path: second moment}, the parameter's dtype


class Optimizer:
    """The chain of ``make_optimizer`` over a flat ``{path: tensor}``
    dict of trainable leaves."""

    def __init__(self, cfg: OptimConfig):
        self.cfg = cfg
        self.mu_dtype = getattr(torch, cfg.mu_dtype)

    def init(self, params: dict) -> AdamState:
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=self.mu_dtype)
                for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, grads: dict, state: AdamState, params: dict) -> None:
        """One step: ``params`` and ``state`` are updated in place."""
        cfg = self.cfg
        gnorm = global_norm(grads)
        trigger = gnorm < cfg.grad_clip
        count = state.count + 1
        bc1 = np.float32(1) - np.float32(cfg.b1) ** np.float32(count)
        bc2 = np.float32(1) - np.float32(cfg.b2) ** np.float32(count)
        step_size = -schedule(cfg, state.count)
        for k, g in grads.items():
            p = params[k]
            # clip_by_global_norm: select(trigger, g, g / ‖g‖ · max_norm)
            g = torch.where(trigger, g,
                            g / gnorm.to(g.dtype) * _weak(cfg.grad_clip, g))
            # scale_by_adam
            mu_prev, nu_prev = state.mu[k], state.nu[k]
            mu = (_weak(1 - cfg.b1, g) * g
                  + _weak(cfg.b1, mu_prev) * mu_prev)
            g2 = g * g
            nu = _weak(1 - cfg.b2, g2) * g2 + _weak(cfg.b2, nu_prev) * nu_prev
            mu_hat = mu / _weak(float(bc1), mu)
            nu_hat = nu / _weak(float(bc2), nu)
            u = mu_hat / (torch.sqrt(nu_hat) + _weak(1e-8, nu_hat))
            # add_decayed_weights (masked)
            if decays(k):
                u = u + _weak(cfg.weight_decay, p) * p
            # scale_by_schedule, then apply_updates in the param's dtype
            u = _weak(step_size, u) * u
            p.copy_((p + u).to(p.dtype))
            state.mu[k].copy_(mu.to(self.mu_dtype))
            state.nu[k].copy_(nu)
        state.count = count


def global_norm(tensors: dict) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of every leaf's sum of
    squares (each leaf summed in its own dtype)."""
    total = sum((t * t).sum() for t in tensors.values())
    return torch.sqrt(total)


def make_optimizer(cfg: OptimConfig) -> Optimizer:
    if cfg.factored:
        raise NotImplementedError(
            "factored=True (adafactor) is not ported yet (ROADMAP.md, "
            "queue A, slice 2 leftovers: adafactor)")
    if cfg.offload != "none":
        raise NotImplementedError(
            f"offload={cfg.offload!r} is not ported yet (ROADMAP.md, "
            "queue A, slice 5: the host-offload optimizer)")
    return Optimizer(cfg)
