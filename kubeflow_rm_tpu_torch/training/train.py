"""The training step (counterpart of ``kubeflow_rm_tpu/training/train.py``).

Single device: no mesh, no pipeline stages, no host offload (later
slices of the port). ``make_train_step`` returns ``step(state, batch)
-> (state, metrics)``, which differentiates the loss with
``torch.autograd.grad``, accumulates over ``grad_accum`` interleaved
microbatches, and applies ``training.optim``'s chain in place — the
port's counterpart of buffer donation: the returned state is the one
passed in, its tensors updated.

With ``OptimConfig(train_only="lora")`` the frozen leaves are set to
``requires_grad=False``: the backward computes no base-weight gradient
and the optimizer keeps no moments for them. That includes the int8 and
float32 arrays of a quantized base (QLoRA); full fine-tuning of a
quantized base raises, since int8 weights take no gradient.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from kubeflow_rm_tpu_torch.models.llama import (
    LlamaConfig, forward_with_aux, init_params,
)
from kubeflow_rm_tpu_torch.models.lora import is_lora_name
from kubeflow_rm_tpu_torch.ops.losses import softmax_cross_entropy
from kubeflow_rm_tpu_torch.training.optim import (
    AdamState, OptimConfig, global_norm, leaf_paths, make_optimizer,
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
    opt_state: AdamState


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
                     device: str | torch.device | None = None) -> TrainState:
    """Fresh state; pass ``params`` to start from existing weights (an
    ``add_lora`` output for adapter training), else they are drawn from
    ``generator`` on ``device``."""
    if params is None:
        params = init_params(cfg.model, generator, device)
    flat = leaf_paths(params)
    opt = make_optimizer(cfg.optim)
    train = {p: flat[p] for p in trainable_paths(cfg, params)}
    return TrainState(step=0, params=params, opt_state=opt.init(train))


def loss_fn(params: dict, batch: dict, cfg: TrainConfig):
    """Masked-mean cross-entropy (+ z-loss) of the model on ``batch``:
    "tokens" and "labels", plus "positions" and "segments" for packed
    documents (then ``packed=True``: the ``pack_documents`` layout keeps
    attention on the flash kernel)."""
    segments = batch.get("segments")
    logits, _ = forward_with_aux(
        params, batch["tokens"], cfg.model, positions=batch.get("positions"),
        segments=segments, packed=segments is not None)
    return softmax_cross_entropy(logits, batch["labels"], z_loss=cfg.z_loss)


def make_train_step(cfg: TrainConfig, state: TrainState,
                    grad_accum: int = 1) -> Callable:
    """Return ``step(state, batch) -> (state, metrics)``.

    ``batch`` maps names to (B, T) integer tensors on the parameters'
    device. ``grad_accum`` > 1 splits it into that many microbatches,
    microbatch m taking rows m, K+m, 2K+m, … (JAX's interleaved fold),
    and averages their gradients before ONE optimizer update. Metrics
    are 0-dim tensors (``loss``, ``grad_norm`` and the loss's aux
    terms), read by the caller when it chooses to sync.
    """
    train_paths = trainable_paths(cfg, state.params)
    train_set = set(train_paths)
    for path, leaf in leaf_paths(state.params).items():
        leaf.requires_grad_(path in train_set)
    opt = make_optimizer(cfg.optim)

    def grads_of(params, batch):
        flat = leaf_paths(params)
        leaves = [flat[p] for p in train_paths]
        (loss, aux) = loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: a.detach() for k, a in aux.items()}, \
            dict(zip(train_paths, grads))

    def step(state: TrainState, batch: dict):
        if grad_accum == 1:
            loss, aux, grads = grads_of(state.params, batch)
        else:
            rows = batch["tokens"].shape[0]
            if rows % grad_accum:
                raise ValueError(f"batch {rows} not divisible by "
                                 f"grad_accum={grad_accum}")
            grads, losses, auxes = None, [], []
            for m in range(grad_accum):
                micro = {k: v[m::grad_accum] for k, v in batch.items()}
                loss_m, aux_m, g = grads_of(state.params, micro)
                losses.append(loss_m)
                auxes.append(aux_m)
                grads = g if grads is None else {
                    k: grads[k] + g[k] for k in grads}
            grads = {k: g / grad_accum for k, g in grads.items()}
            loss = torch.stack(losses).mean()
            aux = {k: torch.stack([a[k] for a in auxes]).mean()
                   for k in auxes[0]}
        flat = leaf_paths(state.params)
        opt.update(grads, state.opt_state,
                   {p: flat[p] for p in train_paths})
        metrics = {"loss": loss, "grad_norm": global_norm(grads), **aux}
        state.step += 1
        return state, metrics

    return step
