"""Training of the port (counterpart of ``kubeflow_rm_tpu/training``):
``train`` (loss, step), ``optim`` (the optax chain), ``data``,
``checkpoint`` and ``loop`` (``fit``)."""

from kubeflow_rm_tpu_torch.training.optim import OptimConfig, make_optimizer
from kubeflow_rm_tpu_torch.training.train import (
    TrainConfig, TrainState, init_train_state, loss_fn, make_train_step,
)

__all__ = [
    "OptimConfig",
    "TrainConfig",
    "TrainState",
    "init_train_state",
    "loss_fn",
    "make_optimizer",
    "make_train_step",
]
