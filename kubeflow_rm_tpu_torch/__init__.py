"""PyTorch/CUDA port of the ``kubeflow_rm_tpu`` compute path.

The JAX package stays the reference; every module here mirrors its
counterpart by name (``ops/attention.py`` ↔ ``kubeflow_rm_tpu/ops/
attention.py``) so the two can be read side by side, and the parity
tests (``tests/test_torch_*.py``) feed both the same numpy inputs.

This package imports ``torch``, numpy and the standard library only —
never ``jax`` and never ``kubeflow_rm_tpu``. What it needs from the JAX
package it keeps as its own copy.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (``device.default_device``); nothing moves to the CPU
silently. Flash attention's forward and backward are hand-written
Hopper kernels (``kernels/csrc/flash_fwd.cu``, ``flash_bwd.cu``); on a
CPU tensor the op runs their plain PyTorch versions instead. Entry
points: ``serve`` (the WSGI server) and ``finetune`` (the trainer).
"""

__all__ = ["default_device"]


def __getattr__(name):
    # resolved on first use, so a process that imports only host code of
    # the port (a control-plane shard worker) does not import torch
    if name == "default_device":
        from kubeflow_rm_tpu_torch.device import default_device
        return default_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
