"""Ops of the port. Flash attention (forward and backward) lives in
``ops.flash_attention`` (a submodule, so its name is not re-exported
here)."""

from kubeflow_rm_tpu_torch.ops.attention import (
    attention_mask, dot_product_attention, flash_eligible,
)
from kubeflow_rm_tpu_torch.ops.losses import IGNORE_INDEX, softmax_cross_entropy
from kubeflow_rm_tpu_torch.ops.norms import rms_norm
from kubeflow_rm_tpu_torch.ops.rope import apply_rope, rope_angles

__all__ = [
    "IGNORE_INDEX",
    "apply_rope",
    "attention_mask",
    "dot_product_attention",
    "flash_eligible",
    "rms_norm",
    "rope_angles",
    "softmax_cross_entropy",
]
