"""Models of the port. ``generate`` (the per-step loop) is reached as
``models.generate.generate``: the package attribute ``generate`` is the
submodule."""

from kubeflow_rm_tpu_torch.models.generate import (
    KVCache, decode_chunk, generate_fused, init_cache,
)
from kubeflow_rm_tpu_torch.models.llama import (
    LlamaConfig, forward, forward_with_aux, init_params, param_spec_shapes,
)
from kubeflow_rm_tpu_torch.models.lora import add_lora, lora_mask, merge_lora
from kubeflow_rm_tpu_torch.models.params import from_numpy_params

__all__ = [
    "KVCache",
    "LlamaConfig",
    "add_lora",
    "decode_chunk",
    "forward",
    "forward_with_aux",
    "from_numpy_params",
    "generate_fused",
    "init_cache",
    "init_params",
    "lora_mask",
    "merge_lora",
    "param_spec_shapes",
]
