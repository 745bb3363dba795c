"""The program under test, ``kubeflow_rm_tpu_torch``, as the drivers
reach it: its model configuration built from a configuration file.
Nothing under ``portbench/reference`` imports this module."""

from __future__ import annotations

import torch

from portbench.arch import Arch


def model_config(a: Arch, **overrides):
    """The port's ``LlamaConfig`` or ``MixtralConfig`` at ``a``'s sizes,
    computing and storing in the configuration's dtype."""
    from kubeflow_rm_tpu_torch.models.llama import LlamaConfig
    from kubeflow_rm_tpu_torch.models.mixtral import MixtralConfig
    from kubeflow_rm_tpu_torch.parallel.moe import MoeConfig

    dtype = getattr(torch, a.dtype)
    kw = dict(vocab_size=a.vocab, dim=a.dim, n_layers=a.layers,
              n_heads=a.heads, n_kv_heads=a.kv_heads, hidden_dim=a.ffn,
              max_seq_len=a.max_positions, rope_theta=a.rope_theta,
              norm_eps=a.norm_eps, dtype=dtype, param_dtype=dtype)
    kw.update(overrides)
    if a.moe:
        return MixtralConfig(moe=MoeConfig(
            n_experts=a.experts, top_k=a.top_k,
            capacity_factor=a.capacity_factor,
            router_aux_weight=a.router_aux_coef), **kw)
    return LlamaConfig(**kw)
