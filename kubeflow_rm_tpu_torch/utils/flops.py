"""Model-FLOPs accounting and MFU (counterpart of
``kubeflow_rm_tpu/utils/flops.py``).

MFU = model FLOPs per second achieved / the card's dense bf16 peak.
Model FLOPs follow the JAX package's convention: 6 per matmul parameter
per trained token (forward 2 + backward 4; 4 with a frozen base), plus
the attention score and value products (12·L·H·hd·T per token, halved
for causal), and no rematerialization recompute. A mixture counts the
parameters a token passes through: its router and ``top_k`` experts,
not the experts it skips nor the dispatch and combine products.
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.models.llama import LlamaConfig

#: dense peaks from NVIDIA's data sheets, matched on the CUDA device
#: name: (substring, bf16 FLOP/s, HBM bytes/s). The first match wins,
#: so the plain "H100" (the SXM part) comes after its variants.
DEVICE_PEAKS = (
    ("H100 PCIe", 756e12, 2.0e12),
    ("H100 NVL", 835e12, 3.9e12),
    ("H200", 989e12, 4.8e12),
    ("H100", 989e12, 3.35e12),
)


def device_peaks(name: str):
    """``(matched key, bf16 FLOP/s, bytes/s)`` for a CUDA device name,
    or None for a device this table does not know."""
    for key, flops, bw in DEVICE_PEAKS:
        if key in name:
            return key, flops, bw
    return None


def device_peak_flops(device) -> float | None:
    """Dense bf16 peak FLOP/s of a torch device, or None (the CPU, an
    unknown card)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    peaks = device_peaks(torch.cuda.get_device_name(device))
    return None if peaks is None else peaks[1]


def matmul_param_count(cfg: LlamaConfig) -> int:
    """Parameters a token passes through in matmuls (excludes the
    embedding gather and the norm gains); of a mixture
    (``MixtralConfig``), the router and ``top_k`` experts a layer."""
    L, D, V = cfg.n_layers, cfg.dim, cfg.vocab_size
    H, KVH, hd, F = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.hidden_dim
    moe = getattr(cfg, "moe", None)
    ffn = (3 * D * F if moe is None
           else moe.top_k * 3 * D * F + D * moe.n_experts)
    per_layer = D * H * hd + 2 * D * KVH * hd + H * hd * D + ffn
    return L * per_layer + D * V  # + lm_head


def train_flops_per_token(cfg: LlamaConfig, seq_len: int,
                          causal: bool = True,
                          frozen_base: bool = False) -> float:
    """Model FLOPs per trained token for one forward + backward.

    ``frozen_base=True`` (LoRA): the base weights take no weight-gradient
    products, so each matmul parameter costs 4 FLOPs per token; adapter
    weight gradients are O(rank/dim) and ignored."""
    mat = (4.0 if frozen_base else 6.0) * matmul_param_count(cfg)
    attn = 12.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * seq_len
    if causal:
        attn /= 2.0
    return mat + attn

