"""LoRA adapters (counterpart of ``kubeflow_rm_tpu/models/lora.py``).

Adapters are extra leaves beside the base weight — ``{name}_lora_a``
(L, in, r) and ``{name}_lora_b`` (L, r, out) — applied in factored
form, ``h @ w + (h @ a) @ b * alpha / r``, never materializing the
(in, out) delta. ``b`` starts at zero, so the adapted model equals the
base until the first update. Freezing lives in the train step
(``training.train``, ``OptimConfig(train_only="lora")``): frozen leaves
get no gradient and no optimizer moments. The base may be quantized
(``models.quantize``): QLoRA trains bf16 adapters over a frozen int8 or
int4 base, which ``merge_lora`` refuses to fold into.
"""

from __future__ import annotations

import torch

from kubeflow_rm_tpu_torch.models.quantize import is_quantized, maybe_dequant
from kubeflow_rm_tpu_torch.models.remat import project

#: classic LoRA targets: the attention projections
DEFAULT_TARGETS = ("wq", "wv")

LORA_A = "_lora_a"
LORA_B = "_lora_b"


def is_lora_name(name: str) -> bool:
    return name.endswith(LORA_A) or name.endswith(LORA_B)


def _base_shape(w, shape=lambda t: tuple(t.shape)) -> tuple[int, int, int]:
    """(L, in, out) of a base weight: plain, int8 ``q``, or packed int4
    ``q4`` (L, G, g/2, out), as JAX reads them; ``shape`` reads an
    array's shape (the global one of a local shard)."""
    if not is_quantized(w):
        return shape(w)
    if "q4" in w:
        q4 = shape(w["q4"])
        return q4[0], q4[-3] * q4[-2] * 2, q4[-1]
    return shape(w["q"])


def add_lora(params: dict, rank: int, *, generator: torch.Generator,
             targets: tuple[str, ...] = DEFAULT_TARGETS,
             param_dtype: torch.dtype | None = None, mesh=None) -> dict:
    """Return ``params`` extended with rank-``rank`` adapters on
    ``targets``: ``a`` ~ N(0, 1)·0.02 drawn in float32 from
    ``generator`` (which must live on the weights' device), ``b`` zeros,
    both in ``param_dtype`` (default: the base weight's dtype, or bf16
    over a quantized base — the QLoRA recipe). The base tensors are
    shared, not copied. On ``mesh`` ``params`` is this rank's tree: the
    adapters are drawn at their global shapes, as one device draws
    them, and cut to this rank's slices (``sharding.shard_leaf``)."""
    from kubeflow_rm_tpu_torch.parallel.sharding import (
        global_shape, shard_leaf,
    )

    def shape(t):
        return tuple(t.shape) if mesh is None else global_shape(t, mesh)

    blocks = dict(params["blocks"])
    for t in targets:
        if t not in blocks:
            raise KeyError(f"lora target {t!r} not in blocks "
                           f"({sorted(blocks)})")
        w = blocks[t]
        L, d_in, d_out = _base_shape(w, shape)
        if is_quantized(w):
            dt, device = param_dtype or torch.bfloat16, w["s"].device
        else:
            dt, device = param_dtype or w.dtype, w.device
        a = torch.randn((L, d_in, rank), generator=generator,
                        dtype=torch.float32, device=device)
        new = {t + LORA_A: (a * 0.02).to(dt),
               t + LORA_B: torch.zeros((L, rank, d_out), dtype=dt,
                                       device=device)}
        for k, v in new.items():
            blocks[k] = (v if mesh is None
                         else shard_leaf(f"blocks/{k}", v, mesh))
    return dict(params, blocks=blocks)


def lora_proj(layer: dict, name: str, h: torch.Tensor, *, alpha: float,
              dtype: torch.dtype) -> torch.Tensor:
    """``h @ w`` plus the factored adapter delta when ``layer`` has one.
    A quantized base is dequantized to ``dtype`` first (QLoRA: a frozen
    int8/int4 base under bf16 adapters)."""
    out = project(h, maybe_dequant(layer[name], dtype), name)
    a = layer.get(name + LORA_A)
    if a is None:
        return out
    b = layer[name + LORA_B]
    rank = a.shape[-1]
    return out + (h @ a.to(dtype)) @ b.to(dtype) * (alpha / rank)


def merge_lora(params: dict, *, alpha: float) -> dict:
    """Fold the adapters into their base weights (serving form): in
    float32, cast back to the base dtype; adapter leaves are dropped."""
    src = params["blocks"]
    blocks = {}
    for k, v in src.items():
        if is_lora_name(k):
            continue
        a = src.get(k + LORA_A)
        if a is None:
            blocks[k] = v
            continue
        if is_quantized(v):
            raise ValueError(
                f"cannot merge adapters into quantized base weight {k!r}: "
                "dequantize first (maybe_dequant) or serve the adapted "
                "model unmerged")
        b = src[k + LORA_B]
        delta = torch.einsum("lir,lro->lio", a.float(), b.float())
        blocks[k] = (v.float() + delta * (alpha / a.shape[-1])).to(v.dtype)
    return dict(params, blocks=blocks)


def lora_mask(params: dict) -> dict:
    """True for adapter leaves — the trainable set — with the nesting of
    ``params``."""
    return {name: (lora_mask(leaf) if isinstance(leaf, dict)
                   else is_lora_name(name))
            for name, leaf in params.items()}
