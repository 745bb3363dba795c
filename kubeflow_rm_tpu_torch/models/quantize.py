"""Weight-only int8 / int4 quantization (counterpart of
``kubeflow_rm_tpu/models/quantize.py``).

The same leaf formats, scales and rounding as the JAX package, so a
tree quantized there and carried over (``params.from_numpy_params``)
holds the bytes this module would have written:

- **int8** (``bits=8``): symmetric per output channel, ``scale =
  max|w| / 127`` over the contraction axis (−2 in the ``(in, out)``
  layout), stored float32, ``1.0`` where a channel is all zero. Leaves
  are ``{"q": int8, "s": float32}``.
- **int4** (``bits=4``): symmetric per group of ``group_size`` rows of
  the contraction axis, ``scale = max|w| / 7``, two nibbles a byte (hi =
  even row, lo = odd row). Leaves are ``{"q4": int8 packed, "s":
  float32}`` with the group axes kept: ``q4`` (..., K/g, g/2, out),
  ``s`` (..., K/g, 1, out).
- **unpacked int4** ``{"q8g", "s"}``: the nibbles as group-shaped int8,
  made once per generation (``unpack_int4_params``) so the decode steps
  pay only the int8 → compute-dtype dequant.

Norms and the embedding (a gather, one row per token) stay in their
dtype. ``maybe_dequant`` materialises the compute-dtype weight in
JAX's order of operations (convert ``q`` and ``s``, then multiply), so a
forward on a quantized tree equals a forward on the dequantized tree bit
for bit. Eager PyTorch does not fuse that dequant into the matmul: each
use writes a compute-dtype copy of the weight, so quantization here cuts
the stored bytes, not the bytes a step reads.
"""

from __future__ import annotations

import torch

#: weight leaves consumed by matmuls (the router stays float)
_MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                  "moe_gate", "moe_up", "moe_down")

_LEAF_KEYS = ({"q", "s"}, {"q4", "s"}, {"q8g", "s"})


def _scale(amax: torch.Tensor, levels: float) -> torch.Tensor:
    """``where(amax == 0, 1, amax / levels)`` in float32. The divisor is
    a tensor on ``amax``'s device: PyTorch's CUDA division by a Python
    scalar multiplies by its reciprocal, which can round the last bit
    away from the true quotient that the CPU and JAX compute."""
    quotient = amax / amax.new_full((), levels)
    return torch.where(amax == 0, torch.ones_like(amax), quotient)


def _quant_leaf(w: torch.Tensor) -> dict:
    """Symmetric int8 over the contraction axis (−2; leading axes are
    layer stacks)."""
    wf = w.float()
    scale = _scale(wf.abs().amax(dim=-2, keepdim=True), 127.0)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def int4_group(K: int, group_size: int) -> int:
    """The group ``_quant_leaf4`` uses for a contraction dim ``K``: an
    indivisible or odd group falls back to one group of ``K``."""
    g = min(group_size, K)
    return K if (K % g or g % 2) else g


def _quant_leaf4(w: torch.Tensor, group_size: int) -> dict:
    """Symmetric int4 with per-(group, out-channel) scales, two values
    packed a byte along the contraction axis."""
    wf = w.float()
    K = wf.shape[-2]
    if K % 2:
        raise ValueError(
            f"int4 packing needs an even contraction dim, got {K} "
            "(real transformer dims are even; pad or use int8)")
    g = int4_group(K, group_size)
    wg = wf.reshape(*wf.shape[:-2], K // g, g, wf.shape[-1])
    scale = _scale(wg.abs().amax(dim=-2, keepdim=True), 7.0)
    q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int8)
    hi, lo = q[..., 0::2, :], q[..., 1::2, :]    # (..., G, g/2, out)
    # int8 shifts wrap like JAX's: the hi nibble's sign bit lands in bit 7
    return {"q4": (hi << 4) | (lo & 0xF), "s": scale}


def _quant_fn(bits: int, group_size: int):
    """bits → the leaf quantizer of ``quantize_params`` and
    ``init_params_quantized``."""
    if bits == 8:
        return _quant_leaf
    if bits == 4:
        return lambda w: _quant_leaf4(w, group_size)
    raise ValueError(f"bits must be 8 or 4, got {bits}")


def quantize_params(params: dict, bits: int = 8,
                    group_size: int = 128) -> dict:
    """Quantize every matmul weight (and the lm head) to ``bits`` (8 or
    4); norms, the embedding and LoRA adapters pass through.
    ``group_size`` applies to int4 only. The input is not modified."""
    quant = _quant_fn(bits, group_size)
    blocks = {k: (quant(v) if k in _MATMUL_LEAVES else v)
              for k, v in params["blocks"].items()}
    out = dict(params, blocks=blocks)
    out["lm_head"] = quant(params["lm_head"])
    return out


def init_params_quantized(cfg, generator: torch.Generator,
                          device: str | torch.device | None = None, *,
                          bits: int = 8, group_size: int = 128,
                          mesh=None) -> dict:
    """Random-init a model directly into quantized form, one draw at a
    time, so the full-precision tree never exists: each matmul leaf is
    drawn a layer at a time (``llama.init_tree``) and each layer
    quantized before the next is drawn. The draws come from
    ``generator`` in ``init_params``' order, and quantization reduces
    along axis -2, so a layer's quantization is the stack's slice: the
    result is bit-identical to ``quantize_params(init_params(cfg,
    generator, device))`` from the same generator state. On ``mesh``
    each quantized layer is cut to this rank's slice as it is made
    (``models.init_params``' ``mesh``)."""
    from kubeflow_rm_tpu_torch.models import init_params

    quant = _quant_fn(bits, group_size)

    def transform(path, leaf):
        name = path.rsplit("/", 1)[-1]
        if name in _MATMUL_LEAVES or name == "lm_head":
            return quant(leaf)
        return leaf

    return init_params(cfg, generator, device, mesh=mesh,
                       transform=transform)


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) in _LEAF_KEYS


def unpack_int4(leaf: dict) -> dict:
    """Packed int4 → group-shaped int8 ``{"q8g", "s"}``: the ops of
    JAX's ``unpack_int4``, so a dequant of the result equals a dequant
    of the packed leaf bit for bit. Twice the bytes of the packed form:
    a transient of a generation (or the engine's resident form)."""
    packed = leaf["q4"]                          # (..., G, g/2, out)
    hi = packed >> 4                             # arithmetic: sign kept
    lo = (packed << 4) >> 4                      # int8 wraps, then sign
    q = torch.stack([hi, lo], dim=-2)            # (..., G, g/2, 2, out)
    gshape = (*packed.shape[:-2], packed.shape[-2] * 2, packed.shape[-1])
    return {"q8g": q.reshape(gshape), "s": leaf["s"]}


def unpack_int4_params(params):
    """Every packed-int4 leaf of a tree in its unpacked ``{"q8g", "s"}``
    form; every other leaf is passed through (the same object). A no-op
    on int8 and plain trees."""
    if isinstance(params, dict):
        if "q4" in params:
            return unpack_int4(params)
        return {k: unpack_int4_params(v) for k, v in params.items()}
    return params


def maybe_dequant(leaf, dtype: torch.dtype) -> torch.Tensor:
    """The weight in the compute dtype from any representation. A plain
    tensor already in ``dtype`` is returned as is (no copy)."""
    if not isinstance(leaf, dict):
        return leaf.to(dtype)
    if "q4" in leaf:
        leaf = unpack_int4(leaf)
    if "q8g" in leaf:
        q = leaf["q8g"]                          # (..., G, g, out)
        w = q.to(dtype) * leaf["s"].to(dtype)
        return w.reshape(*q.shape[:-3], q.shape[-3] * q.shape[-2],
                         q.shape[-1])
    return leaf["q"].to(dtype) * leaf["s"].to(dtype)


def quantized_bytes(params: dict) -> int:
    """Total stored bytes of a parameter tree."""
    if isinstance(params, dict):
        return sum(quantized_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
