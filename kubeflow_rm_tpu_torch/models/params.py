"""Carry a parameter tree over from the JAX package.

``from_numpy_params`` takes the JAX parameter pytree with its leaves as
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the
port's parameter dict: the same nesting, the same names, the same
``(in, out)`` orientation and the same leaf dtypes. Per-layer weights
stay stacked on their leading ``(L, ...)`` axis (``llama.layer_params``
slices one layer as a view). LoRA adapter leaves (``*_lora_a``,
``*_lora_b``) ride along like any other leaf, and so do quantized
leaves (``models.quantize``): their int8 ``q``/``q4``/``q8g`` and
float32 ``s`` arrays are carried as they are. Both frameworks then
compute the same function on the same numbers — what the parity tests
need, since the two random-number generators never agree.
"""

from __future__ import annotations

import numpy as np
import torch

from kubeflow_rm_tpu_torch.models import mixtral
from kubeflow_rm_tpu_torch.models.llama import LlamaConfig, param_spec_shapes
from kubeflow_rm_tpu_torch.models.lora import is_lora_name
from kubeflow_rm_tpu_torch.models.quantize import is_quantized


def _to_tensor(arr, device) -> torch.Tensor:
    arr = np.array(arr)  # a writable copy: JAX hands out read-only views
    if arr.dtype.name == "bfloat16":
        # numpy has no native bf16; torch reads the 16 raw bits
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def quantized_leaf_shapes(leaf: dict, shape: tuple) -> dict:
    """The shapes a quantized form of a ``shape`` = (..., K, out) weight
    must have, with the group size read from the leaf itself: int8
    ``q`` (..., K, out) and ``s`` (..., 1, out); packed int4 ``q4``
    (..., K/g, g/2, out) and ``s`` (..., K/g, 1, out); unpacked
    ``q8g`` (..., K/g, g, out) with the same ``s``."""
    *lead, K, out = shape
    if "q" in leaf:
        return {"q": (*lead, K, out), "s": (*lead, 1, out)}
    key = "q4" if "q4" in leaf else "q8g"
    # a group's rows as stored: g/2 packed bytes or g values
    rows = np.shape(leaf[key])[-2] if np.ndim(leaf[key]) >= 2 else 0
    g = 2 * rows if key == "q4" else rows
    G = K // g if g and K % g == 0 else 0     # 0: no group size fits
    return {key: (*lead, G, rows, out), "s": (*lead, G, 1, out)}


def _walk(tree: dict, cfg: LlamaConfig, leaf_fn) -> dict:
    """``tree`` with ``leaf_fn`` applied to every array, each checked
    against the family's ``param_spec_shapes(cfg)`` (a quantized leaf's
    arrays against ``quantized_leaf_shapes``); LoRA adapters pass
    unchecked."""

    def walk(sub, shapes, path):
        out = {}
        for name, leaf in sub.items():
            where = "/".join(path + (name,))
            expect = shapes.get(name) if isinstance(shapes, dict) else None
            if isinstance(leaf, dict) and isinstance(expect, dict):
                out[name] = walk(leaf, expect, path + (name,))
                continue
            if isinstance(leaf, dict):
                if not (is_quantized(leaf) and isinstance(expect, tuple)):
                    raise ValueError(f"{where}: not a parameter or a "
                                     "quantized leaf of this config")
                out[name] = walk(leaf, quantized_leaf_shapes(leaf, expect),
                                 path + (name,))
                continue
            t = leaf_fn(leaf)
            if not isinstance(t, torch.Tensor):
                raise ValueError(f"{where}: a {type(t).__name__}, not an "
                                 "array")
            if expect is None and not is_lora_name(name):
                raise KeyError(f"{where}: not a parameter of this config")
            if expect is not None and tuple(t.shape) != tuple(expect):
                raise ValueError(f"{where}: shape {tuple(t.shape)} != "
                                 f"{tuple(expect)} for this config")
            out[name] = t
        return out

    shapes = (mixtral.param_spec_shapes(cfg)
              if isinstance(cfg, mixtral.MixtralConfig)
              else param_spec_shapes(cfg))
    return walk(tree, shapes, ())


def check_params(params: dict, cfg: LlamaConfig) -> None:
    """Raise unless every leaf of the port's ``params`` has the shape
    ``cfg`` gives it (plain, quantized or a LoRA adapter)."""
    _walk(params, cfg, lambda t: t)


def from_numpy_params(tree: dict, cfg: LlamaConfig,
                      device: str | torch.device | None = None) -> dict:
    """JAX parameter pytree (numpy leaves) -> the port's parameters on
    ``device``, every array's shape checked (``check_params``)."""
    from kubeflow_rm_tpu_torch.device import default_device

    device = default_device(device)
    return _walk(tree, cfg, lambda a: _to_tensor(a, device))
