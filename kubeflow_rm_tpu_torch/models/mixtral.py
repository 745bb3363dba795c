"""Mixtral-family sparse MoE decoder (counterpart of
``kubeflow_rm_tpu/models/mixtral.py``): Llama's attention stack with a
mixture-of-experts FFN in every layer (``parallel.moe``).

The structure is ``models.llama``'s (stacked ``(L, ...)`` leaves, a loop
over layers, remat with the same policies); the FFN half is the
dense-dispatch MoE layer. ``forward`` returns ``(logits, aux)``, the
router load-balancing loss averaged over layers, which
``training.train.loss_fn`` adds to the objective scaled by
``cfg.moe.router_aux_weight``.

``init_params`` draws every stacked leaf one layer at a time: a stacked
expert leaf of ``mixtral_8x7b`` holds 15 G elements, so a whole-leaf
float32 draw would need 60 GB beside the tree.
``quantize.init_params_quantized`` takes the same draws, so the two stay
bit-identical.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from functools import partial

import torch

from kubeflow_rm_tpu_torch.models.llama import (
    LlamaConfig, _attention_half, _prologue, init_leaf, layer_params,
    logits_head, remat_block,
)
from kubeflow_rm_tpu_torch.models.llama import (
    param_spec_shapes as _llama_shapes,
)
from kubeflow_rm_tpu_torch.ops.norms import rms_norm
from kubeflow_rm_tpu_torch.parallel.moe import MoeConfig, moe_ffn


@dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    moe: MoeConfig = field(default_factory=MoeConfig)

    @staticmethod
    def mixtral_8x7b(**overrides) -> "MixtralConfig":
        return replace(
            MixtralConfig(vocab_size=32000, dim=4096, n_layers=32,
                          n_heads=32, n_kv_heads=8, hidden_dim=14336,
                          rope_theta=1e6, max_seq_len=32768,
                          moe=MoeConfig(n_experts=8, top_k=2)),
            **overrides,
        )

    @staticmethod
    def tiny_moe(**overrides) -> "MixtralConfig":
        base = LlamaConfig.tiny()
        return replace(
            MixtralConfig(
                vocab_size=base.vocab_size, dim=base.dim,
                n_layers=base.n_layers, n_heads=base.n_heads,
                n_kv_heads=base.n_kv_heads, hidden_dim=base.hidden_dim,
                max_seq_len=base.max_seq_len, dtype=base.dtype,
                moe=MoeConfig(n_experts=4, top_k=2, capacity_factor=2.0)),
            **overrides,
        )


def param_spec_shapes(cfg: MixtralConfig) -> dict:
    """Llama's tree with the dense MLP replaced by stacked expert FFNs."""
    shapes = _llama_shapes(cfg)
    blocks = dict(shapes["blocks"])
    for k in ("w_gate", "w_up", "w_down"):
        del blocks[k]
    L, D, F_, E = cfg.n_layers, cfg.dim, cfg.hidden_dim, cfg.moe.n_experts
    blocks["router"] = (L, D, E)
    blocks["moe_gate"] = (L, E, D, F_)
    blocks["moe_up"] = (L, E, D, F_)
    blocks["moe_down"] = (L, E, F_, D)
    return {**shapes, "blocks": blocks}


def _by_layer(n_layers: int, make):
    """Stack ``make(i)`` (a tensor or a dict of tensors) over ``i`` into
    preallocated ``(L, ...)`` tensors, one layer's result alive at a
    time."""
    out, is_dict = None, False
    for i in range(n_layers):
        part = make(i)
        is_dict = isinstance(part, dict)
        parts = part if is_dict else {"": part}
        if out is None:
            out = {k: t.new_empty((n_layers, *t.shape))
                   for k, t in parts.items()}
        for k, t in parts.items():
            out[k][i] = t
        del part, parts
    return out if is_dict else out[""]


def init_params(cfg: MixtralConfig, generator: torch.Generator,
                device: str | torch.device | None = None, *,
                transform=None) -> dict:
    """Random parameters matching ``param_spec_shapes``, by
    ``llama.init_leaf``'s rules, drawn leaf by leaf from ``generator``
    and every ``blocks`` leaf one layer at a time. ``transform(name,
    tensor)``, if given, maps each draw (one layer of a stacked leaf, or
    a whole flat leaf) before the next is drawn — the quantizer of
    ``quantize.init_params_quantized``."""
    from kubeflow_rm_tpu_torch.device import default_device

    device = default_device(device)
    fn = transform or (lambda name, t: t)

    def leaf(name, shape):
        return fn(name, init_leaf(cfg, name, shape, generator, device))

    shapes = param_spec_shapes(cfg)
    out = {}
    for name, s in shapes.items():
        if name == "blocks":
            out[name] = {k: _by_layer(shp[0], lambda i, k=k, shp=shp:
                                      leaf(k, shp[1:]))
                         for k, shp in s.items()}
        elif isinstance(s, dict):
            out[name] = {k: leaf(k, shp) for k, shp in s.items()}
        else:
            out[name] = leaf(name, s)
    return out


def _moe_block(cfg: MixtralConfig, x, layer, cos, sin, positions, segments,
               impl):
    """Llama's attention half, then the MoE FFN half. Returns (x, aux)."""
    x = _attention_half(cfg, x, layer, cos, sin, positions, segments, impl)
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    out, aux = moe_ffn(layer, h, cfg.moe, dtype=cfg.dtype)
    return x + out, aux


def forward(
    params: dict,
    tokens: torch.Tensor,
    cfg: MixtralConfig,
    positions: torch.Tensor | None = None,
    segments: torch.Tensor | None = None,
    *,
    packed: bool = False,
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal LM forward: ((B, T, vocab) float32 logits, the router aux
    loss averaged over layers). The arguments are ``llama.forward``'s;
    each block runs under the same remat wrapper and policy."""
    x, cos, sin, attn_positions = _prologue(params, tokens, cfg, positions,
                                            packed)
    blocks = params["blocks"]
    block = remat_block(partial(_moe_block, cfg), cfg)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, aux = block(x, layer_params(blocks, i), cos, sin, attn_positions,
                       segments, impl)
        aux_sum = aux_sum + aux
    return logits_head(params, x, cfg), aux_sum / cfg.n_layers
