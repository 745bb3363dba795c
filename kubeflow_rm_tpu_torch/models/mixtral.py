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
    LlamaConfig, _attention_half, _epilogue, _mesh_view, _prologue,
    init_tree, layer_slices, remat_block,
)
from kubeflow_rm_tpu_torch.models.llama import (
    param_spec_shapes as _llama_shapes,
)
from kubeflow_rm_tpu_torch.ops.norms import rms_norm
from kubeflow_rm_tpu_torch.parallel.moe import MoeConfig, moe_ffn
from kubeflow_rm_tpu_torch.utils.profiling import annotate


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


def init_params(cfg: MixtralConfig, generator: torch.Generator,
                device: str | torch.device | None = None, *,
                transform=None, layers: range | None = None) -> dict:
    """Random parameters matching ``param_spec_shapes``, by
    ``llama.init_tree``: leaf by leaf from ``generator``, every
    ``blocks`` leaf one layer at a time, each draw passed through
    ``transform(path, tensor)``, the stacked leaves keeping
    ``layers``."""
    from kubeflow_rm_tpu_torch.device import default_device

    return init_tree(cfg, param_spec_shapes(cfg), generator,
                     default_device(device), transform, layers)


def _moe_block(cfg: MixtralConfig, x, layer, cos, sin, positions, segments,
               impl, view=None):
    """Llama's attention half, then the MoE FFN half (on a mesh, this
    rank's experts). Returns (x, aux)."""
    x = _attention_half(cfg, x, layer, cos, sin, positions, segments, impl,
                        view)
    with annotate("block.mlp"):
        h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        out, aux = moe_ffn(layer, h, cfg.moe, dtype=cfg.dtype, view=view)
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
    mesh=None,
    local_vocab: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Causal LM forward: ((B, T, vocab) float32 logits, the router aux
    loss averaged over layers). The arguments are ``llama.forward``'s
    (``mesh`` and ``local_vocab`` too; a pp mesh runs the GPipe
    schedule); each block runs under the same remat wrapper and
    policy."""
    view = _mesh_view(mesh, cfg, params)
    if view is not None and view.pp > 1:
        from kubeflow_rm_tpu_torch.parallel.pipeline import (
            pipeline_forward_with_aux,
        )

        return pipeline_forward_with_aux(
            params, tokens, cfg, mesh, positions=positions,
            segments=segments, packed=packed, impl=impl,
            local_vocab=local_vocab)
    x, cos, sin, attn_positions = _prologue(params, tokens, cfg, positions,
                                            packed, view)
    blocks = params["blocks"]
    block = remat_block(partial(_moe_block, cfg, view=view), cfg)
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in layer_slices(blocks):
        x, aux = block(x, layer, cos, sin, attn_positions, segments, impl)
        aux_sum = aux_sum + aux
    return (_epilogue(params, x, cfg, view, local_vocab=local_vocab),
            aux_sum / cfg.n_layers)
