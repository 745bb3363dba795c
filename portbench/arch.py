"""A model configuration file as the benchmark reads it.

Each file under ``portbench/configs/`` holds the keys of the model's
published ``config.json`` (Hugging Face names), the keys changed from it
(``reduced``), the sizes the publisher leaves open (``assumed``) and the
deployment the cut stands for. ``Arch`` is the part of it every side of
the benchmark needs: the weight drawer, the FLOP counts, the plain
reference and the glue to the port. It imports nothing of the port.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

#: model types whose layer equations the reference implements
DENSE_TYPES = ("mistral", "llama")
MOE_TYPES = ("mixtral",)


@dataclass(frozen=True)
class Arch:
    name: str
    model_type: str
    vocab: int
    dim: int
    layers: int
    heads: int
    kv_heads: int
    ffn: int
    rope_theta: float
    norm_eps: float
    max_positions: int
    dtype: str
    experts: int = 0
    top_k: int = 0
    capacity_factor: float = 0.0
    router_aux_coef: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def moe(self) -> bool:
        return self.experts > 0


def read_config(path: str | Path) -> dict:
    with open(path) as f:
        return json.load(f)


def arch_of(name: str, conf: dict) -> Arch:
    """The ``Arch`` of a configuration file's contents."""
    mt = conf["model_type"]
    if mt not in DENSE_TYPES + MOE_TYPES:
        raise ValueError(f"{name}: model_type {mt!r} is not one the "
                         f"reference implements ({DENSE_TYPES + MOE_TYPES})")
    if conf.get("sliding_window") is not None:
        raise ValueError(f"{name}: a sliding window is not implemented")
    heads = conf["num_attention_heads"]
    if conf.get("head_dim", conf["hidden_size"] // heads) * heads \
            != conf["hidden_size"]:
        raise ValueError(f"{name}: head_dim * heads != hidden_size")
    moe = {}
    if mt in MOE_TYPES:
        moe = dict(experts=conf["num_local_experts"],
                   top_k=conf["num_experts_per_tok"],
                   capacity_factor=conf["assumed"]["capacity_factor"],
                   router_aux_coef=conf["router_aux_loss_coef"])
    return Arch(
        name=name, model_type=mt, vocab=conf["vocab_size"],
        dim=conf["hidden_size"], layers=conf["num_hidden_layers"],
        heads=heads, kv_heads=conf["num_key_value_heads"],
        ffn=conf["intermediate_size"], rope_theta=float(conf["rope_theta"]),
        norm_eps=float(conf["rms_norm_eps"]),
        max_positions=conf["max_position_embeddings"],
        dtype=conf["torch_dtype"], **moe)


def param_shapes(a: Arch, lora_rank: int = 0,
                 lora_targets: tuple = ()) -> dict:
    """``{path: shape}`` of the weights the benchmark draws, in the layout
    it hands to both sides: projections ``(in, out)``, per-layer weights
    stacked on a leading layer axis."""
    L, D, V, F = a.layers, a.dim, a.vocab, a.ffn
    q, kv = a.heads * a.head_dim, a.kv_heads * a.head_dim
    s = {"embed/tokens": (V, D), "blocks/attn_norm": (L, D),
         "blocks/wq": (L, D, q), "blocks/wk": (L, D, kv),
         "blocks/wv": (L, D, kv), "blocks/wo": (L, q, D),
         "blocks/mlp_norm": (L, D)}
    if a.moe:
        E = a.experts
        s.update({"blocks/router": (L, D, E), "blocks/moe_gate": (L, E, D, F),
                  "blocks/moe_up": (L, E, D, F),
                  "blocks/moe_down": (L, E, F, D)})
    else:
        s.update({"blocks/w_gate": (L, D, F), "blocks/w_up": (L, D, F),
                  "blocks/w_down": (L, F, D)})
    s.update({"out_norm": (D,), "lm_head": (D, V)})
    for t in lora_targets:
        _, d_in, d_out = s[f"blocks/{t}"]
        s[f"blocks/{t}_lora_a"] = (L, d_in, lora_rank)
        s[f"blocks/{t}_lora_b"] = (L, lora_rank, d_out)
    return s
