"""Hugging Face Llama checkpoints ↔ the port's parameter layout
(counterpart of ``kubeflow_rm_tpu/models/convert.py``).

``from_hf_llama`` takes a ``transformers.LlamaForCausalLM`` (anything
with ``state_dict()`` and ``.config``) or a bare state dict and returns
``(LlamaConfig, params)`` in the layer-stacked ``(in, out)`` layout of
``models.llama``. ``ops.rope.apply_rope`` rotates split halves as HF's
``rotate_half`` does, so projections transfer as plain transposes (a
``torch.nn.Linear`` stores (out, in)) with no head permutation.
``to_hf_llama`` is the inverse, as numpy float32 arrays under HF's keys.

``load_hf_dir`` reads a local directory that ``save_pretrained`` wrote
(``config.json`` and ``model*.safetensors``, sharded or not, or
``pytorch_model*.bin``) without ``transformers`` or ``safetensors``.
Nothing here downloads: a hub id is not a path.

Layout (HF name → port path, layer i stacked on axis 0; [T] transposed):

    model.embed_tokens.weight              embed/tokens      (V, D)
    model.layers.i.input_layernorm.weight  blocks/attn_norm  (L, D)
    model.layers.i.self_attn.q_proj.weight blocks/wq         (L, D, H*hd)   [T]
    ...k_proj / v_proj                     blocks/wk, wv     (L, D, KVH*hd) [T]
    ...o_proj                              blocks/wo         (L, H*hd, D)   [T]
    model.layers.i.post_attention_layernorm.weight blocks/mlp_norm (L, D)
    model.layers.i.mlp.gate_proj.weight    blocks/w_gate     (L, D, F)      [T]
    ...up_proj / down_proj                 blocks/w_up, w_down               [T]
    model.norm.weight                      out_norm          (D,)
    lm_head.weight                         lm_head           (D, V)         [T]
"""

from __future__ import annotations

import json
import mmap
import types
from dataclasses import replace
from pathlib import Path
from typing import Any

import numpy as np
import torch

from kubeflow_rm_tpu_torch.models.llama import LlamaConfig
from kubeflow_rm_tpu_torch.models.quantize import is_quantized

#: (port name, HF module under ``model.layers.i``) of the projections
_PROJECTIONS = (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"),
                ("w_gate", "mlp.gate_proj"), ("w_up", "mlp.up_proj"),
                ("w_down", "mlp.down_proj"))

#: safetensors dtype names the reader takes
_ST_DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16,
              "F32": torch.float32}


def check_hf_config(hf_config: Any) -> None:
    """Raise unless the HF config describes the model ``models.llama``
    computes: a ``llama`` with plain RoPE, SiLU, ``head_dim`` =
    hidden / heads and no biases. Anything else (a Llama-3.1
    ``rope_scaling``, q/k/v biases) would load and give wrong logits."""
    model_type = getattr(hf_config, "model_type", None)
    rope_scaling = getattr(hf_config, "rope_scaling", None)
    act = getattr(hf_config, "hidden_act", "silu")
    head_dim = hf_config.hidden_size // hf_config.num_attention_heads
    given_head_dim = getattr(hf_config, "head_dim", None)
    problems = []
    if model_type != "llama":
        problems.append(f"model_type {model_type!r} is not 'llama'")
    if rope_scaling:
        problems.append(f"rope_scaling {rope_scaling!r} (only plain RoPE "
                        "is computed)")
    if act != "silu":
        problems.append(f"hidden_act {act!r} is not 'silu'")
    if given_head_dim not in (None, head_dim):
        problems.append(f"head_dim {given_head_dim} != hidden_size / "
                        f"num_attention_heads = {head_dim}")
    for flag in ("attention_bias", "mlp_bias"):
        if getattr(hf_config, flag, False):
            problems.append(f"{flag} (the projections have no biases)")
    if problems:
        raise ValueError("unsupported HF config: " + "; ".join(problems))


def config_from_hf(hf_config: Any, **overrides) -> LlamaConfig:
    """A ``LlamaConfig`` from an HF Llama config: anything with its
    attributes (a ``transformers.LlamaConfig``, or a
    ``types.SimpleNamespace`` of ``config.json``), checked by
    ``check_hf_config``."""
    check_hf_config(hf_config)
    base = LlamaConfig(
        vocab_size=hf_config.vocab_size,
        dim=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(hf_config, "num_key_value_heads", None)
        or hf_config.num_attention_heads,
        hidden_dim=hf_config.intermediate_size,
        max_seq_len=hf_config.max_position_embeddings,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
        norm_eps=float(hf_config.rms_norm_eps),
    )
    return replace(base, **overrides)


def from_hf_llama(model_or_state: Any, cfg: LlamaConfig | None = None,
                  param_dtype: torch.dtype = torch.float32,
                  device: str | torch.device | None = None,
                  ) -> tuple[LlamaConfig, dict]:
    """Convert an HF ``LlamaForCausalLM`` or its state dict to
    ``(cfg, params)`` on ``device`` (the card unless the caller asks for
    the CPU), leaves in ``param_dtype``.

    A model also yields the config; a bare state dict (torch tensors or
    numpy arrays, with or without the ``model.`` prefix) needs ``cfg``.
    Each weight passes through float32 on its way to ``param_dtype``, as
    in JAX. A checkpoint with tied embeddings (no ``lm_head``) uses the
    embedding's transpose for the head. A key that the conversion does
    not read (a bias, a layer beyond ``cfg.n_layers``) raises, except
    the rotary ``inv_freq`` buffers.
    """
    from kubeflow_rm_tpu_torch.device import default_device

    device = default_device(device)
    if hasattr(model_or_state, "state_dict"):
        state = model_or_state.state_dict()
        if cfg is None:
            cfg = config_from_hf(model_or_state.config)
    else:
        state = dict(model_or_state)
        if cfg is None:
            raise ValueError("pass cfg when converting a bare state_dict")

    used = set()

    def get(name) -> torch.Tensor:
        for key in (name, f"model.{name}"):
            if key in state:
                used.add(key)
                return torch.as_tensor(state[key]).float()
        raise KeyError(f"{name} not found in state_dict "
                       f"(keys: {sorted(state)[:8]}...)")

    def cast(t):
        return t.to(device).to(param_dtype).contiguous()

    def stack(fmt, transpose=False):
        out = None
        for i in range(cfg.n_layers):
            m = get(fmt.format(i=i)).to(device)
            m = m.T if transpose else m
            if out is None:
                out = torch.empty((cfg.n_layers, *m.shape),
                                  dtype=param_dtype, device=device)
            out[i] = m
        return out

    embed = cast(get("embed_tokens.weight"))
    try:
        lm_head = cast(get("lm_head.weight").T)
    except KeyError:
        lm_head = embed.T.contiguous()    # tied embeddings
    blocks = {
        "attn_norm": stack("layers.{i}.input_layernorm.weight"),
        "mlp_norm": stack("layers.{i}.post_attention_layernorm.weight"),
    }
    for ours, theirs in _PROJECTIONS:
        blocks[ours] = stack(f"layers.{{i}}.{theirs}.weight", True)
    order = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
             "w_up", "w_down")
    params = {
        "embed": {"tokens": embed},
        "blocks": {k: blocks[k] for k in order},
        "out_norm": cast(get("norm.weight")),
        "lm_head": lm_head,
    }
    unread = sorted(k for k in state if k not in used
                    and not k.endswith("rotary_emb.inv_freq"))
    if unread:
        raise ValueError(f"{len(unread)} state_dict keys are not part of "
                         f"this Llama: {unread[:8]}")
    return cfg, params


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def to_hf_llama(cfg: LlamaConfig, params: dict) -> dict:
    """The params as an HF-keyed state dict of numpy float32 arrays, for
    ``LlamaForCausalLM.load_state_dict`` (wrap the values in tensors).
    LoRA adapters are left out, as in JAX: merge them first
    (``merge_lora``) to keep them. A quantized tree is refused."""
    blocks = params["blocks"]
    quantized = sorted(k for k, v in dict(blocks, lm_head=params["lm_head"])
                       .items() if is_quantized(v))
    if quantized:
        raise ValueError(
            f"cannot export quantized weights ({', '.join(quantized)}) "
            "to HF: export the unquantized weights (a quantized base "
            "cannot take merged adapters either)")
    state = {
        "model.embed_tokens.weight": _np(params["embed"]["tokens"]),
        "model.norm.weight": _np(params["out_norm"]),
        "lm_head.weight": _np(params["lm_head"]).T,
    }
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}"
        state[f"{pre}.input_layernorm.weight"] = _np(blocks["attn_norm"][i])
        state[f"{pre}.post_attention_layernorm.weight"] = \
            _np(blocks["mlp_norm"][i])
        for ours, theirs in _PROJECTIONS:
            state[f"{pre}.{theirs}.weight"] = _np(blocks[ours][i]).T
    return state


def read_safetensors(path) -> dict:
    """A ``.safetensors`` file as ``{name: tensor}`` without the
    ``safetensors`` package: an 8-byte little-endian header length, a
    JSON header of each tensor's dtype, shape and byte offsets, then the
    data. The tensors are CPU views of a private (copy-on-write) map of
    the file."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {meta['dtype']}; "
                             f"the reader takes {sorted(_ST_DTYPES)}")
        begin, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        count = (end - begin) // torch.empty((), dtype=dtype).element_size()
        if count != int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: {name} holds {count} values for "
                             f"shape {shape}")
        t = (torch.frombuffer(buf, dtype=dtype, count=count,
                              offset=8 + n + begin) if count
             else torch.empty(0, dtype=dtype))
        out[name] = t.reshape(shape)
    return out


def _weight_files(d: Path, stem: str, suffix: str) -> list[Path]:
    """The files of one format: the index's shards, or the single file."""
    index = d / f"{stem}{suffix}.index.json"
    if index.exists():
        shards = json.loads(index.read_text())["weight_map"].values()
        return [d / s for s in sorted(set(shards))]
    single = d / f"{stem}{suffix}"
    return [single] if single.exists() else []


def load_hf_dir(path, *, device: str | torch.device | None = None,
                param_dtype: torch.dtype | None = None,
                ) -> tuple[LlamaConfig, dict]:
    """``(cfg, params)`` from a local HF Llama directory: ``config.json``
    and the weights of ``model*.safetensors`` (sharded through
    ``model.safetensors.index.json``), else ``pytorch_model*.bin``
    (``torch.load(weights_only=True)``). ``param_dtype`` defaults to the
    config's ``param_dtype``; ``device`` to the card. The config must
    pass ``check_hf_config``; with ``tie_word_embeddings`` the head is
    the embedding, else the weights must hold ``lm_head.weight``."""
    d = Path(path)
    if not (d / "config.json").is_file():
        raise FileNotFoundError(f"{d}: no config.json (a local directory "
                                "written by save_pretrained is needed)")
    hf = types.SimpleNamespace(**json.loads((d / "config.json").read_text()))
    cfg = config_from_hf(hf)
    state = {}
    files = _weight_files(d, "model", ".safetensors")
    if files:
        for f in files:
            state.update(read_safetensors(f))
    else:
        files = _weight_files(d, "pytorch_model", ".bin")
        for f in files:
            state.update(torch.load(f, map_location="cpu",
                                    weights_only=True))
    if not files:
        raise FileNotFoundError(f"{d}: no model*.safetensors or "
                                "pytorch_model*.bin weights")
    if getattr(hf, "tie_word_embeddings", False):
        state.pop("lm_head.weight", None)
    elif "lm_head.weight" not in state:
        raise ValueError(f"{d}: no lm_head.weight, and config.json does "
                         "not tie the embeddings")
    return from_hf_llama(state, cfg, param_dtype or cfg.param_dtype, device)
