"""Admission-time workload pricing: the memplan walker as a service
(counterpart of ``kubeflow_rm_tpu/analysis/jaxcheck/pricer.py``).

A **declared workload** (the JSON a user puts in the
``tpu.kubeflow.org/declared-workload`` annotation) is parsed, bounded,
walked on meta tensors (nothing materialises, no card needed for the
walk) and priced against the card's memory. The verdict carries the
full breakdown (params / grads / optimizer state / logits / workspace),
which phase binds, and the predicted FLOPs per step.

- **A memo cache** keyed by the canonical declaration: walking a 7B
  step costs seconds of CPU, but every replica of a storm declares the
  same few configs, so the steady state is a dict lookup under a lock.
- **Hard schema bounds** (layer/dim/seq/batch caps) so a hostile
  declaration cannot turn the webhook into a walking DoS.
- **The advisor** (:func:`advise`) walks a short ladder of cheaper knob
  settings (remat=full -> halve the microbatch -> offload=optimizer ->
  both) and returns the first rung that fits.

The budget is the card's: ``hbm_gib_per_chip=None`` reads
``torch.cuda.get_device_properties(0).total_memory`` (and raises without
a card, as the port's entry points do); a caller may pass the memory
explicitly. The JAX pricer's usable fraction (15.75/16) and 5% allocator
margin apply. Sharding model (JAX's): the step is priced on one card and
divided by the chip count. ``preset`` must name one of the port's
``LlamaConfig`` presets (the JAX parser accepts any attribute of its
``LlamaConfig`` and fails later, when it walks a non-preset).
"""

from __future__ import annotations

import functools
import json
from dataclasses import dataclass, replace

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock
from kubeflow_rm_tpu_torch.analysis.torchcheck.memplan import (
    GB, HBM_MARGIN, USABLE_FRACTION, card, model_config, walk_train_step,
)

OPTIMS = ("adamw", "adafactor")
REMATS = ("dots", "full", "attn", "mlp", "attn+mlp")
OFFLOADS = (None, "optimizer")

# schema bounds: a declaration is user input reaching the walker — cap
# everything that scales walk cost
MAX_LAYERS = 200
MAX_DIM = 32768
MAX_SEQ = 65536
MAX_BATCH = 65536
MAX_VOCAB = 1_000_000
MAX_LORA_RANK = 1024
#: the weights a declared LoRA adapts (the port's fine-tune recipe)
LORA_TARGETS = ("wq", "wv")

_MODEL_DIM_KEYS = ("dim", "n_layers", "n_heads", "n_kv_heads",
                   "hidden_dim", "vocab_size")


class DeclarationError(ValueError):
    """The declared-workload JSON is malformed or out of bounds."""


@dataclass(frozen=True)
class DeclaredWorkload:
    """A parsed, bounds-checked workload declaration."""
    preset: str | None           # LlamaConfig preset name, or None
    model: tuple | None          # explicit dims (sorted kv pairs)
    optim: str = "adafactor"
    batch: int = 32
    grad_accum: int = 32
    remat: str = "full"
    seq: int | None = None       # None: the preset's max_seq_len
    param_dtype: str = "bfloat16"
    offload: str | None = None
    tenant: str = "default"
    lora_rank: int = 0           # 0: full fine-tuning

    @property
    def microbatch(self) -> int:
        return self.batch // self.grad_accum

    def to_dict(self) -> dict:
        d = {"optim": self.optim, "batch": self.batch,
             "grad_accum": self.grad_accum, "remat": self.remat,
             "param_dtype": self.param_dtype}
        if self.preset:
            d["preset"] = self.preset
        if self.model:
            d["model"] = dict(self.model)
        if self.seq:
            d["seq"] = self.seq
        if self.offload:
            d["offload"] = self.offload
        if self.tenant != "default":
            d["tenant"] = self.tenant
        if self.lora_rank:
            d["lora_rank"] = self.lora_rank
        return d

    def key(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))


def parse(raw: str | dict) -> DeclaredWorkload:
    """Parse + validate a declaration. Raises :class:`DeclarationError`
    on anything malformed — callers degrade to chip-count-only
    admission, they do not reject."""
    from kubeflow_rm_tpu_torch.models.llama import PRESETS

    if isinstance(raw, str):
        try:
            raw = json.loads(raw)
        except (TypeError, ValueError) as e:
            raise DeclarationError(f"not valid JSON: {e}") from None
    if not isinstance(raw, dict):
        raise DeclarationError("declaration must be a JSON object")

    preset = raw.get("preset")
    model_raw = raw.get("model")
    if preset is not None:
        if not isinstance(preset, str) or preset not in PRESETS:
            raise DeclarationError(f"unknown model preset {preset!r}")
        model = None
    elif model_raw is not None:
        if not isinstance(model_raw, dict):
            raise DeclarationError("model must be an object of dims")
        dims = {}
        for k in _MODEL_DIM_KEYS:
            v = model_raw.get(k)
            if not isinstance(v, int) or v < 1:
                raise DeclarationError(
                    f"model.{k} must be a positive int")
            dims[k] = v
        if dims["n_layers"] > MAX_LAYERS or dims["dim"] > MAX_DIM \
                or dims["vocab_size"] > MAX_VOCAB:
            raise DeclarationError("model dims exceed pricing bounds")
        if dims["dim"] % dims["n_heads"] != 0:
            raise DeclarationError("dim must divide by n_heads")
        model = tuple(sorted(dims.items()))
    else:
        raise DeclarationError(
            "declaration needs 'preset' or explicit 'model' dims")

    optim = raw.get("optim", "adafactor")
    if optim not in OPTIMS:
        raise DeclarationError(f"optim must be one of {OPTIMS}")
    remat = raw.get("remat", "full")
    if remat not in REMATS:
        raise DeclarationError(f"remat must be one of {REMATS}")
    offload = raw.get("offload")
    if offload not in OFFLOADS:
        raise DeclarationError(f"offload must be one of {OFFLOADS}")
    batch = raw.get("batch", 32)
    accum = raw.get("grad_accum", batch)
    for name, v, cap in (("batch", batch, MAX_BATCH),
                         ("grad_accum", accum, MAX_BATCH)):
        if not isinstance(v, int) or not 1 <= v <= cap:
            raise DeclarationError(
                f"{name} must be an int in [1, {cap}]")
    if batch % accum != 0:
        raise DeclarationError("batch must divide by grad_accum")
    seq = raw.get("seq")
    if seq is not None and (not isinstance(seq, int)
                            or not 16 <= seq <= MAX_SEQ):
        raise DeclarationError(f"seq must be an int in [16, {MAX_SEQ}]")
    param_dtype = raw.get("param_dtype", "bfloat16")
    if param_dtype not in ("bfloat16", "float32"):
        raise DeclarationError(
            "param_dtype must be 'bfloat16' or 'float32'")
    tenant = raw.get("tenant", "default")
    if not isinstance(tenant, str) or len(tenant) > 63:
        raise DeclarationError("tenant must be a short string")
    lora_rank = raw.get("lora_rank", 0)
    if not isinstance(lora_rank, int) or not 0 <= lora_rank <= MAX_LORA_RANK:
        raise DeclarationError(
            f"lora_rank must be an int in [0, {MAX_LORA_RANK}]")
    if lora_rank and offload:
        raise DeclarationError("a LoRA declaration streams no optimizer "
                               "state: offload must be unset")
    return DeclaredWorkload(preset=preset, model=model, optim=optim,
                            batch=batch, grad_accum=accum, remat=remat,
                            seq=seq, param_dtype=param_dtype,
                            offload=offload, tenant=tenant,
                            lora_rank=lora_rank)


# ---- the walker ------------------------------------------------------

def _model_config(decl: DeclaredWorkload):
    return model_config(decl.preset, decl.remat, decl.seq, decl.param_dtype,
                        dims=None if decl.preset else dict(decl.model))


def _walk(decl: DeclaredWorkload) -> dict:
    """Walk the declared step and return the raw byte/flop tallies.
    Expensive (seconds) — always reached through the memo cache."""
    import torch

    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.train import TrainConfig

    model = _model_config(decl)
    optim_kw: dict = {"factored": decl.optim == "adafactor"}
    if decl.offload:
        optim_kw["offload"] = decl.offload
    params_fn = None
    if decl.lora_rank:
        # a frozen base with rank-r adapters on LORA_TARGETS: only the
        # adapters take gradients and optimizer state
        optim_kw["train_only"] = "lora"
        params_fn = functools.partial(_lora_params, model, decl.lora_rank)
    tcfg = TrainConfig(model=model, optim=OptimConfig(**optim_kw))
    # the streamed step: on-card peak = grad phase + the step's stream
    # slot; the optimizer state and the update live in host memory
    w = walk_train_step(tcfg, decl.batch, decl.grad_accum,
                        offload=decl.offload == "optimizer",
                        params_fn=params_fn)
    params_b = w["params_bytes"]
    opt_b = w["opt_state_bytes"]
    peak = w["peak_bytes"]
    logits_b = decl.microbatch * model.max_seq_len * model.vocab_size * 4
    grads_b = params_b if not decl.lora_rank else _adapter_bytes(
        params_fn(torch.Generator()))
    return {
        "peak_bytes": int(peak),
        "params_bytes": params_b,
        "grads_bytes": grads_b,
        "opt_state_bytes": opt_b,
        "logits_bytes": logits_b,
        "workspace_bytes": max(0, peak - params_b - grads_b - opt_b
                               - logits_b),
        "flops_per_step": w["flops_per_step"],
        "seq": model.max_seq_len,
        "n_params": params_b // (2 if decl.param_dtype == "bfloat16"
                                 else 4),
    }


def _lora_params(model, rank: int, gen):
    """The declared LoRA tree on the meta device."""
    from kubeflow_rm_tpu_torch.models import init_params
    from kubeflow_rm_tpu_torch.models.lora import add_lora

    return add_lora(init_params(model, gen, "meta"), rank, generator=gen,
                    targets=LORA_TARGETS)


def _adapter_bytes(params: dict) -> int:
    """Bytes of the adapters of a LoRA tree (what takes gradients)."""
    from kubeflow_rm_tpu_torch.models.lora import is_lora_name
    from kubeflow_rm_tpu_torch.training.optim import leaf_paths

    return sum(v.numel() * v.element_size()
               for k, v in leaf_paths(params).items()
               if is_lora_name(k.rsplit("/", 1)[-1]))


_cache: dict[str, dict] = {}
_cache_lock = make_lock("torchcheck.pricer")


def _walk_cached(decl: DeclaredWorkload) -> dict:
    key = decl.key()
    with _cache_lock:
        hit = _cache.get(key)
    if hit is not None:
        return hit
    out = _walk(decl)
    with _cache_lock:
        _cache[key] = out
    return out


def cache_clear() -> None:
    with _cache_lock:
        _cache.clear()


def budget_bytes_per_chip(hbm_gib_per_chip: float) -> int:
    """Usable-memory budget per card, in bytes."""
    return int(hbm_gib_per_chip * USABLE_FRACTION * (2 ** 30))


def card_gib() -> float:
    """The card's memory in GiB (raises without a card)."""
    return card()["total_memory"] / 2 ** 30


def _binding_phase(walk: dict) -> str:
    """Which component binds the peak — the explanation's headline."""
    state_b = (walk["params_bytes"] + walk["grads_bytes"]
               + walk["opt_state_bytes"])
    parts = {"state (params+grads+optimizer)": state_b,
             "logits": walk["logits_bytes"],
             "backward workspace": walk["workspace_bytes"]}
    return max(parts, key=parts.get)


def price(decl: DeclaredWorkload, *, chips: int,
          hbm_gib_per_chip: float | None = None) -> dict:
    """Price ``decl`` on ``chips`` cards of ``hbm_gib_per_chip`` GiB
    each (None: this process's card). Returns the admission verdict
    dict the webhook writes into the CR status."""
    if hbm_gib_per_chip is None:
        hbm_gib_per_chip = card_gib()
    walk = _walk_cached(decl)
    budget = budget_bytes_per_chip(hbm_gib_per_chip)
    per_chip = walk["peak_bytes"] / max(1, chips)
    fit = per_chip * (1 + HBM_MARGIN) <= budget
    binds = _binding_phase(walk)
    verdict = {
        "verdict": "fit" if fit else "rejected",
        "workload": decl.to_dict(),
        "chips": chips,
        "predicted_peak_gb": round(walk["peak_bytes"] / GB, 2),
        "predicted_peak_per_chip_gb": round(per_chip / GB, 2),
        "budget_per_chip_gb": round(budget / GB, 2),
        "hbm_margin": HBM_MARGIN,
        "binds": binds,
        "breakdown_gb": {
            "params": round(walk["params_bytes"] / GB, 2),
            "grads": round(walk["grads_bytes"] / GB, 2),
            "opt_state": round(walk["opt_state_bytes"] / GB, 2),
            "logits": round(walk["logits_bytes"] / GB, 2),
            "workspace": round(walk["workspace_bytes"] / GB, 2),
        },
        "flops_per_step": walk["flops_per_step"],
        "n_params": walk["n_params"],
        "tenant": decl.tenant,
    }
    verdict["explanation"] = (
        f"predicted peak {verdict['predicted_peak_per_chip_gb']} GB"
        f"/chip (x{chips} chips, {verdict['predicted_peak_gb']} GB "
        f"total) {'fits' if fit else 'exceeds'} the "
        f"{verdict['budget_per_chip_gb']} GB usable budget at a "
        f"{int(HBM_MARGIN * 100)}% allocator margin; "
        f"{binds} binds the peak")
    return verdict


# ---- the advisor -----------------------------------------------------

def _ladder(decl: DeclaredWorkload) -> list[DeclaredWorkload]:
    """Progressively cheaper rungs, least disruptive first. Each rung
    is a full declaration the user can paste back verbatim."""
    rungs: list[DeclaredWorkload] = []

    def push(d: DeclaredWorkload) -> None:
        if d != decl and d not in rungs:
            rungs.append(d)

    cur = decl
    if cur.remat != "full":
        cur = replace(cur, remat="full")
        push(cur)
    # shrink the microbatch (batch stays: more accumulation steps)
    mb_rung = cur
    while mb_rung.microbatch > 1:
        mb_rung = replace(mb_rung, grad_accum=mb_rung.grad_accum * 2)
        if mb_rung.batch % mb_rung.grad_accum != 0:
            break
        push(mb_rung)
    if cur.lora_rank:
        return rungs[:8]   # adapters' state is too small to stream
    # stream the optimizer update through host memory
    off = replace(cur, offload="optimizer")
    push(off)
    off_mb = off
    while off_mb.microbatch > 1:
        off_mb = replace(off_mb, grad_accum=off_mb.grad_accum * 2)
        if off_mb.batch % off_mb.grad_accum != 0:
            break
        push(off_mb)
    return rungs[:8]   # bound the webhook's worst-case walk count


def advise(decl: DeclaredWorkload, *, chips: int,
           hbm_gib_per_chip: float | None = None) -> dict | None:
    """The cheapest passing rung for a rejected declaration: the first
    ladder entry that fits, with its own priced verdict. None when no
    rung fits (the slice is simply too small)."""
    if hbm_gib_per_chip is None:
        hbm_gib_per_chip = card_gib()
    for rung in _ladder(decl):
        v = price(rung, chips=chips, hbm_gib_per_chip=hbm_gib_per_chip)
        if v["verdict"] == "fit":
            return {
                "workload": rung.to_dict(),
                "predicted_peak_per_chip_gb":
                    v["predicted_peak_per_chip_gb"],
                "budget_per_chip_gb": v["budget_per_chip_gb"],
                "note": _advice_note(decl, rung),
            }
    return None


def _advice_note(decl: DeclaredWorkload, rung: DeclaredWorkload) -> str:
    changes = []
    if rung.remat != decl.remat:
        changes.append(f"remat={rung.remat}")
    if rung.grad_accum != decl.grad_accum:
        changes.append(f"grad_accum={rung.grad_accum} "
                       f"(microbatch {decl.microbatch}"
                       f"->{rung.microbatch})")
    if rung.offload != decl.offload:
        changes.append(f"offload={rung.offload}")
    return "cheapest passing rung: " + ", ".join(changes)
