"""The one-card memory plan: cost-model predictions for the full-FT
ladder on the card (counterpart of
``kubeflow_rm_tpu/analysis/jaxcheck/memplan.py``).

``python -m kubeflow_rm_tpu_torch.analysis.torchcheck.memplan --out
PATH`` builds every ladder rung's REAL train step
(``training.train.make_train_step``, on fake tensors: nothing
materialises) and walks it with :mod:`.costmodel`. Each row carries the
predicted peak (donation honoured: the step updates its state in place)
and its breakdown (params / grads / optimizer state / logits /
workspace), the executed FLOPs, and a fit verdict against the card.

The card is read from CUDA (``torch.cuda.get_device_properties(0)
.total_memory``) or given (``--hbm-gib``, ``total_memory=``: the tests
on the CPU). The budget keeps the JAX plan's fractions: the usable share
15.75/16 of the memory and a 5% allocator margin (``HBM_MARGIN``). The
rungs carry no measurement: the JAX plan's ``measured`` and ``anchor``
columns are a TPU's; the card's own peaks come from ``chip_smoke.py``'s
``torchcheck`` phase, which runs reduced rungs and holds the walk to
``torch.cuda.max_memory_allocated()``.

**Gradient accumulation.** The port's step loops over its microbatches
in Python, so walking ``accum`` of them would take ``accum`` times as
long. The walk runs the step with two microbatches (the second one
holds the accumulated gradients and the new ones at once, the sum being
added into in place, which is the step's peak for any count from two
on, plus the rest of the batch) and counts each further microbatch as the second one's
``train.microbatch`` region: JAX's scan rule, the body's FLOPs times the
trip count. What this leaves out is the 0-dim metrics of the further
microbatches (a loss and its aux terms, 512 bytes and one flop each).

The ladder is the JAX plan's (names and recipes), plus one rung the
card must reject: Llama-2-13B full fine-tuning with adamw (params,
gradients and both moments in bf16, ~104 GB before any activation).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import dataclass

GB = 1e9            # the plan quotes decimal GB
USABLE_FRACTION = 15.75 / 16   # the JAX plan's usable share of the memory
HBM_MARGIN = 0.05   # allocator fragmentation + runtime scratch


@dataclass(frozen=True)
class Rung:
    name: str
    preset: str                  # LlamaConfig preset
    optim: str                   # "adamw" | "adafactor"
    batch: int
    accum: int
    remat: str
    seq: int | None = None       # None: the preset's max_seq_len
    extrapolated: bool = False


#: JAX's ladder, rung for rung, plus the 13B rung the card must reject
LADDER: tuple[Rung, ...] = (
    Rung("1.2B full-FT adamw mb2 dots accum64", "bench_1b", "adamw",
         128, 64, "dots"),
    Rung("1.2B full-FT adafactor mb2 dots accum64", "bench_1b",
         "adafactor", 128, 64, "dots"),
    Rung("1.2B adamw mb2 dots seq4096 accum8", "bench_1b", "adamw",
         16, 8, "dots", seq=4096),
    Rung("2.1B full-FT adafactor mb1 dots accum64", "bench_2b",
         "adafactor", 64, 64, "dots"),
    Rung("2.1B full-FT adafactor mb2 dots accum32", "bench_2b",
         "adafactor", 64, 32, "dots"),
    Rung("2.1B full-FT adafactor mb2 full accum32", "bench_2b",
         "adafactor", 64, 32, "full"),
    Rung("2.1B full-FT adafactor mb2 attn+mlp accum32", "bench_2b",
         "adafactor", 64, 32, "attn+mlp"),
    Rung("2.7B full-FT adafactor mb1 full accum32", "bench_2_7b",
         "adafactor", 32, 32, "full"),
    Rung("2.7B full-FT adafactor mb1 dots accum32", "bench_2_7b",
         "adafactor", 32, 32, "dots"),
    Rung("3.1B full-FT adafactor mb1 full accum64", "bench_3b",
         "adafactor", 64, 64, "full"),
    Rung("7B full-FT adafactor mb1 full seq2048", "llama2_7b",
         "adafactor", 32, 32, "full", seq=2048, extrapolated=True),
    Rung("13B full-FT adamw mb1 full seq2048", "llama2_13b", "adamw",
         32, 32, "full", seq=2048, extrapolated=True),
)


def card(total_memory: int | None = None,
         name: str | None = None) -> dict:
    """The card the plan is for: ``{"name", "total_memory"}`` read from
    CUDA device 0, or as given (``total_memory`` in bytes). Without a
    card and without ``total_memory`` it raises, as the port's entry
    points do."""
    if total_memory is None:
        import torch

        from kubeflow_rm_tpu_torch.device import default_device

        dev = default_device(None)
        props = torch.cuda.get_device_properties(dev)
        return {"name": props.name, "total_memory": int(props.total_memory)}
    return {"name": name or "given", "total_memory": int(total_memory)}


def budget_bytes(total_memory: int) -> float:
    """The usable share of a card's memory, in bytes."""
    return total_memory * USABLE_FRACTION


def fits(peak_bytes: float, total_memory: int) -> bool:
    return peak_bytes * (1 + HBM_MARGIN) <= budget_bytes(total_memory)


def model_config(preset: str, remat: str, seq: int | None = None,
                 param_dtype: str = "bfloat16", dims: dict | None = None):
    """A rung's or declaration's ``LlamaConfig``: a preset, or explicit
    ``dims``, with bf16 (or float32) parameters and its remat policy."""
    import torch

    from kubeflow_rm_tpu_torch.models.llama import LlamaConfig

    kw = {"param_dtype": getattr(torch, param_dtype), "remat_policy": remat}
    if seq:
        kw["max_seq_len"] = seq
    if preset:
        return getattr(LlamaConfig, preset)(**kw)
    return LlamaConfig(**dims, **kw)


def _tree_bytes(tree) -> int:
    from kubeflow_rm_tpu_torch.utils.pytree import tree_size_bytes

    return tree_size_bytes(tree)


def walk_train_step(tcfg, rows: int, accum: int, *, offload: bool = False,
                    params_fn=None, packed: bool = False) -> dict:
    """Walk one optimizer step of ``tcfg`` on a batch of ``rows`` ×
    ``max_seq_len`` tokens in ``accum`` microbatches: two of them are
    walked, and each further one counts the FLOPs of the second's
    ``train.microbatch`` region (its forward, backward and
    accumulation).

    ``params_fn(generator)`` builds the parameters on the meta device
    (default: the model's random init; the LoRA walk passes one that
    adds adapters). ``offload``: walk the streamed host-offload arm's
    on-card phase (``step.grad_phase``) and add its stream slot.
    ``packed``: the batch carries ``pack_documents``' positions and
    segment ids too. Returns the peak, FLOPs and the state's byte
    counts."""
    import torch

    from kubeflow_rm_tpu_torch.analysis.torchcheck.costmodel import estimate
    from kubeflow_rm_tpu_torch.models import init_params
    from kubeflow_rm_tpu_torch.training.optim import make_offload_optimizer
    from kubeflow_rm_tpu_torch.training.train import (
        TrainState, init_train_state, make_train_step,
    )

    if rows % accum:
        raise ValueError(f"batch {rows} not divisible by grad_accum {accum}")
    walked = min(accum, 2)
    seq = tcfg.model.max_seq_len
    gen = torch.Generator()
    params = None if params_fn is None else params_fn(gen)
    if offload:
        # the host-offload state lives in (pinned) host memory, which a
        # meta walk of the card's phase must not fill: its keys suffice
        if params is None:
            params = init_params(tcfg.model, gen, "meta")
        keys = make_offload_optimizer(tcfg.optim, params).keys
        state = TrainState(step=0, params=params,
                           opt_state=dict.fromkeys(keys))
    else:
        state = init_train_state(tcfg, gen, params=params, device="meta")
    step = make_train_step(tcfg, state, grad_accum=walked,
                           offload="optimizer" if offload else "none")
    batch = {k: torch.zeros(rows // accum * walked, seq, dtype=torch.int32,
                            device="meta")
             for k in ("tokens", "labels", "positions", "segments")[
                 :4 if packed else 2]}
    regions: dict = {}
    if offload:
        est = estimate(step.grad_phase, state.params, batch, regions=regions)
        slot = step.stream_slot_bytes
    else:
        est = estimate(step, state, batch, donate_argnums=(0,),
                       regions=regions)
        slot = 0
    flops = est.flops
    if accum > walked:
        flops += (accum - walked) * regions["train.microbatch"][-1]
    # the step holds its whole batch, not the walked rows alone
    slot += sum(v.numel() * v.element_size() for v in batch.values()) * (
        accum - walked) // walked
    return {
        "peak_bytes": int(est.peak_bytes + slot),
        "peak_bytes_no_donation": int(est.peak_bytes_no_donation + slot),
        "params_bytes": _tree_bytes(state.params),
        "opt_state_bytes": 0 if offload else _tree_bytes(state.opt_state),
        "flops_per_step": float(flops),
        "unknown_primitives": dict(est.unknown_primitives),
        "walked_accum": walked,
    }


def _rung_train_config(rung: Rung):
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.train import TrainConfig

    return TrainConfig(model=model_config(rung.preset, rung.remat, rung.seq),
                       optim=OptimConfig(factored=rung.optim == "adafactor"))


def walker_free(rung: Rung) -> dict:
    """A row's numbers that need no walk: the recipe, the state's bytes
    (on meta tensors), the logits and the FLOPs convention."""
    import torch

    from kubeflow_rm_tpu_torch.training.train import init_train_state
    from kubeflow_rm_tpu_torch.utils.flops import train_flops_per_token

    tcfg = _rung_train_config(rung)
    model = tcfg.model
    state = init_train_state(tcfg, torch.Generator(), device="meta")
    params_b = _tree_bytes(state.params)
    seq = model.max_seq_len
    mb_rows = rung.batch // rung.accum
    return {
        "recipe": {"optim": rung.optim, "batch": rung.batch,
                   "grad_accum": rung.accum, "remat": rung.remat,
                   "seq": seq, "microbatch": mb_rows},
        "n_params": params_b // 2,     # bf16
        "params_bytes": params_b,
        "grads_bytes": params_b,       # full FT: grads in the param dtype
        "opt_state_bytes": _tree_bytes(state.opt_state),
        "logits_bytes": mb_rows * seq * model.vocab_size * 4,
        "flops_per_token_convention":
            round(train_flops_per_token(model, seq), 1),
    }


def plan_rung(rung: Rung, total_memory: int) -> dict:
    """One ladder row: the walk of the rung's real step, its breakdown
    and its verdict on a card of ``total_memory`` bytes."""
    free = walker_free(rung)
    w = walk_train_step(_rung_train_config(rung), rung.batch, rung.accum)
    seq = free["recipe"]["seq"]
    params_b, grads_b = free["params_bytes"], free["grads_bytes"]
    opt_b, logits_b = free["opt_state_bytes"], free["logits_bytes"]
    peak = w["peak_bytes"]
    workspace_b = max(0, peak - params_b - grads_b - opt_b - logits_b)
    return {
        "name": rung.name,
        "preset": rung.preset,
        "recipe": free["recipe"],
        "n_params": free["n_params"],
        "predicted": {
            "peak_gb": round(peak / GB, 2),
            "peak_no_donation_gb": round(w["peak_bytes_no_donation"] / GB,
                                         2),
            "donation_savings_gb":
                round((w["peak_bytes_no_donation"] - peak) / GB, 2),
            "params_gb": round(params_b / GB, 2),
            "grads_gb": round(grads_b / GB, 2),
            "opt_state_gb": round(opt_b / GB, 2),
            "logits_gb": round(logits_b / GB, 2),
            "workspace_gb": round(workspace_b / GB, 2),
            "flops_per_step": w["flops_per_step"],
            "flops_per_token_executed":
                round(w["flops_per_step"] / (rung.batch * seq), 1),
            "flops_per_token_convention":
                free["flops_per_token_convention"],
            "fit": fits(peak, total_memory),
        },
        "walked_accum": w["walked_accum"],
        "unknown_primitives": w["unknown_primitives"],
        "extrapolated": rung.extrapolated,
    }


def offload_native_rows(total_memory: int) -> list[dict]:
    """The streamed host-offload arm (``make_train_step(offload=
    "optimizer")``) at 2.7B and 7B, adafactor, mb1, full remat: the walk
    of its on-card phase plus its stream slot (none on the card: the
    port stages in pinned host memory)."""
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.train import TrainConfig

    rows = []
    for preset, batch_rows, accum, seq, label in (
            ("bench_2_7b", 32, 32, None,
             "2.7B adafactor mb1 full + streamed host-offload "
             "optimizer (native)"),
            ("llama2_7b", 32, 32, 2048,
             "7B adafactor mb1 full seq2048 + streamed host-offload "
             "optimizer (native)"),
    ):
        tcfg = TrainConfig(model=model_config(preset, "full", seq),
                           optim=OptimConfig(factored=True,
                                             offload="optimizer"))
        w = walk_train_step(tcfg, batch_rows, accum, offload=True)
        rows.append({
            "name": label,
            "preset": preset,
            "on_card_peak_gb": round(w["peak_bytes"] / GB, 2),
            "stream_slot_gb": 0.0,
            "fit": fits(w["peak_bytes"], total_memory),
            "chunk_layers": tcfg.optim.offload_chunk_layers,
        })
    return rows


def build_plan(total_memory: int | None = None,
               name: str | None = None) -> dict:
    """The full plan: every ladder rung and the offload rows, for the
    card (read from CUDA) or a card of ``total_memory`` bytes."""
    dev = card(total_memory, name)
    mem = dev["total_memory"]
    return {
        "artifact": "the port's memory plan",
        "generated_by":
            "python -m kubeflow_rm_tpu_torch.analysis.torchcheck.memplan",
        "method": "walk of the real train step on fake tensors under a "
                  "TorchDispatchMode (analysis/torchcheck/costmodel.py), "
                  "storages live from allocation to their last "
                  "reference, in-place updates as donation",
        "device": {**dev,
                   "usable_bytes": budget_bytes(mem),
                   "allocator_margin": HBM_MARGIN},
        "rungs": [plan_rung(r, mem) for r in LADDER],
        "host_offload_native": offload_native_rows(mem),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubeflow_rm_tpu_torch.analysis.torchcheck.memplan")
    ap.add_argument("--out", default=None,
                    help="write the plan JSON here (default: stdout)")
    ap.add_argument("--hbm-gib", type=float, default=None,
                    help="the card's memory in GiB (default: read it "
                         "from CUDA device 0)")
    args = ap.parse_args(argv)
    if args.out and os.path.basename(args.out) == "MEMPLAN_r01.json":
        ap.error("MEMPLAN_r01.json is the JAX plan's artifact (a TPU's); "
                 "write the port's plan elsewhere")
    total = None if args.hbm_gib is None else int(args.hbm_gib * 2 ** 30)
    plan = build_plan(total, None if total is None
                      else f"{args.hbm_gib} GiB (given)")
    text = json.dumps(plan, indent=1)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
        print(f"wrote {args.out}: {len(plan['rungs'])} rungs, "
              f"{sum(not r['predicted']['fit'] for r in plan['rungs'])} "
              f"predicted not to fit")
        return 0
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
