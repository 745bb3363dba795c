"""Fine-tune a Llama with the port (counterpart of
``examples/finetune_llama.py``).

    python -m kubeflow_rm_tpu_torch.finetune --preset tiny --device cpu --steps 4
    python -m kubeflow_rm_tpu_torch.finetune --preset llama2_7b --lora-rank 16 \\
        --batch 2 --seq-len 2048 --data 'shards/*.jsonl' --checkpoint-dir ckpt
    python -m kubeflow_rm_tpu_torch.finetune --preset tiny --device cpu \\
        --lora-rank 4 --int4-base --steps 2

Weights come from ``--hf-model DIR`` (a local directory that
``save_pretrained`` wrote, read by ``models.convert.load_hf_dir``) or are
random from a fixed seed. Without ``--data`` the batches are synthetic.
With ``--lora-rank`` only rank-r adapters on wq/wv train; the base is
frozen and, since it never takes an update, stored in the compute dtype
— or quantized with ``--int8-base``/``--int4-base`` (QLoRA: built
directly in quantized form from the seed, or quantized after the load).
``fit`` resumes from ``--checkpoint-dir`` when it holds a checkpoint.
``--export-hf PATH`` writes the final weights as an HF-keyed ``.npz``
(adapters are left out: merge them first to keep them).
``--tb-logdir DIR`` writes the loop's metrics as tensorboard events
(``utils.tensorboard``; needs the ``tensorboard`` package).

``--dp/--fsdp/--tp`` train on a mesh: ``parallel.distributed.initialize``
joins the job's process group first (torchrun's env, or the notebook
webhook's), ``--fsdp`` defaults to world // (dp·tp), and every rank runs
``fit`` on its shards; rank 0 prints, samples and exports:

    torchrun --nproc-per-node 2 -m kubeflow_rm_tpu_torch.finetune \
        --device cpu --fsdp 2 --preset tiny --steps 4
    torchrun --nproc-per-node 4 -m kubeflow_rm_tpu_torch.finetune \
        --preset llama2_7b --lora-rank 16 --fsdp 2 --tp 2
"""

from __future__ import annotations

import argparse
import glob
import sys
from dataclasses import replace


def main(argv=None) -> int:
    import torch

    import numpy as np

    from kubeflow_rm_tpu_torch.device import default_device
    from kubeflow_rm_tpu_torch.models.convert import load_hf_dir, to_hf_llama
    from kubeflow_rm_tpu_torch.models.generate import (
        generate_fused, make_generate_step,
    )
    from kubeflow_rm_tpu_torch.parallel import distributed
    from kubeflow_rm_tpu_torch.parallel.mesh import (
        MeshConfig, axis_size, make_mesh, mesh_shape,
    )
    from kubeflow_rm_tpu_torch.parallel.sharding import (
        gather_params, shard_params,
    )
    from kubeflow_rm_tpu_torch.models import init_params
    from kubeflow_rm_tpu_torch.models.llama import PRESETS, LlamaConfig
    from kubeflow_rm_tpu_torch.models.lora import add_lora
    from kubeflow_rm_tpu_torch.models.quantize import (
        init_params_quantized, quantize_params,
    )
    from kubeflow_rm_tpu_torch.training.checkpoint import Checkpointer
    from kubeflow_rm_tpu_torch.training.data import (
        jsonl_documents, packed_batches, synthetic_batches,
    )
    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.train import (
        TrainConfig, init_train_state,
    )

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="tiny", choices=PRESETS)
    ap.add_argument("--hf-model", default=None, metavar="DIR",
                    help="local directory written by save_pretrained "
                         "(config.json + safetensors or .bin weights); "
                         "default: random weights of --preset")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--fsdp", type=int, default=0,
                    help="0 = world // (dp·tp) (one process: no mesh "
                         "unless --dp/--fsdp/--tp ask for one)")
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--lora-rank", type=int, default=0,
                    help="train rank-r adapters on wq/wv instead of full "
                         "fine-tuning (frozen base: no grads, no moments)")
    qbase = ap.add_mutually_exclusive_group()
    qbase.add_argument("--int8-base", action="store_true",
                       help="with --lora-rank: quantize the frozen base "
                            "to int8")
    qbase.add_argument("--int4-base", action="store_true",
                       help="with --lora-rank: pack the frozen base to "
                            "int4 (QLoRA)")
    ap.add_argument("--export-hf", default=None, metavar="PATH",
                    help="write the final weights as an HF state_dict "
                         "(.npz) here")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--tb-logdir", default=None,
                    help="write tensorboard events here (point a "
                         "Tensorboard CR at the same pvc:// path)")
    ap.add_argument("--data", default=None,
                    help="glob of pre-tokenized jsonl shards (default: "
                         "synthetic)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run on "
                         "the host)")
    ap.add_argument("--sample", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="greedy-decode a continuation at the end")
    args = ap.parse_args(argv)

    bits = 4 if args.int4_base else 8 if args.int8_base else None
    if bits and not args.lora_rank:
        ap.error("--int8-base/--int4-base need --lora-rank: a quantized "
                 "base is frozen (QLoRA)")
    if bits and args.export_hf:
        ap.error("--export-hf cannot export a quantized base: adapters do "
                 "not merge into int8/int4 weights (merge_lora refuses)")
    # 1. the job: a no-op for one process; torchrun ranks all join
    distributed.initialize(device=args.device)
    device = default_device(args.device)
    world, lead = distributed.world_size(), distributed.rank() == 0
    mesh = None
    if world > 1 or max(args.dp, args.fsdp, args.tp) > 1:
        fsdp = args.fsdp or max(1, world // (args.dp * args.tp))
        mesh = make_mesh(MeshConfig(dp=args.dp, fsdp=fsdp, tp=args.tp),
                         device)
        if lead:
            print(f"process {distributed.rank()}/{world} mesh "
                  f"{mesh_shape(mesh)}")
    # on a mesh every rank holds only its slices: drawn weights are cut
    # as they are drawn, a checkpoint is read into host memory and each
    # rank takes its slices to the card
    if args.hf_model:
        model_cfg, params = load_hf_dir(
            args.hf_model, device=device if mesh is None else "cpu",
            param_dtype=LlamaConfig.dtype if args.lora_rank else None)
    else:
        model_cfg = getattr(LlamaConfig, args.preset)()
        params = None
    if args.lora_rank:
        model_cfg = replace(model_cfg, param_dtype=model_cfg.dtype)
    cfg = TrainConfig(model=model_cfg, optim=OptimConfig(
        train_only="lora" if args.lora_rank else None,
        total_steps=args.steps))
    # fit restores the latest checkpoint when there is one, weights and
    # all: a resume draws no base (it would only be freed again before
    # the restore); otherwise fit starts from these weights, the moments
    # built on this rank's slices
    state = None
    resume = (args.checkpoint_dir is not None
              and Checkpointer(args.checkpoint_dir).latest_step()
              is not None)
    if not resume:
        gen = torch.Generator(device=device).manual_seed(0)
        if params is None and bits:
            # the base is built directly in quantized form, leaf by
            # leaf, so its full-precision copy never exists
            params = init_params_quantized(model_cfg, gen, device,
                                           bits=bits, mesh=mesh)
        else:
            if params is None:
                params = init_params(model_cfg, gen, device, mesh=mesh)
            if bits:
                params = quantize_params(params, bits=bits)
            if mesh is not None:
                params = shard_params(params, mesh, device)
        if args.lora_rank:
            params = add_lora(params, args.lora_rank,
                              generator=torch.Generator(device=device)
                              .manual_seed(1), mesh=mesh)
        state = init_train_state(cfg, params=params, mesh=mesh)
    del params

    if args.data:
        docs = jsonl_documents(sorted(glob.glob(args.data)), seed=0)
        batches = packed_batches(docs, args.batch, args.seq_len)
    else:
        batches = synthetic_batches(args.batch, args.seq_len,
                                    model_cfg.vocab_size)
    loop = LoopConfig(total_steps=args.steps,
                      log_every=max(1, args.steps // 10),
                      checkpoint_dir=args.checkpoint_dir,
                      grad_accum=args.grad_accum)
    callbacks = ()
    if args.tb_logdir:
        from kubeflow_rm_tpu_torch.utils.tensorboard import (
            TensorboardCallback,
        )
        callbacks = (TensorboardCallback(args.tb_logdir),)
    try:
        state, history = fit(cfg, batches, loop, state=state, device=device,
                             callbacks=callbacks if lead else (), mesh=mesh)
    finally:
        for cb in callbacks:
            cb.close()
    if lead:
        for rec in history:
            print(f"step {rec.step} loss {rec.loss:.4f} grad_norm "
                  f"{rec.grad_norm:.4f} {rec.tokens_per_sec:.0f} tok/s "
                  f"mfu {rec.mfu_pct:.1f}%")

    if args.sample:
        prompt = torch.ones((1, 4), dtype=torch.int32, device=device)
        if mesh is None:
            out = generate_fused(state.params, model_cfg, prompt,
                                 max_new_tokens=8)
        else:
            rows = axis_size(mesh, ("dp", "fsdp"))
            step = make_generate_step(state.params, model_cfg, mesh,
                                      max_new_tokens=8, total_len=12)
            out = step(state.params, prompt.expand(rows, 4).contiguous())
        if lead:
            print("sample token ids:", out[0].tolist())

    if args.export_hf:
        params = (state.params if mesh is None
                  else gather_params(state.params, mesh))
        if lead:
            np.savez(args.export_hf, **to_hf_llama(model_cfg, params))
            print(f"exported HF state_dict -> {args.export_hf}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
