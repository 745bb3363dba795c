#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``kubeflow_rm_tpu_torch`` (never JAX) through its main path and
prints one JSON line per phase:

1. device  — the card, as torch and ``nvidia-smi`` name it.
2. build   — compiles every kernel under ``kubeflow_rm_tpu_torch/
   kernels/csrc`` with nvcc for sm_90a (one nvcc per source, in
   parallel) and prints the ptxas report; no kernel may spill, have its
   ``setmaxnreg`` ignored (C7508) or its ``wgmma``s serialised (C7520).
3. kernels — each kernel's wrapper against its plain PyTorch version on
   the card, at the main path's shapes and at edge cases (GQA,
   non-causal, segment ids with rows that match no key, a ragged T,
   head dim 64, a sequence shorter than one 128-row tile, T = 1100
   ragged against the 128-row tiles with GQA group 4 and segment ids,
   B·H = 67,200 rows, above the kernels' grid bound, which the wrappers
   launch in two chunks of whole batch rows):
   the forward (``flash_fwd``) and the backward
   (``flash_bwd_dq``, ``flash_bwd_dkv``) on the same inputs; then
   kernel, plain-version and library times (CUDA events around 10
   back-to-back calls, median of 20 such samples) at the Llama-2-7B
   shape (B=2, T=2048, H=32, D=128, causal).
4. forward — Llama-2-7B at full width (bf16 weights, random from a
   seeded generator), tokens (2, 2048): the flash kernel must launch
   once per layer, and the logits must agree with the dense-attention
   forward; ``decode_chunk`` prefill of 512 tokens against ``forward``.
5. serve   — ``serve.make_app`` on the same weights; 4 concurrent greedy
   requests (prompt lengths 5, 17, 64, 200; 32 new tokens) through the
   WSGI callable, each row equal to ``generate_fused`` on the batch.
6. engine  — ``ContinuousBatchingEngine`` on the same weights, 8 slots of
   512 tokens: 16 greedy requests (a shared 160-token system prompt, a
   prompt repeated to force a copy-on-write fork, all three SLO classes,
   one speculative request, one KV chain prefilled on a second engine
   and installed), run through the paged arm twice (the same tokens both
   times) and the contiguous arm once; every request finishes, the
   block pool is released, no flash kernel launches, and every token
   passes a teacher-forced check against ``forward`` (see ``DELTA``).
7. fleet   — the serving fleet (``controlplane/serving_fleet``) at full
   7B width on the same tree, each replica an engine of 8 × 512-token
   slots with its own paged cache: three replicas behind
   ``make_fleet_app`` take 15 requests sharing a 192-token system prompt
   and 3 three-turn sessions at once (the shared ones concentrate on
   the prompt's owner or spill, sessions stick, the owner's prefix hit
   ratio is above 0); a replica drained with two requests in its slots
   (its ``/healthz`` 503, both finish there) and another killed after 4
   engine steps with four requests on it (held by a step gate; every
   request completes, migrations ≥ 1); a disaggregated fleet (a prefill
   and two decode replicas over a ``GlobalBlockStore`` of 2 GiB) whose
   hot prompt is handed off, evicted from the holder's small pool into
   the store (promote-on-evict) and, after the holder dies, hit in the
   store by the survivor; every bf16 token within DELTA of a
   teacher-forced ``forward``; then the kill, drain and handoff paths
   in float32 at full depth, each request equal to a solo
   ``generate_fused``, and a ``/api/store/chain/<key>`` frame that
   ``chain_from_bytes`` and ``verify_chain`` accept. No flash kernel
   launches (serving decodes with explicit positions).
8. quant   — weight-only int8 and int4 (group 128) of the same weights:
   the packed bytes and scales equal the CPU's, each quantized forward
   launches the flash kernel once per layer and equals the forward of
   its dequantized tree bit for bit, ``generate_fused`` on the serve
   phase's prompts (int4 fused equal to the per-token loop), the engine
   on the int4 tree (8 of the engine phase's requests, teacher-forced
   check, pool released), and the HF conversion round trip at 7B width
   (``to_hf_llama`` → ``from_hf_llama``, and ``load_hf_dir`` on a
   two-layer directory).
9. train_grad — Llama-2-7B width at 4 layers, one packed row of 2048:
   the gradients of every parameter through the kernels and through
   dense attention must be equally close to a float32 forward's; with
   remat on, ``flash_fwd`` launches twice per layer and each backward
   kernel once.
10. train   — the trainer's main path: full Llama-2-7B, bf16 frozen base,
   rank-16 LoRA on wq/wv, 6 steps of B=2×2048 packed documents through
   ``training.loop.fit``: finite losses that fall, the base bit-identical,
   the adapters trained, the kernels launched as counted above.
11. qlora  — the same run over an int4 base built directly in packed form
   (``init_params_quantized``): losses fall, the packed base is
   byte-identical after, the adapters trained, the kernels launched as in
   the train phase.

12. controlplane — the control plane with the card as its node (run
   after the 7B tree is dropped, so the pod has the card to itself), in
   four arms. Arm A, the raw read path (``make_control_plane(cache=
   False)``): ``make_gpu_node("gpu-0", "h100-80gb-1")`` (the table's
   memory equal to the card's) and a Notebook declaring the train
   phase's LoRA workload, priced ``fit``, one replica, its pod bound to
   ``gpu-0`` with ``nvidia.com/gpu: "1"``, the accelerator selector and
   the injected env (``TPU_WORKER_ID=0``, ``TPU_WORKER_HOSTNAMES`` the
   pod's headless DNS name), Ready; stopped (replicas 0, no pod, the
   card free) and deleted (the children collected). Arm B, JAX's
   defaults (the informer cache, every webhook and controller, the
   culler on the phase's settable clock probing a standard-library
   server on 127.0.0.1 through ``default_probe(base_url=)``): a Profile
   with a one-card quota (the Namespace, ``default-editor``, the owner's
   RoleBinding, ``kf-resource-quota``); the ``notebook-images``
   ConfigMap and a PodDefault; the notebook ``ft`` with a short image
   name and the inject-oauth annotation (the reconciliation lock stamped
   then released, the image resolved, the oauth proxy and the auth
   companion's objects, the card on the notebook's container, the
   PodDefault's variable in the env). Then the pod's container runs as
   a child process with the pod's own env (``MASTER_ADDR=127.0.0.1``
   the one substitution: no cluster DNS here; ``CUDA_VISIBLE_DEVICES``
   the device plugin's allocation): ``launcher.torchrun`` joins a
   one-rank NCCL world and ``finetune`` runs Llama-2-7B at full width
   and depth, LoRA r16 on wq/wv, 2 × 2048, 3 steps: finite losses, the
   kernels launched 3 × 64 / 32 / 32, the peak within ``CP_PEAK_RTOL``
   of the pod's predicted-memory annotation, the PodDefault's variable
   seen. Then a second notebook is refused by the quota (no pod; the
   apiserver's quota admission names ``kf-resource-quota``); the pod
   reported Failed is re-created and bound again; the notebook, idle
   for 11 minutes on the clock, is culled (replicas 0, the card free,
   ``notebook_cull_total`` + 1); a TPUJob of one worker binds the freed
   card; the teardown leaves nothing of the profile's namespace. The
   jupyter and KFAM web apps run over arm B's apiserver on a threaded
   ``wsgiref`` server on 127.0.0.1 (:class:`WebAppServer`; the owner's
   identity header and a CSRF cookie and header pair): a client parks a
   readiness long-poll on ``ft`` before the manager reconciles it and
   polls until ``ready`` (the hub's wake counted in
   ``readiness_wake_to_observe_seconds``, ``readiness_waiters`` back at
   0); the spawner lists ``ft`` ``ready`` on ``h100-80gb-1``, its pod
   Running on ``gpu-0``, and offers ``h100-80gb-1``; KFAM makes a
   contributor an editor, whose ``ft2`` spawned through the form is the
   one the quota refuses; a user with no binding gets JAX's 403; the
   listing reads ``stopped`` after the cull; both notebooks are deleted
   through the app. Arm C,
   JAX's defaults with ``enable_suspend=True`` and a
   ``CheckpointerStateStore`` over the port's ``Checkpointer`` on the
   pod's checkpoint directory (a temporary one, removed after), in a
   namespace whose quota admits two one-card notebooks: ``ft``
   (priority ``low``, the same declaration, priced ``fit``) runs the
   fine-tune in a child that saves step 2 and holds, idle like a
   notebook between bursts, in step 3's callback (before step 3's save);
   its losses of steps 1-2 are arm B's bit for bit. ``hp`` (priority
   ``high``) then preempts it: ``ft`` suspended with reason
   ``preempted`` and the checkpoint token ``{"step": 2}``, its pod
   deleted, ``hp`` bound to ``gpu-0``; the smoke, as the kubelet,
   SIGKILLs the child (a SIGTERM would let ``fit`` save step 3). A
   resume of ``ft`` while ``hp`` holds the card leaves it parked;
   suspending ``hp`` re-binds ``ft`` to ``gpu-0`` with
   ``restored-step`` 2 and a ``Resumed`` event, and the new pod's child
   runs exactly one step, step 3: its loss bit-equal to arm B's step 3,
   64 / 32 / 32 launches, its peak within ``CP_PEAK_RTOL`` of the
   prediction. ``notebook_preempt_total`` and ``notebook_resume_total``
   move by one; drain, rebind and restore are observed; the checkpoint's
   bytes and save/restore seconds and each child's wall time are
   printed; the teardown leaves nothing. Arm D, the deployed layout
   (``deploy/``): two shards, each ``APIServer(shard=, wal_dir=)`` with
   the cluster's admission (validators, the notebook, PodDefault and
   card-injection webhooks) and fake kubelet behind a ``RestServer`` on
   127.0.0.1 (:class:`CPShard`); the platform outside it as the
   manifests' ``controller-manager`` runs it: ``make_cluster_manager``
   over ``ShardedKubeAPIServer``, a watch per ``WATCHED_KINDS``,
   ``run_forever`` under a ``LeaderElector`` over the router, the arm's
   namespace on the other shard than the lease's. ``gpu-0`` registers
   with the owning shard. Through the router: a Profile with a one-card
   quota, then ``ft`` declaring the workload, Ready with one replica
   and every object on the ring's owner only; read back as ``v1beta1``
   over REST (the slice in the annotation keys, the same object after
   conversion back); its pod over REST on ``gpu-0`` with one card and
   the injected env; the raw pod (the StatefulSet's template as the
   kubelet submits it) posted as an AdmissionReview to a
   ``WebhookServer(make_admission_handler(router))``, whose JSONPatch
   gives the env and resources the cluster stored; the pod's container
   for one step, its loss arm B's step 1 bit for bit, 64 / 32 / 32; the
   owning shard stopped and restarted in place from its WAL on the same
   port while a router read retries through it (the Notebook,
   StatefulSet and Pod back with the same uids and resourceVersions,
   every watched kind relisted, no pod created); the notebook deleted
   (its children collected) and the profile torn down; the servers,
   the manager and the watches stopped and the WAL directories removed.
   Arm E, the shards as processes (``shard/``): ``ShardRunner(2)``
   spawns two workers (each the apiserver on its WAL, the cluster's
   admission and kubelet, the REST facade on a fixed port and the
   platform's manager under its shard's lease), every one answering
   ``/healthz``, under a watchdog that respawns a dead one in place;
   through the router (a watch on Notebook, StatefulSet and Pod): a node
   and a one-card Profile on the shard that owns the notebook's
   namespace (chosen so neither the split nor the merge moves either),
   12 filler namespaces of 3 pods, and ``ft`` declaring the workload, to
   Ready. ``ElasticShardManager.split`` under the ``shard_split`` chaos
   arm admits ``shard-2`` as a fresh process while a writer creates pods
   in moving namespaces; the busiest donor is SIGKILLed between COPY
   and TAIL and the watchdog respawns it; after the flip every pod
   reads back through the router and lives on its ring owner only
   (each shard read through its own client). The notebook's shard is
   SIGKILLed: back at the same port from its WAL, the Notebook,
   StatefulSet and Pod with their uids and resourceVersions, no second
   pod, ``shard_deaths_total`` + 1. The pod's container runs one step
   from the pod's env read through the router: arm B's step-1 loss bit
   for bit, 64 / 32 / 32, the peak within ``CP_PEAK_RTOL`` of arm B's
   prediction of the same declaration (the shards' admission has no
   pricer), and that drift keeps ``declared-hbm-drift`` ok. A
   ``ShardAutoscaler`` ticked after the step merges back to two shards
   on the federated queue depth, retiring ``shard-2`` (no death
   counted), the audit holds again; the teardown leaves nothing; no
   shard pid holds a CUDA context (``nvidia-smi --query-compute-apps``),
   and none outlives ``stop()``. An ``obs.Observer`` watches the arm
   (the workers traced, this process's steps the roots): it federates
   the three shards' ``/metrics``, and scrapes ``shard-2`` no more after
   the merge; each death counted is a ``shard_death`` bundle or a
   suppression of the flight recorder's rate limit; the owner's bundle
   has every section, the surviving shards' series and slow traces
   whose critical paths sum to their durations, and reads back equal;
   at the end no SLO but ``shard-deaths`` is critical. Start, spawn,
   split, respawn, merge and child seconds, the ``SHARD_*`` counters,
   the observer's ticks, series, bundles and the autoscaler's decisions
   are printed. Arm F, the platform as its manifests deploy it
   (:func:`_cp_process_arm`): one :class:`CPShard` is the cluster, and
   the platform is three ``python -m kubeflow_rm_tpu_torch.controlplane``
   processes over its facade (``KUBE_API_URL``): ``controller-manager``
   (``LEADER_ELECT=true``; up once it holds the lease),
   ``webhook-server`` and ``gateway`` (``DEV_USER`` the owner; up once
   ``/healthz`` answers). Through the gateway over HTTP, as the SPA
   drives it: the shell ``/`` with ``text/html; charset=utf-8`` and the
   CSRF cookie the client then echoes, ``/static/app.js``; the
   workgroup's create (the profile's namespace made by the
   controller-manager process) and env-info offering ``h100-80gb-1``;
   the spawner's config and types, the form's spawn of ``ft`` on
   ``h100-80gb-1`` and the readiness long-poll until ``ready``; its pod
   on ``gpu-0`` with one card and the injected env. The raw pod's
   AdmissionReview posted to the webhook-server process gives the same
   response as ``make_admission_handler`` in this process over the same
   facade, and its patch the stored env and resources. The pod's
   container runs one step: arm B's step-1 loss bit for bit, 64 / 32 /
   32. The dashboard reads 1 node, 1 card of capacity, 1 in use and 1
   notebook running, a history point, ``default_slos()``'s names at
   ``/api/alerts``, 0 harvested and no leases, and ``/api/traces`` with
   tracing off. None of the three processes has torch mapped (this one
   has: the control). The notebook is deleted through the gateway, the
   profile torn down, and each process exits 0 on SIGTERM. Each
   process's start seconds, each request's ms and the spawn seconds are
   printed.
13. moe    — Mixtral 8x7B at full width and 16 of its 32 layers (bf16,
   47 GB; the 7B tree is dropped first): the forward at (1, 2048) with
   one ``flash_fwd`` launch a layer and a router aux loss in [1, 8];
   kernel and dense attention equally close to a float32 copy of the
   first 4 layers; ``generate_fused`` equal to the per-token loop; the
   engine (capacity factor 4: nothing drops) within δ of a
   teacher-forced forward; 4 LoRA steps of ``fit`` (losses fall, base
   bit-identical, ``router_aux`` reported, the kernels as counted).
14. moe_int8 — the full 32-layer Mixtral built directly in int8
   (``init_params_quantized``): stored bytes, fused decode equal to the
   per-token loop, no kernel launch.
15. offload — full fine-tuning of Llama-2-7B with adafactor and the
   optimizer state in host memory (``offload="optimizer"``, chunks of 4
   layers) against the on-card arm, 2 steps each from the same weights:
   step-1 losses bit-equal, step-1 weights within ``OFFLOAD_MAX_STEPS``
   bf16 steps, every layer of every leaf moved, the kernels as counted;
   then adam and adafactor the same way at 2 layers.
16. mesh1  — the mesh path at world size 1 over NCCL (run right after
   train, on the same 7B tree): ``make_mesh(MeshConfig(dp=1, fsdp=1,
   tp=1))``; the train phase's LoRA recipe through ``fit(..., mesh=)``
   for 3 steps (step-1 loss bit-equal to the train phase's, the kernels
   as counted, step time and peak beside train's); ``make_generate_step``
   of 4 prompts × 32 tokens equal to ``generate_fused``; ``make_app(...,
   mesh=)`` answering one ``/generate``; Ulysses at sp=1 on (2, 2048, 32,
   128), KVH 32 and 8, bit-equal to the flash op in output and gradients
   with one ``flash_fwd`` a call and one of each backward kernel; ring
   and zigzag at sp=1 in float32 within ``RING_ATOL`` of dense; and what
   a one-rank NCCL collective (which the port skips) would cost.
17. offload_mesh1 — the host-offload arm on a one-rank NCCL mesh
   (adafactor, 7B width, 2 layers, the offload phase's seed and batch):
   step-1 loss bit-equal to that phase's non-mesh streamed arm, the
   kernels as counted; ``pipeline_forward`` at pp=1 bit-equal to
   ``forward``.
18. mesh_multi — only on a machine with two or more cards:
   ``min(count, 4)`` NCCL ranks, one per card: a 7B-width 4-layer LoRA
   step at fsdp=2 (fsdp=2 × tp=2 at world 4) against the one-rank loss,
   Ulysses and ring at sp=world against the one-card flash op, and the
   step's collective times; the GPipe schedule at pp=2 (pp=2 × fsdp=2
   at world 4) on the same LoRA recipe with a batch of 8 × 2048 in 4
   microbatches against one rank (losses, grad norms, launches, step
   time, the measured bubble beside GPipe's 0.2); adafactor full
   fine-tuning at fsdp=2 × tp=2 against one rank; the host-offload
   arm on that mesh against the on-card arm; greedy decode on a pp=2
   mesh (pp=2 × fsdp=2 at world 4) and, on four cards, a 2-KV-head model
   at tp=4 (the K/V heads repeated): LoRA losses against one rank and
   decode tokens equal to one card's (decode in float32). Each rank
   joins through the launcher's torchrun env of a one-host slice
   (``launcher/torchrun.py``). A one-card machine prints
   ``{"phase": "mesh_multi", "skipped": "1 card"}``.
19. fleet_multi — only on a machine with two or more cards: the
   disaggregated part of ``fleet`` with its prefill replica on
   ``cuda:0`` and its decode replicas on the other cards (each gateway's
   drain thread on its engine's card), the same gates. A one-card
   machine prints ``{"phase": "fleet_multi", "skipped": "1 card"}``.
20. torchcheck — the program auditor (``analysis/torchcheck``) on the
   card: the cost model's self-check; the planner's walk of five reduced
   rungs (1.2B adamw mb2 dots, 2.7B and 7B adafactor mb1 full, 7B adamw
   mb1 full, each at an accumulation of 2, and the train phase's 7B LoRA
   step) against ``torch.cuda.max_memory_allocated()`` over one real
   step with the state resident, each within ``PLAN_RTOL``, beside the
   walk's peak for the step before its accumulation added in place and
   before its layers were sliced by ``llama.layer_slices``, and
   the same rows as the admission seam's drift gauge (below the
   warn-only SLO's 0.2); the 13B adamw rung, which
   the planner rejects, in a subprocess of its own that must end in
   ``torch.cuda.OutOfMemoryError`` before it completes a step (the one
   expected failure); the pricer's verdicts on the 7B declarations for
   1 and 4 cards and its advice for the 13B one; the engine phase's
   requests through both cache arms with the host-sync probe and the
   signature sentinel on (witnesses per region and site, every
   signature limit held), and one engine step's syncs as the CUDA
   runtime counts them (``set_sync_debug_mode("warn")``) beside the
   probe's; and ``utils.profiling.trace`` of one 7B LoRA step, whose
   trace must name the three kernels, their device times beside the
   kernels phase's; then 3 steps of the 7B LoRA ``fit`` and two of the
   7B adafactor rung under the probe, the sentinel and the control
   plane's probe bridges: no witness in ``train.step`` and
   ``implicit_hostsyncs_total{tenant="default"}`` unmoved, the CUDA
   runtime's syncs of the adafactor step reported, none of them in
   ``training/optim.py``.
21. seams  — the control plane's seams into the port: the admission
   pricer over a recorder API on the H100 slice table (its memory
   against this card's within 1%; the 7B and 13B declarations on one-
   and four-card Notebooks, every stamp equal to the pricer's own
   answer), the lint gate (``python -m
   kubeflow_rm_tpu_torch.analysis.torchcheck``, exit 0) and the
   launcher (``WorkerAgent`` on a one-host webhook env: ``/healthz``
   200 once ``join_slice`` has formed a one-rank NCCL world).

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` name/power
line, and last ``{"ok": true, "device": {...}}``. A failed check ends
its phase; the later phases still run (so one run reports every fault),
and the script then exits non-zero without the result lines. So does a
process without CUDA.
"""

from __future__ import annotations

import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import replace

O_TOL = dict(atol=2e-2, rtol=2e-2)   # bf16 output: p is rounded to bf16
LSE_ATOL = 1e-3                      # fp32 on both sides
# Two bf16 forwards (kernel attention, dense attention) are each held to
# a float32 forward of the same weights: at random init near-tied top
# logits make bf16-vs-bf16 argmax agreement a measure of the model's
# rounding noise, so the gate is that both are equally close to float32.
RATIO_MAX = 1.25                     # mean |logit error| ratio, either way
ARGMAX_GAP = 0.02                    # argmax-vs-float32 agreement gap
# backward kernels vs the plain version (float32 on the same bf16
# inputs): P and dS are rounded to bf16 before their products and the
# outputs are bf16, so the relative Frobenius error is ~3e-3
BWD_REL_MAX = 1e-2
# LoRA training: the learning rate of the 6-step run (warmup 1 step)
TRAIN_LR = 1e-3
# Engine, teacher-forced check: each generated token must be forward's
# argmax or have a logit within DELTA of forward's maximum at that
# position. Exactness cannot be asked in bf16 (the engine decodes 8 rows
# where forward runs 1, and a prefix hit splits the prefill), so DELTA
# is derived from the measured bf16-vs-float32 logit error m (the larger
# of the forward phase's max |Δlogit| and the same measure on the engine's
# own sequences): each of two bf16 computations lies within m of float32
# at every logit, so they differ by at most 2m there, and a token the
# engine preferred can trail forward's maximum by at most 2 · 2m.
DELTA_PER_ERROR = 4.0
ENGINE_SLOTS, ENGINE_SLOT_LEN, ENGINE_BLOCK = 8, 512, 16
# the speculative request: SPEC_CANDIDATES one-token prompts of SPEC_LEN
# tokens, SPEC_NEW new tokens
SPEC_CANDIDATES, SPEC_LEN, SPEC_NEW = 8, 128, 64
# new tokens of the request installed as a chain
CHAIN_NEW = 48
# Ring and zigzag at sp=1 on float32 inputs: an online softmax against
# one dense softmax, both float32 (a few ulps of the ~1 outputs)
RING_ATOL = 1e-5
# mesh_multi: MESH_STEPS LoRA steps of a bf16 model on the mesh against
# one rank (the first at lr 0: warmup). The tp all-reduces sum partial
# products, and the fsdp reduce-scatters bf16 partial gradients, in
# another order than one card's matmul. Loss: ~10x the 1.4e-5 measured
# at step 1 on four H100s. Grad norm (a bf16 scalar): under 2 of its
# ulps. The adapters' gradients at the same weights (||g_mesh - g_one||
# / ||g_one||): bf16 rounding of the partial sums moves them by ~1e-2,
# a reduction that drops, repeats or misplaces a rank's share by ~1.
# The adapters' update over the steps: Adam's first updates are near
# +-lr per element, so rounding flips whole elements where a gradient
# is near 0 (0.13-0.36 measured on four H100s, a few % of the elements
# flipped), while an unrelated update differs by sqrt(2).
MESH_STEPS = 3
# mesh_multi's GPipe: microbatches of the 8-row batch (one row each on
# pp=2 × fsdp=2); GPipe's bubble is then (pp-1)/(M+pp-1) = 0.2
PIPE_MICROBATCHES = 4
MESH_LOSS_RTOL = 1.5e-4
MESH_GNORM_RTOL = 1e-2
MESH_GRAD_RTOL = 5e-2
MESH_UPDATE_RTOL = 0.7
# Host-offload optimizer: the learning rate of its 2-step runs (no
# warmup: step 1 must move every bf16 weight, and adafactor's relative
# step of lr·rms(w) rounds away below ~4e-3), and how far its step-1
# weights may lie from the on-card arm's, in bf16 steps at the larger of
# the weight before and after (``bf16_steps``): the host's means reduce
# in another order than CUDA's, which moves a bf16 update u by a few of
# its own last bits (k steps at |u| ≤ 2·max(|w|, |w'|)), and each arm
# then rounds w + u once more: 2k + 1 steps with k ≤ 3
OFFLOAD_LR = 1e-2
OFFLOAD_MAX_STEPS = 7.0
# mesh_multi's adafactor (full fine-tuning at OFFLOAD_LR): its first
# step drops the loss 80-fold (11.2 to ~0.14 on four H100s), so the
# later steps' losses are held to MESH_LOSS_RTOL of the step-1 loss (the
# problem's scale), not of themselves: weights one bf16 step apart here
# and there move a loss near 0 by ~3e-4 (measured between the on-card
# and offload arms on one mesh too). Its step-1 weights are reported in
# bf16 steps (``bf16_steps``) but not gated: the ranks' gradients differ
# from one card's in their last bits, so where a gradient is ~0 its sign
# (and a factored update's) may flip, which on a weight near 0 reads as
# ~2^9 steps; OFFLOAD_MAX_STEPS bounds only a reordered update of equal
# gradients


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3,
                 calls: int = 10) -> float:
    """Time of one call of ``fn``: the median over ``iters`` samples,
    each the CUDA-event time of ``calls`` back-to-back calls divided by
    ``calls``. Back to back, the card's queue stays full, so a sample is
    the device's time and not the host's launch gap before a lone call
    (which adds tens of microseconds to a 0.2 ms kernel)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_profile(fn, top: int = 6) -> dict:
    """Run ``fn`` once under ``torch.profiler`` (CPU + CUDA) and return
    the host wall time, the device's busy time (union of kernel
    intervals), its idle share of the wall, the top kernels by total
    device time, and the port's flash kernels' totals wherever they
    rank. The profiler's own host cost inflates the wall, so the idle
    share is an upper bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        name = ev.name if len(ev.name) <= 80 else ev.name[:77] + "..."
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + end - start, n + 1)
    busy, last = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > last:
            busy += end - max(start, last)
            last = end
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    flash = sorted((n, tc) for n, tc in by_name.items() if "flash_" in n)
    return {"wall_ms": wall_us / 1e3,
            "device_busy_ms": busy / 1e3 if spans else "not measured",
            "device_idle_share": (1 - busy / wall_us) if spans
            else "not measured",
            "kernel_launches": len(spans),
            "top_kernels": [{"name": n, "ms": t / 1e3, "count": c}
                            for n, (t, c) in kernels],
            "flash_kernels": [{"name": n, "ms": t / 1e3, "count": c}
                              for n, (t, c) in flash]}


def peaks_for(name: str):
    """(key, bf16 FLOP/s, bytes/s) of the card from the port's table; an
    unknown card is taken as the H100 SXM."""
    from kubeflow_rm_tpu_torch.utils.flops import device_peaks

    return device_peaks(name) or device_peaks("H100")


def rel_err(a, ref) -> float:
    """||a - ref||_F / ||ref||_F in float32."""
    a, ref = a.float(), ref.float()
    return float((a - ref).norm() / ref.norm())


def phase_device():
    import torch

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    # a float32 reference must be float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return name, smi


def phase_build():
    from kubeflow_rm_tpu_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build()
    secs = time.perf_counter() - t0
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if any(w in ln for w in ("entry function", "registers",
                                          "spill", "smem", "warning",
                                          "C75"))]
             for n, log in build.build_logs.items()}
    emit("build", seconds=round(secs, 3),
         libraries={n: p.name for n, p in libs.items()}, ptxas=ptxas)
    # the kernels' register budgets hold: nothing spills, setmaxnreg is
    # taken (ptxas warns C7508 where it ignores it), and no wgmma is
    # serialised (C7520, e.g. one issued under a branch, or any other
    # "wgmma.mma_async instructions are serialized" report)
    for n, lines in ptxas.items():
        for ln in lines:
            check("C7508" not in ln, f"{n}: setmaxnreg ignored: {ln}")
            check("C7520" not in ln and "serialized" not in ln,
                  f"{n}: wgmma serialised: {ln}")
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", ln)
            check(spill is None or spill.groups() == ("0", "0"),
                  f"{n}: registers spill: {ln}")


def _qkv(gen, B, T, H, KVH, D):
    import torch

    def r(h):
        return torch.randn(B, T, h, D, generator=gen, device="cuda",
                           dtype=torch.float32).to(torch.bfloat16)

    return r(H), r(KVH), r(KVH)


KERNEL_CASES = [
    ("llama2_7b_causal", dict(B=2, T=2048, H=32, KVH=32, D=128), True, None),
    ("llama3_8b_gqa_causal", dict(B=2, T=2048, H=32, KVH=8, D=128), True, None),
    ("llama3_8b_gqa_noncausal", dict(B=2, T=2048, H=32, KVH=8, D=128), False, None),
    ("segments_with_orphan_rows", dict(B=2, T=1024, H=8, KVH=4, D=128), True, "seg"),
    ("ragged_T1000", dict(B=1, T=1000, H=8, KVH=2, D=128), True, None),
    ("head_dim_64", dict(B=2, T=512, H=8, KVH=8, D=64), True, None),
    ("short_T40", dict(B=2, T=40, H=8, KVH=8, D=128), True, None),
    ("ragged_T1100_gqa4_segments", dict(B=2, T=1100, H=16, KVH=4, D=128),
     True, "seg"),
    # B·H = 67,200 q rows: above the kernels' grid-y bound of 65,535, so
    # each wrapper launches once per whole-batch chunk of rows
    ("rows_above_grid_bound", dict(B=2100, T=64, H=32, KVH=8, D=128),
     True, "seg"),
]


def orphan_rows(T: int) -> slice:
    """Rows of batch 0 given a segment id that matches no key: 300..339,
    or 4 rows from the middle of a shorter sequence."""
    return slice(300, 340) if T >= 1000 else slice(T // 2, T // 2 + 4)


def doc_len(T: int) -> int:
    """Document length of the segment-id cases: 200 tokens, or a third
    of a shorter sequence."""
    return min(200, T // 3)


def to_bh(t):
    """(B, T, H, D) -> the kernels' contiguous (B·H, T, D)."""
    B, T, H, D = t.shape
    return t.transpose(1, 2).reshape(B * H, T, D).contiguous()


def check_backward(name, s, causal, qh, kh, vh, out, lse, segq, segkv, gen):
    """``flash_bwd`` (both kernels) against ``flash_attention_bwd_reference``
    in float32 on the same (q, k, v, O, lse, dO); returns the max |Δ| of
    dq and of dk/dv."""
    import torch

    from kubeflow_rm_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_reference, flash_bwd,
    )

    B, T, H, KVH, D = s["B"], s["T"], s["H"], s["KVH"], s["D"]
    do = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    kw = dict(heads=H, group=H // KVH, causal=causal)
    got = flash_bwd(qh, kh, vh, out, lse, do, segq, segkv, **kw)
    again = flash_bwd(qh, kh, vh, out, lse, do, segq, segkv, **kw)
    ref = flash_attention_bwd_reference(
        qh.float(), kh.float(), vh.float(), out.float(), lse, do.float(),
        segq, segkv, **kw)
    torch.cuda.synchronize()
    res = {}
    for what, g, r in zip(("dq", "dk", "dv"), got, ref):
        res[what] = dict(rel=rel_err(g, r),
                         max_abs=float((g.float() - r).abs().max()),
                         finite=bool(torch.isfinite(g).all()))
    orphan_zero = None
    if segq is not None:
        orphan_zero = bool((got[0].view(B, H, T, D)[0, :, orphan_rows(T)]
                            == 0).all())
    # no atomics: a second run gives the same bits
    deterministic = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    emit("kernels", case=name + "_backward", causal=causal, **s, **res,
         orphan_dq_zero=orphan_zero, deterministic=deterministic)
    check(deterministic, f"flash_bwd {name}: two runs differ")
    for what, r in res.items():
        check(r["finite"], f"flash_bwd {name}: non-finite {what}")
        check(r["rel"] <= BWD_REL_MAX,
              f"flash_bwd {name}: {what} rel err {r['rel']} > {BWD_REL_MAX}")
    if segq is not None:
        check(orphan_zero, f"flash_bwd {name}: orphan rows must give dq = 0")
    return res["dq"]["max_abs"], max(res["dk"]["max_abs"],
                                     res["dv"]["max_abs"])


def phase_kernels(device_name: str):
    import torch
    import torch.nn.functional as F

    from kubeflow_rm_tpu_torch.ops.attention import NEG_INF
    from kubeflow_rm_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_reference, flash_attention_reference,
        flash_attention_with_lse, flash_bwd_dkv, flash_bwd_dq, flash_fwd,
        row_chunks,
    )

    worst = dict(flash_fwd=0.0, flash_bwd_dq=0.0, flash_bwd_dkv=0.0)
    for i, (name, s, causal, seg) in enumerate(KERNEL_CASES):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        q, k, v = _qkv(gen, **s)
        kw = {}
        segq = segkv = None
        if seg:
            B, T = s["B"], s["T"]
            ids = torch.arange(T, device="cuda") // doc_len(T) + 1
            segkv = ids.expand(B, T).to(torch.int32).contiguous()
            segq = segkv.clone()
            segq[0, orphan_rows(T)] = 99          # rows that match no key
            kw = dict(segment_ids_q=segq, segment_ids_kv=segkv)
        # launches a wrapper call makes: one per chunk of whole batch rows
        chunks = len(row_chunks(s["B"] * s["H"], s["H"]))
        reset_launches()
        with torch.no_grad():
            out, lse = flash_attention_with_lse(q, k, v, causal=causal, **kw)
            ref, ref_lse = flash_attention_reference(q, k, v, causal=causal,
                                                     **kw)
        torch.cuda.synchronize()
        o, r = out.float(), ref.float()
        err = float((o - r).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        ok = bool(((o - r).abs() <= O_TOL["atol"] + O_TOL["rtol"] * r.abs()).all())
        worst["flash_fwd"] = max(worst["flash_fwd"], err)
        fwd_launches = read_launches()["flash_fwd"]
        emit("kernels", case=name, causal=causal, **s, max_abs_err=err,
             lse_max_abs_err=lse_err, within_tol=ok,
             flash_fwd_launches=fwd_launches)
        check(fwd_launches == chunks, f"flash_fwd {name}: {fwd_launches} "
                                      f"launches, expected {chunks}")
        check(ok, f"flash_fwd {name}: output outside atol=rtol=2e-2 "
                  f"(max abs err {err})")
        check(lse_err <= LSE_ATOL, f"flash_fwd {name}: lse err {lse_err}")
        check(bool(torch.isfinite(o).all()), f"flash_fwd {name}: non-finite")
        if seg:
            rows = orphan_rows(s["T"])
            check(bool((out[0, rows] == 0).all()),
                  "orphan rows must give O = 0")
            check(bool((lse[0, :, rows] == NEG_INF).all()),
                  "orphan rows must give lse = NEG_INF")
        B, T, H = s["B"], s["T"], s["H"]
        dq_err, dkv_err = check_backward(
            name, s, causal, to_bh(q), to_bh(k), to_bh(v), to_bh(out),
            lse.reshape(B * H, T).contiguous(), segq, segkv, gen)
        # check_backward runs flash_bwd twice (the determinism check)
        bwd = read_launches()
        check(bwd["flash_bwd_dq"] == bwd["flash_bwd_dkv"] == 2 * chunks,
              f"flash_bwd {name}: launches {bwd}, expected {chunks} of "
              "each kernel per call")
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], dq_err)
        worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], dkv_err)
        del q, k, v, out, lse, ref, ref_lse, o, r

    # timing at the main path's shape: one layer of the 7B forward and
    # backward. Least time for the work: causal pairs T(T+1)/2 per head;
    # the forward does 2 products (4·D FLOP a pair), dq 3 (S, dP, dQ:
    # 6·D), dkv 4 (S, dP, dV, dK: 8·D); each input read once, each
    # output written once.
    B, T, H, D = 2, 2048, 32, 128
    peak_key, peak_flops, peak_bw = peaks_for(device_name)
    pairs = B * H * T * (T + 1) / 2
    mat = B * H * T * D * 2                  # one bf16 (B·H, T, D) tensor
    row = B * H * T * 4                      # one float32 (B·H, T) row stat

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bw * 1e3
        return dict(bound_ms=max(t_ops, t_bytes),
                    bound_by="operations" if t_ops >= t_bytes else "bytes",
                    flops=flops, bytes=nbytes, peak=peak_key)

    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = _qkv(gen, B, T, H, H, D)
    qh, kh, vh = to_bh(q), to_bh(k), to_bh(v)
    kw = dict(heads=H, group=1, causal=True)
    timing = {}
    ms = cuda_time_ms(lambda: flash_fwd(qh, kh, vh, **kw))
    plain_ms = cuda_time_ms(
        lambda: flash_attention_reference(q, k, v, causal=True))
    qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
    library_ms = cuda_time_ms(
        lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True))
    timing["flash_fwd"] = dict(ms=ms, plain_ms=plain_ms,
                               library_ms=library_ms,
                               **bound(4.0 * D * pairs, 4 * mat + row))
    timing["flash_fwd"]["tflops_achieved"] = \
        timing["flash_fwd"]["flops"] / ms / 1e9
    emit("kernels", case="timing_llama2_7b_forward_shape", B=B, T=T, H=H,
         D=D, **timing["flash_fwd"])

    out, lse = flash_fwd(qh, kh, vh, **kw)
    do = torch.randn(out.shape, generator=gen, device="cuda").to(out.dtype)
    delta = (do.float() * out.float()).sum(-1)
    dq_ms = cuda_time_ms(lambda: flash_bwd_dq(qh, kh, vh, do, lse, delta,
                                              **kw))
    dkv_ms = cuda_time_ms(lambda: flash_bwd_dkv(qh, kh, vh, do, lse, delta,
                                                **kw))
    plain_ms = cuda_time_ms(lambda: flash_attention_bwd_reference(
        qh, kh, vh, out, lse, do, **kw))
    # the library's backward alone: autograd.grad of SDPA's output
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (qs, ks, vs))
    o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    do_lib = do.view(B, H, T, D)
    library_ms = cuda_time_ms(lambda: torch.autograd.grad(
        o_lib, (qs, ks, vs), do_lib, retain_graph=True))
    shared = dict(plain_ms=plain_ms, library_ms=library_ms,
                  plain_and_library_compute="dq, dk and dv together")
    timing["flash_bwd_dq"] = dict(ms=dq_ms, **shared,
                                  **bound(6.0 * D * pairs,
                                          5 * mat + 2 * row))
    timing["flash_bwd_dkv"] = dict(ms=dkv_ms, **shared,
                                   **bound(8.0 * D * pairs,
                                           6 * mat + 2 * row))
    fused = bound(10.0 * D * pairs, 7 * mat + 2 * row)
    for name in ("flash_bwd_dq", "flash_bwd_dkv"):
        t = timing[name]
        t["tflops_achieved"] = t["flops"] / t["ms"] / 1e9
    emit("kernels", case="timing_llama2_7b_backward_shape", B=B, T=T, H=H,
         D=D, dq=timing["flash_bwd_dq"], dkv=timing["flash_bwd_dkv"],
         two_kernels_ms=dq_ms + dkv_ms,
         fused_backward_bound_ms=fused["bound_ms"])
    return worst, timing


def versus(a, b):
    """mean/max |a - b| and argmax agreement of a with b."""
    d = (a - b).abs()
    return dict(mean_abs=float(d.mean()), max_abs=float(d.max()),
                argmax=float((a.argmax(-1) == b.argmax(-1)).float().mean()))


def equally_close(x, y, truth, what):
    """x and y are two bf16 computations of ``truth``: neither may be
    further from it than the other by more than the stated margin."""
    ex, ey = versus(x, truth), versus(y, truth)
    ratio = ex["mean_abs"] / ey["mean_abs"]
    check(1 / RATIO_MAX <= ratio <= RATIO_MAX
          and abs(ex["argmax"] - ey["argmax"]) <= ARGMAX_GAP,
          f"{what}: {ex} vs {ey} against the float32 forward")
    return ex, ey


def timed(fn, reps=3):
    """``fn``'s output and the wall times of ``reps`` calls after a
    warm-up call, as ``{"median", "min", "max"}`` in ms."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return out, dict(median=statistics.median(times), min=min(times),
                     max=max(times))


def phase_forward(cfg, params):
    import torch

    from kubeflow_rm_tpu_torch.models.generate import decode_chunk, init_cache
    from kubeflow_rm_tpu_torch.models.llama import forward

    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048), generator=gen,
                           device="cuda", dtype=torch.int32)

    cfg32 = replace(cfg, dtype=torch.float32)   # float32 activations
    with torch.inference_mode():
        reset_launches()
        logits = forward(params, tokens, cfg)            # the main path
        torch.cuda.synchronize()
        counts = read_launches()
        launches = counts["flash_fwd"]
        check(counts == {"flash_fwd": cfg.n_layers, "flash_bwd_dq": 0,
                         "flash_bwd_dkv": 0},
              f"forward launched {counts}, expected flash_fwd "
              f"{cfg.n_layers} times and no backward kernel")
        check(tuple(logits.shape) == (2, 2048, cfg.vocab_size)
              and bool(torch.isfinite(logits).all()), "bad forward logits")
        dense = forward(params, tokens, cfg, impl="dense")
        truth = forward(params, tokens, cfg32)
        torch.cuda.synchronize()
        check(read_launches() == counts,
              "dense/float32 forwards launched flash")
        kd = versus(logits, dense)
        k32, d32 = equally_close(logits, dense, truth,
                                 "kernel vs dense forward")
        del dense, truth

        prompt = tokens[:, :512]
        cache = init_cache(cfg, 2, 512, "cuda")
        pre, _ = decode_chunk(params, cfg, cache, prompt)
        ref = forward(params, prompt, cfg)
        truth = forward(params, prompt, cfg32)
        pk = versus(pre, ref)
        p32, f32 = equally_close(pre, ref, truth,
                                 "decode_chunk prefill vs kernel forward")
        del pre, ref, truth, cache

        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            forward(params, tokens, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        fwd_ms = statistics.median(times)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            forward(params, tokens, cfg, impl="dense")
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        dense_ms = statistics.median(times)
        prof = device_profile(lambda: forward(params, tokens, cfg))
    emit("forward", preset="llama2_7b", tokens=[2, 2048],
         flash_launches=launches, kernel_vs_dense=kd,
         kernel_vs_fp32=k32, dense_vs_fp32=d32,
         prefill512_vs_kernel_forward=pk, prefill512_vs_fp32=p32,
         kernel_forward512_vs_fp32=f32,
         forward_ms=fwd_ms, tokens_per_s=2 * 2048 / fwd_ms * 1e3,
         dense_forward_ms=dense_ms,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         profile=prof)
    # the largest bf16-vs-float32 logit error seen here bounds the
    # engine phase's teacher-forced check
    return counts, max(k32["max_abs"], d32["max_abs"], p32["max_abs"])


def phase_serve(cfg, params):
    import numpy as np
    import torch

    from kubeflow_rm_tpu_torch.models.generate import generate_fused
    from kubeflow_rm_tpu_torch.serve import make_app, request

    new = 32
    app = make_app(cfg, params, max_new_tokens=new, max_batch=4,
                   window_ms=2000.0, device="cuda")
    try:
        status, out = request(app, "POST", "/generate", {"prompt": [1, 2, 3]})
        check(status == 200 and len(out["tokens"]) == 3 + new,
              f"warm-up request: {status}")
        rng = np.random.default_rng(0)
        lens = (5, 17, 64, 200)
        prompts = [rng.integers(1, cfg.vocab_size, n).tolist() for n in lens]
        results = [None] * 4
        before = app.batcher.batches_run

        def go(i):
            t0 = time.perf_counter()
            st, body = request(app, "POST", "/generate", {"prompt": prompts[i]})
            results[i] = (st, body, (time.perf_counter() - t0) * 1e3)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        check(not any(t.is_alive() for t in threads), "a request hung")
        check(app.batcher.batches_run == before + 1,
              f"4 requests ran as {app.batcher.batches_run - before} batches")
        T = 256
        ids = np.zeros((4, T), np.int32)
        for i, p in enumerate(prompts):
            ids[i, T - len(p):] = p
        pads = torch.tensor([T - n for n in lens], dtype=torch.int32,
                            device="cuda")
        box = {}

        def run():
            box["ref"] = generate_fused(
                params, cfg, torch.from_numpy(ids).cuda(),
                max_new_tokens=new, max_len=T + new, pad_counts=pads)

        prof = device_profile(run)
        ref = box["ref"].cpu()
        for i, (st, body, _) in enumerate(results):
            check(st == 200, f"request {i}: status {st} {body}")
            toks = body["tokens"]
            check(len(toks) == lens[i] + new, f"request {i}: {len(toks)} tokens")
            check(toks == ref[i, T - lens[i]:].tolist(),
                  f"request {i} differs from generate_fused")
    finally:
        app.batcher.close()
    emit("serve", prompt_lens=list(lens), max_new_tokens=new,
         latency_ms=[r[2] for r in results], batch_wall_ms=wall * 1e3,
         decode_tokens_per_s=4 * new / wall, profile_generate_fused=prof)


def engine_traffic(vocab: int):
    """The engine phase's 14 plain requests, the speculative request's
    candidate tokens and the installed chain's prompt, from
    ``numpy.random.default_rng(0)``: prompt lengths 5..256
    (a 256-token prompt's prefill bucket plus 64 new tokens still fits a
    512-token slot; a longer one would need the 512 bucket and leave no
    room), 8..64 new tokens each, all three SLO classes."""
    import numpy as np

    from kubeflow_rm_tpu_torch.models.generate import SLO_CLASSES

    rng = np.random.default_rng(0)

    def toks(n):
        return rng.integers(1, vocab, n).tolist()

    def new():
        return int(rng.integers(8, 65))

    system = toks(160)                 # ten whole blocks, shared by 8
    reqs = [dict(prompt=system + toks(int(rng.integers(1, 97))), new=new(),
                 slo_class=SLO_CLASSES[j % 3]) for j in range(8)]
    base = toks(37)                    # ends inside its third block
    reqs += [dict(prompt=base, new=new(), slo_class="interactive"),
             # its exact repeat forks the partial block (copy-on-write)
             dict(prompt=list(base), new=new(), slo_class="interactive"),
             # an extension adopts its two whole blocks
             dict(prompt=base + toks(20), new=new(), slo_class="batch")]
    reqs += [dict(prompt=toks(n), new=new(), slo_class=c)
             for n, c in ((5, "best_effort"), (140, "interactive"),
                          (256, "batch"))]
    # the speculative request's candidate prompts: one token repeated
    # (see speculative_prompt)
    return reqs, toks(SPEC_CANDIDATES), toks(120)


def drafter_rounds(prompt, out, lookup_n=3, draft_k=8) -> int:
    """Model calls the prompt-lookup decoder (``_speculative_loop``) makes
    for ``out`` if its verified greedy tokens are ``out``: the prefill
    plus one a round, each round committing one token and the drafts
    that agree."""
    buf, i, rounds = list(prompt), 0, 1
    while i < len(out):
        buf.append(out[i])
        i += 1
        tail = buf[-lookup_n:]
        start = 0
        for p in range(len(buf) - lookup_n - 1, -1, -1):
            if buf[p:p + lookup_n] == tail:
                start = p + lookup_n
                break
        draft = (buf + [0] * (draft_k + 1))[start:start + draft_k]
        ok = 0
        while (ok < draft_k and i + ok < len(out)
               and draft[ok] == out[i + ok]):
            ok += 1
        buf.extend(out[i:i + ok])
        i += ok
        rounds += 1
    return rounds


def speculative_prompt(params, cfg, candidates, new: int):
    """The speculative request's prompt: of the one-token prompts
    ``[t] * SPEC_LEN``, the one whose greedy continuation (one batched
    ``generate_fused`` call) the drafter would cover in the fewest model
    calls. Prompt lookup saves calls only where the text repeats, and
    the random 7B's text repeats only for some prompts: a repeated
    token, whose values (no rotary embedding) are the same at every
    position and layer, often continues with runs of one token, but not
    always (on the H100 a random 12-token pattern ×4 accepted no draft,
    and some repeated tokens none). The check that follows —
    fewer model calls than tokens from the engine's own speculative
    decoder, and every token within DELTA — holds the decoder, not this
    choice. Returns (prompt, each candidate's predicted calls)."""
    import torch

    from kubeflow_rm_tpu_torch.models.generate import generate_fused

    rows = torch.tensor([[t] * SPEC_LEN for t in candidates],
                        dtype=torch.int32,
                        device=params["embed"]["tokens"].device)
    outs = generate_fused(params, cfg, rows, max_new_tokens=new).tolist()
    calls = [drafter_rounds(o[:SPEC_LEN], o[SPEC_LEN:]) for o in outs]
    best = min(range(len(candidates)), key=calls.__getitem__)
    return [candidates[best]] * SPEC_LEN, calls


def run_engine(eng, reqs, chain=None, profile_at=None):
    """Submit ``reqs`` (and install ``chain``) at once, then step until
    every request is done. Returns the handles, each request's latency
    (ms from submission to the step that retired it), the wall time,
    each step's time and, with ``profile_at``, that step's profile."""
    import torch

    handles = [eng.submit(r["prompt"], max_new_tokens=r["new"],
                          slo_class=r["slo_class"],
                          speculative=r.get("speculative", False))
               for r in reqs]
    if chain is not None:
        handles.append(eng.install_chain(chain, max_new_tokens=CHAIN_NEW,
                                         slo_class="interactive"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    latency, step_ms, prof, n = {}, [], None, 0
    while eng.queue_depth or eng.active_slots:
        check(n < 10_000, "the engine did not drain")
        ts = time.perf_counter()
        if n == profile_at:
            box = {}
            prof = device_profile(lambda: box.update(done=eng.step()))
            done = box["done"]
        else:
            done = eng.step()
        now = time.perf_counter()
        step_ms.append((now - ts) * 1e3)
        for r in done:
            latency[r.rid] = (now - t0) * 1e3
        n += 1
    torch.cuda.synchronize()
    return handles, latency, time.perf_counter() - t0, step_ms, prof


def teacher_forced(params, cfg, handles, cache, want_fp32=False):
    """Each request's prompt + tokens through the family's forward once
    (bf16, the kernel path). Per request: does every token equal
    forward's argmax, the first divergence, and the largest gap between
    forward's maximum and the chosen token's logit. With ``want_fp32``, also the largest
    |bf16 - float32| logit at the generated positions."""
    import torch

    from kubeflow_rm_tpu_torch.models import forward_with_aux

    def forward(p, seq, c):
        return forward_with_aux(p, seq, c)[0]

    cfg32 = replace(cfg, dtype=torch.float32)
    dev = params["embed"]["tokens"].device
    out, err32 = [], 0.0
    for h in handles:
        key = (tuple(h.prompt), tuple(h.tokens))
        if key not in cache:
            seq = torch.tensor([h.prompt + h.tokens[:-1]], device=dev,
                               dtype=torch.int32)
            Tp, n = len(h.prompt), len(h.tokens)
            with torch.inference_mode():
                logits = forward(params, seq, cfg)[0, Tp - 1:Tp - 1 + n]
                if want_fp32:
                    l32 = forward(params, seq, cfg32)[0, Tp - 1:Tp - 1 + n]
                    err32 = max(err32, float((logits - l32).abs().max()))
            tok = torch.tensor(h.tokens, device=dev)
            chosen = logits.gather(1, tok[:, None].long())[:, 0]
            gap = logits.max(-1).values - chosen
            argmax = logits.argmax(-1)
            miss = (argmax != tok).nonzero()
            first = None
            if len(miss):
                j = int(miss[0])
                first = dict(at=j, token=h.tokens[j], argmax=int(argmax[j]),
                             gap=float(gap[j]))
            cache[key] = dict(exact=not len(miss), first=first,
                              max_gap=float(gap.max()), tokens=n,
                              argmax_tokens=n - len(miss))
        out.append(cache[key])
    return out, err32


def phase_engine(cfg, params, forward_err, card):
    """The continuous-batching engine at full Llama-2-7B width and depth.
    ``forward_err`` is the forward phase's bf16-vs-float32 max |Δlogit|
    (None if that phase failed); ``card`` the ``nvidia-smi`` line."""
    import gc

    import torch

    from kubeflow_rm_tpu_torch.models.generate import ContinuousBatchingEngine
    from kubeflow_rm_tpu_torch.models.paging import RESERVED_BLOCKS

    reqs, candidates, chain_prompt = engine_traffic(cfg.vocab_size)
    spec_prompt, predicted_calls = speculative_prompt(params, cfg,
                                                      candidates, SPEC_NEW)
    reqs.append(dict(prompt=spec_prompt, new=SPEC_NEW, slo_class="batch",
                     speculative=True))
    kw = dict(slots=ENGINE_SLOTS, slot_len=ENGINE_SLOT_LEN,
              block_size=ENGINE_BLOCK)
    # a prefill replica (one slot) exports the chain a decode engine
    # installs: the install path never runs a prefill of its own
    reset_launches()
    pf = ContinuousBatchingEngine(params, cfg, **dict(kw, slots=1))
    chain = pf.prefill_chain(chain_prompt)
    torch.cuda.synchronize()
    counts = {"prefill_chain": read_launches()}
    check(chain is not None, "prefill_chain ran out of blocks")
    del pf

    runs = {}
    for arm in ("paged", "paged_again", "contiguous"):
        paged = arm != "contiguous"
        eng = ContinuousBatchingEngine(params, cfg, paged=paged, **kw)
        reset_launches()
        handles, latency, wall, step_ms, prof = run_engine(
            eng, reqs, chain if paged else None,
            profile_at=8 if arm == "paged_again" else None)
        torch.cuda.synchronize()
        counts[arm] = read_launches()
        st = eng.stats()
        pool = eng.pool
        released = None
        if paged:
            released = dict(
                all_ref0=all(pool.ref_of(b) == 0 for b in
                             range(RESERVED_BLOCKS, pool.num_blocks)),
                free=pool.free_count(), retained=pool.evictable_count(),
                usable=pool.usable_blocks)
        spec = next(h for h in handles if h.speculative)
        runs[arm] = dict(handles=handles, latency=latency, wall=wall,
                         step_ms=step_ms, prof=prof, stats=st,
                         released=released, spec=spec,
                         spec_calls=eng.speculative_model_calls)
        del eng
        gc.collect()
        torch.cuda.empty_cache()

    seen = {}
    paged_check, seq_err = teacher_forced(
        params, cfg, runs["paged"]["handles"], seen, want_fp32=True)
    checks = {arm: teacher_forced(params, cfg, r["handles"], seen)[0]
              for arm, r in runs.items() if arm != "paged"}
    checks["paged"] = paged_check
    delta = DELTA_PER_ERROR * max(seq_err, forward_err or 0.0)

    report = {}
    for arm, r in runs.items():
        hs, st = r["handles"], r["stats"]
        out_tokens = sum(len(h.tokens) for h in hs)
        tf = checks[arm]
        decode_ms = sorted(r["step_ms"])[len(r["step_ms"]) // 2]
        report[arm] = dict(
            requests=len(hs), done=sum(h.done for h in hs),
            tokens_out=out_tokens, wall_s=r["wall"],
            tokens_per_s=out_tokens / r["wall"],
            decode_steps=st["decode_steps"], median_step_ms=decode_ms,
            batch_occupancy=st["batch_occupancy"],
            prefix_hit_ratio=st.get("prefix_hit_ratio"),
            prefix_hit_tokens=st.get("prefix_hit_tokens"),
            cow_forks=st.get("cow_forks"),
            chain_installs=st.get("chain_installs"),
            prefills=st["prefills"], active_slots=st["active_slots"],
            pool=r["released"],
            speculative=dict(model_calls=r["spec_calls"],
                             tokens_out=len(r["spec"].tokens)),
            latency_ms=[r["latency"].get(h.rid) for h in hs],
            latency_steps=[None if h.finished_step is None else
                           h.finished_step - h.submitted_step for h in hs],
            exact_fraction=sum(c["exact"] for c in tf) / len(tf),
            token_argmax_fraction=(sum(c["argmax_tokens"] for c in tf)
                                   / sum(c["tokens"] for c in tf)),
            first_divergence={i: c["first"] for i, c in enumerate(tf)
                              if not c["exact"]},
            max_gap=max(c["max_gap"] for c in tf),
            launches=counts[arm])
        if r["prof"] is not None:
            report[arm]["profile_one_step"] = r["prof"]
    emit("engine", card=card, slots=ENGINE_SLOTS, slot_len=ENGINE_SLOT_LEN,
         block_size=ENGINE_BLOCK, num_blocks=runs["paged"]["stats"][
             "blocks_total"] + RESERVED_BLOCKS,
         prompt_lens=[len(q["prompt"]) for q in reqs] + [len(chain_prompt)],
         max_new_tokens=[q["new"] for q in reqs] + [CHAIN_NEW],
         speculative_predicted_calls=predicted_calls,
         chain_nbytes=chain["nbytes"], bf16_vs_fp32_max_abs=dict(
             forward_phase=forward_err, engine_sequences=seq_err),
         delta=delta, prefill_chain_launches=counts["prefill_chain"],
         **report)

    zero = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    check(counts["prefill_chain"] == zero,
          f"prefill_chain launched {counts['prefill_chain']}")
    for arm, r in runs.items():
        rep = report[arm]
        check(rep["done"] == rep["requests"], f"{arm}: a request never ended")
        check(rep["active_slots"] == 0, f"{arm}: slots still held")
        check(counts[arm] == zero,
              f"{arm}: the engine path launched {counts[arm]}")
        check(rep["max_gap"] <= delta,
              f"{arm}: a token trails forward's maximum by "
              f"{rep['max_gap']} > delta {delta} "
              f"({rep['first_divergence']})")
        check(r["spec_calls"] < len(r["spec"].tokens),
              f"{arm}: speculative request took {r['spec_calls']} model "
              f"calls for {len(r['spec'].tokens)} tokens")
        if arm != "contiguous":
            p = rep["pool"]
            check(p["all_ref0"] and p["free"] + p["retained"] == p["usable"],
                  f"{arm}: pool not released: {p}")
            check(rep["prefix_hit_tokens"] > 0, f"{arm}: no prefix hit")
            check(rep["cow_forks"] >= 1, f"{arm}: no copy-on-write fork")
            check(rep["chain_installs"] == 1, f"{arm}: chain not installed")
    again = [h.tokens for h in runs["paged_again"]["handles"]]
    check(again == [h.tokens for h in runs["paged"]["handles"]],
          "a second paged run gave other tokens")
    return counts["paged"]


# The fleet phase: the serving fleet (``controlplane/serving_fleet``) at
# full 7B width, right after the engine phase, on the same tree. A
# 512-token slot takes a prompt of at most 256 tokens (its prefill
# bucket plus the new tokens must fit), so the shared system prompt is
# 192 tokens (12 blocks) and the suffixes 16..64
FLEET_SYSTEM = 192
FLEET_SHARED, FLEET_SESSIONS, FLEET_TURNS = 15, 3, 3
# the killed replica's engine steps between its last admission and the
# kill; float32 exactness paths run at this many layers (all of them)
FLEET_KILL_AFTER = 4
FLEET_F32_LAYERS = 32
# the store sized to the traffic: 7B K/V is 0.5 MiB a token (2 × 32
# layers × 4096 × 2 B), so a 256-token chain is 128 MiB; 2 GiB holds 16
FLEET_STORE_BYTES = 2 << 30


class StepGate:
    """Holds a gateway's engine at chosen steps, and counts admissions.

    ``gw.engine.step`` is replaced: a call steps the engine while the
    gate has steps to give (``allow``) or is open (``let_go``); otherwise
    it parks with the gateway's lock released (the drain thread steps
    under that lock), so that a kill or a drain lands while the engine's
    requests are mid-flight, after an exact number of steps, with no
    sleep. A parked call returns without stepping once woken."""

    def __init__(self, gw):
        from kubeflow_rm_tpu_torch.analysis.lockgraph import make_condition

        self.gw = gw
        self.budget = 0
        self.open = False
        self.reached = threading.Event()
        self._cv = make_condition("chip_smoke.step_gate")
        self._admitted = 0
        self._step, self._submit = gw.engine.step, gw.try_submit
        gw.engine.step, gw.try_submit = self.step, self.try_submit

    def try_submit(self, *a, **kw):
        out = self._submit(*a, **kw)
        with self._cv:
            self._admitted += out[0] is not None
            self._cv.notify_all()
        return out

    def submitted(self, n: int) -> None:
        with self._cv:
            check(self._cv.wait_for(lambda: self._admitted >= n, 600),
                  f"only {self._admitted} of {n} requests were admitted")

    def step(self):
        with self._cv:
            go = self.open or self.budget > 0
            if go:
                self.budget -= not self.open
            else:
                self.reached.set()
        if go:
            return self._step()
        self.gw._lock.release()
        try:
            with self._cv:
                self._cv.wait_for(lambda: self.open or self.budget > 0, 600)
        finally:
            self.gw._lock.acquire()
        return []

    def allow(self, n: int) -> None:
        """``n`` more engine steps; returns once the engine is held."""
        self.reached.clear()
        with self._cv:
            self.budget += n
            self._cv.notify_all()
        check(self.reached.wait(600), "the engine was never held again")

    def let_go(self) -> None:
        with self._cv:
            self.open = True
            self._cv.notify_all()

    def act_while_held(self, action) -> None:
        """Run ``action`` (a kill or a removal of this replica) on a thread
        of its own; once the replica's drain thread has been told to
        stop, open the gate and join."""
        check(self.reached.wait(600), "the engine never reached the gate")
        t = threading.Thread(target=action)
        t.start()
        check(self.gw._stop.wait(600), "the replica never began to stop")
        self.let_go()
        t.join(600)
        check(not t.is_alive(), "the kill never returned")


class StepTimer:
    """Times each ``engine.step`` of a gateway (host clock around the
    call; a step ends in a host read of its sampled tokens, so the clock
    spans the card's work too) and the gap from one step's end to the
    next step's start (the drain loop's own time and its waits)."""

    def __init__(self, gw):
        self.ms, self.gaps = [], []
        self._end = None
        self._step = gw.engine.step
        gw.engine.step = self.step

    def step(self):
        t0 = time.perf_counter()
        if self._end is not None:
            self.gaps.append((t0 - self._end) * 1e3)
        try:
            return self._step()
        finally:
            self._end = time.perf_counter()
            self.ms.append((self._end - t0) * 1e3)

    def summary(self) -> dict:
        ms, gaps = sorted(self.ms), sorted(self.gaps)
        if not ms:
            return dict(steps=0)
        return dict(steps=len(ms), median_ms=ms[len(ms) // 2],
                    max_ms=ms[-1], total_s=sum(ms) / 1e3,
                    median_gap_ms=gaps[len(gaps) // 2] if gaps else None,
                    gaps_s=sum(gaps) / 1e3)


def fleet_traffic(vocab: int, system_len: int = FLEET_SYSTEM):
    """The affinity part's requests, from ``numpy.random.default_rng(1)``:
    FLEET_SHARED prompts of the shared system prompt plus a 16..64-token
    suffix (8..32 new tokens), and FLEET_SESSIONS conversations of
    FLEET_TURNS turns, each turn the conversation so far plus 16 new
    tokens of the user (16 new tokens). Returns (shared, sessions)."""
    import numpy as np

    rng = np.random.default_rng(1)

    def toks(n):
        return rng.integers(1, vocab, n).tolist()

    system = toks(system_len)
    shared = [dict(prompt=system + toks(int(rng.integers(16, 65))),
                   new=int(rng.integers(8, 33))) for _ in range(FLEET_SHARED)]
    sessions = []
    for s in range(FLEET_SESSIONS):
        base, turns = toks(48), []
        for t in range(FLEET_TURNS):
            turns.append(dict(prompt=base + toks(16 * (t + 1)), new=16,
                              session=f"session-{s}"))
            base = turns[-1]["prompt"]
        sessions.append(turns)
    return system, shared, sessions


def _fleet_post(app, body):
    """``POST /generate`` on a WSGI app: (status, JSON, ms)."""
    from kubeflow_rm_tpu_torch.serve import request

    t0 = time.perf_counter()
    status, out = request(app, "POST", "/generate", body)
    return status, out, (time.perf_counter() - t0) * 1e3


def _run_threads(fns, what: str) -> float:
    threads = [threading.Thread(target=f) for f in fns]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    check(not any(t.is_alive() for t in threads), f"{what}: a request hung")
    return time.perf_counter() - t0


def _gateways(params, cfg, names, device_of=None, **engine_kw):
    from kubeflow_rm_tpu_torch.controlplane.webapps.serving import (
        ServingGateway, TenantPolicy,
    )
    from kubeflow_rm_tpu_torch.models.generate import ContinuousBatchingEngine

    open_policy = TenantPolicy(qps=1e9, burst=10**6, tokens_per_s=1e9,
                               token_burst=10**7, slo_p95_ms=1e12)
    kw = dict(slots=ENGINE_SLOTS, slot_len=ENGINE_SLOT_LEN,
              block_size=ENGINE_BLOCK)
    out = {}
    for n in names:
        p = params if device_of is None else device_of[n]
        eng = ContinuousBatchingEngine(p, cfg, **dict(kw, **engine_kw.get(
            n, {})))
        out[n] = ServingGateway(eng, default_policy=open_policy)
    return out


def _latency_summary(ms):
    ms = sorted(ms)
    return dict(n=len(ms), p50_ms=ms[len(ms) // 2],
                p95_ms=ms[min(len(ms) - 1, int(0.95 * len(ms)))],
                max_ms=ms[-1])


def fleet_affinity(params, cfg, system_len=FLEET_SYSTEM):
    """Part 1: three replicas behind ``make_fleet_app``; the shared
    requests at once, then the sessions' turns (the sessions in
    parallel). Returns (report, handles for the teacher-forced check,
    the fleet, its app)."""
    from types import SimpleNamespace

    from kubeflow_rm_tpu_torch.controlplane.serving_fleet import (
        ServingFleet, make_fleet_app,
    )

    system, shared, sessions = fleet_traffic(cfg.vocab_size, system_len)
    fleet = ServingFleet(_gateways(params, cfg, [f"r{i}" for i in range(3)]))
    timers = {n: StepTimer(gw) for n, gw in fleet.gateways.items()}
    app = make_fleet_app(fleet, cfg)
    owner = fleet.route(system)
    results = {}

    def one(key, req):
        body = dict(prompt=req["prompt"], max_new_tokens=req["new"])
        if "session" in req:
            body["session"] = req["session"]
        results[key] = _fleet_post(app, body)

    def conversation(s):
        for t, req in enumerate(sessions[s]):
            one(("session", s, t), req)

    wall = _run_threads(
        [lambda i=i: one(("shared", i), shared[i]) for i in range(len(shared))]
        + [lambda s=s: conversation(s) for s in range(len(sessions))],
        "affinity")
    bad = {k: r[:2] for k, r in results.items() if r[0] != 200}
    check(not bad, f"affinity: requests failed: {bad}")
    on_owner = sum(results[("shared", i)][1]["replicas"][0] == owner
                   for i in range(len(shared)))
    homes = {s: {results[("session", s, t)][1]["replicas"][0]
                 for t in range(FLEET_TURNS)} for s in range(len(sessions))}
    snap = fleet.snapshot()
    tokens = sum(len(r[1]["tokens"]) for r in results.values())
    handles = [SimpleNamespace(prompt=req["prompt"],
                               tokens=results[("shared", i)][1]["tokens"])
               for i, req in enumerate(shared)]
    handles += [SimpleNamespace(prompt=sessions[s][t]["prompt"],
                                tokens=results[("session", s, t)][1]["tokens"])
                for s in range(len(sessions)) for t in range(FLEET_TURNS)]
    report = dict(
        requests=len(results), wall_s=wall, tokens_out=tokens,
        tokens_per_s=tokens / wall,
        latency=_latency_summary([r[2] for r in results.values()]),
        owner=owner, shared_on_owner=on_owner, spills=fleet.spills,
        session_homes={s: sorted(h) for s, h in homes.items()},
        prefix_hit_ratio={n: r["prefix_hit_ratio"]
                          for n, r in snap["replicas"].items()},
        engine_steps={n: dict(t.summary(), **{
            k: fleet.gateways[n].engine.stats()[k] for k in (
                "decode_steps", "prefills", "batch_occupancy")})
            for n, t in timers.items()},
        migrations=fleet.migrations)
    check(on_owner + fleet.spills >= len(shared) and
          on_owner * 2 >= len(shared),
          f"affinity: {on_owner} of {len(shared)} shared requests on the "
          f"owner {owner} with {fleet.spills} spills")
    check(all(len(h) == 1 for h in homes.values()),
          f"affinity: a session moved: {homes}")
    check(snap["replicas"][owner]["prefix_hit_ratio"] > 0,
          f"affinity: no prefix hit on the owner: {snap['replicas']}")
    return report, handles, fleet, app


def fleet_drain_and_kill(fleet, app, cfg):
    """Part 2 on the affinity fleet: drain a replica with two requests in
    its slots (its ``/healthz`` says 503, the two finish there), then
    kill another after FLEET_KILL_AFTER engine steps with four requests
    on it (every request completes elsewhere). Returns (report,
    handles)."""
    import numpy as np
    from types import SimpleNamespace

    from kubeflow_rm_tpu_torch.controlplane.webapps.serving import (
        make_serving_app,
    )
    from kubeflow_rm_tpu_torch.serve import request

    rng = np.random.default_rng(2)
    names = sorted(fleet.gateways)
    # the drained replica: slotted work, then the drain
    drained = names[1]
    gw = fleet.gateways[drained]
    gate = StepGate(gw)
    held = [rng.integers(1, cfg.vocab_size, 40).tolist() for _ in range(2)]
    pend = [gw.try_submit("t", p, max_new_tokens=24)[0] for p in held]
    gate.submitted(2)
    gate.allow(1)                         # both take a slot
    t0 = time.perf_counter()
    fleet.drain(drained)
    health = request(make_serving_app(gw, cfg), "GET", "/healthz")
    gate.let_go()
    finished = [gw.wait(p, 600) for p in pend]
    drain_s = time.perf_counter() - t0
    check(health == (503, {"ok": False, "state": "draining"}),
          f"drain: the drained replica's /healthz said {health}")
    check([len(f) for f in finished] == [24, 24],
          f"drain: in-flight requests ended with {[len(f) for f in finished]}")
    handles = [SimpleNamespace(prompt=p, tokens=f)
               for p, f in zip(held, finished)]

    # the killed replica: four requests on it, held, then killed
    ready = [n for n in names if fleet.states()[n] == "ready"]
    victim = ready[0]
    prompt = None
    for _ in range(1000):
        cand = rng.integers(1, cfg.vocab_size, 64).tolist()
        if fleet.route(cand) == victim:
            prompt = cand
            break
    check(prompt is not None, "kill: no prompt routes to the victim")
    gate = StepGate(fleet.gateways[victim])
    results = [None] * 4
    before = fleet.migrations

    def go(i):
        results[i] = fleet.submit_and_wait("t", list(prompt),
                                           max_new_tokens=32)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    try:
        gate.submitted(4)
        gate.allow(FLEET_KILL_AFTER)
        gate.act_while_held(lambda: fleet.kill(victim))
    finally:
        gate.let_go()
        for t in threads:
            t.join(900)
    kill_s = time.perf_counter() - t0
    check(not any(t.is_alive() for t in threads), "kill: a request hung")
    migrations = fleet.migrations - before
    check(all(r is not None and r[0] is not None and len(r[0]) == 32
              for r in results), f"kill: requests ended with {results}")
    check(migrations >= 1, f"kill: {migrations} migrations")
    handles += [SimpleNamespace(prompt=prompt, tokens=r[0]) for r in results]
    return dict(drained=drained, drained_healthz=health[0],
                drain_s=drain_s, killed=victim, kill_s=kill_s,
                migrations=migrations,
                paths=[r[1]["replicas"] for r in results],
                fleet_healthz=request(app, "GET", "/healthz")), handles


def fleet_disaggregated(params, cfg, system, device_of=None, before=None):
    """Part 3: one prefill and two decode replicas over a
    ``GlobalBlockStore`` (FLEET_STORE_BYTES; ``device_of`` places each
    replica's tree on its own card). A hot prompt goes through the
    prefill tier (a handoff into the store, installed on dc0), four
    unrelated prompts churn dc0's small pool (promote-on-evict copies
    its evicted blocks to the host), dc0 dies, and the hot prompt again
    must hit the store on dc1. ``before(name, gateway)`` runs on each
    gateway before any traffic. Returns (report, handles, fleet, app)."""
    import numpy as np
    from types import SimpleNamespace

    from kubeflow_rm_tpu_torch.controlplane import metrics as cp_metrics
    from kubeflow_rm_tpu_torch.controlplane.serving_fleet import (
        GlobalBlockStore, ServingFleet, make_fleet_app,
    )
    from kubeflow_rm_tpu_torch.models.paging import RESERVED_BLOCKS

    rng = np.random.default_rng(3)
    maxb = ENGINE_SLOT_LEN // ENGINE_BLOCK
    # a slot and a half: the hot chain is evicted by the third churn
    small = RESERVED_BLOCKS + maxb + maxb // 2
    gws = _gateways(params, cfg, ["pf0", "dc0", "dc1"], device_of,
                    dc0=dict(num_blocks=small))
    for name, gw in gws.items():
        if before is not None:
            before(name, gw)
    store = GlobalBlockStore(max_bytes=FLEET_STORE_BYTES)
    fleet = ServingFleet(gws, roles={"pf0": "prefill", "dc0": "decode",
                                     "dc1": "decode"}, store=store)
    app = make_fleet_app(fleet, cfg)
    hist = cp_metrics.SERVING_CHAIN_HANDOFF_SECONDS
    n0, s0 = hist.get(), hist._unlabelled().sum
    hot = system + rng.integers(1, cfg.vocab_size, 40).tolist()
    handles, lat = [], []

    def post(prompt, new):
        status, out, ms = _fleet_post(app, dict(prompt=prompt,
                                                max_new_tokens=new))
        check(status == 200, f"disaggregated: {status} {out}")
        handles.append(SimpleNamespace(prompt=prompt, tokens=out["tokens"]))
        lat.append(ms)
        return out

    t0 = time.perf_counter()
    first = post(hot, 24)
    holder = first["replicas"][0]
    churn = [post(rng.integers(1, cfg.vocab_size, 200).tolist(), 8)
             for _ in range(4)]
    st_before = store.stats()
    dc1_before = (gws["dc1"].engine.chain_installs, gws["dc1"].engine.prefills)
    fleet.kill(holder)
    again = post(hot, 24)
    wall = time.perf_counter() - t0
    st = store.stats()
    survivor = again["replicas"][0]
    installs = gws[survivor].engine.chain_installs - (
        dc1_before[0] if survivor == "dc1" else 0)
    n, s_ = hist.get() - n0, hist._unlabelled().sum - s0
    report = dict(
        holder=holder, survivor=survivor, wall_s=wall,
        latency=_latency_summary(lat), handoffs=fleet.handoffs,
        handoff_seconds=dict(count=n, mean_s=s_ / n if n else None),
        store_before_kill=st_before, store=st,
        store_hit_ratio=st["hit_ratio"], hits_after_kill=(
            st["hits"] - st_before["hits"]),
        survivor_installs=installs, churn_paths=[c["replicas"]
                                                 for c in churn])
    check(holder == "dc0" and survivor != holder,
          f"disaggregated: holder {holder}, survivor {survivor}")
    check(st["hits"] > st_before["hits"],
          f"disaggregated: no store hit after {holder} died: {st}")
    check(fleet.handoffs >= 1 and n >= 1,
          f"disaggregated: {fleet.handoffs} handoffs")
    check(st_before["promoted"] >= 1,
          f"disaggregated: nothing promoted on eviction: {st_before}")
    return report, handles, fleet, app


def fleet_float32(cfg, device="cuda", layers=FLEET_F32_LAYERS,
                  system_len=FLEET_SYSTEM):
    """Part 4: the migration, drain and handoff paths in float32 at full
    width and ``layers`` layers: every request's tokens must equal a solo
    ``generate_fused`` of its prompt (``max_len`` the slot's), and a
    ``/api/store/chain/<key>`` fetch must come back as a frame that
    ``chain_from_bytes`` and ``verify_chain`` accept. The kernel
    launches of the serving paths are read before the solo references
    run."""
    import numpy as np
    import torch

    from kubeflow_rm_tpu_torch.controlplane.serving_fleet import (
        ServingFleet, chain_from_bytes, make_fleet_app,
    )
    from kubeflow_rm_tpu_torch.models.generate import generate_fused
    from kubeflow_rm_tpu_torch.models.llama import init_params
    from kubeflow_rm_tpu_torch.models.paging import prefix_keys, verify_chain

    cfg32 = replace(cfg, n_layers=layers, dtype=torch.float32,
                    param_dtype=torch.float32)
    params = init_params(cfg32, torch.Generator(device=device).manual_seed(5),
                         device)
    rng = np.random.default_rng(4)
    served = {}        # path -> [(prompt, new tokens, tokens served)]
    out = {}
    reset_launches()
    t0 = time.perf_counter()
    # kill -> migrate, and drain, on a fleet of two
    fleet = ServingFleet(_gateways(params, cfg32, ["r0", "r1"]))
    try:
        prompt = rng.integers(1, cfg.vocab_size, 100).tolist()
        victim = fleet.route(prompt)
        gate = StepGate(fleet.gateways[victim])
        results = [None] * 2

        def go(i):
            results[i] = fleet.submit_and_wait("t", list(prompt),
                                               max_new_tokens=24)

        threads = [threading.Thread(target=go, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        try:
            gate.submitted(2)
            gate.allow(FLEET_KILL_AFTER)
            gate.act_while_held(lambda: fleet.kill(victim))
        finally:
            gate.let_go()
            for t in threads:
                t.join(900)
        served["kill"] = [(prompt, 24, r[0]) for r in results]
        out["kill_migrations"] = fleet.migrations
        survivor = next(n for n in fleet.gateways if n != victim)
        gw = fleet.gateways[survivor]
        gate = StepGate(gw)
        held = rng.integers(1, cfg.vocab_size, 60).tolist()
        pend = gw.try_submit("t", held, max_new_tokens=24)[0]
        gate.submitted(1)
        gate.allow(1)
        fleet.drain(survivor)
        gate.let_go()
        served["drain"] = [(held, 24, gw.wait(pend, 600))]
    finally:
        fleet.close()
    # the handoff: prefill tier -> store -> decode install
    fleet = ServingFleet(_gateways(params, cfg32, ["pf0", "dc0"]),
                         roles={"pf0": "prefill", "dc0": "decode"},
                         store_bytes=FLEET_STORE_BYTES)
    try:
        hot = rng.integers(1, cfg.vocab_size, system_len).tolist()
        tokens, _ = fleet.submit_and_wait("t", hot, max_new_tokens=24)
        served["handoff"] = [(hot, 24, tokens)]
        eng = fleet.gateways["dc0"].engine
        out["handoff"] = dict(installs=eng.chain_installs,
                              prefills=eng.prefills,
                              handoffs=fleet.handoffs)
        key = prefix_keys(hot, ENGINE_BLOCK)[-1][1]
        status, body = _raw_get(make_fleet_app(fleet, cfg32),
                                f"/api/store/chain/{key.hex()}")
        chain = chain_from_bytes(body)
        verify_chain(chain)
        out["chain_endpoint"] = dict(status=status, nbytes=len(body),
                                     covered=chain["covered"],
                                     tokens_equal=chain["tokens"] == hot)
    finally:
        fleet.close()
    if device == "cuda":
        torch.cuda.synchronize()
    out["wall_s"] = time.perf_counter() - t0
    out["launches"] = read_launches()
    out["layers"] = layers
    for path, reqs in served.items():
        out[path + "_equal"] = []
        for prompt, n, got in reqs:
            ref = generate_fused(params, cfg32,
                                 torch.tensor([prompt], dtype=torch.int32,
                                              device=device),
                                 max_new_tokens=n, max_len=ENGINE_SLOT_LEN)
            out[path + "_equal"].append(got == ref[0, len(prompt):].tolist())
    check(all(out["kill_equal"]) and out["kill_migrations"] >= 1,
          f"float32 kill: {out}")
    check(all(out["drain_equal"]), f"float32 drain: {out}")
    check(all(out["handoff_equal"]) and out["handoff"]["installs"] == 1
          and out["handoff"]["prefills"] == 0,
          f"float32 handoff: {out}")
    check(out["chain_endpoint"]["status"] == 200
          and out["chain_endpoint"]["tokens_equal"],
          f"float32 chain endpoint: {out['chain_endpoint']}")
    return out


def _raw_get(app, path):
    """``GET path`` on a WSGI app: (status, body bytes)."""
    import io

    got = []
    environ = {"REQUEST_METHOD": "GET", "PATH_INFO": path,
               "CONTENT_LENGTH": "0", "wsgi.input": io.BytesIO(b""),
               "SERVER_NAME": "localhost", "SERVER_PORT": "0",
               "wsgi.url_scheme": "http"}
    body = b"".join(app(environ, lambda s, h: got.append(int(s.split()[0]))))
    return got[0], body


def phase_fleet(cfg, params, forward_err, card, device="cuda",
                system_len=FLEET_SYSTEM, f32_layers=FLEET_F32_LAYERS):
    """The serving fleet at full Llama-2-7B width on the engine phase's
    tree: affinity, drain and kill, disaggregated, and float32
    exactness (see FLEET_*). Every bf16 token is held teacher-forced
    within DELTA of ``forward`` (as the engine phase holds its own);
    serving decodes with explicit positions, so no flash kernel may
    launch."""
    import gc

    import torch

    reset_launches()
    held_before = (torch.cuda.memory_allocated() if device == "cuda"
                   else 0)
    times = {}
    t0 = time.perf_counter()
    aff, handles, fleet, app = fleet_affinity(params, cfg, system_len)
    times["affinity_s"] = time.perf_counter() - t0
    emit("fleet", part="affinity", card=card, **aff)
    t0 = time.perf_counter()
    try:
        dk, more = fleet_drain_and_kill(fleet, app, cfg)
    finally:
        fleet.close()
    handles += more
    times["drain_kill_s"] = time.perf_counter() - t0
    emit("fleet", part="drain_and_kill", card=card, **dk)
    system = fleet_traffic(cfg.vocab_size, system_len)[0]
    t0 = time.perf_counter()
    dis, more, dfleet, dapp = fleet_disaggregated(params, cfg, system)
    dfleet.close()
    handles += more
    times["disaggregated_s"] = time.perf_counter() - t0
    emit("fleet", part="disaggregated", card=card, **dis)
    if device == "cuda":
        torch.cuda.synchronize()
    # the serving paths' launches, before the references run
    launches = read_launches()
    seen = {}
    tf, seq_err = teacher_forced(params, cfg, handles, seen, want_fp32=True)
    delta = DELTA_PER_ERROR * max(seq_err, forward_err or 0.0)
    max_gap = max(c["max_gap"] for c in tf)
    t0 = time.perf_counter()
    f32 = fleet_float32(cfg, device, f32_layers, system_len)
    times["float32_s"] = time.perf_counter() - t0
    launches = {k: v + f32["launches"][k] for k, v in launches.items()}
    # the engines, their gates and promote hooks hold each other in
    # cycles: collect them before the next phase needs the card
    del fleet, app, dfleet, dapp
    gc.collect()
    held_after = 0
    if device == "cuda":
        torch.cuda.empty_cache()
        held_after = torch.cuda.memory_allocated()
    emit("fleet", part="exactness", card=card, requests=len(tf),
         exact_fraction=sum(c["exact"] for c in tf) / len(tf),
         max_gap=max_gap, delta=delta, bf16_vs_fp32_max_abs=seq_err,
         float32=f32, launches=launches, times=times,
         card_gb_held_before_after=[held_before / 1e9, held_after / 1e9])
    check(max_gap <= delta, f"fleet: a token trails forward's maximum by "
                            f"{max_gap} > delta {delta}")
    check(held_after <= held_before + (1 << 30),
          f"fleet: {held_after / 1e9:.2f} GB still held on the card, "
          f"{held_before / 1e9:.2f} GB before the phase")
    check(launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                       "flash_bwd_dkv": 0},
          f"fleet: the serving path launched {launches}")
    return launches


def phase_fleet_multi(card):
    """The disaggregated fleet across cards: the prefill replica on
    ``cuda:0`` and the decode replicas on the others, the tree copied to
    every card; each gateway's drain thread must step its engine with
    that engine's card current. The single-card part's gates, tokens
    held teacher-forced on ``cuda:0``. Skipped on one card."""
    import gc

    import torch

    from kubeflow_rm_tpu_torch.models.llama import LlamaConfig, init_params

    n = torch.cuda.device_count()
    if n < 2:
        emit("fleet_multi", skipped=f"{n} card")
        return None
    cfg = LlamaConfig.llama2_7b(param_dtype=torch.bfloat16)
    p0 = init_params(cfg, torch.Generator(device="cuda:0").manual_seed(0),
                     "cuda:0")
    devs = {"pf0": "cuda:0", "dc0": "cuda:1", "dc1": f"cuda:{min(2, n - 1)}"}

    def copy_to(d):
        return {k: ({kk: t.to(d) for kk, t in v.items()}
                    if isinstance(v, dict) else v.to(d))
                for k, v in p0.items()}

    trees = {d: p0 if d == "cuda:0" else copy_to(d)
             for d in set(devs.values())}
    system = fleet_traffic(cfg.vocab_size)[0]
    current = {}

    def watch(name, gw):
        step = gw.engine.step

        def stepped():
            current.setdefault(name, set()).add(torch.cuda.current_device())
            return step()

        gw.engine.step = stepped

    reset_launches()
    t0 = time.perf_counter()
    dis, handles, fleet, app = fleet_disaggregated(
        p0, cfg, system, device_of={r: trees[d] for r, d in devs.items()},
        before=watch)
    wall = time.perf_counter() - t0
    engines = {r: str(gw.engine.device) for r, gw in fleet.gateways.items()}
    fleet.close()
    del fleet, app
    gc.collect()
    torch.cuda.synchronize()
    launches = read_launches()        # the serving path's, before the check
    seen = {}
    tf, seq_err = teacher_forced(p0, cfg, handles, seen, want_fp32=True)
    delta = DELTA_PER_ERROR * seq_err
    max_gap = max(c["max_gap"] for c in tf)
    stepped_on = {r: sorted(f"cuda:{i}" for i in v)
                  for r, v in current.items()}
    emit("fleet_multi", card=card, cards=n, engines=engines,
         stepped_on=stepped_on, part_wall_s=wall, max_gap=max_gap,
         delta=delta, launches=launches, **dis)
    check(engines == devs, f"fleet_multi: engines on {engines}")
    check(all(stepped_on[r] == [devs[r]] for r in stepped_on)
          and set(stepped_on) >= {"dc0", "dc1"},
          f"fleet_multi: steps ran with current devices {stepped_on}")
    check(max_gap <= delta, f"fleet_multi: a token trails forward's "
                            f"maximum by {max_gap} > delta {delta}")
    check(launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                       "flash_bwd_dkv": 0},
          f"fleet_multi: the serving path launched {launches}")
    del trees, p0
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def dequantized(params: dict, dtype) -> dict:
    """``params`` with every quantized leaf replaced by its dequantized
    tensor (``maybe_dequant``, leaf by leaf, the whole stack at once)."""
    from kubeflow_rm_tpu_torch.models.quantize import (
        is_quantized, maybe_dequant,
    )

    def deq(t):
        return maybe_dequant(t, dtype) if is_quantized(t) else t

    return dict(params, blocks={k: deq(v) for k, v in
                                params["blocks"].items()},
                lm_head=deq(params["lm_head"]))


def phase_quant(cfg, params, forward_err, card):
    """Weight-only int8 and int4 (group 128) at full Llama-2-7B width and
    depth: the card's packed bytes against the CPU's, the quantized
    forward against the forward of the dequantized tree, fused decode
    (int4 fused against the per-token loop), the engine on int4 with the
    teacher-forced check, and the HF conversion round trip. Returns the
    flash launches of the two quantized forwards."""
    import gc
    import tempfile

    import numpy as np
    import torch

    from kubeflow_rm_tpu_torch.models.convert import (
        from_hf_llama, load_hf_dir, to_hf_llama,
    )
    from kubeflow_rm_tpu_torch.models.generate import (
        ContinuousBatchingEngine, generate, generate_fused,
    )
    from kubeflow_rm_tpu_torch.models.llama import forward
    from kubeflow_rm_tpu_torch.models.paging import RESERVED_BLOCKS
    from kubeflow_rm_tpu_torch.models.quantize import (
        quantize_params, quantized_bytes,
    )
    from kubeflow_rm_tpu_torch.training.optim import leaf_paths

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2048), generator=gen,
                           device="cuda", dtype=torch.int32)
    rng = np.random.default_rng(0)
    lens, new, T = (5, 17, 64, 200), 32, 256
    ids = np.zeros((4, T), np.int32)
    for i, n in enumerate(lens):
        ids[i, T - n:] = rng.integers(1, cfg.vocab_size, n)
    ids = torch.from_numpy(ids).cuda()
    pads = torch.tensor([T - n for n in lens], dtype=torch.int32,
                        device="cuda")
    # the same bf16 bytes, quantized on the CPU
    cpu_tree = {"blocks": {k: params["blocks"][k][:1].cpu()
                           for k in ("wq", "w_down")},
                "lm_head": params["lm_head"].cpu()}

    report, launches = {"bf16_bytes": quantized_bytes(params)}, {}
    with torch.no_grad():
        ref = forward(params, tokens, cfg)
        for bits in (8, 4):
            name = f"int{bits}"
            qp = quantize_params(params, bits=bits, group_size=128)
            on_cpu = quantize_params(cpu_tree, bits=bits, group_size=128)
            same = {}
            for k, want in leaf_paths(on_cpu).items():
                got = leaf_paths(qp)[k]
                got = got if k.startswith("lm_head") else got[:1]
                same[k] = bool(torch.equal(got.cpu(), want))
            reset_launches()
            logits = forward(qp, tokens, cfg)
            launches[name] = read_launches()
            _, fwd_ms = timed(lambda: forward(qp, tokens, cfg))
            prof = device_profile(lambda: forward(qp, tokens, cfg))
            deq = dequantized(qp, cfg.dtype)
            plain = forward(deq, tokens, cfg)
            del deq
            free()
            r = dict(bytes=quantized_bytes(qp), cpu_bytes_equal=same,
                     forward_launches=launches[name], forward_ms=fwd_ms,
                     logits_equal_dequantized_tree=bool(
                         torch.equal(logits, plain)),
                     max_abs_vs_dequantized_tree=float(
                         (logits - plain).abs().max()),
                     mean_abs_vs_bf16=float((logits - ref).abs().mean()),
                     argmax_vs_bf16=float((logits.argmax(-1)
                                           == ref.argmax(-1)).float().mean()),
                     finite=bool(torch.isfinite(logits).all()),
                     profile_forward=prof)
            del logits, plain
            # fused decode: 4 left-padded prompts, 32 new tokens; the
            # decode step is the difference of the median 32-token and
            # the median 1-token run
            kw = dict(max_len=T + new, pad_counts=pads)
            out, fused_ms = timed(lambda: generate_fused(
                qp, cfg, ids, max_new_tokens=new, **kw))
            _, one_ms = timed(lambda: generate_fused(
                qp, cfg, ids, max_new_tokens=1, **kw))
            r.update(fused_batch_ms=fused_ms, fused_one_token_ms=one_ms,
                     fused_decode_step_ms=(fused_ms["median"]
                                           - one_ms["median"]) / (new - 1))
            if bits == 4:
                loop, loop_ms = timed(lambda: generate(
                    qp, cfg, ids, max_new_tokens=new, **kw))
                r.update(loop_batch_ms=loop_ms,
                         fused_equals_loop=bool(torch.equal(out, loop)))
                q4 = qp
            report[name] = r
            del qp, out
            free()
    del ref
    free()

    # the continuous-batching engine on the int4 tree (paged arm): the
    # shared-prefix requests and a prompt with its exact repeat
    reqs, _, _ = engine_traffic(cfg.vocab_size)
    reqs = reqs[:6] + reqs[8:10]
    eng = ContinuousBatchingEngine(q4, cfg, slots=ENGINE_SLOTS,
                                   slot_len=ENGINE_SLOT_LEN,
                                   block_size=ENGINE_BLOCK)
    unpacked = quantized_bytes(eng.params)
    reset_launches()
    handles, _, wall, step_ms, _ = run_engine(eng, reqs)
    engine_launches = read_launches()
    st, pool = eng.stats(), eng.pool
    released = dict(
        all_ref0=all(pool.ref_of(b) == 0 for b in
                     range(RESERVED_BLOCKS, pool.num_blocks)),
        free=pool.free_count(), retained=pool.evictable_count(),
        usable=pool.usable_blocks)
    del eng
    free()
    tf, seq_err = teacher_forced(q4, cfg, handles, {}, want_fp32=True)
    delta = DELTA_PER_ERROR * max(seq_err, forward_err or 0.0)
    out_tokens = sum(len(h.tokens) for h in handles)
    report["engine_int4"] = dict(
        requests=len(handles), done=sum(h.done for h in handles),
        tokens_out=out_tokens, wall_s=wall, tokens_per_s=out_tokens / wall,
        decode_steps=st["decode_steps"],
        median_step_ms=sorted(step_ms)[len(step_ms) // 2],
        prefix_hit_tokens=st["prefix_hit_tokens"], cow_forks=st["cow_forks"],
        pool=released, resident_param_bytes=unpacked,
        max_gap=max(c["max_gap"] for c in tf), delta=delta,
        int4_vs_fp32_max_abs=seq_err,
        token_argmax_fraction=(sum(c["argmax_tokens"] for c in tf)
                               / sum(c["tokens"] for c in tf)),
        launches=engine_launches)
    del q4, handles
    free()

    # HF conversion at 7B width: the whole tree out and back, then a
    # two-layer directory (torch.save, bf16) through the directory reader
    t0 = time.perf_counter()
    state = to_hf_llama(cfg, params)
    _, back = from_hf_llama(state, cfg, param_dtype=torch.bfloat16)
    got, want = leaf_paths(back), leaf_paths(params)
    roundtrip = list(got) == list(want) and all(
        got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
        for k in want)
    del back, got
    free()
    layers = 2
    two = {k: torch.from_numpy(v).to(torch.bfloat16).contiguous()
           for k, v in state.items()
           if not k.startswith("model.layers.")
           or int(k.split(".")[2]) < layers}
    del state
    hf_config = dict(
        architectures=["LlamaForCausalLM"], model_type="llama",
        vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
        intermediate_size=cfg.hidden_dim, num_hidden_layers=layers,
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
        max_position_embeddings=cfg.max_seq_len, rms_norm_eps=cfg.norm_eps,
        rope_theta=cfg.rope_theta, torch_dtype="bfloat16")
    with tempfile.TemporaryDirectory() as d:
        torch.save(two, f"{d}/pytorch_model.bin")
        with open(f"{d}/config.json", "w") as f:
            json.dump(hf_config, f)
        del two
        cfg2, loaded = load_hf_dir(d, param_dtype=torch.bfloat16)
    want2 = dict(params, blocks={k: v[:layers] for k, v in
                                 params["blocks"].items()})
    got, want = leaf_paths(loaded), leaf_paths(want2)
    dir_equal = list(got) == list(want) and all(
        torch.equal(got[k], want[k]) for k in want)
    dir_cfg = cfg2 == replace(cfg, n_layers=layers, dtype=cfg2.dtype,
                              param_dtype=cfg2.param_dtype)
    del loaded, got, want, want2
    free()
    report["hf"] = dict(roundtrip_bit_identical=roundtrip,
                        dir_layers=layers, dir_bit_identical=dir_equal,
                        dir_config_equal=dir_cfg,
                        seconds=time.perf_counter() - t0)
    emit("quant", card=card, preset="llama2_7b", group_size=128,
         forward_tokens=[2, 2048], prompt_lens=list(lens),
         max_new_tokens=new, engine_prompt_lens=[len(r["prompt"])
                                                 for r in reqs],
         **report)

    for name in ("int8", "int4"):
        r = report[name]
        check(all(r["cpu_bytes_equal"].values()),
              f"{name}: card and CPU quantize differently: "
              f"{r['cpu_bytes_equal']}")
        check(r["forward_launches"] == {"flash_fwd": cfg.n_layers,
                                        "flash_bwd_dq": 0,
                                        "flash_bwd_dkv": 0},
              f"{name} forward launched {r['forward_launches']}")
        check(r["finite"], f"{name}: non-finite logits")
        check(r["logits_equal_dequantized_tree"],
              f"{name}: logits differ from the dequantized tree's by "
              f"{r['max_abs_vs_dequantized_tree']}")
    check(report["int4"]["fused_equals_loop"],
          "int4: generate_fused and the per-token loop differ")
    e = report["engine_int4"]
    p = e["pool"]
    check(e["done"] == e["requests"], "int4 engine: a request never ended")
    check(p["all_ref0"] and p["free"] + p["retained"] == p["usable"],
          f"int4 engine: pool not released: {p}")
    check(e["max_gap"] <= delta, f"int4 engine: a token trails forward's "
                                 f"maximum by {e['max_gap']} > {delta}")
    check(e["prefix_hit_tokens"] > 0, "int4 engine: no prefix hit")
    check(e["launches"] == {"flash_fwd": 0, "flash_bwd_dq": 0,
                            "flash_bwd_dkv": 0},
          f"int4 engine launched {e['launches']}")
    h = report["hf"]
    check(h["roundtrip_bit_identical"], "to_hf_llama -> from_hf_llama "
                                        "changed the bf16 params")
    check(h["dir_bit_identical"] and h["dir_config_equal"],
          f"load_hf_dir on a {layers}-layer directory: {h}")
    return {k: launches["int8"][k] + launches["int4"][k]
            for k in launches["int8"]}


def reset_launches():
    from kubeflow_rm_tpu_torch.ops import flash_attention as fa

    for fn in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        fn.launches = 0


def read_launches() -> dict:
    from kubeflow_rm_tpu_torch.ops import flash_attention as fa

    return {fn.__name__: fn.launches
            for fn in (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv)}


def packed_rows(rows: int, T: int, vocab: int, seed: int) -> dict:
    """``rows`` full rows of packed documents (lengths 64..1536, token
    ids from a seeded numpy generator), as int32 numpy arrays."""
    import numpy as np

    from kubeflow_rm_tpu_torch.training.data import pack_documents

    rng = np.random.default_rng(seed)
    docs, total = [], 0
    while total < rows * T:
        n = int(rng.integers(64, 1537))
        docs.append(rng.integers(1, vocab, n).tolist())
        total += n
    return {k: v[:rows] for k, v in pack_documents(docs, T).items()}


def phase_train_grad():
    """Full-parameter gradients at 7B width and 4 layers, three ways."""
    import torch

    from kubeflow_rm_tpu_torch.models.llama import (
        LlamaConfig, forward_with_aux, init_params,
    )
    from kubeflow_rm_tpu_torch.ops.losses import softmax_cross_entropy
    from kubeflow_rm_tpu_torch.training.data import to_device
    from kubeflow_rm_tpu_torch.training.optim import leaf_paths
    from kubeflow_rm_tpu_torch.training.train import TrainConfig, loss_fn

    cfg = LlamaConfig.llama2_7b(n_layers=4, param_dtype=torch.bfloat16)
    tcfg = TrainConfig(model=cfg)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(5),
                         "cuda")
    batch = to_device(packed_rows(1, 2048, cfg.vocab_size, seed=4), "cuda")

    def grads(p, c, impl=None):
        flat = leaf_paths(p)
        for t in flat.values():
            t.requires_grad_(True)
        if impl is None:          # the trainer's loss, as the step runs it
            loss, _ = loss_fn(p, batch, replace(tcfg, model=c))
        else:
            logits, _ = forward_with_aux(
                p, batch["tokens"], c, positions=batch["positions"],
                segments=batch["segments"], packed=True, impl=impl)
            loss, _ = softmax_cross_entropy(logits, batch["labels"],
                                            z_loss=tcfg.z_loss)
        g = torch.autograd.grad(loss, list(flat.values()))
        return loss.item(), dict(zip(flat, g))

    reset_launches()
    loss_k, gk = grads(params, cfg)                       # the kernels
    torch.cuda.synchronize()
    launches = read_launches()
    loss_d, gd = grads(params, cfg, impl="dense")
    params32 = {k: (v.float() if not isinstance(v, dict)
                    else {n: t.float() for n, t in v.items()})
                for k, v in params.items()}
    cfg32 = replace(cfg, dtype=torch.float32, param_dtype=torch.float32)
    loss_32, g32 = grads(params32, cfg32)                 # dense, float32
    torch.cuda.synchronize()
    leaves = {}
    for k in g32:
        ek, ed = rel_err(gk[k], g32[k]), rel_err(gd[k], g32[k])
        leaves[k] = dict(kernel_vs_fp32=ek, dense_vs_fp32=ed, ratio=ek / ed,
                         finite=bool(torch.isfinite(gk[k]).all()))
    emit("train_grad", preset="llama2_7b", n_layers=cfg.n_layers,
         tokens=[1, 2048], remat=cfg.remat_policy, launches=launches,
         loss=dict(kernel=loss_k, dense=loss_d, fp32=loss_32),
         leaves=leaves)
    L = cfg.n_layers
    check(launches == {"flash_fwd": 2 * L, "flash_bwd_dq": L,
                       "flash_bwd_dkv": L},
          f"train_grad launches {launches}, expected flash_fwd {2 * L} "
          f"(forward + remat rerun) and {L} of each backward kernel")
    check(read_launches() == launches,
          "the dense and float32 gradients launched a flash kernel")
    for k, r in leaves.items():
        check(r["finite"], f"train_grad: non-finite gradient of {k}")
        check(1 / RATIO_MAX <= r["ratio"] <= RATIO_MAX,
              f"train_grad {k}: kernel {r['kernel_vs_fp32']} vs dense "
              f"{r['dense_vs_fp32']} relative error against float32")
    return launches


def checksums(params: dict) -> dict:
    """Per-leaf, per-layer checksum of the bit patterns (sum and
    position-weighted sum of 16-bit words, or of bytes for int8), without
    a copy of the weights."""
    import torch

    from kubeflow_rm_tpu_torch.training.optim import leaf_paths

    out = {}
    for k, t in leaf_paths(params).items():
        sums = []
        # one (layer, expert) slice at a time: the int64 temporaries stay
        # the size of one slice
        for part in (t.flatten(0, t.dim() - 3) if t.dim() >= 3 else t[None]):
            bits = part.reshape(-1).view(
                torch.int16 if t.element_size() % 2 == 0 else torch.uint8
            ).long()
            w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
            sums.append((int(bits.sum()), int((bits * w).sum())))
        out[k] = sums
    return out


def phase_train(cfg, params):
    """The trainer's main path: Llama-2-7B, LoRA r=16 on wq/wv, 6 steps
    of ``fit``."""
    import numpy as np
    import torch

    from kubeflow_rm_tpu_torch.models.lora import add_lora, is_lora_name
    from kubeflow_rm_tpu_torch.training.data import to_device
    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig, leaf_paths
    from kubeflow_rm_tpu_torch.training.train import (
        TrainConfig, init_train_state, make_train_step,
    )
    from kubeflow_rm_tpu_torch.utils.flops import train_flops_per_token

    steps, B, T = 6, 2, 2048
    lp = add_lora(params, 16, generator=torch.Generator(device="cuda")
                  .manual_seed(2), targets=("wq", "wv"))
    tcfg = TrainConfig(model=cfg, optim=OptimConfig(
        train_only="lora", learning_rate=TRAIN_LR, warmup_steps=1,
        total_steps=steps))
    batch = packed_rows(B, T, cfg.vocab_size, seed=3)
    base = {k: v for k, v in leaf_paths(lp).items()
            if not is_lora_name(k.rsplit("/", 1)[-1])}
    before = checksums(base)
    state = init_train_state(tcfg, params=lp)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state, history = fit(tcfg, itertools.repeat(batch),
                         LoopConfig(total_steps=steps, log_every=1),
                         state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    L = cfg.n_layers
    losses = [h.loss for h in history]
    norms = [h.grad_norm for h in history]
    timed = history[1:]        # the first record holds the start-up sync
    step_ms = statistics.median(h.step_time_ms for h in timed)
    tps = statistics.median(h.tokens_per_sec for h in timed)
    mfu = statistics.median(h.mfu_pct for h in timed)
    after = checksums(base)
    adapters_b = {k: int(torch.count_nonzero(v))
                  for k, v in leaf_paths(state.params).items()
                  if k.endswith("_lora_b")}

    step_fn = make_train_step(tcfg, state)
    dev_batch = to_device(batch, "cuda")
    prof = device_profile(lambda: step_fn(state, dev_batch))
    flops_step = train_flops_per_token(cfg, T, frozen_base=True) * B * T
    emit("train", preset="llama2_7b", lora_rank=16, targets=["wq", "wv"],
         tokens=[B, T], steps=steps, learning_rate=TRAIN_LR,
         remat=cfg.remat_policy, losses=losses, grad_norms=norms,
         launches=launches, step_time_ms=step_ms, tokens_per_s=tps,
         mfu_pct=mfu, model_tflop_per_step=flops_step / 1e12,
         fit_wall_s=wall, peak_mem_gb=peak_gb,
         adapter_b_nonzero=adapters_b,
         base_bit_identical=before == after, profile_one_step=prof)
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"non-finite loss or grad norm: {losses} {norms}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(before == after, "a frozen base weight changed")
    check(all(n > 0 for n in adapters_b.values()),
          f"an adapter's b stayed zero: {adapters_b}")
    check(launches == {"flash_fwd": 2 * L * steps,
                       "flash_bwd_dq": L * steps,
                       "flash_bwd_dkv": L * steps},
          f"train launches {launches}, expected per step flash_fwd "
          f"{2 * L} and {L} of each backward kernel")
    check(history[-1].mfu_pct > 0, "LoopMetrics MFU is 0")
    return launches, {"losses": losses, "step_ms": step_ms,
                      "peak_mem_gb": peak_gb}


def free_port() -> int:
    """A free localhost TCP port for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_lora_fit(cfg, params, steps: int, mesh):
    """The train phase's recipe (rank-16 LoRA on wq/wv, B=2×2048 packed,
    seed 3) for ``steps`` steps of ``fit`` on ``mesh``: (history,
    launches, peak GB, wall s, a profile of one more step, the ms of
    steps on one device and on the mesh taken in turns)."""
    import torch

    from kubeflow_rm_tpu_torch.models.lora import add_lora
    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.data import to_device
    from kubeflow_rm_tpu_torch.training.train import (
        TrainConfig, init_train_state, make_train_step, shard_batch,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    lp = add_lora(params, 16, generator=torch.Generator(device=dev)
                  .manual_seed(2), targets=("wq", "wv"))
    tcfg = TrainConfig(model=cfg, optim=OptimConfig(
        train_only="lora", learning_rate=TRAIN_LR, warmup_steps=1,
        total_steps=6))
    batch = packed_rows(2, 2048, cfg.vocab_size, seed=3)
    whole = init_train_state(tcfg, params=lp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state, history = fit(tcfg, itertools.repeat(batch),
                         LoopConfig(total_steps=steps, log_every=1),
                         state=whole, mesh=mesh)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_fn = make_train_step(tcfg, state, mesh=mesh)
    local = to_device(shard_batch(batch, mesh), dev)
    prof = device_profile(lambda: step_fn(state, local))
    # one step on one device and one on the mesh, in turns (A B B A): at
    # world 1 the mesh's state is the same memory as the whole one
    one = make_train_step(tcfg, whole)
    glob = to_device(batch, dev)
    runs = {"one_device": lambda: one(whole, glob),
            "mesh": lambda: step_fn(state, local)}
    turns = {k: [] for k in runs}
    for name in ("one_device", "mesh", "mesh", "one_device"):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        runs[name]()[1]["loss"].item()
        torch.cuda.synchronize()
        turns[name].append((time.perf_counter() - t1) * 1e3)
    return history, launches, peak_gb, wall, prof, turns


def one_rank_nccl_cost(w, group, calls: int = 200) -> dict:
    """What a one-rank collective would cost if the port ran it (it
    skips them): host µs a call and device ms a call of
    ``all_gather_into_tensor`` of the weight ``w`` over ``group``, out of
    place and in place, and of an ``all_reduce`` of it; and that NCCL
    sums right over the world."""
    import torch
    import torch.distributed as dist

    x = w.contiguous()
    y = torch.empty_like(x)
    ops = {"all_gather": lambda: dist.all_gather_into_tensor(y, x,
                                                             group=group),
           "all_gather_in_place": lambda: dist.all_gather_into_tensor(
               y, y, group=group),
           "all_reduce": lambda: dist.all_reduce(y, group=group)}
    out = {"bytes": x.numel() * x.element_size()}
    for name, op in ops.items():
        for _ in range(5):
            op()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(calls):
            op()
        end.record()
        host = (time.perf_counter() - t0) / calls * 1e6
        end.synchronize()
        out[name] = {"host_us_per_call": host,
                     "device_ms_per_call": start.elapsed_time(end) / calls}
    one = torch.ones(8, device=x.device)
    dist.all_reduce(one)
    check(bool((one == dist.get_world_size()).all()),
          f"NCCL all_reduce over the world gave {one.tolist()}")
    return out


def phase_mesh1(cfg, params, train_ref):
    """The mesh path at world size 1 over NCCL: one rank, a
    ``make_mesh(MeshConfig(dp=1, fsdp=1, tp=1))`` mesh, the kernels under
    the mesh code. Every axis spans one rank, so the port's collectives
    return their input and no NCCL collective runs in the model (XLA
    emits none for a size-1 axis either); ``one_rank_nccl_cost`` times
    what such a call would cost. The collectives run across cards only
    in ``mesh_multi``."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from kubeflow_rm_tpu_torch.models.generate import (
        generate_fused, make_generate_step,
    )
    from kubeflow_rm_tpu_torch.ops.attention import dot_product_attention
    from kubeflow_rm_tpu_torch.ops.flash_attention import flash_attention
    from kubeflow_rm_tpu_torch.parallel.mesh import (
        MeshConfig, axis_group, make_mesh, mesh_shape,
    )
    from kubeflow_rm_tpu_torch.parallel.ring_attention import ring_attention
    from kubeflow_rm_tpu_torch.parallel.sharding import shard_params
    from kubeflow_rm_tpu_torch.parallel.ulysses import ulysses_attention
    from kubeflow_rm_tpu_torch.parallel.zigzag_ring import (
        zigzag_ring_attention,
    )
    from kubeflow_rm_tpu_torch.serve import make_app, request

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    paths, out = {}, {}
    try:
        mesh = make_mesh(MeshConfig(dp=1, fsdp=1, tp=1))
        out["mesh"] = mesh_shape(mesh)
        out["torch"] = torch.__version__
        out["nccl"] = ".".join(map(str, torch.cuda.nccl.version()))
        out["one_rank_nccl"] = one_rank_nccl_cost(
            params["blocks"]["w_gate"][0], axis_group(mesh, "fsdp"))

        # 1. LoRA: the train phase's recipe, 3 steps of fit on the mesh
        L, steps = cfg.n_layers, 3
        history, launches, peak_gb, wall, prof, turns = mesh_lora_fit(
            cfg, params, steps, mesh)
        paths["mesh1_lora"] = launches
        losses = [h.loss for h in history]
        step_ms = statistics.median(h.step_time_ms for h in history[1:])
        out["lora"] = {"steps": steps, "losses": losses,
                       "train_losses": train_ref["losses"][:steps],
                       "step_ms": step_ms,
                       "train_step_ms": train_ref["step_ms"],
                       "peak_mem_gb": peak_gb,
                       "train_peak_mem_gb": train_ref["peak_mem_gb"],
                       "fit_wall_s": wall, "launches": launches,
                       "step_ms_in_turns": turns,
                       "profile_one_step": prof}
        check(losses[0] == train_ref["losses"][0],
              f"mesh step-1 loss {losses[0]!r} != one-device "
              f"{train_ref['losses'][0]!r}")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"mesh losses {losses}")
        check(launches == {"flash_fwd": 2 * L * steps,
                           "flash_bwd_dq": L * steps,
                           "flash_bwd_dkv": L * steps},
              f"mesh1 LoRA launches {launches}")

        # 2. decode: the sharded generate step against generate_fused
        new, T = 32, 256
        rng = np.random.default_rng(0)
        lens = (5, 17, 64, 200)
        ids = np.zeros((4, T), np.int32)
        for i, n in enumerate(lens):
            ids[i, T - n:] = rng.integers(1, cfg.vocab_size, n)
        prompt = torch.from_numpy(ids).cuda()
        pads = torch.tensor([T - n for n in lens], dtype=torch.int32,
                            device="cuda")
        local = shard_params(params, mesh)
        step = make_generate_step(local, cfg, mesh, max_new_tokens=new,
                                  total_len=T + new)
        runs = {
            "generate_fused": lambda: generate_fused(
                params, cfg, prompt, max_new_tokens=new, max_len=T + new,
                pad_counts=pads),
            "mesh": lambda: step(local, prompt, None, pads)}
        # in turns (A B B A): the host's speed drifts within a call
        wall = {k: [] for k in runs}
        tokens = {}
        for name in ("generate_fused", "mesh", "mesh", "generate_fused"):
            t0 = time.perf_counter()
            tokens[name] = runs[name]()
            torch.cuda.synchronize()
            wall[name].append((time.perf_counter() - t0) * 1e3)
        same = bool(torch.equal(tokens["mesh"], tokens["generate_fused"]))
        out["decode"] = {"prompt_lens": list(lens), "max_new_tokens": new,
                         "wall_ms": wall["mesh"],
                         "generate_fused_ms": wall["generate_fused"],
                         "equal_to_generate_fused": same}
        check(same, "make_generate_step tokens differ from generate_fused")
        app = make_app(cfg, params, max_new_tokens=new, max_batch=4,
                       device="cuda", mesh=mesh)
        try:
            prompt0 = ids[0, T - lens[0]:].tolist()
            status, body = request(app, "POST", "/generate",
                                   {"prompt": prompt0})
        finally:
            app.close()
        # the app left-pads a lone prompt into the 16-token bucket
        bucket = np.zeros((1, 16), np.int32)
        bucket[0, 16 - lens[0]:] = prompt0
        solo = generate_fused(
            params, cfg, torch.from_numpy(bucket).cuda(), max_new_tokens=new,
            max_len=16 + new, pad_counts=torch.tensor(
                [16 - lens[0]], dtype=torch.int32, device="cuda"))
        out["serve"] = {"status": status, "tokens": len(body.get("tokens",
                                                                  []))}
        check(status == 200
              and body["tokens"] == solo[0, 16 - lens[0]:].tolist(),
              f"mesh make_app /generate: {status} {body}")

        # 3. Ulysses at sp=1 on the 7B attention shape: bit-equal to the
        # flash op, one flash_fwd a call, the backward kernels in training
        sp = axis_group(mesh, "sp")
        gen = torch.Generator(device="cuda").manual_seed(7)
        uly = {}
        for kvh in (32, 8):
            q = torch.randn(2, 2048, 32, 128, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            k = torch.randn(2, 2048, kvh, 128, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            v = torch.randn_like(k)
            qs, ks, vs = (t.clone().requires_grad_(True) for t in (q, k, v))
            reset_launches()
            o = ulysses_attention(qs, ks, vs, group=sp)
            fwd = read_launches()
            o.float().square().mean().backward()
            both = read_launches()
            qr, kr, vr = (t.clone().requires_grad_(True) for t in (q, k, v))
            r = flash_attention(qr, kr, vr)
            r.float().square().mean().backward()
            uly[f"kvh{kvh}"] = {
                "bit_equal": bool(torch.equal(o, r)),
                "grads_bit_equal": bool(
                    torch.equal(qs.grad, qr.grad)
                    and torch.equal(ks.grad, kr.grad)
                    and torch.equal(vs.grad, vr.grad)),
                "launches_fwd": fwd, "launches_fwd_bwd": both}
            check(torch.equal(o, r), f"ulysses KVH={kvh} != flash op")
            check(fwd == {"flash_fwd": 1, "flash_bwd_dq": 0,
                          "flash_bwd_dkv": 0},
                  f"ulysses KVH={kvh} forward launches {fwd}")
            check(both["flash_bwd_dq"] == 1 and both["flash_bwd_dkv"] == 1,
                  f"ulysses KVH={kvh} backward launches {both}")
        paths["mesh1_ulysses"] = both
        out["ulysses"] = uly

        # 4. ring and zigzag at sp=1: float32 online softmax vs dense
        q = torch.randn(1, 2048, 32, 128, generator=gen, device="cuda")
        k = torch.randn(1, 2048, 32, 128, generator=gen, device="cuda")
        v = torch.randn(1, 2048, 32, 128, generator=gen, device="cuda")
        dense = dot_product_attention(q, k, v, causal=True, impl="dense")
        with torch.no_grad():
            errs = {
                "ring": (ring_attention(q, k, v, group=sp) - dense)
                .abs().max().item(),
                "zigzag": (zigzag_ring_attention(q, k, v, group=sp) - dense)
                .abs().max().item()}
        out["ring_zigzag_max_abs_err"] = errs
        for name, e in errs.items():
            check(e <= RING_ATOL, f"{name} at sp=1: max |err| {e} > "
                  f"{RING_ATOL}")
    finally:
        dist.destroy_process_group()
    emit("mesh1", **out)
    return paths


def _mesh_multi_rank(rank: int, world: int, port: int, result: str,
                     backend: str, preset: str, layers: int, T: int):
    """One rank of the ``mesh_multi`` phase (a spawned process): its
    rendezvous env is the launcher's for card ``rank`` of a one-host
    slice of ``world`` cards (``launcher/torchrun.py``), joined through
    ``parallel.distributed.initialize``."""
    import torch
    import torch.distributed as dist

    from kubeflow_rm_tpu_torch.models import init_params
    from kubeflow_rm_tpu_torch.models.llama import LlamaConfig
    from kubeflow_rm_tpu_torch.models.lora import add_lora, is_lora_name
    from kubeflow_rm_tpu_torch.ops.attention import dot_product_attention
    from kubeflow_rm_tpu_torch.parallel.collectives import all_gather
    from kubeflow_rm_tpu_torch.parallel.mesh import (
        MeshConfig, axis_group, make_mesh, mesh_shape,
    )
    from kubeflow_rm_tpu_torch.parallel.ring_attention import ring_attention
    from kubeflow_rm_tpu_torch.parallel.sharding import (
        gather_tensor, leaf_spec, local_slices, shard_params,
    )
    from kubeflow_rm_tpu_torch.parallel.ulysses import ulysses_attention
    from kubeflow_rm_tpu_torch.training.data import to_device
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig, leaf_paths
    from kubeflow_rm_tpu_torch.training.train import (
        TrainConfig, init_train_state, loss_fn, make_train_step,
        reduce_grads, shard_batch,
    )

    from kubeflow_rm_tpu_torch.launcher.torchrun import torchrun_env
    from kubeflow_rm_tpu_torch.parallel.distributed import initialize

    cuda = backend == "nccl"
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    # the webhook's env of a one-host slice, mapped to this card's
    # torchrun env; initialize sets the card (LOCAL_RANK) and joins
    rendezvous = torchrun_env(
        {"TPU_WORKER_ID": "0", "TPU_WORKER_HOSTNAMES": "localhost",
         "TPU_ACCELERATOR_TYPE": f"h100-80gb-{world}"},
        cards_per_host=world, local_rank=rank, master_port=port)
    initialize(rendezvous, device=dev)
    if dist.get_backend() != backend or dist.get_world_size() != world \
            or dist.get_rank() != rank:
        raise AssertionError(f"rank {rank}: joined {dist.get_backend()} "
                             f"world {dist.get_world_size()} as rank "
                             f"{dist.get_rank()}")
    out = {"world": world, "rendezvous": rendezvous}
    try:
        dtype = torch.bfloat16 if cuda else torch.float32
        cfg = getattr(LlamaConfig, preset)(n_layers=layers, dtype=dtype,
                                           param_dtype=dtype)
        mc = (MeshConfig(fsdp=2, tp=2) if world == 4
              else MeshConfig(fsdp=world))
        mesh = make_mesh(mc, dev)
        out["mesh"] = mesh_shape(mesh)

        def draw(m):
            # the base from seed 0, rank-16 adapters from seed 2; on the
            # mesh each rank keeps only its slices of every draw
            p = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            dev, mesh=m)
            return add_lora(p, 16, generator=torch.Generator(device=dev)
                            .manual_seed(2), targets=("wq", "wv"), mesh=m)

        def drawn_with_peak(m):
            """``draw(m)`` and the GB it took at its peak beyond what was
            allocated before it (this rank's card)."""
            if not cuda:
                return draw(m), None
            torch.cuda.synchronize(dev)
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            tree = draw(m)
            torch.cuda.synchronize(dev)
            return tree, (torch.cuda.max_memory_allocated(dev) - before) / 1e9

        local, local_gb = drawn_with_peak(mesh)
        lp, whole_gb = drawn_with_peak(None)
        out["init_peak_gb"] = {"sharded": local_gb, "one_rank": whole_gb}
        want = leaf_paths(shard_params(lp, mesh))
        out["sharded_init_equal"] = all(
            torch.equal(t, want[p]) for p, t in leaf_paths(local).items())
        del want
        adapters0 = {p: t.detach().float().clone()
                     for p, t in leaf_paths(lp).items()
                     if is_lora_name(p.rsplit("/", 1)[-1])}
        tcfg = TrainConfig(model=cfg, optim=OptimConfig(
            train_only="lora", learning_rate=TRAIN_LR, warmup_steps=1))
        batch = to_device(packed_rows(2, T, cfg.vocab_size, seed=3), dev)

        def run(m, params, b):
            """MESH_STEPS steps on mesh ``m`` (None: one rank): the
            state, the step, each step's loss and grad norm, and the
            adapters after them (whole, float32)."""
            state = init_train_state(tcfg, params=params, mesh=m)
            step = make_train_step(tcfg, state, mesh=m)
            losses, norms = [], []
            for _ in range(MESH_STEPS):
                state, metrics = step(state, b)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
            adapters = {}
            for p, t in leaf_paths(state.params).items():
                if p in adapters0:
                    whole = t if m is None else gather_tensor(
                        t, leaf_spec(p, t), m)
                    adapters[p] = whole.detach().float()
            return state, step, losses, norms, adapters

        local_batch = shard_batch(batch, mesh)
        state, step, losses, norms, adapters = run(mesh, local, local_batch)
        ref, _, ref_losses, ref_norms, ref_adapters = run(None, lp, batch)
        # the adapters' update over the steps, on the mesh against one
        # rank: ||d_mesh - d_one|| / ||d_one|| per leaf
        update_err = {}
        for p, a0 in adapters0.items():
            d_one = ref_adapters[p] - a0
            d_mesh = adapters[p] - a0
            update_err[p] = float((d_mesh - d_one).norm()
                                  / d_one.norm().clamp_min(1e-30))

        def adapter_grads(params, m, b):
            """The adapters' gradients of one batch's loss (whole,
            float32), through the mesh's backward on ``m``."""
            flat = leaf_paths(params)
            paths = sorted(adapters0)
            loss = (loss_fn(params, b, tcfg) if m is None
                    else loss_fn(params, b, tcfg, m))[0]
            grads = dict(zip(paths, torch.autograd.grad(
                loss, [flat[p] for p in paths])))
            if m is not None:
                grads = {p: gather_tensor(g, leaf_spec(p, flat[p]), m)
                         for p, g in reduce_grads(grads, flat, m).items()}
            return {p: g.float() for p, g in grads.items()}

        # at the same weights (the one-rank run's last adapters, sliced
        # into the mesh state; b is no longer 0, so every adapter takes
        # a gradient): the backward's reduce-scatters and all-reduces
        # across cards against one card's
        ref_flat, mesh_flat = leaf_paths(ref.params), leaf_paths(state.params)
        with torch.no_grad():
            for p in adapters0:
                t = mesh_flat[p]
                t.copy_(ref_flat[p][local_slices(
                    ref_flat[p].shape, leaf_spec(p, t), mesh)])
        g_mesh = adapter_grads(state.params, mesh, local_batch)
        g_one = adapter_grads(ref.params, None, batch)
        grad_err = {p: float((g_mesh[p] - g_one[p]).norm()
                             / g_one[p].norm().clamp_min(1e-30))
                    for p in g_one}
        out["lora"] = {"steps": MESH_STEPS, "losses": losses,
                       "one_rank_losses": ref_losses, "grad_norms": norms,
                       "one_rank_grad_norms": ref_norms,
                       "update_rel_err": update_err,
                       "grad_rel_err": grad_err}
        if cuda:
            prof = device_profile(lambda: step(state, local_batch), top=12)
            comm = {}
            for kern in prof["top_kernels"]:
                for key in ("AllGather", "AllReduce", "ReduceScatter"):
                    if key.lower() in kern["name"].lower():
                        comm[key] = comm.get(key, 0.0) + kern["ms"]
            out["step"] = {"wall_ms": prof["wall_ms"],
                           "device_busy_ms": prof["device_busy_ms"],
                           "collective_ms": comm}
        del state, ref, lp, local

        # Ulysses and ring at sp=world against the one-card flash op
        smesh = make_mesh(MeshConfig(fsdp=1, sp=world), dev)
        sp = axis_group(smesh, "sp")
        gen = torch.Generator(device=dev).manual_seed(7)
        Tg = T * world
        q, k, v = (torch.randn(1, Tg, 32, 128, generator=gen, device=dev,
                               dtype=dtype) for _ in range(3))
        mine = slice(rank * T, (rank + 1) * T)
        ref_o = dot_product_attention(q, k, v, causal=True)
        errs = {}
        for name, fn in (("ulysses", ulysses_attention),
                         ("ring", ring_attention)):
            with torch.no_grad():
                o = fn(q[:, mine], k[:, mine], v[:, mine], group=sp)
            full = all_gather(o.contiguous(), sp, 1)
            errs[name] = (full.float() - ref_o.float()).abs().max().item()
        out["sp_max_abs_err"] = errs
        del q, k, v, ref_o
        if cuda:
            torch.cuda.empty_cache()

        out["pipeline"] = _multi_pipeline(world, dev, cfg, T)
        if cuda:
            torch.cuda.empty_cache()
        out["adafactor"], out["offload"] = _multi_optimizers(world, dev,
                                                             cfg, T)
        if cuda:
            torch.cuda.empty_cache()
        out["pp_decode"], out["kv_heads"] = _multi_decode_and_heads(
            world, dev, preset, layers, T)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(result, "w") as f:
            json.dump(out, f)


def _mesh_steps(tcfg, params, batch, mesh, steps: int,
                n_microbatches=None, snapshot: dict | None = None):
    """``steps`` steps of ``make_train_step`` on ``mesh`` (None: one
    rank) from ``params`` and ``batch`` (this rank's share on a mesh):
    the state, the step, each step's loss, grad norm, wall ms and the
    offload metrics, and the card's peak GB over the steps. ``snapshot``
    (a dict) receives the whole weights after step 1."""
    import torch

    from kubeflow_rm_tpu_torch.training.train import (
        init_train_state, make_train_step,
    )

    state = init_train_state(tcfg, params=params, mesh=mesh)
    step = make_train_step(tcfg, state, mesh=mesh,
                           n_microbatches=n_microbatches)
    cuda = batch["tokens"].device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rec = {"losses": [], "grad_norms": [], "step_ms": [], "offload": []}
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, batch)
        rec["losses"].append(float(m["loss"]))
        if cuda:
            torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["grad_norms"].append(float(m["grad_norm"]))
        rec["offload"].append({k: float(v) for k, v in m.items()
                               if k.startswith("offload_")})
        if i == 0 and snapshot is not None:
            snapshot.update(_whole(state.params, mesh))
    rec["peak_gb"] = (torch.cuda.max_memory_allocated() / 1e9 if cuda
                      else None)
    return state, step, rec


def _whole(params, mesh) -> dict:
    """``{path: whole leaf}`` of a rank's tree (gathered on a mesh;
    copies)."""
    from kubeflow_rm_tpu_torch.parallel.sharding import (
        gather_tensor, leaf_spec,
    )
    from kubeflow_rm_tpu_torch.training.optim import leaf_paths

    return {p: (t.detach().clone() if mesh is None
                else gather_tensor(t, leaf_spec(p, t), mesh))
            for p, t in leaf_paths(params).items()}


def _pipeline_bubble(params, tokens, cfg, mesh, M: int) -> dict:
    """One no-grad ``pipeline_forward`` with each block's device time
    taken by CUDA events (the CPU: host clock): the share of the
    forward's wall that is not this stage's own microbatches (ticks t
    with 0 <= t - stage < M), beside GPipe's (pp-1)/(M+pp-1). Bubble
    ticks compute on a clamped microbatch, so the share counts them with
    the waits."""
    import torch

    from kubeflow_rm_tpu_torch.models import llama
    from kubeflow_rm_tpu_torch.parallel.mesh import axis_index, axis_size
    from kubeflow_rm_tpu_torch.parallel.pipeline import pipeline_forward

    pp, stage = axis_size(mesh, "pp"), axis_index(mesh, "pp")
    cuda = tokens.device.type == "cuda"
    real, spans = llama._block, []

    def timed(*a, **kw):
        if not cuda:
            t0 = time.perf_counter()
            out = real(*a, **kw)
            spans.append((time.perf_counter() - t0) * 1e3)
            return out
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = real(*a, **kw)
        ev[1].record()
        spans.append(ev)
        return out

    llama._block = timed
    try:
        with torch.no_grad():
            pipeline_forward(params, tokens, cfg, mesh, n_microbatches=M)
            if cuda:
                torch.cuda.synchronize()
            spans.clear()
            t0 = time.perf_counter()
            pipeline_forward(params, tokens, cfg, mesh, n_microbatches=M)
            if cuda:
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        llama._block = real
    ms = [e[0].elapsed_time(e[1]) if cuda else e for e in spans]
    per = len(ms) // (M + pp - 1)
    ticks = [sum(ms[t * per:(t + 1) * per]) for t in range(M + pp - 1)]
    own = sum(x for t, x in enumerate(ticks) if 0 <= t - stage < M)
    return {"stage": stage, "forward_ms": wall, "tick_ms": ticks,
            "measured": 1 - own / wall, "gpipe": (pp - 1) / (M + pp - 1)}


def _multi_pipeline(world: int, dev, cfg, T: int) -> dict:
    """GPipe on the cards: pp=2 (pp=2 × fsdp=2 at world 4), the 4-layer
    7B-width rank-16 LoRA recipe (2 layers a stage), a global batch of 8
    × T, ``PIPE_MICROBATCHES`` microbatches, ``MESH_STEPS`` steps
    against the same steps on one rank; the ranks' own draws against the
    one-rank draw's slices; the flash launches; the bubble."""
    import torch
    import torch.distributed as dist

    from kubeflow_rm_tpu_torch.models import init_params
    from kubeflow_rm_tpu_torch.models.lora import add_lora
    from kubeflow_rm_tpu_torch.parallel.mesh import (
        MeshConfig, make_mesh, mesh_shape,
    )
    from kubeflow_rm_tpu_torch.parallel.sharding import shard_params
    from kubeflow_rm_tpu_torch.training.data import to_device
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig, leaf_paths
    from kubeflow_rm_tpu_torch.training.train import (
        TrainConfig, shard_batch,
    )

    cuda = dev.type == "cuda"
    mesh = make_mesh(MeshConfig(pp=2, fsdp=world // 2), dev)
    M = PIPE_MICROBATCHES

    def draw(m):
        p = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        dev, mesh=m)
        return add_lora(p, 16, generator=torch.Generator(device=dev)
                        .manual_seed(2), targets=("wq", "wv"), mesh=m)

    local, whole = draw(mesh), draw(None)
    want = leaf_paths(shard_params(whole, mesh))
    out = {"mesh": mesh_shape(mesh), "microbatches": M,
           "sharded_init_equal": all(
               torch.equal(t, want[p]) for p, t in leaf_paths(local).items()),
           "local_wq": list(local["blocks"]["wq"].shape)}
    del want
    tcfg = TrainConfig(model=cfg, optim=OptimConfig(
        train_only="lora", learning_rate=TRAIN_LR, warmup_steps=1))
    batch = to_device(packed_rows(8, T, cfg.vocab_size, seed=3), dev)
    local_batch = shard_batch(batch, mesh)
    reset_launches()
    state, step, rec = _mesh_steps(tcfg, local, local_batch, mesh,
                                   MESH_STEPS, M)
    out["launches"] = read_launches()
    out.update(rec)
    del state, step
    if cuda:
        torch.cuda.empty_cache()
    bubbles = [None] * world
    dist.all_gather_object(bubbles, _pipeline_bubble(
        local, local_batch["tokens"], cfg, mesh, M))
    out["bubble"] = bubbles
    del local
    _, _, ref = _mesh_steps(tcfg, whole, batch, None, MESH_STEPS)
    out["one_rank"] = ref
    return out


def _multi_optimizers(world: int, dev, cfg, T: int):
    """Full fine-tuning with adafactor at fsdp=2 × tp=2 (fsdp=2 at world
    2) of the 4-layer 7B-width model against one rank, ``MESH_STEPS``
    steps of B=2 × T at ``OFFLOAD_LR``; then the host-offload arm on the
    same mesh against the on-card arm, 2 steps each."""
    import torch

    from kubeflow_rm_tpu_torch.models import init_params
    from kubeflow_rm_tpu_torch.parallel.mesh import (
        MeshConfig, make_mesh, mesh_shape,
    )
    from kubeflow_rm_tpu_torch.training.data import to_device
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.train import (
        TrainConfig, shard_batch,
    )

    cuda = dev.type == "cuda"
    mesh = make_mesh(MeshConfig(fsdp=2, tp=2) if world == 4
                     else MeshConfig(fsdp=world), dev)
    batch = to_device(packed_rows(2, T, cfg.vocab_size, seed=5), dev)
    local_batch = shard_batch(batch, mesh)

    def tcfg(offload):
        return TrainConfig(model=cfg, optim=OptimConfig(
            factored=True, offload=offload, learning_rate=OFFLOAD_LR,
            warmup_steps=0, total_steps=100))

    def draw(m):
        return init_params(cfg, torch.Generator(device=dev).manual_seed(4),
                           dev, mesh=m)

    def free():
        if cuda:
            torch.cuda.empty_cache()

    w_mesh, w_one = {}, {}
    _, _, ada = _mesh_steps(tcfg("none"), draw(mesh), local_batch, mesh,
                            MESH_STEPS, snapshot=w_mesh)
    free()
    _, _, ada_one = _mesh_steps(tcfg("none"), draw(None), batch, None,
                                MESH_STEPS, snapshot=w_one)
    free()
    # step-1 weights against one rank's, in bf16 steps (``bf16_steps``)
    worst, differ, total = 0.0, 0, 0
    for p, w0 in _whole(draw(None), None).items():
        worst = max(worst, float(bf16_steps(w_mesh[p], w_one[p], w0).max()))
        differ += int((w_mesh[p] != w_one[p]).sum())
        total += w0.numel()
    del w_mesh, w_one
    free()
    ada.update(mesh=mesh_shape(mesh), one_rank=ada_one,
               step1_max_bf16_steps=worst,
               step1_differing_fraction=differ / total)
    arms = {}
    for arm in ("none", "optimizer"):
        reset_launches()
        state, _, arms[arm] = _mesh_steps(tcfg(arm), draw(mesh), local_batch,
                                          mesh, 2)
        arms[arm]["launches"] = read_launches()
        if arm == "optimizer":
            tensors = [t for s in state.opt_state.values()
                       for f in s.__dataclass_fields__ if f != "count"
                       for t in getattr(s, f).values()]
            arms[arm]["host_state_pinned"] = all(
                t.device.type == "cpu" and (t.is_pinned() or not cuda)
                for t in tensors)
        del state
        free()
    return ada, {"mesh": mesh_shape(mesh), "on_card": arms["none"],
                 "streamed": arms["optimizer"]}


def _multi_decode_and_heads(world: int, dev, preset: str, layers: int,
                            T: int):
    """Greedy decode on a pp=2 mesh (pp=2 × fsdp=2 at world 4) and, on
    four cards, K/V heads repeated where tp exceeds them: the model with
    2 KV heads at tp=4, ``MESH_STEPS`` LoRA steps against one rank, then
    greedy decode there. Decode runs in float32, its reference
    ``generate_fused`` of the whole tree on this card: in bf16 the mesh's
    sums in another order move logits by their last bit, which flips
    argmaxes of a randomly initialised model."""
    import numpy as np
    import torch

    from kubeflow_rm_tpu_torch.models import init_params
    from kubeflow_rm_tpu_torch.models.generate import (
        generate_fused, make_generate_step,
    )
    from kubeflow_rm_tpu_torch.models.llama import LlamaConfig
    from kubeflow_rm_tpu_torch.models.lora import add_lora
    from kubeflow_rm_tpu_torch.parallel.mesh import (
        MeshConfig, make_mesh, mesh_shape,
    )
    from kubeflow_rm_tpu_torch.parallel.sharded import kv_heads_local
    from kubeflow_rm_tpu_torch.training.data import to_device
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.train import TrainConfig, shard_batch

    cuda = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    new, plen = 16, 32

    def decode(cfg, mc):
        mesh = make_mesh(mc, dev)
        gen = (lambda: torch.Generator(device=dev).manual_seed(6))
        local = init_params(cfg, gen(), dev, mesh=mesh)
        rng = np.random.default_rng(8)
        prompt = torch.from_numpy(rng.integers(
            1, cfg.vocab_size, (4, plen)).astype(np.int32)).to(dev)
        step = make_generate_step(local, cfg, mesh, max_new_tokens=new,
                                  total_len=plen + new)
        got = step(local, prompt, None, None)
        del local
        want = generate_fused(init_params(cfg, gen(), dev), cfg, prompt,
                              max_new_tokens=new)
        return {"mesh": mesh_shape(mesh), "rows": 4, "new_tokens": new,
                "tokens_equal": bool(torch.equal(got.cpu(), want.cpu())),
                "differing_tokens": int((got.cpu() != want.cpu()).sum())}

    fp32 = dict(dtype=torch.float32, param_dtype=torch.float32)
    base = getattr(LlamaConfig, preset)
    pp = decode(base(n_layers=layers, **fp32),
                MeshConfig(pp=2, fsdp=world // 2))
    if cuda:
        torch.cuda.empty_cache()
    if world < 4:
        return pp, {"skipped": f"tp=4 needs 4 cards, {world} here"}

    # 2 KV heads over tp=4 ranks (each rank repeats its K/V head)
    dtype = torch.bfloat16 if cuda else torch.float32
    cfg = base(n_layers=layers, n_kv_heads=2, dtype=dtype, param_dtype=dtype)
    mesh = make_mesh(MeshConfig(tp=4), dev)

    def draw(m):
        p = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        dev, mesh=m)
        return add_lora(p, 16, generator=torch.Generator(device=dev)
                        .manual_seed(2), targets=("wq", "wv"), mesh=m)

    tcfg = TrainConfig(model=cfg, optim=OptimConfig(
        train_only="lora", learning_rate=TRAIN_LR, warmup_steps=1))
    batch = to_device(packed_rows(2, T, cfg.vocab_size, seed=3), dev)
    reset_launches()
    _, _, rec = _mesh_steps(tcfg, draw(mesh), shard_batch(batch, mesh), mesh,
                            MESH_STEPS)
    rec["launches"] = read_launches()
    if cuda:
        torch.cuda.empty_cache()
    _, _, rec["one_rank"] = _mesh_steps(tcfg, draw(None), batch, None,
                                        MESH_STEPS)
    if cuda:
        torch.cuda.empty_cache()
    heads = {"mesh": mesh_shape(mesh), "n_heads": cfg.n_heads,
             "n_kv_heads": cfg.n_kv_heads,
             "kv_heads_local": kv_heads_local(cfg, 4), "lora": rec,
             "decode": decode(base(n_layers=layers, n_kv_heads=2, **fp32),
                              MeshConfig(tp=4))}
    return pp, heads


def phase_mesh_multi(backend: str = "nccl", preset: str = "llama2_7b",
                     layers: int = 4, T: int = 2048):
    """Only where the machine has two or more cards: ``min(count, 4)``
    NCCL ranks, one per card. A 7B-width, 4-layer LoRA model drawn on
    each rank as its slices (``init_params``/``add_lora`` with ``mesh``,
    checked equal to the one-rank draw's slices), ``MESH_STEPS`` steps at
    fsdp=2 (fsdp=2 × tp=2 at world 4) against the same steps on one
    rank: every step's loss and grad norm, and the adapters' update;
    Ulysses and ring at sp=world against the one-card attention; the
    step's collective times; then the GPipe schedule
    (``_multi_pipeline``), adafactor and the host-offload arm
    (``_multi_optimizers``), each against one rank or the on-card arm."""
    import tempfile

    import torch
    import torch.multiprocessing as mp

    count = torch.cuda.device_count() if backend == "nccl" else 4
    if count < 2:
        emit("mesh_multi", skipped=f"{count} card")
        return None
    world = min(count, 4)
    with tempfile.TemporaryDirectory() as d:
        result = f"{d}/mesh_multi.json"
        mp.start_processes(_mesh_multi_rank, nprocs=world, start_method="spawn",
                           args=(world, free_port(), result, backend,
                                 preset, layers, T))
        with open(result) as f:
            out = json.load(f)
    lora = out["lora"]
    emit("mesh_multi", **out)
    check(out["sharded_init_equal"],
          "mesh_multi: the ranks' own draws differ from the one-rank "
          "draw's slices")
    for i in range(lora["steps"]):
        for what, tol in (("losses", MESH_LOSS_RTOL),
                          ("grad_norms", MESH_GNORM_RTOL)):
            got, want = lora[what][i], lora[f"one_rank_{what}"][i]
            check(abs(got - want) <= tol * abs(want),
                  f"mesh_multi step {i + 1} {what}: {got} vs one rank "
                  f"{want} (rtol {tol})")
    for what, tol in (("grad_rel_err", MESH_GRAD_RTOL),
                      ("update_rel_err", MESH_UPDATE_RTOL)):
        worst = max(lora[what].values())
        check(worst <= tol,
              f"mesh_multi adapters' {what}: {lora[what]} (limit {tol})")
    errs = out["sp_max_abs_err"]
    check(errs["ulysses"] == 0.0, f"ulysses at sp={world}: {errs}")
    check(errs["ring"] <= O_TOL["atol"] * 2, f"ring at sp={world}: {errs}")
    pipe, ada, off = out["pipeline"], out["adafactor"], out["offload"]
    check(pipe["sharded_init_equal"],
          "mesh_multi pipeline: the stages' own draws differ from the "
          "one-rank draw's slices")
    for name, got, ref in (("pipeline", pipe, pipe["one_rank"]),
                           ("adafactor", ada, ada["one_rank"])):
        for i in range(MESH_STEPS):
            for what, tol in (("losses", MESH_LOSS_RTOL),
                              ("grad_norms", MESH_GNORM_RTOL)):
                a, b = got[what][i], ref[what][i]
                # adafactor's later losses: against the step-1 loss's
                # scale (see the note under OFFLOAD_MAX_STEPS)
                scale = (ref[what][0] if name == "adafactor"
                         and what == "losses" else b)
                check(abs(a - b) <= tol * abs(scale),
                      f"mesh_multi {name} step {i + 1} {what}: {a} vs one "
                      f"rank {b} (rtol {tol} of {scale})")
    if backend == "nccl":
        ticks = PIPE_MICROBATCHES + 1            # M + pp - 1
        per_step = {"flash_fwd": 2 * 2 * ticks, "flash_bwd_dq": 2 * ticks,
                    "flash_bwd_dkv": 2 * ticks}  # 2 layers a stage
        want = {k: v * MESH_STEPS for k, v in per_step.items()}
        check(pipe["launches"] == want,
              f"mesh_multi pipeline launches {pipe['launches']}, expected "
              f"{want}")
    rdv = out["rendezvous"]          # rank 0's
    check((rdv["RANK"], rdv["LOCAL_RANK"], rdv["WORLD_SIZE"])
          == ("0", "0", str(world)),
          f"mesh_multi rendezvous env of rank 0: {rdv}")
    dec = out["pp_decode"]
    check(dec["tokens_equal"],
          f"mesh_multi decode on {dec['mesh']}: {dec['differing_tokens']} "
          f"tokens differ from one rank's")
    heads = out["kv_heads"]
    if world == 4:
        lo = heads["lora"]
        for i in range(MESH_STEPS):
            for what, tol in (("losses", MESH_LOSS_RTOL),
                              ("grad_norms", MESH_GNORM_RTOL)):
                a, b = lo[what][i], lo["one_rank"][what][i]
                check(abs(a - b) <= tol * abs(b),
                      f"mesh_multi tp=4 over {heads['n_kv_heads']} KV heads "
                      f"step {i + 1} {what}: {a} vs one rank {b} (rtol {tol})")
        check(heads["decode"]["tokens_equal"],
              f"mesh_multi decode at tp=4 over 2 KV heads: "
              f"{heads['decode']['differing_tokens']} tokens differ from "
              f"one rank's")
    on, st = off["on_card"], off["streamed"]
    check(st["losses"][0] == on["losses"][0]
          and st["grad_norms"][0] == on["grad_norms"][0],
          f"mesh_multi offload step 1: {st['losses'][0]} / "
          f"{st['grad_norms'][0]} vs on-card {on['losses'][0]} / "
          f"{on['grad_norms'][0]}")
    check(abs(st["losses"][1] - on["losses"][1])
          <= MESH_LOSS_RTOL * abs(on["losses"][0]),
          f"mesh_multi offload step 2 loss {st['losses'][1]} vs on-card "
          f"{on['losses'][1]} (rtol {MESH_LOSS_RTOL} of the step-1 loss)")
    check(st["host_state_pinned"], "mesh_multi offload state not pinned")
    check(st["launches"] == on["launches"],
          f"mesh_multi offload launches {st['launches']} vs on-card "
          f"{on['launches']}")
    return out


def phase_qlora(card):
    """QLoRA at full Llama-2-7B: the train phase's configuration over an
    int4 base (group 128) built directly in packed form
    (``init_params_quantized``), 6 steps of ``fit``."""
    import numpy as np
    import torch

    from kubeflow_rm_tpu_torch.models.llama import LlamaConfig
    from kubeflow_rm_tpu_torch.models.lora import add_lora, is_lora_name
    from kubeflow_rm_tpu_torch.models.quantize import (
        init_params_quantized, quantized_bytes,
    )
    from kubeflow_rm_tpu_torch.training.data import to_device
    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig, leaf_paths
    from kubeflow_rm_tpu_torch.training.train import (
        TrainConfig, init_train_state, make_train_step,
    )
    from kubeflow_rm_tpu_torch.utils.flops import train_flops_per_token

    steps, B, T = 6, 2, 2048
    cfg = LlamaConfig.llama2_7b(param_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    base = init_params_quantized(
        cfg, torch.Generator(device="cuda").manual_seed(6), "cuda", bits=4,
        group_size=128)
    base_bytes = quantized_bytes(base)
    lp = add_lora(base, 16, generator=torch.Generator(device="cuda")
                  .manual_seed(2), targets=("wq", "wv"))
    tcfg = TrainConfig(model=cfg, optim=OptimConfig(
        train_only="lora", learning_rate=TRAIN_LR, warmup_steps=1,
        total_steps=steps))
    batch = packed_rows(B, T, cfg.vocab_size, seed=3)
    frozen = {k: v for k, v in leaf_paths(lp).items()
              if not is_lora_name(k.rsplit("/", 1)[-1])}
    before = checksums(frozen)
    state = init_train_state(tcfg, params=lp)

    reset_launches()
    t0 = time.perf_counter()
    state, history = fit(tcfg, itertools.repeat(batch),
                         LoopConfig(total_steps=steps, log_every=1),
                         state=state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_above = (torch.cuda.max_memory_allocated() - held) / 1e9

    L = cfg.n_layers
    losses = [h.loss for h in history]
    timed = history[1:]        # the first record holds the start-up sync
    after = checksums(frozen)
    adapters_b = {k: int(torch.count_nonzero(v))
                  for k, v in leaf_paths(state.params).items()
                  if k.endswith("_lora_b")}
    flops_step = train_flops_per_token(cfg, T, frozen_base=True) * B * T
    step_fn = make_train_step(tcfg, state)
    dev_batch = to_device(batch, "cuda")
    prof = device_profile(lambda: step_fn(state, dev_batch))
    emit("qlora", card=card, preset="llama2_7b", base="int4", group_size=128,
         lora_rank=16, targets=["wq", "wv"], tokens=[B, T], steps=steps,
         learning_rate=TRAIN_LR, remat=cfg.remat_policy, losses=losses,
         grad_norms=[h.grad_norm for h in history], launches=launches,
         step_time_ms=statistics.median(h.step_time_ms for h in timed),
         tokens_per_s=statistics.median(h.tokens_per_sec for h in timed),
         mfu_pct=statistics.median(h.mfu_pct for h in timed),
         model_tflop_per_step=flops_step / 1e12, fit_wall_s=wall,
         base_bytes=base_bytes, peak_mem_gb_above_held=peak_above,
         held_gb=held / 1e9, adapter_b_nonzero=adapters_b,
         base_byte_identical=before == after, profile_one_step=prof)
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(before == after, "a frozen int4 base array changed")
    check(all(not t.requires_grad for t in frozen.values()),
          "a frozen base array requires grad")
    check(all(n > 0 for n in adapters_b.values()),
          f"an adapter's b stayed zero: {adapters_b}")
    check(launches == {"flash_fwd": 2 * L * steps,
                       "flash_bwd_dq": L * steps,
                       "flash_bwd_dkv": L * steps},
          f"qlora launches {launches}, expected per step flash_fwd "
          f"{2 * L} and {L} of each backward kernel")
    return launches


def phase_moe(card):
    """Mixtral 8x7B at full width and 16 of its 32 layers (bf16): the
    forward, kernel against dense attention on 4 layers, fused decode
    against the per-token loop, the engine against a teacher-forced
    forward, and 4 LoRA steps of ``fit``. Returns the launches of the
    forward and of the LoRA run."""
    import gc

    import numpy as np
    import torch

    from kubeflow_rm_tpu_torch.models import forward_with_aux
    from kubeflow_rm_tpu_torch.models.generate import (
        ContinuousBatchingEngine, generate, generate_fused,
    )
    from kubeflow_rm_tpu_torch.models.lora import add_lora, is_lora_name
    from kubeflow_rm_tpu_torch.models.mixtral import (
        MixtralConfig, init_params,
    )
    from kubeflow_rm_tpu_torch.models.quantize import quantized_bytes
    from kubeflow_rm_tpu_torch.training.data import to_device
    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig, leaf_paths
    from kubeflow_rm_tpu_torch.training.train import (
        TrainConfig, init_train_state, make_train_step,
    )
    from kubeflow_rm_tpu_torch.utils.flops import matmul_param_count

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    cfg = MixtralConfig.mixtral_8x7b(n_layers=16, param_dtype=torch.bfloat16)
    L, V = cfg.n_layers, cfg.vocab_size
    # capacity for E / top_k = 4 slots a token: no token is ever dropped,
    # so decode and a full forward route every token alike
    no_drop = replace(cfg, moe=replace(cfg.moe, capacity_factor=4.0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                         "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaf_paths(params).values())
    gen = torch.Generator(device="cuda").manual_seed(8)
    tokens = torch.randint(0, V, (1, 2048), generator=gen, device="cuda",
                           dtype=torch.int32)
    out = dict(card=card, preset="mixtral_8x7b", n_layers=L,
               params=n_params, param_bytes=quantized_bytes(params),
               active_params=matmul_param_count(cfg), init_s=init_s)

    with torch.inference_mode():
        reset_launches()
        logits, aux = forward_with_aux(params, tokens, cfg)   # the main path
        torch.cuda.synchronize()
        fwd_counts = read_launches()
        check(fwd_counts == {"flash_fwd": L, "flash_bwd_dq": 0,
                             "flash_bwd_dkv": 0},
              f"moe forward launched {fwd_counts}, expected flash_fwd {L}")
        check(tuple(logits.shape) == (1, 2048, V)
              and bool(torch.isfinite(logits).all()),
              "bad Mixtral forward logits")
        aux = float(aux)
        check(1.0 <= aux <= cfg.moe.n_experts,
              f"router aux {aux} outside [1, {cfg.moe.n_experts}]")
        del logits
        _, fwd_t = timed(lambda: forward_with_aux(params, tokens, cfg)[0])
        out.update(forward_launches=fwd_counts, router_aux=aux,
                   forward_ms=fwd_t,
                   forward_tokens_per_s=2048 / fwd_t["median"] * 1e3)

        # kernel and dense attention against float32 on the first 4
        # layers (the 16-layer tree in float32 would not fit beside it)
        cut = replace(cfg, n_layers=4)
        sub = dict(params, blocks={k: v[:4]
                                   for k, v in params["blocks"].items()})
        sub32 = {k: ({n: t.float() for n, t in v.items()}
                     if isinstance(v, dict) else v.float())
                 for k, v in sub.items()}
        cut32 = replace(cut, dtype=torch.float32,
                        param_dtype=torch.float32)
        lk = forward_with_aux(sub, tokens, cut)[0]
        ld = forward_with_aux(sub, tokens, cut, impl="dense")[0]
        l32 = forward_with_aux(sub32, tokens, cut32)[0]
        k32, d32 = equally_close(lk, ld, l32, "moe kernel vs dense forward")
        del lk, ld, l32
        # the engine's tolerance: bf16-vs-float32 at the engine's config
        lk = forward_with_aux(sub, tokens, replace(cut, moe=no_drop.moe))[0]
        l32 = forward_with_aux(sub32, tokens,
                               replace(cut32, moe=no_drop.moe))[0]
        err32 = float((lk - l32).abs().max())
        del lk, l32, sub32
        free()
        out.update(kernel_vs_fp32_4l=k32, dense_vs_fp32_4l=d32,
                   bf16_vs_fp32_max_abs_4l_no_drop=err32)

    # fused decode against the per-token loop: 4 prompts x 16 tokens
    new = 16
    prompt = torch.randint(1, V, (4, 32), generator=gen, device="cuda",
                           dtype=torch.int32)
    fused, fused_t = timed(lambda: generate_fused(params, cfg, prompt,
                                                  max_new_tokens=new), reps=2)
    _, one_t = timed(lambda: generate_fused(params, cfg, prompt,
                                            max_new_tokens=1), reps=2)
    loop = generate(params, cfg, prompt, max_new_tokens=new)
    check(torch.equal(fused, loop), "moe generate_fused differs from the "
          "per-token loop")
    out.update(decode=dict(
        prompts=[4, 32], new_tokens=new, fused_ms=fused_t,
        step_ms=(fused_t["median"] - one_t["median"]) / (new - 1)))

    # the engine, teacher-forced against the forward (no drops)
    rng = np.random.default_rng(1)
    reqs = [dict(prompt=rng.integers(1, V, n).tolist(), new=new,
                 slo_class=c)
            for n, c in ((12, "interactive"), (40, "batch"),
                         (77, "best_effort"), (130, "interactive"))]
    eng = ContinuousBatchingEngine(params, no_drop, slots=4, slot_len=512,
                                   block_size=16)
    reset_launches()
    handles, latency, wall, step_ms, _ = run_engine(eng, reqs)
    eng_counts = read_launches()
    st = eng.stats()
    del eng
    free()
    tf, _ = teacher_forced(params, no_drop, handles, {})
    delta = DELTA_PER_ERROR * err32
    toks = sum(len(h.tokens) for h in handles)
    out.update(engine=dict(
        requests=len(handles), done=sum(h.done for h in handles),
        tokens_out=toks, tokens_per_s=toks / wall,
        median_step_ms=statistics.median(step_ms),
        decode_steps=st["decode_steps"], launches=eng_counts,
        exact_fraction=sum(c["exact"] for c in tf) / len(tf),
        max_gap=max(c["max_gap"] for c in tf), delta=delta,
        first_divergence={i: c["first"] for i, c in enumerate(tf)
                          if not c["exact"]}))
    check(all(h.done and len(h.tokens) == new for h in handles),
          "a Mixtral engine request did not finish")
    check(eng_counts == {"flash_fwd": 0, "flash_bwd_dq": 0,
                         "flash_bwd_dkv": 0},
          f"the Mixtral engine launched {eng_counts}")
    check(out["engine"]["max_gap"] <= delta,
          f"Mixtral engine: a token trails forward's maximum by "
          f"{out['engine']['max_gap']} > delta {delta}")

    # LoRA: rank 16 on wq/wv over the frozen bf16 base, 4 steps of fit
    steps, B, T = 4, 1, 2048
    lp = add_lora(params, 16, generator=torch.Generator(device="cuda")
                  .manual_seed(2), targets=("wq", "wv"))
    tcfg = TrainConfig(model=cfg, optim=OptimConfig(
        train_only="lora", learning_rate=TRAIN_LR, warmup_steps=1,
        total_steps=steps))
    batch = packed_rows(B, T, V, seed=9)
    base = {k: v for k, v in leaf_paths(lp).items()
            if not is_lora_name(k.rsplit("/", 1)[-1])}
    before = checksums(base)
    state = init_train_state(tcfg, params=lp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, history = fit(tcfg, itertools.repeat(batch),
                         LoopConfig(total_steps=steps, log_every=1),
                         state=state)
    torch.cuda.synchronize()
    lora_counts = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h.loss for h in history]
    timed_h = history[1:]      # the first record holds the start-up sync
    after = checksums(base)
    step_fn = make_train_step(tcfg, state)
    dev_batch = to_device(batch, "cuda")
    box = {}
    prof = device_profile(lambda: box.update(m=step_fn(state, dev_batch)[1]))
    metrics = {k: float(v) for k, v in box["m"].items()}
    step_ms = statistics.median(h.step_time_ms for h in timed_h)
    tps = statistics.median(h.tokens_per_sec for h in timed_h)
    out.update(lora=dict(
        rank=16, targets=["wq", "wv"], tokens=[B, T], steps=steps,
        learning_rate=TRAIN_LR, remat=cfg.remat_policy, losses=losses,
        grad_norms=[h.grad_norm for h in history], launches=lora_counts,
        router_aux=metrics.get("router_aux"), step_time_ms=step_ms,
        tokens_per_s=tps,
        mfu_pct=statistics.median(h.mfu_pct for h in timed_h),
        peak_mem_gb=peak_gb, base_bit_identical=before == after,
        profile_one_step=prof))
    emit("moe", **out)
    check(all(np.isfinite(losses)), f"non-finite Mixtral loss: {losses}")
    check(losses[-1] < losses[0], f"Mixtral loss did not fall: {losses}")
    check(before == after, "a frozen Mixtral base weight changed")
    check(metrics.get("router_aux") is not None
          and np.isfinite(metrics["router_aux"]),
          f"router_aux not reported: {metrics}")
    check(lora_counts == {"flash_fwd": 2 * L * steps,
                          "flash_bwd_dq": L * steps,
                          "flash_bwd_dkv": L * steps},
          f"Mixtral LoRA launches {lora_counts}, expected per step "
          f"flash_fwd {2 * L} and {L} of each backward kernel")
    return fwd_counts, lora_counts


def phase_moe_int8(card):
    """Mixtral 8x7B at full width and depth, built directly in int8
    (``init_params_quantized``): stored bytes, and fused decode against
    the per-token loop. Decode takes the dense attention path, so no
    kernel runs. Returns the launches (all zero)."""
    import torch

    from kubeflow_rm_tpu_torch.models.generate import generate, generate_fused
    from kubeflow_rm_tpu_torch.models.mixtral import MixtralConfig
    from kubeflow_rm_tpu_torch.models.quantize import (
        init_params_quantized, quantized_bytes,
    )
    from kubeflow_rm_tpu_torch.training.optim import leaf_paths

    cfg = MixtralConfig.mixtral_8x7b(param_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params_quantized(
        cfg, torch.Generator(device="cuda").manual_seed(11), "cuda", bits=8)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    flat = leaf_paths(params)
    by_kind = {"q": 0, "s": 0, "float": 0}
    for k, t in flat.items():
        kind = k.rsplit("/", 1)[-1]
        by_kind[kind if kind in ("q", "s") else "float"] += (
            t.numel() * t.element_size())
    new = 16
    gen = torch.Generator(device="cuda").manual_seed(12)
    prompt = torch.randint(1, cfg.vocab_size, (4, 32), generator=gen,
                           device="cuda", dtype=torch.int32)
    reset_launches()
    fused, fused_t = timed(lambda: generate_fused(params, cfg, prompt,
                                                  max_new_tokens=new), reps=2)
    _, one_t = timed(lambda: generate_fused(params, cfg, prompt,
                                            max_new_tokens=1), reps=2)
    loop = generate(params, cfg, prompt, max_new_tokens=new)
    torch.cuda.synchronize()
    counts = read_launches()
    emit("moe_int8", card=card, preset="mixtral_8x7b",
         n_layers=cfg.n_layers, bits=8, stored_bytes=quantized_bytes(params),
         bytes_by_kind=by_kind, init_s=init_s, init_peak_gb=init_peak,
         prompts=[4, 32], new_tokens=new, fused_ms=fused_t,
         decode_step_ms=(fused_t["median"] - one_t["median"]) / (new - 1),
         fused_equals_loop=bool(torch.equal(fused, loop)), launches=counts,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(torch.equal(fused, loop),
          "int8 Mixtral generate_fused differs from the per-token loop")
    check(counts == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0},
          f"int8 Mixtral decode launched {counts}")
    return counts


def bf16_steps(a, b, w0):
    """Per element |a - b| in bf16 steps at max(|w0|, |a|, |b|): the
    spacing of bf16 numbers at the larger of a weight before (``w0``) and
    after its update (float32 math; the smallest normal's spacing at
    least). Measured at the result alone, an update that nearly cancels
    its weight would count its own rounding as a large error."""
    import torch

    a, b = a.float(), b.float()
    mag = torch.maximum(torch.maximum(a.abs(), b.abs()), w0.float().abs())
    spacing = torch.exp2(torch.floor(torch.log2(
        mag.clamp_min(torch.finfo(torch.bfloat16).tiny))) - 7)
    return (a - b).abs() / spacing


def phase_offload(card):
    """Full fine-tuning of Llama-2-7B with adafactor and the optimizer in
    host memory (``offload="optimizer"``, chunks of 4 layers): 2 steps of
    the streamed arm against 2 of the on-card arm from the same weights
    and batch; then both scalers at 7B width and 2 layers. Returns the
    streamed arm's launches and the 2-layer adafactor arms
    (``phase_offload_mesh1`` holds the mesh's arm to them)."""
    import gc

    import numpy as np
    import torch

    from kubeflow_rm_tpu_torch.models.llama import LlamaConfig, init_params
    from kubeflow_rm_tpu_torch.training.data import to_device
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig, leaf_paths
    from kubeflow_rm_tpu_torch.training.train import (
        TrainConfig, init_train_state, make_train_step,
    )

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    host_free = subprocess.run(["free", "-g"], capture_output=True,
                               text=True, timeout=60).stdout
    B, T = 1, 2048
    batch = packed_rows(B, T, 32000, seed=13)

    def arms(cfg, factored, steps, seed):
        """Both arms from one seed: per arm the losses, step times, the
        streamed arm's metrics and the launches; the largest step-1
        parameter difference between the arms in bf16 steps and the share
        of elements that differ; whether every layer of every leaf moved
        in step 1. The peak memory is the steps' own (the checks between
        them are left out)."""
        res, ref = {}, None
        for off in ("none", "optimizer"):
            tcfg = TrainConfig(model=cfg, optim=OptimConfig(
                factored=factored, offload=off, offload_chunk_layers=4,
                learning_rate=OFFLOAD_LR, warmup_steps=0,
                total_steps=100))
            params = init_params(
                cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
            init_sums = checksums(params)
            state = init_train_state(tcfg, params=params)
            del params
            step = make_train_step(tcfg, state)
            dev_batch = to_device(batch, "cuda")
            losses, ms, extra, peak = [], [], [], 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            for i in range(steps):
                t0 = time.perf_counter()
                state, m = step(state, dev_batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                peak = max(peak, torch.cuda.max_memory_allocated())
                losses.append(float(m["loss"]))
                extra.append({k: float(m[k]) for k in
                              ("offload_transfer_ms", "offload_overlap_frac")
                              if k in m})
                if i > 0:
                    continue
                flat = leaf_paths(state.params)
                after = checksums(state.params)
                res[f"changed_{off}"] = {
                    k: all(x != y for x, y in zip(init_sums[k], after[k]))
                    for k in init_sums}
                if ref is None:        # the on-card arm's step-1 weights
                    ref = {k: t.detach().to("cpu", copy=True)
                           for k, t in flat.items()}
                    torch.cuda.reset_peak_memory_stats()
                    continue
                # the initial weights again, from the seed
                w0 = leaf_paths(init_params(
                    cfg, torch.Generator(device="cuda").manual_seed(seed),
                    "cuda"))
                worst, differ, total = 0.0, 0, 0
                for k, t in flat.items():
                    rows = zip(*(x.reshape(-1, t.shape[-1]).split(4096)
                                 for x in (ref[k], t.detach(), w0[k])))
                    for a, b, c in rows:
                        a = a.to("cuda")
                        worst = max(worst, float(bf16_steps(a, b, c).max()))
                        differ += int((a != b).sum())
                        total += a.numel()
                res.update(max_steps_step1=worst,
                           differing_fraction_step1=differ / total)
                ref = w0 = None
                torch.cuda.reset_peak_memory_stats()
            flat = None
            res[off] = dict(losses=losses, step_ms=ms, metrics=extra,
                            launches=read_launches(), peak_gb=peak / 1e9)
            if off == "optimizer":
                tensors = [t for s in state.opt_state.values()
                           for f in s.__dataclass_fields__ if f != "count"
                           for t in getattr(s, f).values()]
                res["host_state_bytes"] = sum(
                    t.numel() * t.element_size() for t in tensors)
                res["host_state_pinned"] = all(
                    t.device.type == "cpu" and t.is_pinned()
                    for t in tensors)
            del state, step
            free()
        return res

    cfg = LlamaConfig.llama2_7b(param_dtype=torch.bfloat16)
    full = arms(cfg, True, 2, 14)
    L = cfg.n_layers
    small = {name: arms(replace(cfg, n_layers=2), fac, 2, 15)
             for name, fac in (("adam", False), ("adafactor", True))}
    stream = full["optimizer"]
    emit("offload", card=card, preset="llama2_7b", optimizer="adafactor",
         offload="optimizer", chunk_layers=4, tokens=[B, T],
         learning_rate=OFFLOAD_LR, host_free_g=host_free.split("\n")[:2],
         on_card=full["none"], streamed=stream,
         host_state_bytes=full["host_state_bytes"],
         host_state_pinned=full["host_state_pinned"],
         jax_priced_on_chip_gb=32.05,
         step1_max_bf16_steps=full["max_steps_step1"],
         step1_differing_fraction=full["differing_fraction_step1"],
         every_leaf_changed=all(full["changed_none"].values())
         and all(full["changed_optimizer"].values()),
         two_layer={n: {k: v for k, v in r.items()
                        if not k.startswith("changed")}
                    for n, r in small.items()})
    for name, r in (("7b adafactor", full), *((f"2-layer {n}", r)
                                              for n, r in small.items())):
        on, off = r["none"], r["optimizer"]
        check(np.isfinite(on["losses"]).all()
              and np.isfinite(off["losses"]).all(),
              f"{name}: non-finite loss {on['losses']} {off['losses']}")
        check(on["losses"][0] == off["losses"][0],
              f"{name}: step-1 losses differ: {on['losses'][0]} vs "
              f"{off['losses'][0]}")
        check(r["max_steps_step1"] <= OFFLOAD_MAX_STEPS,
              f"{name}: step-1 parameters differ by "
              f"{r['max_steps_step1']} bf16 steps")
        for arm in ("none", "optimizer"):
            moved = r[f"changed_{arm}"]
            check(all(moved.values()),
                  f"{name} ({arm}): unchanged after step 1: "
                  f"{[k for k, c in moved.items() if not c]}")
        check(all(0.0 <= m["offload_overlap_frac"] <= 1.0
                  for m in off["metrics"]), f"{name}: overlap fraction")
    check(full["host_state_pinned"], "the offload state is not pinned")
    want = {"flash_fwd": 2 * L * 2, "flash_bwd_dq": L * 2,
            "flash_bwd_dkv": L * 2}
    check(stream["launches"] == want and full["none"]["launches"] == want,
          f"offload launches {stream['launches']} / on-card "
          f"{full['none']['launches']}, expected per step flash_fwd {2 * L} "
          f"and {L} of each backward kernel")
    return stream["launches"], small["adafactor"]


def phase_offload_mesh1(card, two_layer):
    """The host-offload arm on the one-rank NCCL mesh: adafactor at 7B
    width and 2 layers from the offload phase's seed and batch, 2 steps
    of ``make_train_step(..., mesh=)`` against that phase's non-mesh
    streamed arm (``two_layer``: step-1 losses bit-equal, the same
    gradient phase); then ``pipeline_forward`` at pp=1 against
    ``forward`` on the trained weights (bit-equal: the schedule falls
    back to the family's forward). Returns the launches."""
    import torch
    import torch.distributed as dist

    from kubeflow_rm_tpu_torch.models.llama import (
        LlamaConfig, forward, init_params,
    )
    from kubeflow_rm_tpu_torch.parallel.mesh import (
        MeshConfig, make_mesh, mesh_shape,
    )
    from kubeflow_rm_tpu_torch.parallel.pipeline import pipeline_forward
    from kubeflow_rm_tpu_torch.training.data import to_device
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.train import (
        TrainConfig, shard_batch,
    )

    check(two_layer is not None, "the offload phase gave no 2-layer arm")
    cfg = replace(LlamaConfig.llama2_7b(param_dtype=torch.bfloat16),
                  n_layers=2)
    tcfg = TrainConfig(model=cfg, optim=OptimConfig(
        factored=True, offload="optimizer", offload_chunk_layers=4,
        learning_rate=OFFLOAD_LR, warmup_steps=0, total_steps=100))
    batch = to_device(packed_rows(1, 2048, 32000, seed=13), "cuda")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(MeshConfig(dp=1, fsdp=1, tp=1))
        params = init_params(
            cfg, torch.Generator(device="cuda").manual_seed(15), "cuda")
        reset_launches()
        state, _, rec = _mesh_steps(tcfg, params, shard_batch(batch, mesh),
                                    mesh, 2)
        launches = read_launches()
        with torch.no_grad():
            piped = pipeline_forward(state.params, batch["tokens"], cfg,
                                     mesh)
            plain = forward(state.params, batch["tokens"], cfg)
        pp1_equal = bool(torch.equal(piped, plain))
        out = {"mesh": mesh_shape(mesh)}
    finally:
        dist.destroy_process_group()
    ref = two_layer["optimizer"]
    emit("offload_mesh1", card=card, preset="llama2_7b", layers=2,
         optimizer="adafactor", offload="optimizer", **out,
         streamed=rec, non_mesh_streamed={k: ref[k] for k in (
             "losses", "step_ms", "metrics")},
         launches=launches, pipeline_pp1_bit_equal=pp1_equal)
    check(rec["losses"][0] == ref["losses"][0],
          f"offload on the one-rank mesh: step-1 loss {rec['losses'][0]!r}"
          f" != the non-mesh arm's {ref['losses'][0]!r}")
    check(all(0.0 <= m["offload_overlap_frac"] <= 1.0
              for m in rec["offload"]), "offload_mesh1 overlap fraction")
    check(launches == {"flash_fwd": 8, "flash_bwd_dq": 4,
                       "flash_bwd_dkv": 4},
          f"offload_mesh1 launches {launches}, expected per step "
          "flash_fwd 4 and 2 of each backward kernel")
    check(pp1_equal, "pipeline_forward at pp=1 differs from forward")
    return launches


# torchcheck: the reduced rungs the planner is held to on the card (name,
# preset, optimizer, batch rows, accumulation, remat, LoRA rank or 0).
# Each runs with its own microbatch and remat and an accumulation of 2
# (the walk's own: from two microbatches on, the step's peak repeats);
# the 7B LoRA rung is the train phase's step (one packed 2 × 2048 batch).
PLAN_RUNGS = (
    ("1.2B full-FT adamw mb2 dots seq2048", "bench_1b", "adamw", 4, 2,
     "dots", 0),
    ("2.7B full-FT adafactor mb1 full", "bench_2_7b", "adafactor", 2, 2,
     "full", 0),
    ("7B full-FT adafactor mb1 full seq2048", "llama2_7b", "adafactor", 2,
     2, "full", 0),
    ("7B full-FT adamw mb1 full seq2048", "llama2_7b", "adamw", 2, 2,
     "full", 0),
    ("7B LoRA r16 wq/wv dots (the train phase's step)", "llama2_7b",
     "adamw", 2, 1, "dots", 16),
)
# the walk's peak of each rung, in GB, while the step's gradient
# accumulation rebuilt its sum out of place (the old sum, a microbatch's
# tree and the new sum alive at once; added in place it holds two): the
# planner's prediction for the step before that repair, shown beside
# the new one (the same walk over that step's code, on a CPU)
OUT_OF_PLACE_PEAK_GB = {
    PLAN_RUNGS[0][0]: 15.951, PLAN_RUNGS[1][0]: 21.508,
    PLAN_RUNGS[2][0]: 53.913, PLAN_RUNGS[3][0]: 80.861,
    PLAN_RUNGS[4][0]: 30.588,
}
# the walk's peak of each rung, in GB, while the training forwards took
# layer i of a stacked leaf by a per-layer select, whose backward is a
# zero-filled tensor of the whole leaf, one a layer (the walk held two
# of the largest leaf's at the backward that binds; the card one): the
# planner's prediction for the step before the stacked-slice repair
# (``llama.layer_slices``), shown beside the new one
SELECT_PEAK_GB = {
    PLAN_RUNGS[0][0]: 15.951, PLAN_RUNGS[1][0]: 18.591,
    PLAN_RUNGS[2][0]: 46.781, PLAN_RUNGS[3][0]: 76.993,
    PLAN_RUNGS[4][0]: 30.588,
}
# the planner's peak against the allocator's, either way: the bound JAX
# held its anchors to (tests/test_jaxcheck.py)
PLAN_RTOL = 0.10
# the rung the card must reject, run in a subprocess of its own
OOM_RUNG = ("13B full-FT adamw mb1 full seq2048", "llama2_13b", "adamw", 2,
            2, "full", 0)


def _rung_cfg(rung):
    """(TrainConfig, packed?) of a ``PLAN_RUNGS`` entry, at seq 2048."""
    from kubeflow_rm_tpu_torch.analysis.torchcheck.memplan import (
        model_config,
    )
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.train import TrainConfig

    _, preset, optim, _, _, remat, lora = rung
    model = model_config(preset, remat, 2048)
    optim_cfg = OptimConfig(factored=optim == "adafactor",
                            train_only="lora" if lora else None)
    return TrainConfig(model=model, optim=optim_cfg), bool(lora)


def _rung_params(rung, cfg, gen, device):
    """The rung's parameters on ``device`` (adapters for a LoRA rung),
    or None for the model's own draw."""
    from kubeflow_rm_tpu_torch.models import init_params
    from kubeflow_rm_tpu_torch.models.lora import add_lora

    lora = rung[-1]
    if not lora:
        return None
    return add_lora(init_params(cfg, gen, device), lora, generator=gen,
                    targets=("wq", "wv"))


def _rung_batch(rung, cfg, packed: bool) -> dict:
    import torch

    rows = rung[3]
    if packed:
        host = packed_rows(rows, 2048, cfg.vocab_size, seed=3)
    else:
        import numpy as np

        rng = np.random.default_rng(5)
        host = {k: rng.integers(1, cfg.vocab_size, (rows, 2048))
                .astype(np.int32) for k in ("tokens", "labels")}
    return {k: torch.from_numpy(v).cuda() for k, v in host.items()}


def walk_rung(rung) -> dict:
    """The planner's walk of a ``PLAN_RUNGS`` entry on meta tensors (no
    card needed): ``python3 -c "import chip_smoke as c;
    c.print_plan_walks()"`` prints all five on a CPU."""
    from kubeflow_rm_tpu_torch.analysis.torchcheck import memplan

    tcfg, packed = _rung_cfg(rung)
    t0 = time.perf_counter()
    w = memplan.walk_train_step(
        tcfg, rung[3], rung[4], packed=packed,
        params_fn=None if not rung[-1] else
        (lambda g, r=rung, c=tcfg.model: _rung_params(r, c, g, "meta")))
    w["walk_s"] = time.perf_counter() - t0
    return w


def print_plan_walks() -> None:
    """One JSON line per ``PLAN_RUNGS`` entry: the walk's peak beside the
    walk of the step whose layers were taken by a per-layer select
    (``SELECT_PEAK_GB``)."""
    for rung in PLAN_RUNGS:
        w = walk_rung(rung)
        print(json.dumps(dict(rung=rung[0],
                              predicted_peak_gb=w["peak_bytes"] / 1e9,
                              select_peak_gb=SELECT_PEAK_GB[rung[0]],
                              walk_s=w["walk_s"])), flush=True)


def measure_rung(rung) -> dict:
    """One real step of a reduced rung on the card, its state already
    resident: ``max_memory_allocated`` after ``reset_peak_memory_stats``,
    less what was allocated before the rung's state was built."""
    import gc

    import torch

    from kubeflow_rm_tpu_torch.training.train import (
        init_train_state, make_train_step,
    )

    tcfg, packed = _rung_cfg(rung)
    gc.collect()
    torch.cuda.empty_cache()
    outside = torch.cuda.memory_allocated()
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = init_train_state(tcfg, gen, device="cuda",
                             params=_rung_params(rung, tcfg.model, gen,
                                                 "cuda"))
    step = make_train_step(tcfg, state, grad_accum=rung[4])
    batch = _rung_batch(rung, tcfg.model, packed)
    _, metrics = step(state, batch)          # builds kernels, cuBLAS
    loss = float(metrics["loss"])
    del metrics
    gc.collect()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated() - outside
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, metrics = step(state, batch)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() - outside
    loss2 = float(metrics["loss"])
    del state, step, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return dict(peak_bytes=peak, resident_bytes=resident, step_ms=ms,
                losses=[loss, loss2])


def oom_child() -> int:
    """Run in a subprocess of its own (``phase_torchcheck``): build the
    13B adamw rung's state on the card and take one step. Prints one
    JSON line: where the card ran out of memory, or that the step
    completed (the planner then was wrong)."""
    import torch

    from kubeflow_rm_tpu_torch.training.train import (
        init_train_state, make_train_step,
    )

    tcfg, packed = _rung_cfg(OOM_RUNG)
    where = "init"
    try:
        gen = torch.Generator(device="cuda").manual_seed(0)
        state = init_train_state(tcfg, gen, device="cuda")
        where = "step"
        step = make_train_step(tcfg, state, grad_accum=OOM_RUNG[4])
        _, metrics = step(state, _rung_batch(OOM_RUNG, tcfg.model, packed))
        torch.cuda.synchronize()
    except torch.cuda.OutOfMemoryError as e:
        print(json.dumps({
            "oom": True, "where": where, "error": str(e).splitlines()[0],
            "allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "max_allocated_gb": torch.cuda.max_memory_allocated() / 1e9}),
            flush=True)
        return 0
    print(json.dumps({"oom": False, "loss": float(metrics["loss"])}),
          flush=True)
    return 0


def trace_kernel_ms(path: str) -> dict:
    """Device time of each flash kernel in a Chrome trace: per kernel
    name, the launches and the mean ms a launch."""
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        durs = [e["dur"] for e in events
                if e.get("cat") == "kernel"
                and name + "_kernel" in e.get("name", "")]
        out[name] = dict(launches=len(durs),
                         ms=(sum(durs) / len(durs) / 1e3) if durs else None)
    return out


def probe_engine(params, cfg) -> dict:
    """The engine phase's requests through both arms with the host-sync
    probe and the signature sentinel on; then one step's syncs as the
    CUDA runtime counts them (``set_sync_debug_mode("warn")``) beside
    the probe's count of the same step."""
    import collections
    import gc
    import warnings

    import torch

    from kubeflow_rm_tpu_torch.analysis.torchcheck import (
        hostsync, recompile,
    )
    from kubeflow_rm_tpu_torch.models.generate import ContinuousBatchingEngine

    reqs, candidates, chain_prompt = engine_traffic(cfg.vocab_size)
    spec_prompt, _ = speculative_prompt(params, cfg, candidates, SPEC_NEW)
    reqs.append(dict(prompt=spec_prompt, new=SPEC_NEW, slo_class="batch",
                     speculative=True))
    kw = dict(slots=ENGINE_SLOTS, slot_len=ENGINE_SLOT_LEN,
              block_size=ENGINE_BLOCK)

    def site(w):
        # the innermost frame in the port: where the sync was asked for
        lines = [ln.strip() for ln in w["stack"].splitlines()
                 if ln.strip().startswith('File "')]
        ours = [ln for ln in lines if "kubeflow_rm_tpu_torch" in ln]
        return (ours or lines or ["?"])[-1].split("kubeflow_rm_tpu_torch/")[
            -1]

    out = {}
    hostsync.set_enabled(True)
    recompile.set_enabled(True)
    hostsync.install()
    try:
        for arm in ("paged", "contiguous"):
            hostsync.reset()
            recompile.reset()
            paged = arm == "paged"
            chain = None
            if paged:
                pf = ContinuousBatchingEngine(params, cfg, **dict(kw, slots=1))
                chain = pf.prefill_chain(chain_prompt)
                del pf
                hostsync.reset()
                recompile.reset()
            eng = ContinuousBatchingEngine(params, cfg, paged=paged, **kw)
            handles, _, wall, _, _ = run_engine(eng, reqs, chain)
            steps = eng.decode_steps
            prefills = eng.prefills
            wit = hostsync.witnesses()
            by_region = collections.defaultdict(collections.Counter)
            for w in wit:
                by_region[w["region"]][(w["kind"], site(w))] += 1
            rep = recompile.report()
            out[arm] = dict(
                decode_steps=steps, prefills=prefills, wall_s=wall,
                done=all(h.done for h in handles),
                witnesses={r: dict(total=sum(c.values()),
                                   per_decode_step=sum(c.values()) / steps,
                                   sites=[dict(kind=k, site=s, count=n)
                                          for (k, s), n in c.most_common()])
                           for r, c in by_region.items()},
                sentinel={e: dict(signatures=v["signatures"],
                                  calls=v["calls"], limit=v["limit"])
                          for e, v in rep.items()},
                over_limit=recompile.over_limit())
            del eng
            gc.collect()
            torch.cuda.empty_cache()

        # one engine step of 8 live slots: the CUDA runtime's syncs and
        # the probe's witnesses of the same step (a region around it
        # catches the syncs outside the engine's own regions)
        eng = ContinuousBatchingEngine(params, cfg, paged=True, **kw)
        for r in reqs[:ENGINE_SLOTS]:
            eng.submit(r["prompt"], max_new_tokens=r["new"],
                       slo_class=r["slo_class"])
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
        hostsync.reset()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with hostsync.region("engine.step"):
                    eng.step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        runtime = [w for w in caught
                   if "called a synchronizing" in str(w.message)]
        probe = hostsync.witnesses()
        out["one_step"] = dict(
            cuda_runtime_syncs=len(runtime),
            # the Python line of each: warnings name the caller's frame
            cuda_runtime_sites=dict(collections.Counter(
                f"{w.filename.split('kubeflow_rm_tpu_torch/')[-1]}:"
                f"{w.lineno}" for w in runtime)),
            probe_witnesses=len(probe),
            probe_sites=dict(collections.Counter(
                f"{w['region']} {w['kind']} {site(w)}" for w in probe)))
        del eng
    finally:
        hostsync.uninstall()
        hostsync.set_enabled(False)
        recompile.set_enabled(False)
        hostsync.reset()
        recompile.reset()
    return out


def drift_slo_state() -> tuple[float, str]:
    """The ``declared-hbm-drift`` SLO's threshold, read off the port's
    ``default_slos()``, and its state once an ``Observer`` has sampled
    the drift gauge three times, 30 s apart on its own clock (a
    sustained reading, as the SLO's windowed mean wants)."""
    from kubeflow_rm_tpu_torch.controlplane import obs

    (spec,) = [s for s in obs.default_slos()
               if s.name == "declared-hbm-drift"]
    observer = obs.Observer(interval_s=1.0)
    base = time.time()
    for t in (0.0, 30.0, 60.0):
        observer.tick(now=base + t)
    return spec.threshold, observer.engine.state_of("declared-hbm-drift")


def phase_torchcheck(card, timing):
    """The program auditor on the card: the planner against the
    allocator on four reduced rungs, the 13B rung's OOM in a subprocess
    of its own, the pricer's verdicts, the probe and the sentinel on the
    7B engine, a profiler trace of one 7B LoRA step, and the cost
    model's self-check. ``timing`` is the kernels phase's (for the
    profiler's kernel times beside the smoke's own)."""
    import gc
    import os
    import tempfile

    import torch

    from kubeflow_rm_tpu_torch.analysis.torchcheck import memplan, pricer
    from kubeflow_rm_tpu_torch.analysis.torchcheck.costmodel import selfcheck
    from kubeflow_rm_tpu_torch.controlplane import metrics as cp_metrics
    from kubeflow_rm_tpu_torch.controlplane.webhook.admission_pricer import (
        record_declared_drift,
    )
    from kubeflow_rm_tpu_torch.models.llama import LlamaConfig, init_params
    from kubeflow_rm_tpu_torch.models.lora import add_lora
    from kubeflow_rm_tpu_torch.training.data import to_device
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.train import (
        TrainConfig, init_train_state, make_train_step,
    )
    from kubeflow_rm_tpu_torch.utils import profiling

    failures = selfcheck()
    emit("torchcheck", part="selfcheck", card=card, failures=failures)
    check(not failures, f"cost model selfcheck: {failures}")

    dev = memplan.card()
    rows = []
    for rung in PLAN_RUNGS:
        w = walk_rung(rung)
        walk_s = w["walk_s"]
        m = measure_rung(rung)
        delta = (w["peak_bytes"] - m["peak_bytes"]) / m["peak_bytes"]
        rows.append(dict(
            rung=rung[0], batch=rung[3], grad_accum=rung[4],
            microbatch=rung[3] // rung[4], remat=rung[5], seq=2048,
            walk_s=walk_s, predicted_peak_gb=w["peak_bytes"] / 1e9,
            predicted_peak_gb_out_of_place=OUT_OF_PLACE_PEAK_GB[rung[0]],
            predicted_peak_gb_select=SELECT_PEAK_GB[rung[0]],
            measured_peak_gb=m["peak_bytes"] / 1e9,
            delta_pct=100 * delta,
            predicted_state_gb=(w["params_bytes"] + w["opt_state_bytes"])
            / 1e9,
            measured_resident_gb=m["resident_bytes"] / 1e9,
            predicted_fit=memplan.fits(w["peak_bytes"],
                                       dev["total_memory"]),
            step_ms=m["step_ms"], losses=m["losses"]))
        emit("torchcheck", part="plan_vs_allocator", card=card, **rows[-1])
    for r in rows:
        check(abs(r["delta_pct"]) <= 100 * PLAN_RTOL,
              f"{r['rung']}: predicted {r['predicted_peak_gb']:.3f} GB, "
              f"measured {r['measured_peak_gb']:.3f} GB "
              f"({r['delta_pct']:+.1f}% > {PLAN_RTOL:.0%})")
    # the same rows as the admission seam's drift gauge: the worst
    # |measured - predicted| / predicted, below the warn-only SLO's limit
    drift = record_declared_drift([
        {"priced_on_chip_peak_gb": r["predicted_peak_gb"],
         "native_on_chip_peak_gb": r["measured_peak_gb"]} for r in rows])
    # through the observer: the warn-only SLO reads the gauge's windowed
    # mean over three samples, a minute apart on its own clock
    limit, state = drift_slo_state()
    emit("torchcheck", part="declared_drift", card=card, ratio=drift,
         gauge=cp_metrics.DECLARED_HBM_DRIFT_RATIO.get(), limit=limit,
         slo_state=state)
    check(drift < limit, f"declared_hbm_drift_ratio {drift} >= {limit}")
    check(state == "ok", f"declared-hbm-drift is {state} at drift {drift}")

    # the rung the card must reject: its own process, which must end in
    # torch.cuda.OutOfMemoryError before it completes a step
    tcfg, packed = _rung_cfg(OOM_RUNG)
    w = memplan.walk_train_step(tcfg, OOM_RUNG[3], OOM_RUNG[4])
    gc.collect()
    torch.cuda.empty_cache()
    here = os.path.dirname(os.path.abspath(__file__))
    child = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke.oom_child())"],
        cwd=here, capture_output=True, text=True, timeout=600)
    lines = [ln for ln in child.stdout.splitlines() if ln.startswith("{")]
    result = json.loads(lines[-1]) if lines else None
    emit("torchcheck", part="oom_rung", card=card, rung=OOM_RUNG[0],
         batch=OOM_RUNG[3], grad_accum=OOM_RUNG[4],
         predicted_peak_gb=w["peak_bytes"] / 1e9,
         predicted_fit=memplan.fits(w["peak_bytes"], dev["total_memory"]),
         total_memory_gb=dev["total_memory"] / 1e9, child_rc=child.returncode,
         child=result, child_stderr=child.stderr[-800:] if result is None
         else None)
    check(not memplan.fits(w["peak_bytes"], dev["total_memory"]),
          "the planner predicts the 13B adamw rung fits")
    check(result is not None and result.get("oom") is True,
          f"the 13B adamw rung did not end in OutOfMemoryError: {result}")

    # the pricer with the card's budget
    decls = {
        "7B adafactor": {"preset": "llama2_7b", "optim": "adafactor",
                         "batch": 32, "grad_accum": 32, "remat": "full",
                         "seq": 2048},
        "7B adamw": {"preset": "llama2_7b", "optim": "adamw", "batch": 32,
                     "grad_accum": 32, "remat": "full", "seq": 2048},
    }
    verdicts = {}
    for label, raw in decls.items():
        decl = pricer.parse(raw)
        for chips in (1, 4):
            v = pricer.price(decl, chips=chips)
            verdicts[f"{label} x{chips}"] = {
                k: v[k] for k in ("verdict", "predicted_peak_gb",
                                  "predicted_peak_per_chip_gb",
                                  "budget_per_chip_gb", "binds",
                                  "breakdown_gb", "flops_per_step")}
    big = pricer.parse({"preset": "llama2_13b", "optim": "adamw",
                        "batch": 32, "grad_accum": 32, "remat": "full",
                        "seq": 2048})
    advice = {chips: dict(verdict=pricer.price(big, chips=chips)["verdict"],
                          advice=pricer.advise(big, chips=chips))
              for chips in (1, 4)}
    emit("torchcheck", part="pricer", card=card, card_gib=pricer.card_gib(),
         verdicts=verdicts, advise_13b_adamw=advice)

    # the probe and the sentinel on the 7B engine; a profiler trace of
    # one 7B LoRA step
    cfg = LlamaConfig.llama2_7b(param_dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    probes = probe_engine(params, cfg)
    emit("torchcheck", part="hostsync_and_sentinel", card=card, **probes)
    for arm in ("paged", "contiguous"):
        p = probes[arm]
        check(p["done"], f"{arm}: a request never ended")
        check(p["over_limit"] == [],
              f"{arm}: a signature limit broke: {p['over_limit']}")
        check(p["sentinel"]["engine.prefill"]["limit"]
              == ENGINE_SLOT_LEN.bit_length()
              and p["sentinel"]["engine.decode_step"]["limit"] == 1,
              f"{arm}: limits not declared: {p['sentinel']}")

    lp = add_lora(params, 16, generator=torch.Generator(device="cuda")
                  .manual_seed(2), targets=("wq", "wv"))
    tcfg = TrainConfig(model=cfg, optim=OptimConfig(train_only="lora"))
    state = init_train_state(tcfg, params=lp)
    step = make_train_step(tcfg, state)
    batch = to_device(packed_rows(2, 2048, cfg.vocab_size, seed=3), "cuda")
    step(state, batch)
    torch.cuda.synchronize()
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="kfrm_trace_") as logdir:
        with profiling.trace(logdir) as prof:
            with profiling.annotate("train.step"):
                step(state, batch)
        launches = read_launches()
        kernels = trace_kernel_ms(prof.trace_path)
        trace_bytes = os.path.getsize(prof.trace_path)
    emit("torchcheck", part="profiler", card=card, trace_bytes=trace_bytes,
         launches=launches,
         trace_kernels={k: dict(**v, smoke_ms=timing.get(k, {}).get("ms"))
                        for k, v in kernels.items()})
    for name, v in kernels.items():
        check(v["launches"] > 0, f"the trace names no {name} kernel")
    del state, step
    gc.collect()
    fit_launches = probe_training(cfg, lp, card)
    del lp, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, fit_launches


def probe_training(cfg, lp, card) -> dict:
    """Training under the host-sync probe, the signature sentinel and
    the control plane's probe bridges: 3 steps of ``fit`` on the 7B LoRA
    tree ``lp``, then one step of the 7B full-FT adafactor rung (where
    the factored update's scalar rounding sits). No witness may fall in
    ``train.step`` and ``implicit_hostsyncs_total{tenant="default"}``
    must not move; the CUDA runtime's count of the adafactor step's
    syncs is reported beside them. Returns the LoRA fit's launches."""
    import gc
    import warnings

    import torch

    from kubeflow_rm_tpu_torch.analysis.torchcheck import (
        hostsync, recompile,
    )
    from kubeflow_rm_tpu_torch.controlplane import metrics as cp_metrics
    from kubeflow_rm_tpu_torch.controlplane.obs import slo
    from kubeflow_rm_tpu_torch.training.data import to_device
    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.train import (
        TrainConfig, init_train_state, make_train_step,
    )

    syncs = cp_metrics.IMPLICIT_HOSTSYNCS_TOTAL
    recompiles = cp_metrics.JIT_RECOMPILES_TOTAL
    hostsync.set_enabled(True)
    recompile.set_enabled(True)
    hostsync.install()
    slo.install_probe_bridges()
    out = {}
    try:
        hostsync.reset()
        recompile.reset()
        before = syncs.get(tenant="default"), recompiles.get(tenant="default")
        tcfg = TrainConfig(model=cfg, optim=OptimConfig(
            train_only="lora", learning_rate=TRAIN_LR, warmup_steps=1))
        host = packed_rows(2, 2048, cfg.vocab_size, seed=3)
        reset_launches()
        _, history = fit(tcfg, iter([host] * 3),
                         LoopConfig(total_steps=3, log_every=1),
                         state=init_train_state(tcfg, params=lp))
        torch.cuda.synchronize()
        launches = read_launches()
        out["lora_fit"] = dict(
            steps=len(history), losses=[h.loss for h in history],
            step_ms=[h.step_time_ms for h in history], launches=launches,
            witnesses=len(hostsync.witnesses()))

        rung = PLAN_RUNGS[2]                  # 7B full-FT adafactor
        rcfg, packed = _rung_cfg(rung)
        gen = torch.Generator(device="cuda").manual_seed(0)
        state = init_train_state(rcfg, gen, device="cuda")
        step = make_train_step(rcfg, state, grad_accum=rung[4])
        batch = _rung_batch(rung, rcfg.model, packed)
        with hostsync.region("train.step"):
            state, metrics = step(state, batch)   # builds, warms up
        loss1 = float(metrics["loss"])
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with hostsync.region("train.step"):
                    state, metrics = step(state, batch)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        runtime = [w for w in caught
                   if "called a synchronizing" in str(w.message)]
        sites = {}
        for w in runtime:
            at = (f"{w.filename.split('kubeflow_rm_tpu_torch/')[-1]}:"
                  f"{w.lineno}")
            sites[at] = sites.get(at, 0) + 1
        out["adafactor_step"] = dict(
            rung=rung[0], losses=[loss1, float(metrics["loss"])],
            cuda_runtime_syncs=len(runtime), cuda_runtime_sites=sites)
        del state, step, batch, metrics
        wit = hostsync.witnesses()
        out["train_step_witnesses"] = [
            dict(region=w["region"], kind=w["kind"]) for w in wit
            if w["region"] == "train.step"]
        out["implicit_hostsyncs_total_default"] = (
            syncs.get(tenant="default") - before[0])
        out["jit_recompiles_total_default"] = (
            recompiles.get(tenant="default") - before[1])
        out["rate_limits_per_s"] = {
            s.metric: s.allowed_per_s for s in slo.default_slos()
            if isinstance(s, slo.TenantRateSLO)}
    finally:
        hostsync.uninstall()
        hostsync.set_enabled(False)
        recompile.set_enabled(False)
        hostsync.reset()
        recompile.reset()
        gc.collect()
        torch.cuda.empty_cache()
    emit("torchcheck", part="training_under_probes", card=card, **out)
    check(out["lora_fit"]["steps"] == 3
          and all(math.isfinite(h) for h in out["lora_fit"]["losses"]),
          f"the probed LoRA fit: {out['lora_fit']}")
    check(out["train_step_witnesses"] == [],
          f"implicit syncs in train.step: {out['train_step_witnesses']}")
    check(out["implicit_hostsyncs_total_default"] == 0,
          f"implicit_hostsyncs_total{{tenant=\"default\"}} moved by "
          f"{out['implicit_hostsyncs_total_default']}")
    # adafactor's step count is filled on the card: no upload per leaf
    optim_syncs = {k: v for k, v in
                   out["adafactor_step"]["cuda_runtime_sites"].items()
                   if "training/optim.py" in k}
    check(not optim_syncs,
          f"CUDA-runtime syncs in training/optim.py: {optim_syncs}")
    return launches


class RecorderAPI:
    """The two calls the admission seam makes on an API server: it runs
    the registered plugins on a create, as the server's admission chain
    does, and keeps the events."""

    def __init__(self):
        self.plugins, self.events = [], []

    def register_admission(self, kind: str, fn) -> None:
        self.plugins.append((kind, fn))

    def record_event(self, obj, etype, reason, message) -> None:
        self.events.append(dict(name=obj["metadata"]["name"], type=etype,
                                reason=reason, message=message))

    def create(self, obj: dict) -> dict:
        for kind, fn in self.plugins:
            if kind == obj["kind"]:
                obj = fn("CREATE", obj, None) or obj
        return obj


# PERF.md's declarations, priced through the admission seam on one- and
# four-card H100 Notebook CRs: (label, declaration, accelerator types)
SEAM_DECLARATIONS = (
    ("7B adafactor", {"preset": "llama2_7b", "optim": "adafactor",
                      "batch": 32, "grad_accum": 32, "remat": "full",
                      "seq": 2048}, ("h100-80gb-1", "h100-80gb-4")),
    ("7B adamw", {"preset": "llama2_7b", "optim": "adamw", "batch": 32,
                  "grad_accum": 32, "remat": "full", "seq": 2048},
     ("h100-80gb-1", "h100-80gb-4")),
    ("13B adamw", {"preset": "llama2_13b", "optim": "adamw", "batch": 32,
                   "grad_accum": 32, "remat": "full", "seq": 2048},
     ("h100-80gb-1",)),
)


def phase_seams(card, device: str = "cuda"):
    """The control plane's seams into the port, on the card's machine:
    the admission seam over a recorder API (the H100 slice table against
    this card's memory; every stamped verdict, advisor and annotation
    equal to the pricer's own answer), the lint gate
    (``python -m kubeflow_rm_tpu_torch.analysis.torchcheck``, exit 0),
    and the launcher (``WorkerAgent`` on a one-host webhook env:
    ``/healthz`` answers 200 once ``join_slice`` has formed a one-rank
    NCCL world). ``device="cpu"`` rehearses it without a card (gloo, and
    the table's own memory in place of the card's)."""
    import os
    import urllib.request

    import torch
    import torch.distributed as dist

    from kubeflow_rm_tpu_torch.analysis.torchcheck import pricer
    from kubeflow_rm_tpu_torch.analysis.torchcheck.__main__ import (
        TORCHCHECK_RULES,
    )
    from kubeflow_rm_tpu_torch.controlplane.api import gpu
    from kubeflow_rm_tpu_torch.controlplane.webhook.admission_pricer import (
        AdmissionPricer,
    )
    from kubeflow_rm_tpu_torch.launcher.agent import WorkerAgent

    # the admission seam
    topo = gpu.lookup("h100-80gb-1")
    card_gib = (torch.cuda.get_device_properties(0).total_memory / 2 ** 30
                if device == "cuda" else topo.hbm_gib_per_chip)
    table_err = abs(topo.hbm_gib_per_chip - card_gib) / card_gib
    api = RecorderAPI()
    AdmissionPricer(api).register()
    stamped, mismatches = {}, []
    for label, decl, types in SEAM_DECLARATIONS:
        for acc in types:
            name = f"{label.replace(' ', '-').lower()}-{acc}"
            obj = api.create({
                "apiVersion": "kubeflow.org/v1", "kind": "Notebook",
                "metadata": {"name": name, "namespace": "smoke",
                             "annotations": {
                                 gpu.DECLARED_WORKLOAD_ANNOTATION:
                                     json.dumps(decl)}},
                "spec": {"tpu": {"acceleratorType": acc}}})
            t = gpu.lookup(acc)
            parsed = pricer.parse(decl)
            want = pricer.price(parsed, chips=t.cards,
                                hbm_gib_per_chip=t.hbm_gib_per_chip)
            want["accelerator_type"] = acc
            if want["verdict"] == "rejected":
                want["advisor"] = pricer.advise(
                    parsed, chips=t.cards,
                    hbm_gib_per_chip=t.hbm_gib_per_chip)
            adm = obj.get("status", {}).get("admission")
            ann = obj["metadata"]["annotations"]
            if adm != want or ann.get(gpu.PREDICTED_HBM_ANNOTATION) != str(
                    want["predicted_peak_gb"]) or ann.get(
                    gpu.PREDICTED_FLOPS_ANNOTATION) != str(
                    want["flops_per_step"]):
                mismatches.append(name)
            stamped[f"{label} x{t.cards}"] = dict(
                verdict=adm and adm["verdict"],
                predicted_peak_gb=adm and adm["predicted_peak_gb"],
                predicted_peak_per_chip_gb=adm
                and adm["predicted_peak_per_chip_gb"],
                budget_per_chip_gb=adm and adm["budget_per_chip_gb"],
                binds=adm and adm["binds"],
                advisor=adm and adm.get("advisor"))
    emit("seams", part="admission", card=card,
         table_hbm_gib=topo.hbm_gib_per_chip, card_hbm_gib=card_gib,
         table_rel_err=table_err, verdicts=stamped,
         events=[(e["name"], e["reason"]) for e in api.events],
         mismatches=mismatches)
    check(table_err <= 0.01,
          f"h100-80gb-1 table memory {topo.hbm_gib_per_chip} GiB vs the "
          f"card's {card_gib} GiB")
    check(not mismatches, f"the seam's stamps differ from the pricer's "
                          f"answers: {mismatches}")

    # the lint gate, as the card's machine runs it
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    gate = subprocess.run(
        [sys.executable, "-m", "kubeflow_rm_tpu_torch.analysis.torchcheck",
         "--json"], cwd=here, capture_output=True, text=True, timeout=600)
    report = json.loads(gate.stdout) if gate.returncode in (0, 1) else None
    emit("seams", part="lint_gate", card=card, rc=gate.returncode,
         seconds=time.perf_counter() - t0, rules=sorted(TORCHCHECK_RULES),
         report=report,
         stderr=gate.stderr[-800:] if gate.returncode else None)
    check(TORCHCHECK_RULES == {f"KFRM00{i}" for i in range(1, 9)},
          f"the gate runs {sorted(TORCHCHECK_RULES)}, not KFRM001-008")
    check(gate.returncode == 0, f"the torchcheck gate exited "
                                f"{gate.returncode}: {report}")

    # the launcher: a one-host webhook env through the worker agent
    check(not dist.is_initialized(), "a process group is already open")
    agent = WorkerAgent({"TPU_WORKER_ID": "0",
                         "TPU_WORKER_HOSTNAMES": "localhost",
                         "TPU_ACCELERATOR_TYPE": "h100-80gb-1"},
                        cards_per_host=1, health_port=0,
                        master_port=free_port(), device=device)
    port = agent.start_health_server()
    try:
        t0 = time.perf_counter()
        agent.join_slice(retry_interval_s=1.0, max_attempts=3)
        join_s = time.perf_counter() - t0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=30) as r:
            status, body = r.status, json.loads(r.read())
        x = torch.ones(4, device=device)
        dist.all_reduce(x)
        world = dict(backend=dist.get_backend(), size=dist.get_world_size(),
                     rank=dist.get_rank(), all_reduce=x.sum().item())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        agent._httpd.shutdown()
        agent._httpd.server_close()
    emit("seams", part="launcher", card=card, healthz=status, body=body,
         join_s=join_s, world=world)
    check(status == 200 and body["ready"], f"/healthz: {status} {body}")
    check(world["backend"] == ("nccl" if device == "cuda" else "gloo")
          and world["size"] == 1
          and world["rank"] == 0 and world["all_reduce"] == 4.0,
          f"the agent's world: {world}")


# the controlplane phase: the Notebook's declared workload is the pod's
# fine-tune (``finetune``'s LoRA recipe: adamw on rank-16 adapters on
# wq/wv, remat "dots", B = 2 × 2048 in one microbatch), CP_STEPS steps
CP_DECLARATION = {"preset": "llama2_7b", "optim": "adamw", "batch": 2,
                  "grad_accum": 1, "remat": "dots", "seq": 2048,
                  "lora_rank": 16}
CP_STEPS = 3
# arm E's chaos plan: the seed of its shard_split fault
CP_SEED = 1234
# arm E's observer: its background tick (s), and the most autoscaler
# ticks the merge back to two shards may take (it needs ``sustain``)
CP_OBS_INTERVAL_S = 1.0
CP_AUTOSCALE_TICKS = 40
# the pod's measured peak against its predicted-memory annotation, either
# way: the bound the planner's anchors are held to (PLAN_RTOL)
CP_PEAK_RTOL = PLAN_RTOL
# the child's own time limit (7B init + 3 steps take well under a minute)
CP_CHILD_TIMEOUT_S = 600


def pod_workload() -> int:
    """The pod's container, run in a child process with the pod's env
    (``phase_controlplane``): the launcher turns the injected rendezvous
    env into torchrun's and joins the process group, then ``finetune``
    runs the declared workload. Prints one JSON line: the losses, the
    step times, the peak, the kernels' launches, the checkpoint's save
    and restore seconds and the world. With ``CP_CKPT_DIR`` it checkpoints
    there (and resumes from it), every ``CP_CKPT_EVERY`` steps; with
    ``CP_HOLD_STEP`` it prints the line (as ``pod_held``) from that
    step's callback and holds until it is killed."""
    import os

    import torch
    import torch.distributed as dist

    from kubeflow_rm_tpu_torch import finetune
    from kubeflow_rm_tpu_torch.launcher.torchrun import init_distributed
    from kubeflow_rm_tpu_torch.training import loop
    from kubeflow_rm_tpu_torch.training.checkpoint import Checkpointer

    decl = json.loads(os.environ["CP_DECLARATION"])
    device = os.environ.get("CP_DEVICE", "cuda")
    steps = int(os.environ["CP_STEPS"])
    # arm C: the pod's checkpoint directory, the save period and the step
    # whose callback holds the process (before that step's save)
    ckpt_dir = os.environ.get("CP_CKPT_DIR")
    ckpt_every = int(os.environ.get("CP_CKPT_EVERY", "0"))
    hold = int(os.environ.get("CP_HOLD_STEP", "0"))
    init_distributed(device=device,
                     **({} if device == "cuda" else {"cards_per_host": 1}))
    world = dict(backend=dist.get_backend(), size=dist.get_world_size(),
                 rank=dist.get_rank(),
                 master=os.environ["MASTER_ADDR"],
                 torchrun={k: os.environ[k] for k in (
                     "RANK", "LOCAL_RANK", "WORLD_SIZE", "MASTER_PORT")})
    history, seen = [], []
    fit = loop.fit
    on_card = device == "cuda"
    ckpt_s = {"save": [], "restore": []}
    for verb in ckpt_s:
        def timed(*a, _fn=getattr(Checkpointer, verb), _verb=verb, **k):
            t = time.perf_counter()
            out = _fn(*a, **k)
            ckpt_s[_verb].append(time.perf_counter() - t)
            return out
        setattr(Checkpointer, verb, timed)

    def report(key, rc, losses, records):
        print(json.dumps({key: dict(
            rc=rc, losses=losses,
            step_ms=[h.step_time_ms for h in records],
            steps=[h.step for h in records],
            wall_s=time.perf_counter() - t0,
            peak_gb=(torch.cuda.max_memory_allocated() / 1e9 if on_card
                     else None),
            launches=read_launches(), world=world, checkpoint_s=ckpt_s,
            poddefault=os.environ.get("KFRM_PODDEFAULT"))}), flush=True)

    def held(rec):
        seen.append(rec)
        if rec.step == hold:
            # idle between bursts: the step's loss is known, its save has
            # not run; only a SIGKILL ends this process now
            report("pod_held", None, [h.loss for h in seen], seen)
            threading.Event().wait()

    def recorded_fit(*args, **kwargs):
        if ckpt_every:
            args = (args[0], args[1],
                    replace(args[2], checkpoint_every=ckpt_every),
                    *args[3:])
        if hold:
            kwargs["callbacks"] = tuple(kwargs.get("callbacks", ())) + (
                held,)
        state, hist = fit(*args, **kwargs)
        history.extend(hist)
        return state, hist

    loop.fit = recorded_fit
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    rc = finetune.main(
        ["--preset", decl["preset"], "--lora-rank", str(decl["lora_rank"]),
         "--batch", str(decl["batch"]), "--seq-len", str(decl["seq"]),
         "--grad-accum", str(decl["grad_accum"]), "--steps", str(steps),
         "--no-sample"] + (["--device", device] if device != "cuda" else [])
        + (["--checkpoint-dir", ckpt_dir] if ckpt_dir else []))
    report("pod_workload", rc, [h.loss for h in history], history)
    return rc


# the controlplane phase's node (the card) and arm B's objects
# (``make_control_plane`` with JAX's defaults: the informer cache, every
# webhook and controller, the culler)
CP_NS, CP_ACC = "smoke", "h100-80gb-1"
CP_OWNER = "smoke@example.com"
CP_IMAGE = "jupyter-torch-cuda"
CP_IMAGE_REF = "registry.example.com/kubeflow/jupyter-torch-cuda:2026.10"
CP_POD_LABEL = {"kfrm-smoke": "poddefault"}
CP_CULL = {"cull_idle_minutes": 10, "check_period_minutes": 1}


class SettableClock:
    """The control plane's injected clock, moved by hand: the culler's
    idle time passes without the phase waiting for it."""

    def __init__(self):
        import datetime

        self.now = datetime.datetime(2026, 1, 1,
                                     tzinfo=datetime.timezone.utc)

    def __call__(self):
        return self.now

    def advance(self, **timedelta_kwargs) -> None:
        import datetime

        self.now = self.now + datetime.timedelta(**timedelta_kwargs)


class JupyterStandIn:
    """A standard-library HTTP server on 127.0.0.1 standing in for the
    pod's Jupyter server: ``/api/kernels`` answers ``kernels`` (set by
    the phase), ``/api/terminals`` none. The culler's ``default_probe``
    reaches it through ``base_url``; :meth:`close` stops it."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, HTTPServer

        stand_in = self
        self.kernels: list = []
        self.gets = 0

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                stand_in.gets += 1
                if self.path.endswith("/api/kernels"):
                    body = stand_in.kernels
                elif self.path.endswith("/api/terminals"):
                    body = []
                else:
                    self.send_error(404)
                    return
                data = json.dumps(body).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        self.server = HTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="jupyter-stand-in", daemon=True)
        self.thread.start()
        self.base_url = f"http://127.0.0.1:{self.server.server_address[1]}/api"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(30)


#: arm B's contributor (granted ``edit`` through KFAM) and a user with no
#: binding in the profile's namespace
CP_CONTRIBUTOR = "contrib@example.com"
CP_STRANGER = "stranger@example.com"
#: a readiness long-poll's own timeout and the most polls one wait takes
CP_POLL_TIMEOUT_S, CP_POLL_MAX = 30, 200


class HTTPUser:
    """A user of the platform's web apps at ``url`` over HTTP, as the
    mesh's auth proxy and the SPA present one: the ``kubeflow-userid``
    header and a CSRF cookie and header pair (``token``); each request's
    seconds are kept by name in ``seconds``."""

    def __init__(self, url: str):
        import secrets
        import urllib.request

        self.url = url
        self.token = secrets.token_urlsafe(16)
        # loopback only: no proxy from the environment
        self.opener = urllib.request.build_opener(
            urllib.request.ProxyHandler({}))
        self.seconds: dict[str, list] = {}

    def fetch(self, name, method, path, body=None, user=CP_OWNER):
        """``(status, headers, raw body)`` of one request as ``user``."""
        import urllib.error
        import urllib.request

        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.url + path, data=data,
                                     method=method)
        req.add_header("kubeflow-userid", ":" + user)
        req.add_header("Cookie", f"XSRF-TOKEN={self.token}")
        req.add_header("X-XSRF-TOKEN", self.token)
        if data is not None:
            req.add_header("Content-Type", "application/json")
        t0 = time.perf_counter()
        try:
            with self.opener.open(req, timeout=CP_POLL_TIMEOUT_S + 30) as r:
                status, headers, raw = r.status, r.headers, r.read()
        except urllib.error.HTTPError as e:
            status, headers, raw = e.code, e.headers, e.read()
        self.seconds.setdefault(name, []).append(time.perf_counter() - t0)
        return status, headers, raw

    def call(self, name, method, path, body=None, user=CP_OWNER):
        """``(status, JSON body)`` of one request as ``user``."""
        status, _, raw = self.fetch(name, method, path, body, user)
        return status, json.loads(raw)


class WebAppServer(HTTPUser):
    """The platform's notebook-facing web apps over ``api`` on 127.0.0.1:
    the jupyter app under ``/jupyter`` (where the SPA calls it) and KFAM
    at ``/kfam/``, served by a threaded ``wsgiref`` server (a thread a
    request, so a parked readiness long-poll holds no other request
    back), and called as :class:`HTTPUser`. :meth:`close` stops the
    server."""

    def __init__(self, api):
        import socketserver
        from wsgiref.simple_server import (
            WSGIRequestHandler, WSGIServer, make_server,
        )

        from kubeflow_rm_tpu_torch.controlplane.webapps import jupyter, kfam

        self.jupyter = jupyter.create_app(api, prefix="/jupyter")
        self.kfam = kfam.create_app(api)

        def dispatch(environ, start_response):
            app = (self.jupyter if environ.get("PATH_INFO", "").startswith(
                "/jupyter/") else self.kfam)
            return app(environ, start_response)

        class Server(socketserver.ThreadingMixIn, WSGIServer):
            daemon_threads = True

        class Quiet(WSGIRequestHandler):
            def log_message(self, *args):
                pass

        self.server = make_server("127.0.0.1", 0, dispatch,
                                  server_class=Server, handler_class=Quiet)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       name="web-apps", daemon=True)
        self.thread.start()
        super().__init__(f"http://127.0.0.1:{self.server.server_port}")

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(30)


class ReadinessPoll:
    """A client of the spawner's readiness long-poll on a thread: it
    passes back the last resourceVersion it saw and polls again until
    the answer says ``ready`` (at most :data:`CP_POLL_MAX` polls). After
    :meth:`join`: ``polls`` (each poll's status, changed, ready and
    phase), ``last`` (the ready answer's body) and ``error``."""

    def __init__(self, web, ns, name, known):
        self.web, self.known = web, known
        self.path = f"/jupyter/api/namespaces/{ns}/notebooks/{name}/readiness"
        self.polls, self.last, self.error = [], None, None
        self.thread = threading.Thread(target=self._run, name="readiness",
                                       daemon=True)
        self.thread.start()

    def _run(self):
        try:
            known = self.known
            for _ in range(CP_POLL_MAX):
                status, body = self.web.call(
                    "readiness", "GET", f"{self.path}?knownVersion={known}"
                    f"&timeoutSeconds={CP_POLL_TIMEOUT_S}")
                nb = body.get("notebook") or {}
                self.polls.append(dict(
                    status=status, changed=body.get("changed"),
                    ready=body.get("ready"),
                    phase=(nb.get("processed_status") or {}).get("phase")))
                if status != 200:
                    return
                known = nb["metadata"]["resourceVersion"]
                if body["ready"]:
                    self.last = body
                    return
        except Exception as e:  # noqa: BLE001 - reported by the gate
            self.error = f"{type(e).__name__}: {e}"

    def join(self, timeout: float) -> None:
        self.thread.join(timeout)


def _cp_check_node(device: str):
    """The node this card is: the table's memory equal to the card's,
    and as many cards on the machine as the slice type has."""
    import torch

    from kubeflow_rm_tpu_torch.controlplane.api import gpu

    topo = gpu.lookup(CP_ACC)
    card_gib = (torch.cuda.get_device_properties(0).total_memory / 2 ** 30
                if device == "cuda" else topo.hbm_gib_per_chip)
    cards_here = torch.cuda.device_count() if device == "cuda" else 1
    check(topo.hbm_gib_per_chip == card_gib,
          f"{CP_ACC}'s memory {topo.hbm_gib_per_chip} GiB is not the card's "
          f"{card_gib} GiB")
    check(topo.cards <= cards_here,
          f"{CP_ACC} has {topo.cards} cards, the machine {cards_here}")
    return topo, card_gib


def _cp_spawned(api, ns, name, topo):
    """The gates a spawned notebook of one card meets in both arms: the
    admission verdict and its annotations, one replica, the pod bound to
    ``gpu-0`` with one card, the accelerator selector and the injected
    env, the Notebook Ready. Returns (nb, pod, env)."""
    from kubeflow_rm_tpu_torch.controlplane.api import gpu
    from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api

    nb = api.get(nb_api.KIND, name, ns)
    sts = api.get("StatefulSet", name, ns)
    pods = [p for p in api.list("Pod", ns) if (p["metadata"].get(
        "labels") or {}).get(nb_api.NOTEBOOK_NAME_LABEL) == name]
    adm = (nb.get("status") or {}).get("admission") or {}
    check(adm.get("verdict") == "fit", f"admission: {adm}")
    ann = nb["metadata"].get("annotations") or {}
    check(ann.get(gpu.PREDICTED_HBM_ANNOTATION) == str(
        adm["predicted_peak_gb"]) and ann.get(
        gpu.PREDICTED_FLOPS_ANNOTATION) == str(adm["flops_per_step"]),
        f"the pricer's annotations: {ann}")
    check(sts["spec"]["replicas"] == 1, f"replicas {sts['spec']['replicas']}")
    check([p["metadata"]["name"] for p in pods] == [f"{name}-0"],
          f"pods {[p['metadata']['name'] for p in pods]}")
    pod = pods[0]
    c0 = pod["spec"]["containers"][0]
    env = {e["name"]: e["value"] for e in c0.get("env") or []}
    check(pod["spec"].get("nodeName") == "gpu-0"
          and c0["resources"]["limits"] == {gpu.NVIDIA_GPU_RESOURCE: "1"}
          and pod["spec"].get("nodeSelector") == {
              gpu.NODE_LABEL_ACCELERATOR: topo.gke_accelerator}
          and pod["status"]["phase"] == "Running",
          f"the pod's binding: {pod['spec'].get('nodeName')} "
          f"{c0['resources']} {pod['spec'].get('nodeSelector')}")
    check(env.get("TPU_WORKER_ID") == "0" and env.get(
        "TPU_WORKER_HOSTNAMES") ==
        f"{name}-0.{name}-workers.{ns}.svc.cluster.local",
        f"the injected env: {env}")
    check(nb["status"].get("readyReplicas") == 1, f"status {nb['status']}")
    return nb, pod, env


def _cp_raw_arm(topo, decl) -> dict:
    """Arm A: ``make_control_plane(cache=False)`` (the raw read path):
    spawn (price, bind, inject), stop, delete; no child process."""
    from kubeflow_rm_tpu_torch.controlplane import make_control_plane
    from kubeflow_rm_tpu_torch.controlplane import scheduler
    from kubeflow_rm_tpu_torch.controlplane.api import gpu
    from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
    from kubeflow_rm_tpu_torch.controlplane.controllers.statefulset import (
        make_gpu_node,
    )

    ns = "raw"
    api, mgr = make_control_plane(cache=False)
    check(mgr.api is api, "arm A's manager reads through a cache")
    api.ensure_namespace(ns)
    api.create(make_gpu_node("gpu-0", CP_ACC))
    t0 = time.perf_counter()
    api.create(nb_api.make_notebook(
        "ft", ns, accelerator_type=CP_ACC,
        annotations={gpu.DECLARED_WORKLOAD_ANNOTATION: json.dumps(decl)}))
    reconciles = mgr.run_until_idle()
    spawn_s = time.perf_counter() - t0
    _cp_spawned(api, ns, "ft", topo)
    sched = scheduler.cache_for(api)
    bound = sched.stats()["free_chips"]
    check(bound == 0.0, f"free cards after the bind: {bound}")
    nb = api.get(nb_api.KIND, "ft", ns)
    nb["metadata"]["annotations"][nb_api.STOP_ANNOTATION] = "smoke"
    api.update(nb)
    t0 = time.perf_counter()
    stop_reconciles = mgr.run_until_idle()
    stop_s = time.perf_counter() - t0
    stopped = dict(replicas=api.get("StatefulSet", "ft", ns)["spec"][
        "replicas"], pods=len(api.list("Pod", ns)),
        free_cards=sched.stats()["free_chips"])
    check(stopped == dict(replicas=0, pods=0, free_cards=1.0),
          f"arm A after the stop: {stopped}")
    api.delete(nb_api.KIND, "ft", ns)
    mgr.run_until_idle()
    left = {k: len(api.list(k, ns)) for k in (
        "StatefulSet", "Service", "VirtualService", "Pod")}
    check(not any(left.values()), f"arm A left after the delete: {left}")
    return dict(spawn_s=spawn_s, reconciles=reconciles, stop_s=stop_s,
                stop_reconciles=stop_reconciles, stopped=stopped,
                left_after_delete=left)


def _cp_child_env(env, decl, steps, device, extra=None, workload=None):
    """The pod's container's environment: the pod's own env
    (``MASTER_ADDR=127.0.0.1`` substituted: no cluster DNS here, and
    ``extra``'s entries; ``CUDA_VISIBLE_DEVICES`` the device plugin's
    allocation) and the workload's settings (``workload``: arm C's
    ``CP_CKPT_*``/``CP_HOLD_STEP``). Returns (env, the
    substitutions)."""
    import os

    child_env = dict(os.environ)
    child_env.update(env)
    substituted = {"MASTER_ADDR": "127.0.0.1", **(extra or {})}
    child_env.update(substituted)
    child_env.update(CP_DECLARATION=json.dumps(decl), CP_STEPS=str(steps),
                     CP_DEVICE=device, **(workload or {}))
    if device == "cuda":
        child_env["CUDA_VISIBLE_DEVICES"] = "0"
    print(f"controlplane: the pod's env {sorted(env)} with "
          f"{substituted} (no cluster DNS on this machine)", flush=True)
    return child_env, substituted


_POD_CMD = [sys.executable, "-c",
            "import sys, chip_smoke; sys.exit(chip_smoke.pod_workload())"]


def _here() -> str:
    import os

    return os.path.dirname(os.path.abspath(__file__))


def _cp_child(env, decl, steps, device, extra=None, workload=None):
    """The pod's container run to its end in a child process (see
    :func:`_cp_child_env`). Returns (result, seconds, the
    substitutions)."""
    child_env, substituted = _cp_child_env(env, decl, steps, device, extra,
                                           workload)
    t0 = time.perf_counter()
    child = subprocess.run(_POD_CMD, cwd=_here(), env=child_env,
                           capture_output=True, text=True,
                           timeout=CP_CHILD_TIMEOUT_S)
    child_s = time.perf_counter() - t0
    lines = [ln for ln in child.stdout.splitlines()
             if ln.startswith('{"pod_workload"')]
    result = json.loads(lines[-1])["pod_workload"] if lines else None
    if child.returncode or result is None:
        print(child.stdout[-4000:], child.stderr[-8000:], file=sys.stderr)
    check(child.returncode == 0 and result is not None,
          f"the pod's workload exited {child.returncode}")
    return result, child_s, substituted


class HeldChild:
    """The pod's container in a child process that holds at a step
    (``CP_HOLD_STEP``): :meth:`held` waits for its ``pod_held`` line,
    :meth:`kill` is the kubelet's SIGKILL. Its output goes to a reader
    thread (stdout) and a file (stderr), so no pipe fills."""

    def __init__(self, env, decl, steps, device, extra, workload):
        import tempfile

        child_env, self.substituted = _cp_child_env(env, decl, steps,
                                                    device, extra, workload)
        self.err = tempfile.TemporaryFile(mode="w+")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(_POD_CMD, cwd=_here(), env=child_env,
                                     stdout=subprocess.PIPE,
                                     stderr=self.err, text=True)
        self.lines: list[str] = []
        self.result = None
        self._held = threading.Event()
        self._reader = threading.Thread(target=self._read, daemon=True,
                                        name="held-child-stdout")
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append(line)
            if line.startswith('{"pod_held"'):
                self.result = json.loads(line)["pod_held"]
                self._held.set()
        self._held.set()           # the child ended (or was killed)

    def held(self) -> dict:
        """The child's report from its holding step, and the seconds it
        took to get there."""
        check(self._held.wait(CP_CHILD_TIMEOUT_S),
              "the pod's workload never reached its holding step")
        if self.result is None:
            self.err.seek(0)
            print("".join(self.lines)[-4000:], self.err.read()[-8000:],
                  file=sys.stderr)
        check(self.result is not None,
              f"the pod's workload exited {self.proc.poll()} before it "
              "held")
        return self.result, time.perf_counter() - self.t0

    def kill(self) -> int:
        """SIGKILL (no ``finally`` runs, so no save either); returns the
        exit code."""
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)
        rc = self.proc.wait(60)
        self._reader.join(60)
        self.err.close()
        return rc


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tree_bytes(path) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def _pod_launches(decl, steps, device) -> dict:
    """The kernels' launches of ``steps`` LoRA steps of ``decl`` (remat
    on: the forward twice a layer, each backward kernel once); none on
    the CPU."""
    from kubeflow_rm_tpu_torch.models.llama import LlamaConfig

    layers = getattr(LlamaConfig, decl["preset"])().n_layers
    n = steps if device == "cuda" else 0
    return {"flash_fwd": 2 * layers * n, "flash_bwd_dq": layers * n,
            "flash_bwd_dkv": layers * n}


def _cp_suspend_arm(topo, decl, steps, device, ref_losses) -> dict:
    """Arm C: JAX's defaults with the suspend/resume lifecycle on a
    ``CheckpointerStateStore`` over the pod's checkpoint directory. The
    low-priority ``ft`` checkpoints step ``steps - 1`` and holds in step
    ``steps``; the high-priority ``hp`` preempts it; the kubelet SIGKILLs
    its container; ``ft`` resumes once ``hp`` is suspended, and its new
    container runs step ``steps`` alone. ``ref_losses`` are arm B's
    (every step of an uninterrupted run)."""
    import os
    import shutil
    import tempfile

    from kubeflow_rm_tpu_torch.controlplane import make_control_plane
    from kubeflow_rm_tpu_torch.controlplane import metrics, scheduler
    from kubeflow_rm_tpu_torch.controlplane import suspend
    from kubeflow_rm_tpu_torch.controlplane.api import gpu
    from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
    from kubeflow_rm_tpu_torch.controlplane.api.profile import make_profile
    from kubeflow_rm_tpu_torch.controlplane.controllers.statefulset import (
        make_gpu_node,
    )
    from kubeflow_rm_tpu_torch.training.checkpoint import Checkpointer

    ns, durable = "resume", steps - 1
    ckpt_dir = tempfile.mkdtemp(prefix="kfrm-smoke-ckpt-")
    store = suspend.CheckpointerStateStore(
        lambda namespace, name: Checkpointer(ckpt_dir))
    steps_s, held = {}, None

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        mgr.run_until_idle()
        steps_s[name] = time.perf_counter() - t0
        return out

    def counters():
        rv = metrics.registry_value
        return dict(
            preempt=rv("notebook_preempt_total"),
            resume=rv("notebook_resume_total"),
            suspend_preempted=rv("notebook_suspend_total",
                                 {"reason": "preempted"}),
            **{f"{p}_n": rv("suspend_resume_phase_seconds_count",
                            {"phase": p})
               for p in ("drain", "rebind", "restore")},
            **{f"{p}_s": rv("suspend_resume_phase_seconds_sum",
                            {"phase": p})
               for p in ("drain", "rebind", "restore")})

    def notebook(name, priority):
        return nb_api.make_notebook(
            name, ns, accelerator_type=CP_ACC, priority_class=priority,
            annotations={gpu.DECLARED_WORKLOAD_ANNOTATION: json.dumps(decl)})

    def ann(name):
        return api.get(nb_api.KIND, name, ns)["metadata"].get(
            "annotations") or {}

    def peak_err(result, predicted):
        return (None if result["peak_gb"] is None
                else (result["peak_gb"] - predicted) / predicted)

    # the module's store serves the verbs (a preemption's suspend), the
    # controller's the resume; both the pod's checkpoints
    before = suspend.state_store()
    suspend.set_state_store(store)
    try:
        c0 = counters()
        api, mgr = make_control_plane(
            clock=SettableClock(), enable_suspend=True,
            suspend_config={"store": store, "check_period_minutes": 1.0})
        check([type(c).__name__ for c in mgr.controllers][-2:] == [
            "SuspendController", "ReplicaFailoverController"],
            "arm C's manager has no suspend controllers")
        check(suspend.oversubscribe(), "arm C runs with oversubscription off")
        api.create(make_gpu_node("gpu-0", CP_ACC))
        sched = scheduler.cache_for(api)
        # 1. a namespace whose quota admits two one-card notebooks
        step("profile", lambda: api.create(make_profile(
            ns, CP_OWNER, quota_hard={gpu.NVIDIA_GPU_RESOURCE: "2"})))
        step("spawn", lambda: api.create(notebook("ft", "low")))
        _, pod, env = _cp_spawned(api, ns, "ft", topo)
        predicted = float(pod["metadata"]["annotations"][
            gpu.PREDICTED_HBM_ANNOTATION])
        # 2. the pod's container saves step `durable`, holds in `steps`
        held = HeldChild(env, decl, steps, device,
                         {"MASTER_PORT": str(_free_port())},
                         {"CP_CKPT_DIR": ckpt_dir,
                          "CP_CKPT_EVERY": str(durable),
                          "CP_HOLD_STEP": str(steps)})
        first, first_s = held.held()
        check(first["steps"] == list(range(1, steps + 1))
              and first["losses"][:durable] == ref_losses[:durable],
              f"the first container's losses {first['losses']} vs arm "
              f"B's {ref_losses}")
        check(first["launches"] == _pod_launches(decl, steps, device),
              f"the first container's launches {first['launches']}")
        check(Checkpointer(ckpt_dir).all_steps() == [durable],
              f"checkpoints before the preemption: "
              f"{Checkpointer(ckpt_dir).all_steps()}")
        ckpt_bytes = _tree_bytes(os.path.join(ckpt_dir, str(durable)))
        # 3. the high-priority notebook preempts ft at its durable step
        step("preempt", lambda: api.create(notebook("hp", "high")))
        a = ann("ft")
        hp_pod = api.get("Pod", "hp-0", ns)
        preempted = dict(
            reason=a.get(nb_api.SUSPEND_REASON_ANNOTATION),
            token=json.loads(a.get(nb_api.SUSPEND_CHECKPOINT_ANNOTATION)
                             or "null"),
            drained=nb_api.SUSPEND_DRAINED_ANNOTATION in a,
            ft_pod=api.try_get("Pod", "ft-0", ns),
            hp_node=hp_pod["spec"].get("nodeName"),
            hp_limits=hp_pod["spec"]["containers"][0]["resources"][
                "limits"],
            hp_phase=hp_pod["status"].get("phase"))
        check(preempted == dict(
            reason="preempted", token={"step": durable}, drained=True,
            ft_pod=None, hp_node="gpu-0",
            hp_limits={gpu.NVIDIA_GPU_RESOURCE: "1"}, hp_phase="Running"),
            f"the preemption: {preempted}")
        # 4. the kubelet: ft's pod is gone, so its container is killed —
        # SIGKILL, or fit's finally would save step `steps`
        killed_rc = held.kill()
        check(killed_rc == -9, f"the held container exited {killed_rc}")
        check(Checkpointer(ckpt_dir).all_steps() == [durable],
              "the killed container saved a checkpoint")
        # 5. a resume while hp holds the card: ft stays parked
        step("resume_parked", lambda: suspend.request_resume(
            api, api.get(nb_api.KIND, "ft", ns)))
        parked = dict(
            ft_ready=api.get(nb_api.KIND, "ft", ns).get("status", {}).get(
                "readyReplicas"),
            ft_node=(api.try_get("Pod", "ft-0", ns) or {}).get(
                "spec", {}).get("nodeName"),
            hp_node=api.get("Pod", "hp-0", ns)["spec"].get("nodeName"))
        check(not parked["ft_ready"] and parked["ft_node"] is None
              and parked["hp_node"] == "gpu-0", f"while hp runs: {parked}")
        # 6. hp suspends: ft re-binds to the card with its step restored
        step("rebind", lambda: suspend.initiate_suspend(
            api, api.get(nb_api.KIND, "hp", ns), reason="api"))
        nb, pod, env = _cp_spawned(api, ns, "ft", topo)
        a = nb["metadata"].get("annotations") or {}
        reasons = [e["reason"] for e in api.events_for(nb)]
        check(a.get(nb_api.RESTORED_STEP_ANNOTATION) == str(durable)
              and "Resumed" in reasons
              and api.get(nb_api.KIND, "hp", ns)["status"]["phase"]
              == nb_api.SUSPENDED_PHASE
              and api.try_get("Pod", "hp-0", ns) is None,
              f"the resume: {a} {reasons}")
        predicted2 = float(pod["metadata"]["annotations"][
            gpu.PREDICTED_HBM_ANNOTATION])
        # 7. the new pod's container resumes at `durable`: one step
        resumed, resumed_s, _ = _cp_child(
            env, decl, steps, device, {"MASTER_PORT": str(_free_port())},
            {"CP_CKPT_DIR": ckpt_dir})
        check(resumed["steps"] == [steps]
              and resumed["losses"] == ref_losses[durable:],
              f"the resumed container's losses {resumed['losses']} at "
              f"steps {resumed['steps']} vs arm B's {ref_losses}")
        check(resumed["launches"] == _pod_launches(decl, 1, device),
              f"the resumed container's launches {resumed['launches']}")
        errs = [peak_err(first, predicted), peak_err(resumed, predicted2)]
        check(all(e is None or abs(e) <= CP_PEAK_RTOL for e in errs),
              f"the containers' peaks {first['peak_gb']} and "
              f"{resumed['peak_gb']} GB vs the predicted {predicted} GB")
        check(Checkpointer(ckpt_dir).all_steps() == [durable, steps],
              "the resumed container did not save its step")
        resumed_bytes = _tree_bytes(os.path.join(ckpt_dir, str(steps)))
        # 8. the counters
        c1 = counters()
        moved = {k: c1[k] - c0[k] for k in c0}
        check(moved["preempt"] == 1 and moved["resume"] == 1
              and moved["suspend_preempted"] == 1
              and all(moved[f"{p}_n"] >= 1
                      for p in ("drain", "rebind", "restore")),
              f"the lifecycle's counters moved {moved}")
        # 9. teardown
        def teardown():
            for name in ("ft", "hp"):
                api.delete(nb_api.KIND, name, ns)
            api.delete("Profile", ns)
        step("teardown", teardown)
        left = {k: len(api.list(k, ns)) for k in sorted(api._by_kind)
                if api.list(k, ns)}
        check(not left and api.try_get("Namespace", ns) is None
              and sched.stats()["free_chips"] == 1.0,
              f"arm C left after the teardown: {left}")
    finally:
        suspend.set_state_store(before)
        if held is not None:
            held.kill()
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    check(not os.path.exists(ckpt_dir), f"{ckpt_dir} was not removed")
    launches = {k: first["launches"][k] + resumed["launches"][k]
                for k in first["launches"]}
    return dict(steps_s=steps_s, preempted=preempted, parked=parked,
                restored_step=a.get(nb_api.RESTORED_STEP_ANNOTATION),
                counters=moved, checkpoint_bytes={
                    str(durable): ckpt_bytes, str(steps): resumed_bytes},
                checkpoint_save_s=first["checkpoint_s"]["save"]
                + resumed["checkpoint_s"]["save"],
                checkpoint_restore_s=resumed["checkpoint_s"]["restore"],
                first_child=dict(first, to_hold_s=first_s),
                resumed_child=dict(resumed, wall_s_parent=resumed_s),
                predicted_pod_gb=[predicted, predicted2], peak_rel_err=errs,
                killed_rc=killed_rc, launches=launches)


class CPShard:
    """One shard of arm D's cluster: ``APIServer(shard=, wal_dir=)`` with
    the cluster's admission (the Notebook and PodDefault validators; the
    notebook, PodDefault and card-injection webhooks) and its fake
    kubelet (the StatefulSet and Deployment controllers, serving on a
    thread), behind a ``RestServer`` on 127.0.0.1 that counts the
    requests it answers. :meth:`stop` stops the facade and the kubelet
    and closes the store; :meth:`start` then restarts the shard in
    place: a new apiserver recovers from the same WAL directory behind a
    facade on the same port."""

    def __init__(self, name: str, wal_dir: str):
        self.name, self.wal_dir = name, wal_dir
        # one entry a request: a list append is atomic, so the handler
        # threads take no lock
        self._answered: list = []
        self.up = False
        self.start(0)

    @property
    def requests(self) -> int:
        return len(self._answered)

    def start(self, port: int) -> None:
        from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
        from kubeflow_rm_tpu_torch.controlplane.api import (
            poddefault as pd_api,
        )
        from kubeflow_rm_tpu_torch.controlplane.apiserver import APIServer
        from kubeflow_rm_tpu_torch.controlplane.controllers import (
            statefulset,
        )
        from kubeflow_rm_tpu_torch.controlplane.deploy.restserver import (
            RestServer,
        )
        from kubeflow_rm_tpu_torch.controlplane.runtime import Manager
        from kubeflow_rm_tpu_torch.controlplane.webhook.gpu_inject import (
            GpuInjectWebhook,
        )
        from kubeflow_rm_tpu_torch.controlplane.webhook.notebook import (
            NotebookWebhook,
        )
        from kubeflow_rm_tpu_torch.controlplane.webhook.poddefault import (
            PodDefaultWebhook,
        )

        shard = self

        class CountingRestServer(RestServer):
            def _handle(self, handler):
                shard._answered.append(None)
                super()._handle(handler)

        self.api = APIServer(shard=self.name, wal_dir=self.wal_dir)
        self.api.register_validator(nb_api.KIND, nb_api.validate)
        self.api.register_validator(pd_api.KIND, pd_api.validate)
        NotebookWebhook(self.api).register()
        PodDefaultWebhook(self.api).register()
        GpuInjectWebhook(self.api).register()
        self.kubelet = Manager(self.api)
        self.kubelet.add(statefulset.StatefulSetController(auto_ready=True))
        self.kubelet.add(statefulset.DeploymentController(auto_ready=True))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self.kubelet.run_forever, name=f"kubelet-{self.name}",
            kwargs=dict(stop=self._stop, poll_interval_s=0.05), daemon=True)
        self._thread.start()
        self.rest = CountingRestServer(self.api, port=port)
        self.port = self.rest.start()
        self.url = self.rest.url
        self.up = True

    def stop(self) -> None:
        if not self.up:
            return
        self.up = False
        self.rest.stop()
        self._stop.set()
        self.kubelet._wake.set()
        self._thread.join(60)
        check(not self._thread.is_alive(), f"{self.name}'s kubelet lives")
        self.api.close_persistence()
        _stop_fanout(self.api)


def _stop_fanout(api) -> None:
    """Join every watch-fanout thread of ``api`` (each exits at once when
    its idle wait is set to zero and it is woken)."""
    for ch in list(getattr(api, "_channels", ())):
        ch.IDLE_EXIT_S = 0.0
        with ch._cond:
            thread = ch._thread
            ch._cond.notify_all()
        if thread is not None:
            thread.join(timeout=30)


def _poll(fn, timeout_s: float, what: str):
    """Bounded poll: ``fn()``'s first true value, or a failed check at
    the deadline."""
    deadline = time.monotonic() + timeout_s
    while True:
        out = fn()
        if out:
            return out
        check(time.monotonic() < deadline, f"timed out: {what}")
        time.sleep(0.02)


def _cp_deployed_arm(topo, decl, device, ref_loss, in_process_spawn_s):
    """Arm D: the deployed layout. The cluster is two shards
    (:class:`CPShard`); the platform runs outside it as the manifests'
    ``controller-manager`` does — ``make_cluster_manager`` over the shard
    router (``ShardedKubeAPIServer``), one watch per ``WATCHED_KINDS``,
    ``run_forever`` under a ``LeaderElector`` over the router. Every
    write and read goes through the router unless a gate says
    otherwise. The notebook ``ft`` spawns on the shard that owns its
    namespace; its pod's container runs one step of the fine-tune,
    whose loss must be ``ref_loss`` (arm B's step 1) bit for bit; the
    owning shard restarts in place from its WAL; the notebook is deleted
    and the profile torn down. ``in_process_spawn_s`` is arm B's spawn,
    printed beside this one's."""
    import base64
    import os
    import shutil
    import tempfile
    import urllib.request

    from kubeflow_rm_tpu_torch.controlplane import (
        WATCHED_KINDS, make_cluster_manager,
    )
    from kubeflow_rm_tpu_torch.controlplane.api import gpu
    from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
    from kubeflow_rm_tpu_torch.controlplane.api.conversion import (
        TPU_ACCELERATOR_ANNOTATION, convert_notebook,
    )
    from kubeflow_rm_tpu_torch.controlplane.api.profile import make_profile
    from kubeflow_rm_tpu_torch.controlplane.controllers.statefulset import (
        StatefulSetController, make_gpu_node,
    )
    from kubeflow_rm_tpu_torch.controlplane.deploy import kubeclient
    from kubeflow_rm_tpu_torch.controlplane.deploy.webhook_server import (
        WebhookServer, make_admission_handler,
    )
    from kubeflow_rm_tpu_torch.controlplane.ha import LeaderElector
    from kubeflow_rm_tpu_torch.controlplane.shard.ring import HashRing

    names = ("shard-0", "shard-1")
    ring = HashRing(list(names))
    lease_shard = ring.shard_for("kubeflow")
    # the arm's namespace on the other shard than the elector's lease, so
    # the restart below tests the router and not the election
    ns = next(f"deployed-{i}" for i in range(100)
              if ring.shard_for(f"deployed-{i}") != lease_shard)
    owner = ring.shard_for(ns)
    print(f"controlplane: arm D's namespace {ns} on {owner}, the lease's "
          f"namespace kubeflow on {lease_shard}", flush=True)
    wal_root = tempfile.mkdtemp(prefix="kfrm-smoke-wal-")
    shards, threads, webhook = {}, [], None
    watch_stop, mgr_stop = threading.Event(), threading.Event()
    steps_s = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        steps_s[name] = time.perf_counter() - t0
        return out

    def live(kind, name, namespace=None):
        """A read past the router's store: the owning shard's client."""
        client = router._clients[router.shard_of(kind, name, namespace)]
        return client.get(kind, name, namespace)

    try:
        for name in names:
            shards[name] = CPShard(name, f"{wal_root}/{name}")
        # the node registers with its own cluster: the shard that will
        # schedule the notebook's pod (Nodes are not broadcast)
        shards[owner].api.create(make_gpu_node("gpu-0", CP_ACC))
        router = kubeclient.ShardedKubeAPIServer(
            {n: s.url for n, s in shards.items()})
        mgr = make_cluster_manager(router, enable_culling=False)
        for kind in WATCHED_KINDS:
            threads.append(threading.Thread(
                target=router.watch_kind, name=f"watch-{kind}",
                args=(kind, None, watch_stop, 60), daemon=True))
            threads[-1].start()
        check(router.wait_for_sync(WATCHED_KINDS, timeout=120),
              "the router's informers never synced")
        elector = LeaderElector(router, "smoke-manager",
                                retry_period_s=0.5)
        threads.append(threading.Thread(
            target=mgr.run_forever, name="controller-manager", kwargs=dict(
                stop=mgr_stop, elector=elector, poll_interval_s=0.05),
            daemon=True))
        threads[-1].start()
        _poll(lambda: elector.is_leader, 60, "the manager's election")

        # 1. the profile with a one-card quota, then the notebook
        timed("profile", lambda: (router.create(make_profile(
            ns, CP_OWNER, quota_hard={gpu.NVIDIA_GPU_RESOURCE: "1"})),
            _poll(lambda: router.try_get("ResourceQuota",
                                         "kf-resource-quota", ns),
                  60, "the profile's quota")))
        t0 = time.perf_counter()
        router.create(nb_api.make_notebook(
            "ft", ns, accelerator_type=CP_ACC,
            annotations={gpu.DECLARED_WORKLOAD_ANNOTATION: json.dumps(decl)}))
        _poll(lambda: (router.get(nb_api.KIND, "ft", ns).get("status")
                       or {}).get("readyReplicas") == 1, 120,
              "ft never went Ready over the wire")
        steps_s["spawn"] = time.perf_counter() - t0
        placed = {}
        for kind, name in ((nb_api.KIND, "ft"), ("StatefulSet", "ft"),
                           ("Pod", "ft-0"), ("Service", "ft"),
                           ("ResourceQuota", "kf-resource-quota")):
            placed[f"{kind}/{name}"] = sorted(
                n for n, s in shards.items()
                if s.api.try_get(kind, name, ns) is not None)
        placed["Profile"] = sorted(n for n, s in shards.items()
                                   if s.api.try_get("Profile", ns))
        check(all(v == [owner] for v in placed.values()),
              f"the notebook's objects by shard: {placed} (owner {owner})")
        sts = live("StatefulSet", "ft", ns)
        check(sts["spec"]["replicas"] == 1, f"replicas {sts['spec']}")

        # 2. the notebook as v1beta1 through the facade, and back
        sess = router._clients[owner]._session
        base = f"{shards[owner].url}/apis/kubeflow.org"
        beta = sess.get(f"{base}/v1beta1/namespaces/{ns}/notebooks/ft").json()
        v1 = sess.get(f"{base}/v1/namespaces/{ns}/notebooks/ft").json()
        check(beta["apiVersion"] == "kubeflow.org/v1beta1"
              and "tpu" not in beta["spec"]
              and beta["metadata"]["annotations"].get(
                  TPU_ACCELERATOR_ANNOTATION) == CP_ACC
              and convert_notebook(beta, "v1") == v1,
              f"the v1beta1 read: {beta['metadata'].get('annotations')}")

        # 3. the pod over REST
        pod = live("Pod", "ft-0", ns)
        c0 = pod["spec"]["containers"][0]
        env = {e["name"]: e.get("value") for e in c0.get("env") or []}
        check(pod["spec"].get("nodeName") == "gpu-0"
              and c0["resources"]["limits"].get(gpu.NVIDIA_GPU_RESOURCE)
              == "1" and env.get("TPU_WORKER_ID") == "0"
              and env.get("TPU_WORKER_HOSTNAMES")
              == f"ft-0.ft-workers.{ns}.svc.cluster.local",
              f"the pod over REST: {pod['spec'].get('nodeName')} "
              f"{c0['resources']} {env}")

        # 4. the webhook server: the raw pod (the StatefulSet's template
        # as the kubelet submits it) in, a JSONPatch out
        webhook = WebhookServer(make_admission_handler(router), port=0)
        hook_port = webhook.start()
        raw = StatefulSetController()._render_pod(sts, 0)
        t0 = time.perf_counter()
        req = urllib.request.Request(
            f"http://127.0.0.1:{hook_port}/mutate-pod",
            data=json.dumps({"apiVersion": "admission.k8s.io/v1",
                             "kind": "AdmissionReview", "request": {
                                 "uid": "smoke", "operation": "CREATE",
                                 "object": raw}}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            review = json.loads(resp.read())["response"]
        steps_s["webhook_review"] = time.perf_counter() - t0
        ops = json.loads(base64.b64decode(review["patch"]))
        patched = _apply_json_patch(raw, ops)
        p0 = patched["spec"]["containers"][0]
        check(review["allowed"] and review["uid"] == "smoke"
              and p0.get("env") == c0.get("env")
              and p0.get("resources") == c0.get("resources"),
              f"the webhook's patch: {p0.get('env')} {p0.get('resources')} "
              f"vs the stored {c0.get('env')} {c0.get('resources')}")

        # 5. the pod's container: one step, arm B's step-1 loss
        result, child_s, substituted = _cp_child(
            env, decl, 1, device, {"MASTER_PORT": str(_free_port())})
        check(result["losses"] == [ref_loss],
              f"arm D's step-1 loss {result['losses']} vs arm B's "
              f"{ref_loss}")
        check(result["launches"] == _pod_launches(decl, 1, device),
              f"arm D's launches {result['launches']}")

        # 6. the owning shard restarts in place from its WAL
        before = {k: live(k, n, ns)["metadata"] for k, n in (
            (nb_api.KIND, "ft"), ("StatefulSet", "ft"), ("Pod", "ft-0"))}
        relists, merge = [], router._merge_shard_list

        def counted(shard, kind, items):
            relists.append((shard, kind))
            merge(shard, kind, items)
        router._merge_shard_list = counted
        failed = threading.Event()
        transient = kubeclient._is_transient

        def spy(e):
            failed.set()
            return transient(e)
        kubeclient._is_transient = spy
        read = {}
        try:
            t0 = time.perf_counter()
            shards[owner].stop()
            # a read through the router while the shard is down: it
            # retries until the shard serves again
            reader = threading.Thread(target=lambda: read.update(
                logs=router.pod_logs(ns, "ft-0")), daemon=True)
            reader.start()
            check(failed.wait(60), "the router never met the outage")
            shards[owner].start(shards[owner].port)
            reader.join(60)
            restart_s = time.perf_counter() - t0
        finally:
            kubeclient._is_transient = transient
        check("logs" in read, "the router's read did not get through")
        after = {k: shards[owner].api.get(k, n, ns)["metadata"]
                 for k, n in ((nb_api.KIND, "ft"), ("StatefulSet", "ft"),
                              ("Pod", "ft-0"))}
        same = {k: (after[k]["uid"], after[k]["resourceVersion"])
                == (before[k]["uid"], before[k]["resourceVersion"])
                for k in before}
        check(all(same.values()), f"after the restart: {before} {after}")
        _poll(lambda: {k for s, k in relists if s == owner}
              >= set(WATCHED_KINDS), 120,
              f"the manager's watches relist {owner}")
        api1 = shards[owner].api

        def quiet():
            n = len(api1.write_log)
            time.sleep(1.0)
            return len(api1.write_log) == n
        _poll(quiet, 60, "the manager settles after the relist")
        pods = [p["metadata"]["uid"] for p in api1.list("Pod", ns)]
        created = [w for w in api1.write_log
                   if w["verb"] == "create" and w["kind"] == "Pod"]
        check(pods == [before["Pod"]["uid"]] and not created,
              f"pods after the restart: {pods}, created {created}")
        router._merge_shard_list = merge

        # 7. delete the notebook through the router; tear the profile down
        t0 = time.perf_counter()
        router.delete(nb_api.KIND, "ft", ns)
        _poll(lambda: not any(api1.list(k, ns) for k in (
            "StatefulSet", "Pod", "Service")), 120,
            "ft's children were not collected")
        steps_s["delete"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        router.delete("Profile", ns)
        _poll(lambda: api1.try_get("Namespace", ns) is None, 120,
              "the profile's namespace was not removed")
        steps_s["teardown"] = time.perf_counter() - t0
        left = {k: len(s.api.list(k, ns)) for s in shards.values()
                for k in sorted(s.api._by_kind) if s.api.list(k, ns)}
        check(not left, f"arm D left after the teardown: {left}")
        requests = {n: s.requests for n, s in shards.items()}
    finally:
        mgr_stop.set()
        watch_stop.set()
        if webhook is not None:
            webhook.stop()
        for s in shards.values():
            s.stop()
        for t in threads:
            t.join(60)
        shutil.rmtree(wal_root, ignore_errors=True)
    lives = [t.name for t in threads if t.is_alive()]
    check(not lives, f"arm D's threads still running: {lives}")
    check(not os.path.exists(wal_root), f"{wal_root} was not removed")
    return dict(namespace=ns, owner=owner, lease_shard=lease_shard,
                steps_s=steps_s, spawn_s=steps_s["spawn"],
                in_process_spawn_s=in_process_spawn_s, placed=placed,
                pod_env=env, substituted=substituted,
                rest_requests=requests, restart_s=restart_s,
                recovered=same, relisted=sorted({k for s, k in relists}),
                child=result, child_s=child_s, launches=result["launches"])


def _cuda_holders(pids) -> dict:
    """Which of ``pids`` hold a CUDA context. ``nvidia-smi
    --query-compute-apps=pid`` names the processes with a context on the
    card; where it cannot see this process (a pid namespace of its own),
    a process's open ``/dev/nvidia<N>`` (the per-card node a context
    opens) stands in. Either way this process, which holds one, is the
    positive control. Returns the method, the control and the holders."""
    import os

    me = os.getpid()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
        listed = {int(x) for x in out.split() if x.strip().isdigit()}
    except (OSError, subprocess.SubprocessError):
        listed = set()
    if me in listed:
        return dict(method="nvidia-smi", control=True,
                    holders=sorted(p for p in pids if p in listed))

    def opens_card(pid) -> bool:
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except OSError:
            return False
        for fd in fds:
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if re.fullmatch(r"/dev/nvidia\d+", target):
                return True
        return False

    return dict(method="/proc/<pid>/fd", control=opens_card(me),
                holders=sorted(p for p in pids if opens_card(p)))


def _check_bundle(recorder, bundle, shard, survivors, out_dir) -> dict:
    """Gate a shard's ``shard_death`` flight bundle: every section of
    JAX's (``tests/test_flight.py``), the surviving shards' instances in
    its metric window, every slow trace's critical path summing to the
    trace's duration within 1 ms, and the ``recorder``'s ``dump_json``
    reading back equal. Returns what it counted."""
    import os

    from kubeflow_rm_tpu_torch.controlplane.obs import flight

    check(bundle["schema_version"] == flight.SCHEMA_VERSION
          and bundle["trigger"]["reason"] == "shard_death"
          and bundle["trigger"]["detail"] == {"shard": shard,
                                              "exitcode": -9}
          and bundle["run_meta"]["harness"]
          and isinstance(bundle["alerts"]["active"], list)
          and isinstance(bundle["slow_traces"], list)
          and "lockgraph" in bundle
          and isinstance(bundle["shard_liveness"], dict),
          f"{shard}'s bundle: {sorted(bundle)} {bundle['trigger']}")
    held = {s["labels"].get("instance") for s in bundle["metrics"]
            if s["points"]}
    check(survivors <= held,
          f"{shard}'s bundle holds {sorted(held - {None})}, not "
          f"{sorted(survivors)}")
    sums = []
    for t in bundle["slow_traces"]:
        total = sum(h["self_ms"] for h in t["critical_path"])
        sums.append([t["duration_ms"], round(total, 3)])
        check(abs(total - t["duration_ms"]) <= 1.0,
              f"slow trace {t['trace_id']}: critical path {total} ms vs "
              f"{t['duration_ms']} ms")
    path = recorder.dump_json(os.path.join(out_dir, f"FLIGHT_{shard}.json"),
                              bundle)
    with open(path) as f:
        check(json.load(f) == json.loads(json.dumps(bundle, default=str)),
              f"{shard}'s bundle does not read back equal")
    os.remove(path)
    return dict(slow_traces=len(bundle["slow_traces"]),
                processes=sorted({p for t in bundle["slow_traces"]
                                  for p in t["processes"]}),
                series=len(bundle["metrics"]), duration_vs_path_ms=sums,
                instances=sorted(held - {None}))


def _cp_elastic_arm(decl, device, ref_loss, predicted) -> dict:
    """Arm E: the cluster as processes. ``ShardRunner(2)`` spawns two
    shard workers (``shard/worker.py``: each the apiserver on its WAL,
    the cluster's admission, the fake kubelet, the REST facade on a
    fixed port and the platform's manager under the shard's own lease),
    supervised by a watchdog that respawns a dead one in place. Through
    ``ShardedKubeAPIServer`` (a watch on Notebook, StatefulSet and Pod):
    a node and a Profile of one card on the shard that owns the
    notebook's namespace, which neither the split nor the merge moves,
    filler load in 12 other namespaces, and the notebook ``ft``
    declaring the workload. An ``ElasticShardManager`` split under the
    ``shard_split`` chaos arm admits ``shard-2`` as a fresh process; a
    donor is SIGKILLed between COPY and TAIL and respawned by the
    watchdog; a writer thread creates pods in moving namespaces
    throughout; after the flip every object reads back through the
    router and lives on its ring owner only. The owner is then
    SIGKILLed and respawned from its WAL at the same port: the same uids
    and resourceVersions, no second pod, one death counted. The pod's
    container runs one step (arm B's step-1 loss bit for bit, 64/32/32,
    the peak within ``CP_PEAK_RTOL`` of ``predicted``: the shards'
    admission chain is JAX's worker's, without the pricer, so the pod
    carries no prediction of its own and arm B's of the same
    declaration stands in), and its measured peak against that
    prediction goes through ``record_declared_drift``. A
    ``ShardAutoscaler`` ticked once the writer and the step are done
    merges back to two shards on the federated queue depth, retiring
    ``shard-2`` (no death counted), with the audit holding again; the
    teardown leaves nothing, no shard process made a CUDA context, and
    none outlives ``stop()``.

    An ``obs.Observer`` watches it all, ticking in the background: it
    federates every shard's ``/metrics`` (the split adds ``shard-2``'s
    scrape, the merge removes it), runs JAX's default SLOs, and its
    flight recorder takes the chaos plan's trigger and the supervisor's
    death hook. The workers and this process trace (this process's
    steps are the roots; the shards' server spans their children). Each
    death counted is a ``shard_death`` bundle or one suppression of the
    recorder's rate limit; the owner's bundle (the arm waits out the
    limit before the kill) has every section, the surviving shards'
    series and slow traces whose critical paths sum to their durations;
    ``declared-hbm-drift`` stays ok, and no SLO but ``shard-deaths`` is
    critical at the end."""
    import os
    import shutil
    import tempfile
    import urllib.request

    from kubeflow_rm_tpu_torch.controlplane import (
        chaos, metrics, obs, tracing,
    )
    from kubeflow_rm_tpu_torch.controlplane.api import gpu
    from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
    from kubeflow_rm_tpu_torch.controlplane.api.profile import make_profile
    from kubeflow_rm_tpu_torch.controlplane.controllers.statefulset import (
        make_gpu_node,
    )
    from kubeflow_rm_tpu_torch.controlplane.deploy import kubeclient
    from kubeflow_rm_tpu_torch.controlplane.shard.elastic import (
        ElasticShardManager, ShardAutoscaler,
    )
    from kubeflow_rm_tpu_torch.controlplane.shard.ring import HashRing
    from kubeflow_rm_tpu_torch.controlplane.shard.runner import ShardRunner
    from kubeflow_rm_tpu_torch.controlplane.webhook.admission_pricer import (
        record_declared_drift,
    )

    two = HashRing(["shard-0", "shard-1"])
    three = two.with_member("shard-2")

    def still(key):
        return two.shard_for(key) == three.shard_for(key)

    # the notebook's namespace and node on one shard that neither the
    # split nor the merge moves (gang scheduling sees its shard's nodes)
    ns = next(f"elastic-{i}" for i in range(200) if still(f"elastic-{i}"))
    owner = two.shard_for(ns)
    node = next(f"gpu-e{i}" for i in range(200)
                if still(f"gpu-e{i}") and two.shard_for(f"gpu-e{i}") == owner)
    fill = [f"fill-{i}" for i in range(12)]
    moving = [f for f in fill if not still(f)]
    check(moving, f"no filler namespace moves in the split: {fill}")
    print(f"controlplane: arm E's namespace {ns} and node {node} on "
          f"{owner}; filler moving to shard-2: {moving}", flush=True)
    base = tempfile.mkdtemp(prefix="kfrm-smoke-shards-")
    runner = ShardRunner(2, base_dir=base, wal=True, manager_workers=4,
                         tracing=True)
    observer = None
    traced = (tracing.enabled(), tracing.process_name())
    seen: set[int] = set()
    watch_stop, threads, steps_s = threading.Event(), [], {}
    keys = ((nb_api.KIND, "ft"), ("StatefulSet", "ft"), ("Pod", "ft-0"))

    def client(shard):
        return kubeclient.KubeAPIServer(runner.urls[shard],
                                        cache_reads=False)

    def audit(objects) -> int:
        """Every (namespace, pod) reads back through the router and lives
        on its ring owner only, each shard read through its own client.
        Returns the count checked."""
        clients = {s: client(s) for s in runner.names}
        for pns, name in objects:
            check(router.get("Pod", name, pns) is not None,
                  f"{pns}/{name} lost through the router")
            own = router.shard_of("Pod", None, pns)
            where = sorted(s for s, c in clients.items()
                           if c.try_get("Pod", name, pns) is not None)
            check(where == [own], f"{pns}/{name} on {where}, owner {own}")
        return len(objects)

    def lease_holder(shard):
        lease = client(shard).try_get(
            "Lease", f"controlplane-manager-{shard}", "kubeflow") or {}
        return (lease.get("spec") or {}).get("holderIdentity")

    def shard_metrics() -> dict:
        out = {}
        for shard, url in runner.urls.items():
            with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
                text = r.read().decode()
            out[shard] = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
                          for ln in text.splitlines()
                          if ln.startswith("shard_")}
        return out

    def supervisor_metrics() -> dict:
        fams = ("shard_deaths_total", "shard_splits_total",
                "shard_merges_total", "shard_handoff_seconds_count",
                "shard_handoff_objects_total", "shard_handoff_replay_lag",
                "shard_autoscale_decisions_total")
        return {name: metrics.registry_value(name) for name in fams}

    def step(name):
        """A root span of this process around one of the arm's steps: the
        shards' server spans of its requests are its children."""
        return tracing.start_span(f"arm_e.{name}", kind="internal")

    def last_t(shard) -> float:
        pts = [p[0] for s in observer.tsdb.range(
            "workqueue_depth", {"instance": shard}, window_s=3600.0)
            for p in s["points"]]
        return max(pts, default=0.0)

    try:
        # 1. start: two traced workers, every one answering /healthz; the
        # observer federating both, ticking in the background
        tracing.set_enabled(True)
        tracing.set_process("coordinator")
        tracing.collector().clear()
        t0 = time.perf_counter()
        runner.start(timeout=120)
        steps_s["start"] = time.perf_counter() - t0
        seen |= set(runner.pids().values())
        print(f"controlplane: arm E's shards up in {steps_s['start']:.3f} s "
              f"(pids {runner.pids()})", flush=True)
        observer = obs.Observer(
            interval_s=CP_OBS_INTERVAL_S, shard_urls=runner.urls,
            liveness=runner.liveness,
            run_meta=obs.build_run_meta("chip_smoke.controlplane.arm_e", {
                "shards": 2, "wal": True, "tracing": True,
                "chaos": "shard_split", "device": device}))
        runner.set_on_death(observer.on_shard_death)
        deaths_all = metrics.registry_value("shard_deaths_total")
        observer.start()
        router = kubeclient.ShardedKubeAPIServer(runner.urls,
                                                 retry_window_s=20)
        watched = ("Notebook", "StatefulSet", "Pod")
        for kind in watched:
            threads.append(threading.Thread(
                target=router.watch_kind, name=f"arm-e-watch-{kind}",
                args=(kind, None, watch_stop, 60), daemon=True))
            threads[-1].start()
        check(router.wait_for_sync(watched, timeout=60),
              "arm E's router never synced")

        # 2. the node, the profile of one card and the filler load
        router.create(make_gpu_node(node, CP_ACC))
        t0 = time.perf_counter()
        with step("profile"):
            router.create(make_profile(
                ns, CP_OWNER, quota_hard={gpu.NVIDIA_GPU_RESOURCE: "1"}))
            owner_cli = client(owner)
            _poll(lambda: owner_cli.try_get("ResourceQuota",
                                            "kf-resource-quota", ns),
                  60, "arm E's profile quota")
        steps_s["profile"] = time.perf_counter() - t0
        objects = []
        for f in fill:
            router.ensure_namespace(f)
            for j in range(3):
                router.create(_cp_pod(f"p-{j}", f))
                objects.append((f, f"p-{j}"))

        # 3. the notebook, create -> Ready
        t0 = time.perf_counter()
        with step("spawn"):
            router.create(nb_api.make_notebook(
                "ft", ns, accelerator_type=CP_ACC,
                annotations={gpu.DECLARED_WORKLOAD_ANNOTATION:
                             json.dumps(decl)}))
            _poll(lambda: (owner_cli.get(nb_api.KIND, "ft", ns).get(
                "status") or {}).get("readyReplicas") == 1, 120,
                "arm E's ft never went Ready")
        steps_s["spawn"] = time.perf_counter() - t0
        pod0 = owner_cli.get("Pod", "ft-0", ns)
        check(pod0["spec"].get("nodeName") == node,
              f"ft-0 on {pod0['spec'].get('nodeName')}, not {node}")

        # 4. the split under the shard_split chaos arm (its injection a
        # flight trigger), a writer running
        elastic = ElasticShardManager(runner, router, observer=observer)
        kill, killed = runner.kill, {}

        def timed_kill(name):
            killed.update(name=name, t=time.perf_counter(),
                          pid=runner.pids()[name])
            return kill(name)
        runner.kill = timed_kill
        written, wstop = [], threading.Event()
        werr = []

        def writer():
            i = 0
            try:
                while not wstop.is_set():
                    wns = moving[i % len(moving)]
                    router.create(_cp_pod(f"w-{i}", wns))
                    written.append((wns, f"w-{i}"))
                    i += 1
                    time.sleep(0.01)
            except Exception as e:  # noqa: BLE001 - a gate below
                werr.append(repr(e))
        wt = threading.Thread(target=writer, name="arm-e-writer",
                              daemon=True)
        plan = chaos.plan_from_args(CP_SEED, "shard_split:1.0",
                                    flight=observer.flight)
        chaos.install(plan)
        try:
            wt.start()
            _poll(lambda: len(written) >= 5, 60, "the writer's first pods")
            t0 = time.perf_counter()
            with step("split"):
                new = elastic.split()
            steps_s["split"] = time.perf_counter() - t0
        finally:
            chaos.uninstall()
            runner.kill = kill
            wstop.set()
            wt.join(60)
        check(not werr and not wt.is_alive(), f"the writer: {werr}")
        check(new == "shard-2" and plan.counts.get("shard_split") == 1
              and killed, f"the split: {new} {plan.counts} {killed}")
        seen |= set(runner.pids().values())
        victim = killed["name"]
        _poll(lambda: runner.pids()[victim] != killed["pid"], 30,
              "the chaos victim's respawn")
        runner.wait_ready(60, names=[victim])
        chaos_respawn_s = time.perf_counter() - killed["t"]
        seen |= set(runner.pids().values())
        split = {k: v for k, v in elastic.events[-1].items() if k != "t"}
        check(router.shard_of("Pod", None, ns) == owner
              and router.shard_of("Node", node, None) == owner,
              "the split moved the notebook or its node")
        check(any(router.shard_of("Pod", None, f) == "shard-2"
                  for f, _ in objects), "no filler load moved")
        objects += written
        audited_split = audit(objects)
        print(f"controlplane: arm E's split {steps_s['split']:.3f} s, "
              f"{split['objects_bulk']} objects copied and "
              f"{split['objects_tail']} replayed in "
              f"{split['tail_passes']} tail passes, the writer's "
              f"{len(written)} pods; chaos killed {victim}, back in "
              f"{chaos_respawn_s:.3f} s", flush=True)
        smi_split = (_cuda_holders(seen) if device == "cuda" else None)
        # the split's new shard federated beside the first two
        t0 = time.perf_counter()
        _poll(lambda: {"shard-0", "shard-1", "shard-2"} <= set(
            observer.tsdb.label_values("workqueue_depth", "instance")),
            30, "workqueue_depth federated from all three shards")
        steps_s["federate"] = time.perf_counter() - t0

        # 5. SIGKILL the notebook's owner: respawned in place from its
        # WAL. First wait out the recorder's rate limit since its last
        # automatic bundle, so the owner's death records one
        owner_cli = client(owner)
        before = {k: owner_cli.get(k, n, ns)["metadata"] for k, n in keys}
        deaths0 = metrics.SHARD_DEATHS_TOTAL.get(shard=owner)
        url0, pid0 = runner.urls[owner], runner.pids()[owner]
        t0 = time.perf_counter()
        last_auto = max((b["trigger"]["t"] for b in observer.flight.bundles()),
                        default=0.0)
        time.sleep(max(0.0, observer.flight.min_interval_s
                       - (time.time() - last_auto) + 0.1))
        steps_s["owner_wait"] = time.perf_counter() - t0
        deaths_state = observer.engine.state_of("shard-deaths")
        t0 = time.perf_counter()
        with step("owner_kill"):
            runner.kill(owner)
            _poll(lambda: runner.pids()[owner] != pid0, 30,
                  "the owner's respawn")
            runner.wait_ready(60, names=[owner])
        kill_s = time.perf_counter() - t0
        seen |= set(runner.pids().values())
        check(runner.urls[owner] == url0, "the owner moved port")
        deaths = metrics.SHARD_DEATHS_TOTAL.get(shard=owner) - deaths0
        _poll(lambda: lease_holder(owner)
              == f"{owner}-{runner.pids()[owner]}", 60,
              "the respawned manager's lease")
        time.sleep(1.5)   # the new manager's first pass over its store
        owner_cli = client(owner)
        after = {k: owner_cli.get(k, n, ns)["metadata"] for k, n in keys}
        same = {k: (after[k]["uid"], after[k]["resourceVersion"])
                == (before[k]["uid"], before[k]["resourceVersion"])
                for k in before}
        pods = [p["metadata"]["uid"] for p in owner_cli.list("Pod", ns)]
        check(all(same.values()), f"after the kill: {before} {after}")
        check(pods == [pod0["metadata"]["uid"]],
              f"pods after the kill: {pods}")
        check(deaths == 1, f"shard_deaths_total{{shard={owner}}} +{deaths}")
        print(f"controlplane: arm E's {owner} SIGKILLed and serving again "
              f"in {kill_s:.3f} s", flush=True)

        # the owner's shard_death bundle: every section, the surviving
        # shards' series, slow traces whose critical paths partition them
        (owner_bundle,) = _poll(lambda: [
            b for b in observer.flight.bundles()
            if b["trigger"]["reason"] == "shard_death"
            and b["trigger"]["detail"]["shard"] == owner], 30,
            "the owner's shard_death bundle")
        bundle_check = _check_bundle(observer.flight, owner_bundle, owner,
                                     set(runner.names) - {owner}, base)
        print(f"controlplane: arm E's {owner} bundle (shard-deaths "
              f"{deaths_state} before the kill, "
              f"{steps_s['owner_wait']:.3f} s waited for the rate limit): "
              f"{bundle_check['slow_traces']} slow traces from "
              f"{len(bundle_check['processes'])} processes "
              f"{bundle_check['processes']}, "
              f"{bundle_check['series']} series", flush=True)

        # 6. the pod's container, from the pod's env read through the router
        pod = router.get("Pod", "ft-0", ns)
        c0 = pod["spec"]["containers"][0]
        env = {e["name"]: e.get("value") for e in c0.get("env") or []}
        result, child_s, substituted = _cp_child(
            env, decl, 1, device, {"MASTER_PORT": str(_free_port())})
        check(result["losses"] == [ref_loss],
              f"arm E's step-1 loss {result['losses']} vs arm B's "
              f"{ref_loss}")
        check(result["launches"] == _pod_launches(decl, 1, device),
              f"arm E's launches {result['launches']}")
        peak_err = (None if result["peak_gb"] is None
                    else (result["peak_gb"] - predicted) / predicted)
        check(peak_err is None or abs(peak_err) <= CP_PEAK_RTOL,
              f"arm E's peak {result['peak_gb']} GB vs {predicted} GB")
        print(f"controlplane: arm E's child {child_s:.3f} s", flush=True)
        smi_child = (_cuda_holders(seen) if device == "cuda" else None)
        # the measured peak against the prediction, through the drift
        # gauge the observer's warn-only SLO reads
        drift = (None if result["peak_gb"] is None else record_declared_drift(
            [{"priced_on_chip_peak_gb": predicted,
              "native_on_chip_peak_gb": result["peak_gb"]}]))
        observer.tick()
        drift_state = observer.engine.state_of("declared-hbm-drift")
        check(drift_state == "ok",
              f"declared-hbm-drift {drift_state} at drift {drift}")

        # 7. the autoscaler merges shard-2 back on the federated queue
        # depth of the three idle shards: not a death; the audit holds
        deaths2 = metrics.SHARD_DEATHS_TOTAL.get(shard="shard-2")
        pid2 = runner.pids()["shard-2"]
        scaler = ShardAutoscaler(elastic, observer, min_shards=2)
        federated = {}
        t0 = time.perf_counter()
        with step("autoscale"):
            for _ in range(CP_AUTOSCALE_TICKS):
                observer.tick()
                federated = {s: observer.tsdb.latest(
                    "workqueue_depth", {"instance": s})
                    for s in router.ring.members}
                t1 = time.perf_counter()
                if scaler.tick() == "merge":
                    steps_s["merge"] = time.perf_counter() - t1
                    break
                time.sleep(0.2)
        steps_s["autoscale"] = time.perf_counter() - t0
        merged_at = time.time()
        decisions = [d["decision"] for d in scaler.decisions]
        check(decisions[-1:] == ["merge"]
              and not {"split", "carve"} & set(decisions)
              and all(d["mean_depth"] <= scaler.merge_depth
                      for d in scaler.decisions[-scaler.sustain:]),
              f"the autoscaler's decisions: {scaler.decisions}")
        check(sorted(federated) == ["shard-0", "shard-1", "shard-2"]
              and None not in federated.values(),
              f"the autoscaler's input: {federated}")
        retired = elastic.events[-1]["shard"]
        merge = {k: v for k, v in elastic.events[-1].items() if k != "t"}
        check(retired == "shard-2" and merge["op"] == "merge"
              and runner.names == ["shard-0", "shard-1"]
              and router.ring.members == ["shard-0", "shard-1"],
              f"the merge: {merge} {runner.names}")
        time.sleep(0.5)   # watchdog ticks: the exit is not a death
        check(metrics.SHARD_DEATHS_TOTAL.get(shard="shard-2") == deaths2,
              "the merge's exit counted as a death")
        check(not _pid_alive(pid2), f"shard-2 (pid {pid2}) outlived the "
                                    "merge")
        audited_merge = audit(objects)
        print(f"controlplane: arm E's merge by the autoscaler "
              f"{steps_s['merge']:.3f} s after {len(decisions)} ticks "
              f"{decisions} ({steps_s['autoscale']:.3f} s), "
              f"{merge['objects_bulk']} objects handed back", flush=True)
        # shard-2 scraped no more: two ticks after the merge, its series
        # end before it while the survivors' go on
        taken = observer.tsdb.samples_taken
        _poll(lambda: observer.tsdb.samples_taken >= taken + 2, 30,
              "two ticks after the merge")
        check(last_t("shard-2") < merged_at < min(
            last_t("shard-0"), last_t("shard-1")),
            f"shard-2 scraped after the merge: {last_t('shard-2')} vs "
            f"{merged_at}")
        counters = dict(shards=shard_metrics(),
                        supervisor=supervisor_metrics())
        print(f"controlplane: arm E's SHARD_* {json.dumps(counters)}",
              flush=True)

        # 8. teardown through the router
        t0 = time.perf_counter()
        router.delete(nb_api.KIND, "ft", ns)
        owner_cli = client(owner)
        _poll(lambda: not any(owner_cli.list(k, ns) for k in (
            "StatefulSet", "Pod", "Service")), 120,
            "arm E's children were not collected")
        router.delete("Profile", ns)
        _poll(lambda: owner_cli.try_get("Namespace", ns) is None, 120,
              "arm E's namespace was not removed")
        steps_s["teardown"] = time.perf_counter() - t0

        # every death the supervisor counted is a shard_death bundle
        # naming the shard and its exit code, or one suppression
        observer.tick()
        deaths_all = metrics.registry_value("shard_deaths_total") - deaths_all
        bundled = [b["trigger"]["detail"] for b in observer.flight.bundles()
                   if b["trigger"]["reason"] == "shard_death"]
        suppressed = observer.flight.suppressed_total
        check(all(d["exitcode"] == -9 and d["shard"] in (victim, owner)
                  for d in bundled)
              and deaths_all - len(bundled) <= suppressed
              and {"shard": owner, "exitcode": -9} in bundled,
              f"deaths {deaths_all}, bundles {bundled}, suppressed "
              f"{suppressed}")
        alerts = observer.alerts()
        states = {s["name"]: s["state"] for s in alerts["slos"]}
        critical = sorted(n for n, st in states.items() if st == "critical")
        print(f"controlplane: arm E's alerts at the end: "
              f"{json.dumps({n: st for n, st in states.items() if st != 'ok'})}"
              f"; tsdb {json.dumps(alerts['tsdb'])}; flight "
              f"{json.dumps(alerts['flight'])}", flush=True)
        check(set(critical) <= {"shard-deaths"},
              f"critical SLOs at the end of arm E: {critical}")
        # the observer's own cost: a tick and a bundle's capture, timed
        t1 = time.perf_counter()
        observer.tick()
        tick_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        observer.flight.trigger("arm_e_done")
        capture_s = time.perf_counter() - t1
        left = {}
        for shard in runner.names:
            cli = client(shard)
            for kind, (_, _, namespaced) in kubeclient.RESOURCES.items():
                if namespaced and cli.list(kind, ns):
                    left[f"{shard}/{kind}"] = len(cli.list(kind, ns))
        check(not left, f"arm E left after the teardown: {left}")
    finally:
        if observer is not None:
            observer.stop()
        tracing.set_enabled(traced[0])
        tracing.set_process(traced[1])
        tracing.collector().clear()
        watch_stop.set()
        seen |= set(runner.pids().values())
        runner.stop()
        for t in threads:
            t.join(60)
        shutil.rmtree(base, ignore_errors=True)
    alive = sorted(p for p in seen if _pid_alive(p))
    check(not alive, f"shard processes outlived stop(): {alive}")
    lives = [t.name for t in threads if t.is_alive()]
    check(not lives, f"arm E's threads still running: {lives}")
    for when, smi in (("split", smi_split), ("child", smi_child)):
        check(smi is None or (smi["control"] and not smi["holders"]),
              f"CUDA contexts after the {when}: {smi}")
    check(not os.path.exists(base), f"{base} was not removed")
    check(not [t for t in threading.enumerate() if t.name == "obs-observer"],
          "the observer's thread outlived the arm")
    return dict(namespace=ns, owner=owner, node=node, moving=moving,
                steps_s=steps_s, start_s=steps_s["start"],
                spawn_s=steps_s["spawn"], split=split,
                chaos_victim=victim, chaos_respawn_s=chaos_respawn_s,
                written=len(written), audited=[audited_split, audited_merge],
                kill_s=kill_s, recovered=same, deaths=deaths, merge=merge,
                child=result, child_s=child_s, peak_rel_err=peak_err,
                cuda_gate=dict(split=smi_split, child=smi_child),
                pids=sorted(seen), counters=counters,
                launches=result["launches"],
                observer=dict(
                    interval_s=CP_OBS_INTERVAL_S, ticks=alerts["tsdb"][
                        "samples_taken"], tick_s=tick_s, capture_s=capture_s,
                    tsdb=alerts["tsdb"], flight=alerts["flight"],
                    deaths=deaths_all, death_bundles=bundled,
                    suppressed=suppressed, owner_bundle=bundle_check,
                    shard_deaths_before_kill=deaths_state,
                    drift=drift, drift_state=drift_state,
                    not_ok={n: st for n, st in states.items() if st != "ok"},
                    decisions=scaler.decisions, federated=federated))


#: the deployed processes' entry point, and the deadline of each one's
#: start (its first answer) and of its exit after SIGTERM
CP_MODULE = "kubeflow_rm_tpu_torch.controlplane"
CP_PROC_DEADLINE_S = 90


def torch_mapped(pid: int) -> bool:
    """Whether process ``pid`` has torch's libraries mapped (its
    ``/proc/<pid>/maps``): a process that imported torch has."""
    with open(f"/proc/{pid}/maps") as f:
        return any("libtorch" in line or "/torch/_C" in line for line in f)


def _healthz(url: str) -> bool:
    """Whether the server at ``url`` answers ``/healthz`` with 200."""
    return HTTPUser(url).fetch("healthz", "GET", "/healthz")[0] == 200


class CPProcess:
    """``python -m kubeflow_rm_tpu_torch.controlplane <cmd>`` in a child
    process, as the manifests start it: this process's environment with
    ``env`` over it, run from the checkout, its output to
    ``<log_dir>/<cmd>.log``. :meth:`ready` waits for its first answer
    (``start_s``), :meth:`torch_loaded` reads its mapped libraries and
    :meth:`stop` is the kubelet's SIGTERM."""

    def __init__(self, cmd: str, env: dict, log_dir: str):
        import os

        self.cmd = cmd
        self.log_path = os.path.join(log_dir, f"{cmd}.log")
        self._log = open(self.log_path, "w")
        self.start_s = None
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", CP_MODULE, cmd], cwd=_here(),
            env=dict(os.environ, **env), stdout=self._log,
            stderr=subprocess.STDOUT)

    def ready(self, probe, timeout_s: float = CP_PROC_DEADLINE_S) -> float:
        """Poll ``probe()`` until it is true (an ``OSError`` is a no);
        fails if the process exits first or at the deadline. Returns the
        seconds since the start."""
        def up():
            check(self.proc.poll() is None,
                  f"{self.cmd} exited {self.proc.returncode}")
            try:
                return probe()
            except OSError:
                return False
        _poll(up, timeout_s, f"{self.cmd}'s first answer")
        self.start_s = time.perf_counter() - self.t0
        return self.start_s

    def torch_loaded(self) -> bool:
        return torch_mapped(self.proc.pid)

    def tail(self, n: int = 4000) -> str:
        with open(self.log_path) as f:
            return f.read()[-n:]

    def stop(self, timeout_s: float = CP_PROC_DEADLINE_S):
        """SIGTERM, then the exit code within ``timeout_s`` (``None``,
        and a SIGKILL, past it)."""
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(30)
            rc = None
        self._log.close()
        return rc


#: arm F's controller-manager's election identity (its ``POD_NAME``)
CP_ELECTION_ID = "smoke-controller-manager"


def _cp_process_arm(decl, device, ref_loss) -> dict:
    """Arm F: the platform as its manifests deploy it. The cluster is one
    :class:`CPShard` (its facade with the cluster's admission and fake
    kubelet); the platform is three ``python -m
    kubeflow_rm_tpu_torch.controlplane`` processes over it: the
    ``controller-manager`` under ``LEADER_ELECT``, the ``webhook-server``
    and the ``gateway`` with ``DEV_USER`` the owner. Over HTTP through the
    gateway, as the SPA drives it: the shell and ``app.js``, the
    workgroup, the spawner's config and types, the form's spawn of an
    ``h100-80gb-1`` notebook read ``ready`` through the readiness
    long-poll; the webhook server's patch for the raw pod equal to the
    in-process handler's over the same facade; the pod's container's one
    step with ``ref_loss`` (arm B's step 1) bit for bit; the dashboard's
    metrics, history, alerts, harvest and traces; none of the three
    processes with torch loaded; the delete through the gateway, the
    profile torn down, and each process exiting 0 on SIGTERM."""
    import base64
    import os
    import shutil
    import tempfile

    from kubeflow_rm_tpu_torch.controlplane.api import gpu
    from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
    from kubeflow_rm_tpu_torch.controlplane.controllers.statefulset import (
        StatefulSetController, make_gpu_node,
    )
    from kubeflow_rm_tpu_torch.controlplane.deploy.kubeclient import (
        KubeAPIServer,
    )
    from kubeflow_rm_tpu_torch.controlplane.deploy.webhook_server import (
        make_admission_handler,
    )
    from kubeflow_rm_tpu_torch.controlplane.ha.leases import (
        DEFAULT_LEASE_NAME,
    )
    from kubeflow_rm_tpu_torch.controlplane.obs.slo import default_slos

    ns, name = "processes", "ft"
    t_arm = time.perf_counter()
    base = tempfile.mkdtemp(prefix="kfrm-smoke-procs-")
    shard, procs, steps_s = None, {}, {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        steps_s[key] = time.perf_counter() - t0
        return out

    try:
        shard = CPShard("shard-0", f"{base}/wal")
        shard.api.create(make_gpu_node("gpu-0", CP_ACC))
        hook_port, gw_port = _free_port(), _free_port()
        for cmd, env in (
                ("controller-manager", {"LEADER_ELECT": "true",
                                        "POD_NAME": CP_ELECTION_ID}),
                ("webhook-server", {"PORT": str(hook_port)}),
                ("gateway", {"PORT": str(gw_port), "DEV_USER": CP_OWNER,
                             "SECURE_COOKIES": "false"})):
            procs[cmd] = CPProcess(cmd, dict(env, KUBE_API_URL=shard.url),
                                   base)

        def elected():
            lease = shard.api.try_get("Lease", DEFAULT_LEASE_NAME,
                                      "kubeflow")
            return bool(lease) and lease["spec"].get(
                "holderIdentity") == CP_ELECTION_ID
        procs["controller-manager"].ready(elected)
        hook = f"http://127.0.0.1:{hook_port}"
        procs["webhook-server"].ready(lambda: _healthz(hook))
        gw = HTTPUser(f"http://127.0.0.1:{gw_port}")
        procs["gateway"].ready(lambda: _healthz(gw.url))
        started = {cmd: p.start_s for cmd, p in procs.items()}
        print(f"controlplane: arm F's processes up (s): {started}",
              flush=True)

        # 1. the SPA's shell sets the CSRF cookie the client echoes
        status, headers, raw = gw.fetch("shell", "GET", "/")
        cookie = headers.get("Set-Cookie") or ""
        check(status == 200 and headers.get("Content-Type")
              == "text/html; charset=utf-8"
              and b'src="/static/app.js"' in raw
              and cookie.startswith("XSRF-TOKEN="),
              f"the shell: {status} {dict(headers)}")
        gw.token = cookie.split(";", 1)[0].split("=", 1)[1]
        status, headers, raw = gw.fetch("app_js", "GET", "/static/app.js")
        check(status == 200 and headers.get("Content-Type")
              == "text/javascript; charset=utf-8"
              and b'"/jupyter/api/tpus"' in raw,
              f"app.js: {status} {dict(headers)}")

        # 2. the workgroup, made by the controller-manager process
        owner = {"namespace": ns, "role": "owner", "user": CP_OWNER}

        def registered():
            status, info = gw.call("env_info", "GET",
                                   "/api/workgroup/env-info")
            return status == 200 and owner in info["namespaces"] and info

        def workgroup():
            status, body = gw.call("workgroup_create", "POST",
                                   "/api/workgroup/create",
                                   {"namespace": ns})
            check(status == 200, f"the workgroup's create: {body}")
            return _poll(registered, 60, "the profile's namespace")
        info = timed("profile", workgroup)
        check(info["tpuSliceTypes"] == [CP_ACC]
              and info["isClusterAdmin"] is False, f"env-info: {info}")

        # 3. the spawner's form, then the readiness long-poll
        status, cfg = gw.call("config", "GET", "/jupyter/api/config")
        check(status == 200, f"the spawner's config: {cfg}")
        status, offered = gw.call("tpus", "GET", "/jupyter/api/tpus")
        check(status == 200 and [t["acceleratorType"] for t in offered[
            "tpus"]] == [CP_ACC], f"the spawner's types: {offered}")
        form = {"name": name, "image": cfg["config"]["image"]["value"],
                "imagePullPolicy": "IfNotPresent", "serverType": "jupyter",
                "cpu": "4", "memory": "16Gi",
                "tpu": {"acceleratorType": CP_ACC},
                "tolerationGroup": "none", "affinityConfig": "none",
                "configurations": [], "shm": True, "environment": {},
                "datavols": []}

        def spawn():
            status, body = gw.call(
                "spawn_form", "POST", f"/jupyter/api/namespaces/{ns}/"
                "notebooks", form)
            check(status == 200, f"the form's spawn: {status} {body}")
            poll = ReadinessPoll(gw, ns, name, "")
            poll.join(CP_POLL_TIMEOUT_S * 4)
            return poll
        poll = timed("spawn", spawn)
        check(not poll.thread.is_alive() and poll.error is None
              and poll.last is not None and poll.last["notebook"][
                  "processed_status"]["phase"] == "ready",
              f"the long-poll: {poll.polls} {poll.error}")
        print(f"controlplane: arm F's spawn through the gateway "
              f"{steps_s['spawn']:.3f} s, {len(poll.polls)} polls",
              flush=True)
        nb = shard.api.get(nb_api.KIND, name, ns)
        pod = shard.api.get("Pod", f"{name}-0", ns)
        c0 = pod["spec"]["containers"][0]
        env = {e["name"]: e.get("value") for e in c0.get("env") or []}
        check(nb["status"].get("readyReplicas") == 1
              and pod["spec"].get("nodeName") == "gpu-0"
              and c0["resources"]["limits"].get(gpu.NVIDIA_GPU_RESOURCE)
              == "1" and env.get("TPU_WORKER_ID") == "0",
              f"the pod: {pod['spec'].get('nodeName')} {c0['resources']} "
              f"{env}")

        # 4. the webhook-server process against the in-process handler
        raw_pod = StatefulSetController()._render_pod(
            shard.api.get("StatefulSet", name, ns), 0)
        review = {"apiVersion": "admission.k8s.io/v1",
                  "kind": "AdmissionReview", "request": {
                      "uid": "smoke-f", "operation": "CREATE",
                      "object": raw_pod}}

        def webhook():
            status, body = HTTPUser(hook).call("review", "POST",
                                               "/mutate-pod", review)
            check(status == 200, f"the review: {status} {body}")
            return body["response"]
        got = timed("webhook_review", webhook)
        want = make_admission_handler(KubeAPIServer(shard.url)).review(
            "/mutate-pod", review)["response"]
        check(got == want and got["allowed"] and "patch" in got,
              f"the webhook process's review {got} vs in process {want}")
        patched = _apply_json_patch(
            raw_pod, json.loads(base64.b64decode(got["patch"])))
        p0 = patched["spec"]["containers"][0]
        check(p0.get("env") == c0.get("env")
              and p0.get("resources") == c0.get("resources"),
              f"the patched pod: {p0.get('env')} {p0.get('resources')} vs "
              f"the stored {c0.get('env')} {c0.get('resources')}")

        # 5. the pod's container: one step, arm B's step-1 loss
        result, child_s, substituted = _cp_child(
            env, decl, 1, device, {"MASTER_PORT": str(_free_port())})
        check(result["losses"] == [ref_loss],
              f"arm F's step-1 loss {result['losses']} vs arm B's "
              f"{ref_loss}")
        check(result["launches"] == _pod_launches(decl, 1, device),
              f"arm F's launches {result['launches']}")

        # 6. the dashboard's reads through the gateway
        status, snap = gw.call("metrics", "GET", "/api/metrics")
        check(status == 200 and snap["metrics"] == {
            "nodes": 1, "chips_capacity": 1.0, "chips_requested": 1.0,
            "notebooks_running": 1}, f"/api/metrics: {snap.get('metrics')}")
        status, hist = gw.call("history", "GET", "/api/metrics/history")
        check(status == 200 and len(hist["series"]) >= 1,
              f"/api/metrics/history: {hist}")
        status, alerts = gw.call("alerts", "GET", "/api/alerts")
        check(status == 200 and [s["name"] for s in alerts["slos"]]
              == [s.name for s in default_slos()],
              f"/api/alerts: {[s['name'] for s in alerts.get('slos', [])]}")
        status, harvest = gw.call("harvest", "GET", "/api/harvest")
        check(status == 200 and harvest["harvested_chips"] == 0.0
              and harvest["leases"] == [] and harvest["controller"] is None,
              f"/api/harvest: {harvest}")
        status, traces = gw.call("traces", "GET", "/api/traces")
        check(status == 200 and traces["enabled"] is False
              and traces["slow"] == [], f"/api/traces: {traces}")

        # 7. no torch in the control plane (this process is the control)
        loaded = {cmd: p.torch_loaded() for cmd, p in procs.items()}
        control = torch_mapped(os.getpid())
        print(f"controlplane: arm F's torch loaded {loaded} (control "
              f"{control})", flush=True)
        check(control and not any(loaded.values()),
              f"torch in the control plane: {loaded}, control {control}")

        # 8. the delete through the gateway, the profile, SIGTERM
        def delete():
            status, body = gw.call(
                "delete", "DELETE",
                f"/jupyter/api/namespaces/{ns}/notebooks/{name}")
            check(status == 200, f"the delete: {body}")
            _poll(lambda: not any(shard.api.list(k, ns) for k in (
                "StatefulSet", "Pod", "Service")), 120,
                f"{name}'s children were not collected")
        timed("delete", delete)

        def teardown():
            shard.api.delete("Profile", ns)
            _poll(lambda: shard.api.try_get("Namespace", ns) is None, 120,
                  "the profile's namespace was not removed")
        timed("teardown", teardown)
        left = {k: len(shard.api.list(k, ns)) for k in sorted(
            shard.api._by_kind) if shard.api.list(k, ns)}
        check(not left, f"arm F left after the teardown: {left}")
        exits, stop_s = {}, {}
        for cmd in ("gateway", "webhook-server", "controller-manager"):
            t0 = time.perf_counter()
            exits[cmd] = procs[cmd].stop()
            stop_s[cmd] = time.perf_counter() - t0
        print(f"controlplane: arm F's exits {exits} in {stop_s} s",
              flush=True)
        check(all(rc == 0 for rc in exits.values()),
              f"arm F's processes on SIGTERM: {exits}")
        released = shard.api.get("Lease", DEFAULT_LEASE_NAME, "kubeflow")[
            "spec"].get("holderIdentity")
        check(released == "", f"the lease after the exit: {released!r}")
    except BaseException:
        for p in procs.values():
            print(f"--- {p.cmd}'s log ---\n{p.tail()}", file=sys.stderr)
        raise
    finally:
        for p in procs.values():
            if p.proc.poll() is None:
                p.proc.kill()
                p.proc.wait(30)
        if shard is not None:
            shard.stop()
        shutil.rmtree(base, ignore_errors=True)
    web_ms = {k: [round(1e3 * t, 3) for t in v]
              for k, v in gw.seconds.items()}
    print(f"controlplane: arm F's requests (ms) {web_ms}", flush=True)
    return dict(namespace=ns, arm_s=time.perf_counter() - t_arm,
                steps_s=steps_s, spawn_s=steps_s["spawn"], start_s=started,
                torch_loaded=loaded, torch_control=control, polls=poll.polls,
                web_ms=web_ms, review=got, env_info=info,
                metrics=snap["metrics"],
                series=len(hist["series"]),
                slos=[s["name"] for s in alerts["slos"]],
                traces=traces, exits=exits, stop_s=stop_s, child=result,
                child_s=child_s, substituted=substituted,
                launches=result["launches"])


def _pid_alive(pid: int) -> bool:
    import os

    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


def _cp_pod(name, ns) -> dict:
    """A bare pod of the filler load."""
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"containers": [{"name": "c", "image": "img"}]}}


def _apply_json_patch(doc, ops):
    """Apply RFC 6902 ``add``/``replace``/``remove`` operations (the ones
    the webhook server emits) to a copy of ``doc``."""
    import copy

    doc = copy.deepcopy(doc)
    for op in ops:
        parts = [p.replace("~1", "/").replace("~0", "~")
                 for p in op["path"].split("/")[1:]]
        target = doc
        for p in parts[:-1]:
            target = target[p]
        if op["op"] == "remove":
            del target[parts[-1]]
        else:
            target[parts[-1]] = op["value"]
    return doc


def phase_controlplane(card, train_ref=None, device: str = "cuda",
                       decl=None, steps: int = CP_STEPS):
    """The control plane on the card (module docstring, phase 12): arm A
    on the raw read path, then arm B, JAX's defaults, through a
    notebook's life with the pod's fine-tune in a child process, then
    arm C, the fine-tune preempted at its checkpoint and resumed there
    (:func:`_cp_suspend_arm`), then arm D, the deployed layout: two
    sharded apiservers behind REST facades and the manager over the
    router (:func:`_cp_deployed_arm`), then arm E, the shards as
    processes under a supervisor, split and merged live around the
    notebook (:func:`_cp_elastic_arm`), then arm F, the platform's
    deployed processes over one shard's facade (:func:`_cp_process_arm`).
    Returns the launches of all six arms' containers.
    ``train_ref`` (the train phase's) puts the pod's step beside the
    train phase's. ``device="cpu"`` rehearses it without a card (the
    table's own memory, gloo, a small declaration such as ``{"preset":
    "tiny", ...}``; no kernel launches, no peak)."""
    import functools

    from kubeflow_rm_tpu_torch.controlplane import make_control_plane
    from kubeflow_rm_tpu_torch.controlplane import metrics, scheduler
    from kubeflow_rm_tpu_torch.controlplane.api import gpu
    from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
    from kubeflow_rm_tpu_torch.controlplane.api import tpujob as tj_api
    from kubeflow_rm_tpu_torch.controlplane.api.meta import make_object
    from kubeflow_rm_tpu_torch.controlplane.api.poddefault import (
        make_poddefault,
    )
    from kubeflow_rm_tpu_torch.controlplane.api.profile import (
        DEFAULT_EDITOR, QUOTA_NAME, make_profile,
    )
    from kubeflow_rm_tpu_torch.controlplane.apiserver import APIError
    from kubeflow_rm_tpu_torch.controlplane.controllers.authcompanion import (
        OAUTH_INJECT_ANNOTATION,
    )
    from kubeflow_rm_tpu_torch.controlplane.controllers.culling import (
        default_probe,
    )
    from kubeflow_rm_tpu_torch.controlplane.controllers.statefulset import (
        make_gpu_node,
    )
    from kubeflow_rm_tpu_torch.controlplane.webhook.notebook import (
        IMAGE_CONFIGMAP, IMAGE_CONFIGMAP_NAMESPACE, LOCK_VALUE,
    )

    decl = decl or CP_DECLARATION
    ns = CP_NS
    t_phase = time.perf_counter()
    topo, card_gib = _cp_check_node(device)
    arm_a = _cp_raw_arm(topo, decl)

    # arm B: JAX's defaults on the phase's own clock; the culler probes
    # the stand-in server through the default probe
    clock, jupyter = SettableClock(), JupyterStandIn()
    steps_s, reconciles = {}, {}

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        reconciles[name] = mgr.run_until_idle()
        steps_s[name] = time.perf_counter() - t0
        return out

    def reads():
        return {f"{v}_{r}": metrics.CACHE_READS_TOTAL.get(verb=v, result=r)
                for v in ("get", "list", "scan") for r in ("hit", "miss")}

    def kfam_counts():
        return {f"{a}_{r}": metrics.KFAM_REQUESTS_TOTAL.get(action=a, result=r)
                for a in ("create_binding", "read_bindings")
                for r in ("success", "error")}

    def wakes():
        return tuple(metrics.registry_value(
            f"readiness_wake_to_observe_seconds_{k}") for k in ("count",
                                                                "sum"))

    web = None
    try:
        api, mgr = make_control_plane(
            clock=clock, enable_culling=True, culler_config=dict(
                CP_CULL, probe_fn=functools.partial(
                    default_probe, base_url=jupyter.base_url)))
        check(type(mgr.api).__name__ == "CachedAPI",
              f"arm B's manager reads through {type(mgr.api).__name__}")
        reads0 = reads()
        culls0 = metrics.NOTEBOOK_CULL_TOTAL.get()
        kfam0 = kfam_counts()
        wakes0 = wakes()
        # the notebook-facing web apps over arm B's apiserver
        web = WebAppServer(api)
        nbs = f"/jupyter/api/namespaces/{ns}/notebooks"
        api.create(make_gpu_node("gpu-0", CP_ACC))
        sched = scheduler.cache_for(api)

        # 1. the profile: its namespace, RBAC and a one-card quota
        step("profile", lambda: api.create(make_profile(
            ns, CP_OWNER, quota_hard={gpu.NVIDIA_GPU_RESOURCE: "1"})))
        ns_obj = api.get("Namespace", ns)
        rb = api.try_get("RoleBinding", "namespaceAdmin", ns)
        quota = api.try_get("ResourceQuota", QUOTA_NAME, ns)
        check((ns_obj["metadata"].get("annotations") or {}).get("owner")
              == CP_OWNER
              and api.try_get("ServiceAccount", DEFAULT_EDITOR, ns)
              and rb and rb["subjects"][0]["name"] == CP_OWNER
              and quota and quota["spec"]["hard"] == {
                  gpu.NVIDIA_GPU_RESOURCE: "1"},
              f"the profile's objects: {ns_obj['metadata']} {rb} {quota}")

        # 2. the image table and 3. a PodDefault for the notebook's pod
        def images_and_poddefault():
            api.ensure_namespace(IMAGE_CONFIGMAP_NAMESPACE)
            cm = make_object("v1", "ConfigMap", IMAGE_CONFIGMAP,
                             IMAGE_CONFIGMAP_NAMESPACE)
            cm["data"] = {CP_IMAGE: CP_IMAGE_REF}
            api.create(cm)
            api.create(make_poddefault(
                "smoke", ns, selector={"matchLabels": dict(CP_POD_LABEL)},
                env=[{"name": "KFRM_PODDEFAULT", "value": "smoke"}]))
        step("images_poddefault", images_and_poddefault)

        # 4. the notebook: locked, resolved, priced, bound, injected, and
        # given the oauth proxy and the auth companion's objects. It is
        # made through the apiserver (the spawner's form carries neither
        # the declared workload nor the oauth annotation); a client of
        # the spawner parks a readiness long-poll on it before the
        # manager reconciles, and polls until it reads ``ready``
        poll_box = []

        def spawn():
            made = api.create(nb_api.make_notebook(
                "ft", ns, image=CP_IMAGE, accelerator_type=CP_ACC,
                labels=dict(CP_POD_LABEL),
                annotations={
                    gpu.DECLARED_WORKLOAD_ANNOTATION: json.dumps(decl),
                    OAUTH_INJECT_ANNOTATION: "true"}))
            t0 = time.perf_counter()
            poll_box.append(ReadinessPoll(
                web, ns, "ft", made["metadata"]["resourceVersion"]))
            while metrics.READINESS_WAITERS.get() < 1:
                check(time.perf_counter() - t0 < 30 and not
                      poll_box[0].polls, "the readiness poll never parked")
                time.sleep(0.001)
            poll_box.append(time.perf_counter() - t0)
            return made
        made = step("spawn", spawn)
        poll, park_s = poll_box
        poll.join(CP_POLL_TIMEOUT_S + 60)
        check(poll.error is None and poll.last is not None,
              f"the readiness poll: {poll.error} {poll.polls}")
        wakes1 = wakes()
        longpoll = dict(
            polls=poll.polls, park_s=park_s, wakes=wakes1[0] - wakes0[0],
            wake_to_observe_s=wakes1[1] - wakes0[1],
            waiters_after=metrics.READINESS_WAITERS.get())
        check(poll.last["notebook"]["processed_status"]["phase"] == "ready"
              and longpoll["wakes"] >= 1
              and longpoll["waiters_after"] == 0,
              f"the readiness long-poll: {longpoll}")
        check(made["metadata"]["annotations"].get(
            nb_api.STOP_ANNOTATION) == LOCK_VALUE,
            f"the lock at admission: {made['metadata']['annotations']}")
        nb, pod, env = _cp_spawned(api, ns, "ft", topo)
        adm = nb["status"]["admission"]
        check(nb_api.STOP_ANNOTATION not in nb["metadata"]["annotations"],
              "the reconciliation lock was not released")
        names = [c["name"] for c in pod["spec"]["containers"]]
        check(pod["spec"]["containers"][0]["image"] == CP_IMAGE_REF
              and names == ["ft", "oauth-proxy"]
              and pod["spec"].get("serviceAccountName") == "ft",
              f"the pod's containers: {names} "
              f"{pod['spec']['containers'][0]['image']}")
        companion = {
            "ServiceAccount": ["ft", "default-editor", "default-viewer"],
            "Service": ["ft", "ft-tls", "ft-workers"],
            "Secret": ["ft-oauth-config"], "Route": ["ft"],
            "NetworkPolicy": ["ft-ctrl-np", "ft-oauth-np"],
            "RoleBinding": ["default-editor", "default-viewer",
                            "elyra-pipelines-ft", "namespaceAdmin"]}
        have = {k: sorted(o["metadata"]["name"] for o in api.list(k, ns))
                for k in companion}
        check(have == {k: sorted(v) for k, v in companion.items()},
              f"the auth companion's objects: {have}")
        route = api.get("Route", "ft", ns)["spec"]
        check(route["to"]["name"] == "ft-tls"
              and route["tls"]["termination"] == "reencrypt",
              f"the oauth route: {route}")
        check(env.get("KFRM_PODDEFAULT") == "smoke",
              f"the PodDefault's variable: {env.get('KFRM_PODDEFAULT')}")
        check(sched.stats()["free_chips"] == 0.0, "free cards after the bind")
        predicted = float(pod["metadata"]["annotations"][
            gpu.PREDICTED_HBM_ANNOTATION])
        # the spawner's views of it: the listing, the slice's pods, the
        # types on offer
        listed = web.call("list", "GET", nbs)
        pods = web.call("pods", "GET", f"{nbs}/ft/pods")
        offered = web.call("tpus", "GET", "/jupyter/api/tpus")
        entries = [(e["name"], e["status"]["phase"],
                    (e["tpu"] or {}).get("acceleratorType"))
                   for e in listed[1].get("notebooks", [])]
        check(listed[0] == 200 and entries == [("ft", "ready", CP_ACC)]
              and pods[0] == 200 and pods[1]["pods"] == [dict(
                  name="ft-0", phase="Running", nodeName="gpu-0")]
              and offered[0] == 200 and [t["acceleratorType"] for t in
                                         offered[1]["tpus"]] == [CP_ACC],
              f"the spawner's views: {listed} {pods} {offered}")

        # 5. the pod's container
        result, child_s, substituted = _cp_child(env, decl, steps, device)

        # 6. the quota: KFAM makes a contributor an editor of the
        # namespace, whose second notebook of one card, spawned through
        # the form, is refused whole; a user with no binding is refused
        # by the web app
        granted = step("kfam_binding", lambda: web.call(
            "kfam_binding", "POST", "/kfam/v1/bindings", {
                "user": {"kind": "User", "name": CP_CONTRIBUTOR},
                "referredNamespace": ns,
                "roleRef": {"kind": "ClusterRole", "name": "edit"}}))
        bindings = web.call("kfam_bindings", "GET",
                            f"/kfam/v1/bindings?namespace={ns}")
        check(granted[0] == 200 and bindings[0] == 200 and [
            (b["user"]["name"], b["roleRef"]["name"])
            for b in bindings[1]["bindings"]] == [(CP_CONTRIBUTOR, "edit")],
            f"the KFAM binding: {granted} {bindings}")
        form = {"name": "ft2", "image": CP_IMAGE,
                "imagePullPolicy": "IfNotPresent", "serverType": "jupyter",
                "cpu": "4", "memory": "16Gi",
                "tpu": {"acceleratorType": CP_ACC},
                "tolerationGroup": "none", "affinityConfig": "none",
                "configurations": [], "shm": True, "environment": {},
                "datavols": []}
        posted = step("quota", lambda: web.call(
            "spawn_form", "POST", nbs, form, user=CP_CONTRIBUTOR))
        stranger = web.call("stranger", "POST", nbs, dict(form, name="ft3"),
                            user=CP_STRANGER)
        check(posted[0] == 200 and stranger == (403, {
            "success": False, "status": 403, "user": CP_STRANGER,
            "log": f"User '{CP_STRANGER}' is not authorized to create "
                   f"notebooks in namespace '{ns}'"})
              and api.get(nb_api.KIND, "ft2", ns)["metadata"][
                  "annotations"].get("notebooks.kubeflow.org/creator")
              == CP_CONTRIBUTOR
              and api.try_get(nb_api.KIND, "ft3", ns) is None,
              f"the form's spawns: {posted} {stranger}")
        refusals = [e["message"] for e in api.events_for(
            api.get("StatefulSet", "ft2", ns))
            if e["reason"] == "SliceAdmissionFailed"]
        direct = api.get("Pod", "ft-0", ns)
        direct["metadata"] = {"name": "direct", "namespace": ns}
        direct["spec"].pop("nodeName", None)
        direct.pop("status", None)
        try:
            api.create(direct)
            denied = None
        except APIError as e:
            denied = str(e)
        check(api.try_get("Pod", "ft2-0", ns) is None
              and refusals == ["namespace quota cannot admit all 1 hosts "
                               "of the slice; rejecting whole (slice "
                               "admission is all-or-nothing)"]
              and denied is not None
              and denied.startswith(f"exceeded quota {QUOTA_NAME}:"),
              f"the quota's refusal: {refusals} {denied}")
        check(api.get("Pod", "ft-0", ns)["spec"]["nodeName"] == "gpu-0",
              "ft-0 lost its card to the refused notebook")
        deleted = step("quota_delete", lambda: web.call(
            "delete", "DELETE", f"{nbs}/ft2", user=CP_CONTRIBUTOR))
        check(deleted[0] == 200 and api.try_get(nb_api.KIND, "ft2", ns)
              is None, f"ft2's delete through the app: {deleted}")

        # 7. slice health: the kubelet reports the pod Failed, as after
        # an Xid error or an OOM kill
        uid = api.get("Pod", "ft-0", ns)["metadata"]["uid"]

        def fail():
            pod = api.get("Pod", "ft-0", ns)
            pod["status"] = {"phase": "Failed"}
            api.update_status(pod)
        step("slice_health", fail)
        pod = api.get("Pod", "ft-0", ns)
        restarted = dict(new_uid=pod["metadata"]["uid"] != uid,
                         node=pod["spec"].get("nodeName"),
                         phase=pod["status"].get("phase"),
                         free_cards=sched.stats()["free_chips"])
        check(restarted == dict(new_uid=True, node="gpu-0",
                                phase="Running", free_cards=0.0),
              f"after the failure: {restarted}")

        # 8. culling: one idle kernel, then eleven minutes of nothing
        jupyter.kernels = [{"id": "k0", "execution_state": "idle",
                            "last_activity": clock().isoformat()}]

        def idle():
            clock.advance(minutes=11)
        step("cull", idle)
        nb = api.get(nb_api.KIND, "ft", ns)
        culled = dict(
            stopped_at=nb["metadata"]["annotations"].get(
                nb_api.STOP_ANNOTATION),
            replicas=api.get("StatefulSet", "ft", ns)["spec"]["replicas"],
            pods=len(api.list("Pod", ns)),
            free_cards=sched.stats()["free_chips"],
            culls=metrics.NOTEBOOK_CULL_TOTAL.get() - culls0,
            probe_gets=jupyter.gets)
        check(culled["stopped_at"] == clock().isoformat()
              and culled["replicas"] == 0 and culled["pods"] == 0
              and culled["free_cards"] == 1.0 and culled["culls"] == 1,
              f"after the idle time: {culled}")
        listed = web.call("list", "GET", nbs)
        check(listed[0] == 200 and [
            (e["name"], e["status"]["phase"])
            for e in listed[1]["notebooks"]] == [("ft", "stopped")],
            f"the spawner's listing after the cull: {listed}")

        # 9. a TPUJob of one worker on the freed card
        step("tpujob", lambda: api.create(tj_api.make_tpujob(
            "job", ns, roles=[{"name": "worker", "replicas": 1,
                               "tpu": {"acceleratorType": CP_ACC}}])))
        job = api.get(tj_api.KIND, "job", ns)
        jpod = api.get("Pod", "job-worker-0", ns)
        jenv = {e["name"]: e.get("value")
                for e in jpod["spec"]["containers"][0].get("env") or []}
        check(jpod["spec"].get("nodeName") == "gpu-0"
              and jenv.get("TPU_WORKER_ID") == "0"
              and job["status"]["phase"] == tj_api.RUNNING_PHASE
              and job["status"]["readyPods"] == 1,
              f"the TPUJob: {job['status']} {jpod['spec'].get('nodeName')}")
        step("tpujob_delete", lambda: api.delete(tj_api.KIND, "job", ns))
        check(api.list("Pod", ns) == [] and sched.stats()[
            "free_chips"] == 1.0, "the TPUJob's pod was not collected")

        # 10. teardown: the notebook through the app, then the profile
        # and its namespace
        def teardown():
            out = web.call("delete", "DELETE", f"{nbs}/ft")
            api.delete("Profile", ns)
            return out
        deleted = step("teardown", teardown)
        check(deleted[0] == 200, f"ft's delete through the app: {deleted}")
        left = {k: len(api.list(k, ns)) for k in sorted(api._by_kind)
                if api.list(k, ns)}
        check(not left and api.try_get("Profile", ns) is None
              and api.try_get("Namespace", ns) is None,
              f"left after the teardown: {left}")
        store = mgr.api.store.stats()
        reads1 = reads()
        kfam1 = kfam_counts()
    finally:
        if web is not None:
            web.close()
        jupyter.close()

    losses, launches = result["losses"], result["launches"]
    want = _pod_launches(decl, steps, device)
    arm_c = _cp_suspend_arm(topo, decl, steps, device, losses)
    arm_d = _cp_deployed_arm(topo, decl, device, losses[0], steps_s["spawn"])
    arm_e = _cp_elastic_arm(decl, device, losses[0], predicted)
    arm_f = _cp_process_arm(decl, device, losses[0])
    peak_err = (None if result["peak_gb"] is None
                else (result["peak_gb"] - predicted) / predicted)
    # the first record holds the start-up sync (as in the train phase)
    step_ms = statistics.median(result["step_ms"][1:] or result["step_ms"])
    train_ms = train_ref and train_ref["step_ms"]
    cache = {k: reads1[k] - reads0[k] for k in reads0}
    hits = sum(v for k, v in cache.items() if k.endswith("_hit"))
    emit("controlplane", card=card, node_gib=topo.hbm_gib_per_chip,
         card_gib=card_gib, arm_a=arm_a,
         arm_b=dict(steps_s=steps_s, reconciles=reconciles,
                    cache_reads=cache,
                    cache_hit_ratio=hits / max(1, sum(cache.values())),
                    informer=store, culled=culled, restarted=restarted,
                    quota_refusal=refusals, quota_denied=denied,
                    web_s=web.seconds, longpoll=longpoll,
                    kfam={k: kfam1[k] - kfam0[k] for k in kfam0}),
         admission={k: adm.get(k) for k in (
             "verdict", "predicted_peak_gb", "budget_per_chip_gb", "binds",
             "flops_per_step", "workload")},
         pod_env=env, substituted=substituted, child_s=child_s,
         pod_workload=result, pod_step_ms=step_ms, train_step_ms=train_ms,
         pod_over_train=train_ms and step_ms / train_ms,
         predicted_pod_gb=predicted, peak_rel_err=peak_err, arm_c=arm_c,
         arm_d=arm_d, arm_e=arm_e, arm_f=arm_f,
         phase_s=time.perf_counter() - t_phase)
    check(result.get("poddefault") == "smoke",
          f"the child saw KFRM_PODDEFAULT={result.get('poddefault')}")
    check(all(math.isfinite(x) for x in losses) and len(losses) == steps,
          f"the pod's losses: {losses}")
    check(result["world"]["size"] == 1 and result["world"]["backend"] == (
        "nccl" if device == "cuda" else "gloo")
        and result["world"]["master"] == "127.0.0.1",
        f"the pod's world: {result['world']}")
    check(launches == want, f"the pod's launches {launches}, expected "
                            f"{want}")
    check(peak_err is None or abs(peak_err) <= CP_PEAK_RTOL,
          f"the pod's peak {result['peak_gb']} GB vs its predicted "
          f"{predicted} GB")
    return {k: launches[k] + arm_c["launches"][k] + arm_d["launches"][k]
            + arm_e["launches"][k] + arm_f["launches"][k] for k in launches}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke needs a GPU",
              file=sys.stderr)
        return 2
    from kubeflow_rm_tpu_torch.models.llama import LlamaConfig, init_params

    failures = []

    def run(phase, fn, *args):
        """Run one phase; a failure is recorded and the next phase runs."""
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001 - reported, then exit 1
            traceback.print_exc()
            failures.append(f"{phase}: {type(e).__name__}: {e}")
            emit(phase, failed=str(e)[:2000])
            return None

    name, smi = phase_device()
    run("build", phase_build)
    worst, timing = run("kernels", phase_kernels, name) or ({}, {})

    cfg = LlamaConfig.llama2_7b(param_dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    paths = {}
    paths["forward"], forward_err = (run("forward", phase_forward, cfg,
                                         params) or (None, None))
    run("serve", phase_serve, cfg, params)
    paths["engine"] = run("engine", phase_engine, cfg, params, forward_err,
                          smi)
    torch.cuda.empty_cache()
    paths["fleet"] = run("fleet", phase_fleet, cfg, params, forward_err, smi)
    torch.cuda.empty_cache()
    paths["quant"] = run("quant", phase_quant, cfg, params, forward_err, smi)
    torch.cuda.empty_cache()
    paths["train_grad"] = run("train_grad", phase_train_grad)
    paths["train"], train_ref = (run("train", phase_train, cfg, params)
                                 or (None, None))
    torch.cuda.empty_cache()
    # the mesh at world size 1, while the 7B tree is still on the card
    paths.update(run("mesh1", phase_mesh1, cfg, params, train_ref) or {})
    torch.cuda.empty_cache()
    paths["qlora"] = run("qlora", phase_qlora, smi)
    # the control plane's pod, the MoE and offload phases need the card
    # to themselves
    del params
    torch.cuda.empty_cache()
    paths["controlplane"] = run("controlplane", phase_controlplane, smi,
                                train_ref)
    torch.cuda.empty_cache()
    paths["moe_forward"], paths["moe_lora"] = (
        run("moe", phase_moe, smi) or (None, None))
    torch.cuda.empty_cache()
    paths["moe_int8"] = run("moe_int8", phase_moe_int8, smi)
    torch.cuda.empty_cache()
    paths["offload"], two_layer = (run("offload", phase_offload, smi)
                                   or (None, None))
    torch.cuda.empty_cache()
    paths["offload_mesh1"] = run("offload_mesh1", phase_offload_mesh1, smi,
                                 two_layer)
    torch.cuda.empty_cache()
    multi = run("mesh_multi", phase_mesh_multi)
    if multi is not None:
        paths["mesh_multi_pipeline"] = multi["pipeline"]["launches"]
    torch.cuda.empty_cache()
    fleet_multi = run("fleet_multi", phase_fleet_multi, smi)
    if fleet_multi is not None:
        paths["fleet_multi"] = fleet_multi
    torch.cuda.empty_cache()
    paths["torchcheck_profile"], paths["torchcheck_probed_fit"] = (
        run("torchcheck", phase_torchcheck, smi, timing) or (None, None))
    torch.cuda.empty_cache()
    run("seams", phase_seams, smi)
    if failures:
        print("chip_smoke: FAILED\n  " + "\n  ".join(failures),
              file=sys.stderr)
        return 1

    sources = {"flash_fwd": ("flash_fwd.cu", 83),
               "flash_bwd_dq": ("flash_bwd.cu", 279),
               "flash_bwd_dkv": ("flash_bwd.cu", 321)}
    kernels = []
    for kname, (src, line) in sources.items():
        t = timing[kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"kubeflow_rm_tpu_torch/kernels/csrc/{src}",
            "replaces": f"kubeflow_rm_tpu/ops/flash_attention.py:{line}",
            # the kernels' main path is the trainer (the engine runs
            # none of them); every path's count
            "launches": paths["train"][kname],
            "launches_by_path": {p: c[kname] for p, c in paths.items()},
            "max_abs_err": worst[kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "tflops_achieved": t["tflops_achieved"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
