"""The training loop — ``fit()`` (counterpart of
``kubeflow_rm_tpu/training/loop.py``).

- **Few syncs.** PyTorch queues kernels on the card and returns; the
  loop reads metrics (which waits for the card) only once after the
  first step, so start-up never pollutes the interval throughput, and
  at log boundaries.
- **MFU in the loop** from the port's ``utils.flops`` (6N + attention,
  4N with a frozen base; a mixture's N its router and top-k experts)
  against the card's bf16 peak; 0 on a device the peak table does not
  know (the CPU).
- **Spans** (``utils.profiling.annotate``, free unless a profiler runs
  or an observer is installed): ``fit.data`` and ``fit.to_device`` each
  step, and the set-up's ``make_train_step`` and ``fit.first_step``
  (the first step to the sync after it).
- **Checkpoint/resume** via ``training.checkpoint``: ``fit`` restores
  the latest step when the directory has one, fast-forwards the data
  past the batches those steps consumed, saves every
  ``checkpoint_every`` steps and at the end.
- **Mesh** (``fit(..., mesh=)``): every rank draws the same global
  batches and trains on its share (``shard_batch``) of its shards
  (``shard_state``); the metrics are global, logged and handed to the
  callbacks on rank 0; MFU divides by the world's peak, as JAX's
  ``n_dev`` does.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import torch
import torch.distributed as dist

from kubeflow_rm_tpu_torch.analysis.torchcheck import hostsync as _hostsync
from kubeflow_rm_tpu_torch.training.checkpoint import Checkpointer
from kubeflow_rm_tpu_torch.training.data import to_device
from kubeflow_rm_tpu_torch.training.train import (
    TrainConfig, TrainState, init_train_state, make_train_step,
    shard_batch, shard_state,
)
from kubeflow_rm_tpu_torch.utils.flops import (
    device_peak_flops, train_flops_per_token,
)
from kubeflow_rm_tpu_torch.utils.profiling import annotate

log = logging.getLogger("kubeflow_rm_tpu_torch.train")


@dataclass(frozen=True)
class LoopConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 0          # 0 = only final
    checkpoint_dir: str | None = None  # None = no checkpointing
    max_to_keep: int = 3
    seed: int = 0
    grad_accum: int = 1                # microbatches per optimizer step
    # "none" | "optimizer" | None (follow cfg.optim.offload): the
    # streamed host-offload arm of make_train_step
    offload: str | None = None


@dataclass
class LoopMetrics:
    """One log-interval record, also handed to callbacks."""
    step: int
    loss: float
    grad_norm: float
    tokens_per_sec: float
    mfu_pct: float
    step_time_ms: float
    # offload arm only (0.0 on the on-card arm): ms the stream spent
    # blocked on device-to-host transfers, and the share of the streaming
    # phase not blocked (how much of the transfer the lookahead hid)
    offload_transfer_ms: float = 0.0
    offload_overlap_frac: float = 0.0


def _device_of(state: TrainState) -> torch.device:
    return state.params["embed"]["tokens"].device


def fit(cfg: TrainConfig, data: Iterable[dict], loop: LoopConfig = LoopConfig(),
        *, state: TrainState | None = None, batch_keys: tuple | None = None,
        callbacks: tuple[Callable[[LoopMetrics], Any], ...] = (),
        device: str | torch.device | None = None, mesh=None,
        ) -> tuple[TrainState, list[LoopMetrics]]:
    """Train for ``loop.total_steps`` total steps (counting restored
    progress); returns the final state and the per-interval metrics.

    ``data`` yields batches of ``{"tokens", "labels", ...}`` (numpy
    arrays or tensors); ``batch_keys`` defaults to the first batch's
    keys. Without ``state`` the loop restores the latest checkpoint or
    draws fresh parameters from ``loop.seed`` on ``device`` (default the
    card). On resume the iterator skips the batches the restored steps
    consumed, so a deterministic stream replays exactly what an
    uninterrupted run would have seen.

    ``mesh``: every rank calls with the same arguments; ``state`` (if
    given) is the global state or this rank's, and the returned state is
    this rank's (``gather_state`` makes it whole). Without ``state``
    each rank restores or draws only its slices, so no rank holds the
    global state: pass a rank's own state (``init_train_state(...,
    mesh=)``) rather than a global one to keep it so.
    """
    from kubeflow_rm_tpu_torch.device import default_device

    if loop.log_every < 1:
        raise ValueError(f"log_every must be >= 1, got {loop.log_every}")
    ckpt = (Checkpointer(loop.checkpoint_dir, max_to_keep=loop.max_to_keep)
            if loop.checkpoint_dir else None)
    lead = mesh is None or dist.get_rank() == 0
    resumed = False
    if state is None:
        dev = default_device(device)
        state = ckpt.restore(cfg, mesh, device=dev) if ckpt else None
        if state is not None:
            resumed = True
            if lead:
                log.info("resumed from step %d", state.step)
        else:
            gen = torch.Generator(device=dev).manual_seed(loop.seed)
            state = init_train_state(cfg, gen, device=dev, mesh=mesh)
    if mesh is not None:
        state = shard_state(state, mesh)
    dev = _device_of(state)

    data = iter(data)
    if resumed:
        for _ in range(min(state.step, loop.total_steps)):
            try:
                next(data)
            except StopIteration:
                break
    try:
        with annotate("fit.data"):
            first = next(data)
    except StopIteration:
        log.warning("data exhausted before step %d; nothing to do",
                    state.step)
        if ckpt:
            ckpt.close()
        return state, []
    if batch_keys is None:
        batch_keys = tuple(first.keys())
    with annotate("make_train_step"):
        step_fn = make_train_step(cfg, state, grad_accum=loop.grad_accum,
                                  offload=loop.offload, mesh=mesh)
    peak = device_peak_flops(dev)
    world = 1 if mesh is None else mesh.size()

    history: list[LoopMetrics] = []
    start = state.step
    total = loop.total_steps

    def launch(state, batch):
        host = {k: batch[k] for k in batch_keys}
        with annotate("fit.to_device"):
            if mesh is not None:
                host = shard_batch(host, mesh)
            dev_batch = to_device(host, dev)
        # hot region: the step must not wait on the card — the
        # deliberate metric reads below run outside it
        # (KFRM_HOSTSYNC_PROBE records any implicit sync in here)
        with _hostsync.region("train.step"):
            return step_fn(state, dev_batch)

    t0 = time.perf_counter()
    interval_start = start
    batch = first
    try:
        for i in range(start, total):
            now = i + 1
            rows, batch_len = tuple(batch["tokens"].shape)
            if now == start + 1:
                # set-up's last part: the first step, to one sync after
                # it, so start-up (kernel builds, allocator warm-up)
                # stays out of the interval numbers
                with annotate("fit.first_step"):
                    state, metrics = launch(state, batch)
                    with _hostsync.sanctioned("fit.first_step"):
                        metrics["loss"].item()
                t0 = time.perf_counter()
                interval_start = now
            else:
                state, metrics = launch(state, batch)
            if now < total:
                try:
                    with annotate("fit.data"):
                        batch = next(data)
                except StopIteration:
                    log.warning("data exhausted at step %d (< total_steps "
                                "%d); stopping", now, total)
                    total = now
            if now % loop.log_every == 0 or now == total:
                m = {k: float(v) for k, v in metrics.items()}  # syncs
                dt = time.perf_counter() - t0
                steps_done = now - interval_start
                tokens = steps_done * rows * batch_len
                tps = tokens / dt if dt > 0 and steps_done else 0.0
                flops = tps * train_flops_per_token(
                    cfg.model, batch_len,
                    frozen_base=cfg.optim.train_only is not None)
                rec = LoopMetrics(
                    step=now, loss=m["loss"], grad_norm=m["grad_norm"],
                    tokens_per_sec=tps,
                    mfu_pct=100.0 * flops / (world * peak) if peak else 0.0,
                    step_time_ms=1e3 * dt / max(steps_done, 1),
                    offload_transfer_ms=m.get("offload_transfer_ms", 0.0),
                    offload_overlap_frac=m.get("offload_overlap_frac", 0.0))
                history.append(rec)
                if lead:
                    log.info("step %d loss %.4f %.0f tok/s mfu %.1f%%",
                             rec.step, rec.loss, rec.tokens_per_sec,
                             rec.mfu_pct)
                    for cb in callbacks:
                        cb(rec)
                t0 = time.perf_counter()
                interval_start = now
            if (ckpt and loop.checkpoint_every
                    and now % loop.checkpoint_every == 0):
                ckpt.save(state, mesh=mesh)
            if now >= total:
                break
    finally:
        if ckpt:
            ckpt.save(state, mesh=mesh)
            ckpt.close()
    return state, history
