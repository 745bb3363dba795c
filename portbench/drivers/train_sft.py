"""Driver ``train_sft``: a LoRA fine-tune of packed documents through the
port's ``training.loop.fit``, the function ``finetune.py`` runs.

Traffic parameters (``portbench/traffic/<mix>.json``): ``rows`` ×
``seq_len`` tokens a step; document lengths log-uniform in
``doc_length`` [min, max], the last document of a row cut at the row's
end; ``layouts`` row layouts drawn once from ``layout_seed`` (every
seed runs the same layouts, in its own order, with its own token ids);
the adapters (``lora_rank``, ``lora_targets``, ``lora_alpha``), the
``optimizer``, ``z_loss`` and ``remat_policy``; ``checked_steps`` run
in set-up and are held to the reference; ``profiled_steps`` follow the
window in a traced run.

Set-up builds one training state from the seed (weights drawn on the
device, ``init_train_state``) and drives it through the checked steps
with ``fit``; the window hands the same state to ``fit`` again, with a
data iterator that stops at the window's end and no checkpoint.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import compare, flops, weights
from portbench.trace import Profiler

IGNORE = -100


def layouts(job: dict) -> list:
    """``layouts`` batches, each ``rows`` lists of document lengths that
    fill ``seq_len`` exactly (seed-independent)."""
    rng = np.random.default_rng(job["layout_seed"])
    lo, hi = (math.log(job["doc_length"]["min"]),
              math.log(job["doc_length"]["max"]))
    out = []
    for _ in range(job["layouts"]):
        rows = []
        for _ in range(job["rows"]):
            row, left = [], job["seq_len"]
            while left:
                n = min(left, int(round(math.exp(rng.uniform(lo, hi)))))
                row.append(n)
                left -= n
            rows.append(row)
        out.append(rows)
    return out


def pack(docs_by_row: list, seq_len: int) -> dict:
    """The packed layout the port trains on (``pack_documents``'s):
    tokens, next-token labels inside each document (the last token of a
    document has none), positions from 0 in each document, and segment
    ids from 1, one per document."""
    out = {k: np.zeros((len(docs_by_row), seq_len), np.int32)
           for k in ("tokens", "labels", "positions", "segments")}
    seg = 1
    for r, docs in enumerate(docs_by_row):
        off = 0
        for d in docs:
            n = len(d)
            out["tokens"][r, off:off + n] = d
            out["labels"][r, off:off + n - 1] = d[1:]
            out["labels"][r, off + n - 1] = IGNORE
            out["positions"][r, off:off + n] = np.arange(n)
            out["segments"][r, off:off + n] = seg
            seg += 1
            off += n
    return out


class Feed:
    """Step ``i``'s batch for ``seed``: a layout chosen by the seed's
    order over the fixed layouts, documents in the seed's order, token
    ids drawn from (seed, i)."""

    def __init__(self, job: dict, vocab: int, seed: int):
        self.job, self.vocab, self.seed = job, vocab, seed
        self.layouts = layouts(job)
        self.order = np.random.default_rng([seed, 0]).permutation(
            len(self.layouts))

    def docs(self, i: int) -> tuple[list, list]:
        """(documents by row, document lengths by row) of step ``i``."""
        rows = self.layouts[self.order[i % len(self.layouts)]]
        rng = np.random.default_rng([self.seed, 1, i])
        lengths = [[int(n) for n in rng.permutation(r)] for r in rows]
        docs = [[rng.integers(0, self.vocab, n, dtype=np.int64) for n in r]
                for r in lengths]
        return docs, lengths

    def batch(self, i: int) -> tuple[dict, list]:
        docs, lengths = self.docs(i)
        return pack(docs, self.job["seq_len"]), lengths


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _adapters(params_flat: dict) -> dict:
    return {p: t for p, t in params_flat.items() if "_lora_" in p}


def build(cell, device):
    """The program's training state for ``cell``'s seed, and its feed."""
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.train import (
        TrainConfig, init_train_state,
    )
    from portbench.port import model_config

    a, job = cell.arch, cell.traffic
    W = weights.draw(a, cell.seed, device, lora_rank=job["lora_rank"],
                     lora_targets=tuple(job["lora_targets"]))
    cfg = TrainConfig(
        model=model_config(a, remat=True, remat_policy=job["remat_policy"],
                           lora_alpha=job["lora_alpha"]),
        optim=OptimConfig(train_only="lora", **job["optimizer"]),
        z_loss=job["z_loss"])
    state = init_train_state(cfg, params=weights.nest(W))
    return cfg, state, W, Feed(job, a.vocab, cell.seed)


def checked_steps(cell, cfg, state, W, feed) -> dict:
    """The set-up's steps through ``fit``: the objective of each, the
    first step's gradient norm a leaf as the optimizer takes it in (from
    Adam's second moment after one step, ``nu = (1 - b2) g^2`` of the
    clipped gradient, and the global norm ``fit`` reports) and each
    leaf's change."""
    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit

    n = cell.traffic["checked_steps"]
    opt = cell.traffic["optimizer"]
    p0 = {p: t.detach().float().clone() for p, t in _adapters(W).items()}
    state, h1 = fit(cfg, (feed.batch(i)[0] for i in range(1)),
                    LoopConfig(total_steps=1, log_every=1), state=state)
    # the moments hold the clipped gradient; the optimizer's input is it
    # times the global norm over the clip, where the clip acted
    unclip = max(1.0, h1[0].grad_norm / opt["grad_clip"])
    g1 = {p: unclip * math.sqrt(float(state.opt_state.nu[p].float().sum())
                                / (1 - opt["b2"]))
          for p in p0}
    state, h2 = fit(cfg, (feed.batch(i)[0] for i in range(1, n)),
                    LoopConfig(total_steps=n, log_every=1), state=state)
    change = {p: float((W[p].detach().float() - p0[p]).norm()) for p in p0}
    return {"losses": [h.loss for h in h1 + h2], "grad_norms": g1,
            "global_grad_norm": h1[0].grad_norm, "change_norms": change}


def reference(cell, device, precision: str = "fp32", rows: slice = slice(None)):
    """The plain reference over the checked steps, from weights drawn
    again; ``rows`` keeps part of each batch (a fault's reading)."""
    from portbench.reference import train as ref_train

    a, job = cell.arch, cell.traffic
    W = weights.draw(a, cell.seed, device, lora_rank=job["lora_rank"],
                     lora_targets=tuple(job["lora_targets"]))
    feed = Feed(job, a.vocab, cell.seed)
    batches = [feed.docs(i)[0][rows] for i in range(job["checked_steps"])]
    out = ref_train.train(W, a, _adapters(W), batches, job, precision)
    del W
    return out


def free():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run(cell, device) -> dict:
    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit

    job = cell.traffic
    cfg, state, W, feed = build(cell, device)
    prog = checked_steps(cell, cfg, state, W, feed)
    _sync(device)
    setup_s = time.perf_counter() - cell.t_start

    # the window: the same state, fit until the data stops at the end
    first = job["checked_steps"]
    window_rows: list = []

    def timed_batches(stop):
        i = first
        while time.perf_counter() < stop:
            b, lengths = feed.batch(i)
            window_rows.append(lengths)
            i += 1
            yield b

    t0 = time.perf_counter()
    state, hist = fit(cfg, timed_batches(t0 + cell.seconds),
                      LoopConfig(total_steps=10**9, log_every=10**9),
                      state=state)
    _sync(device)
    window_s = time.perf_counter() - t0
    steps = len(window_rows)
    tokens = steps * job["rows"] * job["seq_len"]
    last_loss = hist[-1].loss if hist else float("nan")

    readings = {"window_s": window_s, "tokens": tokens,
                "model_flops": sum(flops.train_step_flops(
                    cell.arch, r, job["lora_rank"], job["lora_targets"])
                    for r in window_rows),
                "arch": cell.arch}
    traced = None
    if cell.trace:
        # profiled steps after the window: from the sync that follows
        # fit's first step, so the stretch holds steady steps only
        k = state.step
        prof = Profiler(lambda: _sync(device))
        prof_rows: list = []

        def traced_batches():
            for j in range(1 + job["profiled_steps"]):
                b, lengths = feed.batch(k + j)
                if j == 1:
                    prof.start()
                if j >= 1:
                    prof_rows.append(lengths)
                yield b

        state, _ = fit(cfg, traced_batches(),
                       LoopConfig(total_steps=k + 1 + job["profiled_steps"],
                                  log_every=10**9), state=state)
        traced = prof.stop()
        readings.update(trace=traced, flash_rows=prof_rows)

    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    del state, W, hist, feed
    free()
    ref = reference(cell, device)
    numbers = compare.train_numbers(prog, ref)
    ok, checks = compare.judge(numbers, cell.limits)
    return {
        "end_to_end": {"train_tokens_per_s": tokens / window_s,
                       "setup_s": setup_s},
        "readings": readings, "trace": traced,
        "correct": ok and math.isfinite(last_loss) and steps > 0,
        "attempted": steps, "failed": 0 if math.isfinite(last_loss)
        else steps, "memory_peak_bytes": peak, "checks": checks,
        "detail": {"numbers": numbers, "program": prog, "reference": ref,
                   "window_steps": steps},
    }
