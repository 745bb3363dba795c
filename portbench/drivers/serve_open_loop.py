"""Driver ``serve_open_loop``: document QA sessions offered at a fixed
rate to the port's ``ContinuousBatchingEngine`` (paged, prefix cache).

Traffic parameters (``portbench/traffic/<mix>.json``): the engine's
``slots``, ``slot_len``, ``block_size`` and ``num_blocks``; ``rate`` in
requests a second; ``sessions``: a document of ``doc_length`` tokens
asked ``asks`` questions of ``question_length`` tokens, answered in
``answer_length`` tokens (greedy, no eos), the asks ``ask_gap_mean_s``
apart on average (exponential); ``base_seed`` fixes the set of sessions
and gaps (every seed serves the same sizes and arrivals, in its own
order, with its own token ids); arrivals go on ``horizon_s`` past the
window so its last requests finish under load, waited for at most
``drain_s``; ``checked_tokens`` served tokens at least are held to the
reference; ``profile_s`` seconds from the window's middle are traced in
a traced run.

Open loop: each request is submitted when it is due, and its latency
runs from then. A request's first token and every later one count as
served when the ``step`` call that produced it returns.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from portbench import weights
from portbench.trace import Profiler


@dataclass
class Request:
    due: float
    max_new: int
    counted: bool
    prompt: list
    times: list = field(default_factory=list)
    handle: object = None


def _uniform(rng, spec):
    return int(rng.integers(spec["min"], spec["max"] + 1))


def _starts(n: int, span: float, rng) -> np.ndarray:
    """``n`` session starts filling [0, span): the gaps of a Poisson
    process as its quantiles, in the seed's order, scaled to the span."""
    g = -np.log1p(-(np.arange(n) + 0.5) / n)
    g = g[rng.permutation(n)] * span / g.sum()
    return np.concatenate([[0.0], np.cumsum(g)[:-1]])


def schedule(job: dict, vocab: int, seed: int, seconds: float) -> list:
    """The window's requests (``counted``) and those of the horizon after
    it, in due order. Every seed starts the same sessions in the window
    (and the same others after it), in its own order."""
    s = job["sessions"]
    per_s = job["rate"] / ((s["asks"]["min"] + s["asks"]["max"]) / 2)
    n_w = max(1, round(per_s * seconds))
    n_h = round(per_s * job["horizon_s"])
    base = np.random.default_rng(job["base_seed"])
    sessions = []
    for _ in range(n_w + n_h):
        asks = _uniform(base, s["asks"])
        sessions.append(dict(
            doc=_uniform(base, s["doc_length"]),
            q=[_uniform(base, s["question_length"]) for _ in range(asks)],
            a=[_uniform(base, s["answer_length"]) for _ in range(asks)],
            gaps=[0.0] + [float(base.exponential(s["ask_gap_mean_s"]))
                          for _ in range(asks - 1)]))
    rng = np.random.default_rng([seed, 2])
    order = np.concatenate([rng.permutation(n_w),
                            n_w + rng.permutation(n_h)]).astype(int)
    start = np.concatenate([_starts(n_w, seconds, rng),
                            seconds + _starts(n_h, job["horizon_s"], rng)])
    out = []
    for k, (t0, i) in enumerate(zip(start, order)):
        ses = sessions[i]
        ids = np.random.default_rng([seed, 3, k])
        doc = ids.integers(0, vocab, ses["doc"]).tolist()
        due = float(t0)
        for q, a, g in zip(ses["q"], ses["a"], ses["gaps"]):
            due += g
            out.append(Request(due=due, max_new=a, counted=due < seconds,
                               prompt=doc + ids.integers(0, vocab, q).tolist()))
    out.sort(key=lambda r: r.due)
    return out


def _bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def warmup(eng, job: dict, vocab: int) -> None:
    """One request for every prefill shape the traffic reaches: fresh
    prompts of each padding bucket, and after a document is cached, a
    suffix of each bucket (a question behind a block-aligned document).
    Returns when all have finished."""
    s = job["sessions"]
    rng = np.random.default_rng(12345)
    lo = s["doc_length"]["min"] + s["question_length"]["min"]
    hi = s["doc_length"]["max"] + s["question_length"]["max"]
    fresh = sorted({_bucket(n) for n in (lo, hi)}
                   | {b for b in (2 ** k for k in range(40)) if lo < b < hi})
    bs = job["block_size"]
    tail_lo = s["question_length"]["min"]
    tail_hi = s["question_length"]["max"] + bs - 1
    tails = sorted({_bucket(n) for n in range(tail_lo, tail_hi + 1)})
    for b in fresh:
        n = max(lo, min(hi, b))
        eng.submit(rng.integers(0, vocab, n).tolist(), max_new_tokens=2)
        eng.run()
    doc = rng.integers(0, vocab, (s["doc_length"]["min"] // bs) * bs).tolist()
    eng.submit(doc + [1], max_new_tokens=2)
    eng.run()
    for b in tails:
        eng.submit(doc + rng.integers(0, vocab, b).tolist(), max_new_tokens=2)
        eng.run()


def nearest_rank(values: list, p: float) -> float:
    v = sorted(values)
    return v[max(0, math.ceil(p * len(v)) - 1)]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run(cell, device) -> dict:
    from kubeflow_rm_tpu_torch.models.generate import (
        ContinuousBatchingEngine,
    )
    from portbench.port import model_config

    a, job = cell.arch, cell.traffic
    W = weights.draw(a, cell.seed, device)
    eng = ContinuousBatchingEngine(
        weights.nest(W), model_config(a), slots=job["slots"],
        slot_len=job["slot_len"], paged=True, block_size=job["block_size"],
        num_blocks=job["num_blocks"], prefix_cache=True)
    warmup(eng, job, a.vocab)
    reqs = schedule(job, a.vocab, cell.seed, cell.seconds)
    _sync(device)
    setup_s = time.perf_counter() - cell.t_start

    W_s = cell.seconds
    pending = deque(reqs)
    live: dict = {}
    steps = []            # (start, wall, admitted, profiled, queued)
    open_counted = sum(r.counted for r in reqs)
    hit0, prompt0 = eng.prefix_hit_tokens, eng.prompt_tokens
    prof = Profiler(lambda: _sync(device)) if cell.trace else None
    traced, profiling = None, False
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        while pending and pending[0].due <= now:
            r = pending.popleft()
            r.handle = eng.submit(r.prompt, max_new_tokens=r.max_new)
            live[id(r)] = r
        if (now >= W_s and open_counted == 0) or now >= W_s + job["drain_s"]:
            break
        if prof is not None and traced is None:
            # the stretch runs profile_s from when the profiler is up
            if not profiling and now >= W_s / 2:
                prof.start()
                profiling, since = True, time.perf_counter()
            elif profiling and time.perf_counter() - since >= job["profile_s"]:
                traced = prof.stop()
                profiling = False
        if not live:
            wait = (pending[0].due if pending else W_s + job["drain_s"]) - now
            time.sleep(min(max(wait, 0.0), 0.05))
            continue
        n0, queued = eng.prefills, eng.queue_depth
        ts = time.perf_counter()
        eng.step()
        te = time.perf_counter()
        steps.append((ts - t0, te - ts, eng.prefills != n0, profiling,
                      queued))
        for key, r in list(live.items()):
            got = len(r.handle.tokens)
            if got > len(r.times):
                r.times.extend([te - t0] * (got - len(r.times)))
            if r.handle.done:
                del live[key]
                open_counted -= r.counted
    end = time.perf_counter() - t0
    if profiling:
        traced = prof.stop()
    hits = eng.prefix_hit_tokens - hit0
    prompts = eng.prompt_tokens - prompt0

    counted = [r for r in reqs if r.counted]
    ttft = [(r.times[0] if r.times else end) - r.due for r in counted]
    itl = [b - a for r in counted for a, b in zip(r.times, r.times[1:])]
    finished = [r for r in counted if r.handle is not None and r.handle.done]
    readings = {
        "decode_step_s": [w for (s, w, adm, pr, _) in steps
                          if s < W_s and not adm and not pr],
        "prefix_hits": hits, "prompt_tokens": prompts, "trace": traced,
    }
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    served = [(r.prompt, list(r.handle.tokens)) for r in finished]
    del eng, W, live, pending
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    checks, ok, detail = check(cell, device, served)
    return {
        "end_to_end": {
            "serve_ttft_p90_ms": 1e3 * nearest_rank(ttft, 0.90),
            "serve_itl_p95_ms": 1e3 * nearest_rank(itl, 0.95),
            "setup_s": setup_s},
        "readings": readings, "trace": traced,
        "correct": ok and len(finished) == len(counted),
        "attempted": len(counted), "failed": len(counted) - len(finished),
        "memory_peak_bytes": peak, "checks": checks,
        "detail": dict(detail, steps=len(steps), window_end_s=end,
                       ttft_p50_ms=1e3 * statistics.median(ttft),
                       backlog_slope_per_s=backlog_slope(steps, W_s),
                       lateness_s=max(0.0, end - W_s)),
    }


def backlog_slope(steps: list, until: float) -> float:
    """Least-squares slope of the queued requests over the window's
    steps, in requests a second: above 0 the backlog grows."""
    pts = [(s[0], s[4]) for s in steps if s[0] < until]
    if len(pts) < 2:
        return 0.0
    mt = sum(t for t, _ in pts) / len(pts)
    mq = sum(q for _, q in pts) / len(pts)
    var = sum((t - mt) ** 2 for t, _ in pts)
    return sum((t - mt) * (q - mq) for t, q in pts) / var if var else 0.0


def sample(served: list, seed: int, tokens: int) -> list:
    """The requests held to the reference: the longest, then others in
    the seed's order until ``tokens`` served tokens are covered."""
    if not served:
        return []
    order = sorted(range(len(served)),
                   key=lambda i: -(len(served[i][0]) + len(served[i][1])))
    pick, n = [order[0]], len(served[order[0]][1])
    rest = np.random.default_rng([seed, 4]).permutation(order[1:]).tolist()
    for i in rest:
        if n >= tokens:
            break
        pick.append(i)
        n += len(served[i][1])
    return [served[i] for i in pick]


def check(cell, device, served: list, precision: str = "fp32"):
    """Hold the sampled requests' served tokens to the reference."""
    from portbench import compare
    from portbench.reference import serve as ref_serve

    a = cell.arch
    picked = sample(served, cell.seed, cell.traffic["checked_tokens"])
    W = weights.draw(a, cell.seed, device)
    widest, n = 0.0, 0
    for prompt, toks in picked:
        lg = ref_serve.logits(W, a, prompt, toks, precision)
        widest = max(widest, float(ref_serve.gaps(lg, toks).max()))
        n += len(toks)
    del W
    ok, checks = compare.judge({"logit_gap": widest if picked
                                else float("nan")}, cell.limits)
    return checks, ok, {"checked_requests": len(picked),
                        "checked_tokens": n}
