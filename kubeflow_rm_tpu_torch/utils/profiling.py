"""Profiling hooks (counterpart of ``kubeflow_rm_tpu/utils/profiling.py``).

Two layers:
- **Device**: ``trace()`` wraps ``torch.profiler`` (CPU and, where a
  card is present, CUDA activity) so a notebook user captures a trace of
  a training interval and views it in Perfetto or ``chrome://tracing``;
  ``annotate()`` names host regions (spans) in that trace, and on the
  card also in an NVTX range. A span costs one flag check while no
  profiler runs and no observer is installed (``observe``). ``SPANS``
  names the spans of the port's training path.
- **Control plane (host)**: ``profile_wsgi`` adds on-demand cProfile
  capture around a WSGI app for the "why is this request slow"
  question; ``PhaseRecorder`` aggregates named wall-clock phases, and
  ``observe(recorder.phase)`` feeds it every span's host wall.
"""

from __future__ import annotations

import contextlib
import cProfile
import io
import itertools
import os
import pstats
import time

_trace_ids = itertools.count()


class PhaseRecorder:
    """Named wall-clock phases of a repeated operation, aggregated into
    per-phase percentiles (provision latency by phase: POST→CR,
    CR→StatefulSet, StatefulSet→Pods, Pods→Ready).

    ``record(phase, seconds)`` takes externally-measured durations;
    ``phase(name)`` times a block inline. ``summary()`` returns
    per-phase count/p50/p95/p99/max in milliseconds."""

    def __init__(self):
        self._samples: dict[str, list[float]] = {}

    def record(self, phase: str, seconds: float) -> None:
        self._samples.setdefault(phase, []).append(float(seconds))

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)

    def merge(self, other: "PhaseRecorder") -> None:
        for name, vals in other._samples.items():
            self._samples.setdefault(name, []).extend(vals)

    @staticmethod
    def _pct(vals: list[float], q: float) -> float:
        # linear interpolation between closest ranks (numpy's default
        # percentile method)
        s = sorted(vals)
        if len(s) == 1:
            return s[0]
        pos = min(max(q, 0.0), 1.0) * (len(s) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (pos - lo)

    def summary(self) -> dict[str, dict]:
        out = {}
        for name, vals in self._samples.items():
            out[name] = {
                "count": len(vals),
                "p50_ms": round(self._pct(vals, 0.5) * 1e3, 1),
                "p95_ms": round(self._pct(vals, 0.95) * 1e3, 1),
                "p99_ms": round(self._pct(vals, 0.99) * 1e3, 1),
                "max_ms": round(max(vals) * 1e3, 1),
            }
        return out


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the enclosed region into a
    Chrome trace file under ``logdir``:

        with profiling.trace("/home/jovyan/traces") as prof:
            state, metrics = step(state, batch)
        prof.trace_path        # the JSON file written

    CUDA activity (kernels, copies) is recorded where a card is present;
    the card's queue is drained before the trace stops, so every kernel
    the region launched is in it. Yields the ``torch.profiler.profile``
    (``key_averages()``, ``events()``); ``trace_path`` is set on it once
    the file is written.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir,
                        f"trace.{os.getpid()}.{next(_trace_ids)}.json")
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if cuda:
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    prof.trace_path = path


#: the spans the port's training path and its set-up open, by name:
#: what ``portbench.spans`` attributes a trace's kernels and idle to
SPANS = frozenset({
    "fit.data", "fit.to_device", "fit.first_step",
    "train.forward", "train.backward", "train.optimizer",
    "train.microbatch",
    "embed", "block.attn", "block.mlp", "head", "loss",
    "moe.route", "moe.dispatch", "moe.experts", "moe.combine",
    "remat.replay",
    "kernels.load", "init_train_state", "make_train_step",
})

# one shared, reentrant null context serves every span while nothing
# listens (the pattern of ``analysis.torchcheck.hostsync.region``)
_NULL = contextlib.nullcontext()
#: ``torch.autograd.profiler`` and the span hooks, bound at the first
#: span (this module is imported by torch-free control-plane processes)
_torch = None
#: installed ``observe`` hooks: name -> a context manager for the span
_observers: tuple = ()


class _Torch:
    def __init__(self):
        import torch
        from torch.autograd import profiler

        self.profiler = profiler
        # a range on the profiler's own clock that no dispatch mode (the
        # remat policy's) sees: it dispatches no op
        self.fast = torch._C._profiler._RecordFunctionFast
        self.nvtx = torch.cuda.nvtx if torch.cuda.is_available() else None


def annotate(name: str):
    """A named span of host work, nested like the calls it wraps.

    While a ``torch.profiler`` profile is active the span is a range in
    its trace, on the clock of the CUDA events, and on the card an NVTX
    range; every ``observe`` hook installed sees it too. Otherwise (the
    run that is not traced) it is a shared null context after one flag
    check."""
    t = _torch or _bind()
    if not (t.profiler._is_profiler_enabled or _observers):
        return _NULL
    return _Span(name, t)


def _bind():
    global _torch
    _torch = _Torch()
    return _torch


class _Span:
    __slots__ = ("name", "range", "nvtx", "hooks")

    def __init__(self, name: str, t: _Torch):
        self.name = name
        on = t.profiler._is_profiler_enabled
        self.range = t.fast(name) if on else None
        self.nvtx = t.nvtx if on else None
        self.hooks = [h(name) for h in _observers]

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
            if self.nvtx is not None:
                self.nvtx.range_push(self.name)
        for h in self.hooks:
            h.__enter__()
        return self

    def __exit__(self, *exc):
        for h in reversed(self.hooks):
            h.__exit__(*exc)
        if self.range is not None:
            if self.nvtx is not None:
                self.nvtx.range_pop()
            self.range.__exit__(*exc)
        return False


@contextlib.contextmanager
def observe(hook):
    """Install ``hook(name) -> context manager`` around every span
    opened while the block runs, on any thread: the backward on the
    card runs on the autograd engine's own threads, and a set-up part
    such as ``kernels.load`` may open there. ``observe(recorder.phase)``
    records each span's host wall into a ``PhaseRecorder``; the cost
    model counts FLOPs by span, and takes only its own thread's. Hooks
    nest; none is called once the block ends."""
    global _observers
    _observers = _observers + (hook,)
    try:
        yield hook
    finally:
        i = max(i for i, h in enumerate(_observers) if h is hook)
        _observers = _observers[:i] + _observers[i + 1:]


@contextlib.contextmanager
def profile_wsgi(sort: str = "cumulative", limit: int = 30):
    """cProfile a block of WSGI handling; yields a StringIO that holds
    the stats table after exit."""
    out = io.StringIO()
    prof = cProfile.Profile()
    prof.enable()
    try:
        yield out
    finally:
        prof.disable()
        pstats.Stats(prof, stream=out).sort_stats(sort).print_stats(limit)
