"""Profiling hooks (counterpart of ``kubeflow_rm_tpu/utils/profiling.py``).

Two layers:
- **Device**: ``trace()`` wraps ``torch.profiler`` (CPU and, where a
  card is present, CUDA activity) so a notebook user captures a trace of
  a training interval and views it in Perfetto or ``chrome://tracing``;
  ``annotate()`` names host regions in that trace, and on the card also
  in an NVTX range.
- **Control plane (host)**: ``profile_wsgi`` adds on-demand cProfile
  capture around a WSGI app for the "why is this request slow"
  question; ``PhaseRecorder`` aggregates named wall-clock phases.
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


@contextlib.contextmanager
def annotate(name: str):
    """A named host region in the trace (``record_function``) and, on
    the card, an NVTX range of the same name. Regions nest."""
    import torch

    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


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
