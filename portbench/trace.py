"""The traced stretch of a run: ``torch.profiler`` over CPU and CUDA.

A copy of ``chip_smoke.device_profile``'s reading (the union of the
device's kernel intervals against the host's wall), extended with what
the per-layer readers and the result's ``breakdown`` need: every device
operation's total time and launch count, and the idle gaps between
device work named by the innermost host operation that spans each gap.
"""

from __future__ import annotations

import bisect
import time


class Traced:
    """What one profiled stretch showed."""

    def __init__(self):
        self.wall_s = 0.0
        self.busy_s = 0.0
        self.ops: dict[str, list] = {}      # name -> [seconds, count]
        self.gaps: dict[str, float] = {}    # host op -> idle seconds

    def kernel(self, pattern: str) -> tuple[float, int]:
        """Seconds and launches of the device operations whose name holds
        ``pattern``."""
        s = n = 0
        for name, (t, c) in self.ops.items():
            if pattern in name:
                s += t
                n += c
        return s, n

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[_short(n), t] for n, (t, _) in ops],
                "idle_gaps": [[_short(n), t] for n, t in gaps]}


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


class Profiler:
    """``start`` and ``stop`` around a stretch of work (they may be
    called from inside a loop the benchmark does not own); ``stop``
    waits for the device with ``sync`` and returns the ``Traced``."""

    def __init__(self, sync):
        self.sync, self.prof, self.t0 = sync, None, None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> Traced:
        self.sync()
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        out = _read(self.prof)
        out.wall_s = wall
        return out


def idle_pct(t: Traced | None) -> float | None:
    """The device's idle share of a traced stretch, in percent."""
    if t is None or t.wall_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)


def _read(prof) -> Traced:
    import torch

    out = Traced()
    dev, host = [], []
    for ev in prof.events():
        r = ev.time_range
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((r.start, r.end))
            acc = out.ops.setdefault(ev.name, [0.0, 0])
            acc[0] += (r.end - r.start) * 1e-6
            acc[1] += 1
        elif r.end > r.start:
            host.append((r.start, r.end, ev.name))
    busy, last, spans = 0.0, None, []
    for start, end in sorted(dev):
        if last is None or start > last:
            spans.append([start, end])
        else:
            spans[-1][1] = max(spans[-1][1], end)
        last = spans[-1][1]
    busy = sum(e - s for s, e in spans)
    out.busy_s = busy * 1e-6
    host.sort()
    starts = [s for s, _, _ in host]
    for (_, a), (b, _) in zip(spans, spans[1:]):
        # the innermost host op spanning the gap's middle: of those that
        # started before it and end after it, the one that started last
        mid = (a + b) / 2
        key = "(no host op)"
        for i in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 4001), -1):
            if host[i][1] >= mid:
                key = host[i][2]
                break
        out.gaps[key] = out.gaps.get(key, 0.0) + (b - a) * 1e-6
    return out
