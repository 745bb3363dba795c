"""The program's spans in a traced stretch: which span launched each
kernel, and which span the host was in over each idle gap.

The program names its parts with ``utils.profiling.annotate`` (a range
in the ``torch.profiler`` trace while a profile runs). ``attribute``
reads ``prof.events()``:

- A kernel takes the spans open over the host op that launched it
  (the launch/kernel correlation the profiler keeps: ``event.kernels``
  of the first host event with the launch's correlation id), walking
  up the host op's parents on its own thread.
- A kernel launched under a backward node (an event with a forward
  thread and a sequence number) takes, besides the spans opened inside
  the node, the spans of the forward op with the same sequence number
  on the forward thread. Forward ops that ``remat.replay`` runs again
  are forward ops too: their kernels' phase is ``replay``.
- An idle gap of the device (the union of its intervals, as
  ``portbench.trace`` computes it) takes the innermost host op open
  over its midpoint on any thread, the one that started last, and that
  op's spans by the same rules.

Kernel seconds are the device operations' summed durations, as
``Traced.ops`` sums them. From them come three readings: the share of
kernel seconds under ``moe.route``, ``moe.dispatch`` or ``moe.combine``
in any phase (``moe_dispatch``); the share launched while
``remat.replay`` is open (``remat_replay``); the idle seconds of gaps
whose host op runs inside ``remat.replay``, over the traced wall
(``replay_idle``).

Run on the chip, it traces a cell's steps after a warm-up, as the
benchmark's traced run takes them, and prints one JSON line (the
readings, the spans' device and idle seconds, each top device
operation's launching span and host op, and the set-up by part):

    python3 -m portbench.spans --workload <cell> --seed <n>
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

from kubeflow_rm_tpu_torch.utils.profiling import SPANS

MOE_DISPATCH = frozenset({"moe.route", "moe.dispatch", "moe.combine"})
REPLAY = "remat.replay"
NONE = "(no span)"
#: steps before the traced ones, and traced stretches of a cell's
#: ``profiled_steps`` each (their walls: the spans' cost when traced)
WARM, REPEAT = 2, 3


class Spans:
    """What ``attribute`` found in one traced stretch (seconds)."""

    def __init__(self):
        self.kernel_s = 0.0        # every device op, as Traced.ops sums
        self.busy_s = 0.0          # the union of device intervals
        self.idle_s = 0.0          # the gaps between them
        self.linked_s = 0.0        # kernel seconds with a launching op
        self.spanned_s = 0.0       # ... and a span over it
        self.moe_dispatch_s = 0.0
        self.replay_s = 0.0
        self.replay_idle_s = 0.0
        self.device: dict[str, float] = defaultdict(float)  # key -> s
        self.idle: dict[str, float] = defaultdict(float)    # key -> s
        # device op -> (span key, launching host op) -> seconds
        self.callers: dict[str, dict] = defaultdict(lambda: defaultdict(
            float))
        self.opened: dict[str, int] = defaultdict(int)      # span -> n
        self.on_device = 0   # device events named as a span (none: the
        #                      spans are host ranges, not GPU annotations)

    def pct(self, wall_s: float) -> dict:
        k = self.kernel_s or float("nan")
        return {"moe_dispatch": 100.0 * self.moe_dispatch_s / k,
                "remat_replay": 100.0 * self.replay_s / k,
                "replay_idle": (100.0 * self.replay_idle_s / wall_s
                                if wall_s > 0 else None),
                "unattributed": 100.0 * (1.0 - self.spanned_s / k)}

    def table(self, top: int = 15) -> list:
        """The spans' [key, device s, idle s], the most time first."""
        keys = set(self.device) | set(self.idle)
        rows = sorted(keys, key=lambda k: -(self.device.get(k, 0.0)
                                            + self.idle.get(k, 0.0)))
        return [[k, self.device.get(k, 0.0), self.idle.get(k, 0.0)]
                for k in rows[:top]]

    def callers_of(self, ops: int = 12, top: int = 4) -> dict:
        """The ``ops`` costliest device ops: each one's launching
        [span key, host op, seconds], the most first."""
        total = {n: sum(v.values()) for n, v in self.callers.items()}
        out = {}
        for name in sorted(total, key=lambda n: -total[n])[:ops]:
            rows = sorted(self.callers[name].items(), key=lambda kv: -kv[1])
            out[name[:120]] = [[k, op, s] for (k, op), s in rows[:top]]
        return out


def _is_backward_node(e) -> bool:
    return bool(e.fwd_thread) and e.sequence_nr >= 0


class _Chains:
    """Each host event's spans (outer first) and phase, memoised."""

    def __init__(self, host):
        self.forward = {}
        for e in host:
            if e.sequence_nr >= 0 and not _is_backward_node(e):
                self.forward.setdefault((e.sequence_nr, e.thread), e)
        self.memo: dict[int, tuple] = {}

    def of(self, e) -> tuple[tuple, str]:
        """(spans outer to inner, phase): ``forward``, ``replay`` (under
        ``remat.replay`` on the launching thread) or ``backward``."""
        hit = self.memo.get(id(e))
        if hit is not None:
            return hit
        inner, x, base, phase = [], e, (), "forward"
        while x is not None:
            if x.name in SPANS:
                inner.append(x.name)
            if _is_backward_node(x):
                f = self.forward.get((x.sequence_nr, x.fwd_thread))
                base = self.of(f)[0] if f is not None else ()
                phase = "backward"
                break
            x = x.cpu_parent
        if REPLAY in inner:
            phase = "replay"
        out = (base + tuple(reversed(inner)), phase)
        self.memo[id(e)] = out
        return out


def _key(chain: tuple, phase: str) -> str:
    if not chain:
        return NONE
    return chain[-1] if phase == "forward" else f"{chain[-1]} ({phase})"


def attribute(events) -> Spans:
    """The spans of a traced stretch from ``prof.events()``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out = Spans()
    dev, host = [], []
    for e in events:
        r = e.time_range
        if e.device_type == cuda:
            dev.append((r.start, r.end))
            out.kernel_s += (r.end - r.start) * 1e-6
            out.on_device += e.name in SPANS
        else:
            host.append(e)
            if e.name in SPANS:
                out.opened[e.name] += 1
    chains = _Chains(host)

    # the profiler ties a kernel to every host event with its launching
    # op's correlation id, and its own stall events ("Command Buffer
    # Full") carry the id of the op they interrupt: the op, the first
    # of them to start, launched it
    launcher: dict = {}
    for e in host:
        if e.kernels and (e.id not in launcher or e.time_range.start
                          < launcher[e.id].time_range.start):
            launcher[e.id] = e
    for e in launcher.values():
        chain, phase = chains.of(e)
        key = _key(chain, phase)
        for k in e.kernels:
            s = k.duration * 1e-6
            out.device[key] += s
            out.callers[k.name][(key, e.name)] += s
            out.linked_s += s
            if chain:
                out.spanned_s += s
            if MOE_DISPATCH & set(chain):
                out.moe_dispatch_s += s
            if phase == "replay":
                out.replay_s += s

    busy = []
    for start, end in sorted(dev):
        if busy and start <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], end)
        else:
            busy.append([start, end])
    out.busy_s = sum(b - a for a, b in busy) * 1e-6
    by_thread = defaultdict(list)
    for e in host:
        if e.time_range.end > e.time_range.start:
            by_thread[e.thread].append(e)
    starts = {}
    for t, evs in by_thread.items():
        evs.sort(key=lambda e: e.time_range.start)
        starts[t] = [e.time_range.start for e in evs]
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid, gap = (a + b) / 2, (b - a) * 1e-6
        out.idle_s += gap
        op = _innermost(by_thread, starts, mid)
        chain, phase = chains.of(op) if op is not None else ((), "forward")
        out.idle[_key(chain, phase)] += gap
        if phase == "replay":
            out.replay_idle_s += gap
    return out


def _innermost(by_thread, starts, mid):
    """The host op open over ``mid`` that started last, on any thread.
    On one thread ops nest: the op that contains ``mid`` is the last op
    started before it or one of that op's parents."""
    best = None
    for t, evs in by_thread.items():
        i = bisect.bisect_right(starts[t], mid) - 1
        x = evs[i] if i >= 0 else None
        while x is not None and x.time_range.end < mid:
            x = x.cpu_parent
        if x is not None and (best is None or x.time_range.start
                              > best.time_range.start):
            best = x
    return best


def trace_cell(cell, device: str) -> dict:
    """Build ``cell``'s training state (the set-up's spans recorded by
    part), run ``WARM`` steps, trace the cell's ``profiled_steps`` from
    the sync after ``fit``'s first, ``REPEAT`` times (the walls of all,
    the spans of the first), and read the spans."""
    import torch

    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit
    from kubeflow_rm_tpu_torch.utils.profiling import PhaseRecorder, observe
    from portbench.drivers import train_sft
    from portbench.trace import Profiler

    steps = cell.traffic["profiled_steps"]

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    rec = PhaseRecorder()
    with observe(rec.phase):
        cfg, state, W, feed = train_sft.build(cell, device)
        state, _ = fit(cfg, (feed.batch(i)[0] for i in range(1)),
                       LoopConfig(total_steps=1, log_every=10**9),
                       state=state)
        sync()
    setup_s = time.perf_counter() - cell.t_start
    k = state.step
    state, _ = fit(cfg, (feed.batch(k + j)[0] for j in range(WARM)),
                   LoopConfig(total_steps=k + WARM, log_every=10**9),
                   state=state)
    walls, first, events = [], None, None
    for _ in range(REPEAT):
        k = state.step
        prof = Profiler(sync)

        def traced():
            for j in range(1 + steps):
                if j == 1:
                    prof.start()
                yield feed.batch(k + j)[0]

        state, _ = fit(cfg, traced(), LoopConfig(
            total_steps=k + 1 + steps, log_every=10**9), state=state)
        t = prof.stop()
        walls.append(t.wall_s)
        if first is None:
            first, events = t, prof.prof.events()
    t0 = time.perf_counter()
    s = attribute(events)
    return {
        "steps": steps, "walls_s": walls, "wall_s": first.wall_s,
        "busy_s": first.busy_s, "on_device": s.on_device,
        "kernel_s": s.kernel_s, "linked_s": s.linked_s, "idle_s": s.idle_s,
        "pct": s.pct(first.wall_s),
        "spans_per_step": {n: c / steps for n, c in s.opened.items()},
        "spans": s.table(), "callers": s.callers_of(),
        "breakdown": first.breakdown(), "setup_s": setup_s,
        "setup_parts": {k: v for k, v in rec.summary().items()
                        if k in ("kernels.load", "init_train_state",
                                 "make_train_step", "fit.first_step")},
        "attribute_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA device", file=sys.stderr)
        return 2
    from portbench.arch import arch_of, read_config
    from portbench.run import Cell, cache_dirs, find_cell

    root = Path.cwd()
    cache_dirs(root)
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    w, c, traffic = find_cell(root, bench, args.workload)
    cell = Cell(name=w["name"], arch=arch_of(c["name"],
                                             read_config(root / c["file"])),
                traffic=traffic, limits={}, seed=args.seed % 2**62,
                seconds=0, trace=True, t_start=t_start)
    out = trace_cell(cell, "cuda")
    print(json.dumps({"workload": w["name"], "seed": args.seed,
                      "device": torch.cuda.get_device_name(0), **out,
                      "memory_peak_bytes": torch.cuda.max_memory_allocated()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
