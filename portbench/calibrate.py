"""Readings that a training cell's limits are set from (run on the chip,
not by the benchmark's own runs).

    python3 -m portbench.calibrate --workload <cell> --seeds 11 12 ... \\
        --control-seeds 21 22 23

For each of ``--seeds``: the program's checked steps (the set-up of a
run, through ``fit``) against the float32 reference: the sound runs'
numbers, whose largest is a limit's lower reading. For each of
``--control-seeds``: the reference computed in fp8 put in the program's
place (the control), and the reference with half of each batch left out
and the mean taken over the rest (a fault), each against the float32
reference: the upper readings. A step that returns its state unchanged
reads 1 on ``update_gap`` by construction and needs no run. One JSON
line per reading on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    from portbench import compare
    from portbench.arch import arch_of, read_config
    from portbench.drivers import train_sft
    from portbench.run import Cell, find_cell

    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd()
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    w, c, traffic = find_cell(root, bench, args.workload)
    conf = read_config(root / c["file"])

    def cell(seed):
        return Cell(name=w["name"], arch=arch_of(c["name"], conf),
                    traffic=traffic, limits={}, seed=seed, seconds=0,
                    trace=False, t_start=time.perf_counter())

    def emit(**kw):
        print(json.dumps(kw), flush=True)

    for seed in args.seeds:
        t0 = time.perf_counter()
        x = cell(seed)
        cfg, state, W, feed = train_sft.build(x, "cuda")
        prog = train_sft.checked_steps(x, cfg, state, W, feed)
        del cfg, state, W, feed
        train_sft.free()
        t1 = time.perf_counter()
        ref = train_sft.reference(x, "cuda")
        emit(kind="program", seed=seed,
             numbers=compare.train_numbers(prog, ref), program=prog,
             reference=ref, program_s=t1 - t0,
             reference_s=time.perf_counter() - t1)
        train_sft.free()
    rows = traffic["rows"]
    for seed in args.control_seeds:
        x = cell(seed)
        ref = train_sft.reference(x, "cuda")
        train_sft.free()
        t0 = time.perf_counter()
        low = train_sft.reference(x, "cuda", precision="fp8")
        emit(kind="control_fp8", seed=seed,
             numbers=compare.train_numbers(low, ref), control=low,
             seconds=time.perf_counter() - t0)
        train_sft.free()
        half = train_sft.reference(x, "cuda", rows=slice(0, rows // 2))
        emit(kind="fault_half_batch", seed=seed,
             numbers=compare.train_numbers(half, ref), fault=half)
        train_sft.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
