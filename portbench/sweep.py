"""The knee of a serving cell: its traffic offered at several fixed
rates, one window each, in one process (run on the chip once, when the
cell's rate is chosen; the benchmark's own runs offer the cell's one
rate).

    python3 -m portbench.sweep --config mistral-7b --traffic docqa-open-loop \\
        --seed <n> --seconds 30 --rates 0.6 0.9 1.2

One JSON line a rate: the tails, the share of requests finished, how
late the last due request finished, and the slope of the queue over
the window (the knee is the highest rate whose backlog does not grow).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench.arch import arch_of, read_config
    from portbench.drivers import serve_open_loop
    from portbench.run import Cell

    if not torch.cuda.is_available():
        print("portbench.sweep: no CUDA device", file=sys.stderr)
        return 2
    root = Path.cwd() / "portbench"
    conf = read_config(root / "configs" / f"{args.config}.json")
    traffic = read_config(root / "traffic" / f"{args.traffic}.json")
    for rate in args.rates:
        cell = Cell(name="sweep", arch=arch_of(args.config, conf),
                    traffic=dict(traffic, rate=rate),
                    limits={"logit_gap": float("inf")}, seed=args.seed,
                    seconds=args.seconds, trace=False,
                    t_start=time.perf_counter())
        torch.cuda.reset_peak_memory_stats()
        res = serve_open_loop.run(cell, "cuda")
        print(json.dumps({"rate": rate, **res["end_to_end"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "peak_bytes": res["memory_peak_bytes"],
                          "checks": res["checks"], **res["detail"]}),
              flush=True)
        serve_open_loop.gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
