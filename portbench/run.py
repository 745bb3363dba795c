"""Run one cell of the port's benchmark and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``. The cell
names a configuration (``portbench/configs/<config>.json``) and a
traffic mix (``portbench/traffic/<mix>.json``), whose ``driver`` names
the module under ``portbench/drivers/`` that builds the program's state,
runs the window and holds what the window produced to the reference.
With ``--trace 0`` the result carries the cell's end-to-end metrics;
with ``--trace 1`` its per-layer metrics, each read by
``portbench/metrics/<metric>.py`` from what the run recorded, and a
``breakdown`` of the traced stretch. The last key of the result, and
the last lines of standard error, are the numbers that decided
``correct``, each beside its limit.

Exit codes: 0 with a result; 2 without a card or with fewer cards than
the cell asks for; 3 if JAX or the JAX package was loaded; 4 on a
malformed benchmark. Only the program under test,
``kubeflow_rm_tpu_torch``, is measured.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

#: top-level module names that must not be loaded in the measured process
FORBIDDEN = ("jax", "jaxlib", "flax", "kubeflow_rm_tpu")


@dataclass
class Cell:
    name: str
    arch: object
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    t_start: float


def forbidden_loaded() -> list[str]:
    """Forbidden top-level names in ``sys.modules`` (whole names: the
    port's ``kubeflow_rm_tpu_torch`` is not the JAX package)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_reader(root: Path, metric: str):
    path = root / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(root: Path, bench: dict, workload: str):
    """(workload entry, config entry, traffic dict) of ``workload``."""
    from portbench.arch import read_config

    w = next((x for x in bench["workloads"] if x["name"] == workload), None)
    if w is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    c = next(x for x in bench["configs"] if x["name"] == w["config"])
    traffic = read_config(root / "portbench" / "traffic"
                          / f"{w['traffic']}.json")
    return w, c, traffic


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own kernel build directory is ``kubeflow_rm_tpu_torch/kernels/
    _build``, also inside it)."""
    base = root / ".portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(base / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path.cwd()
    cache_dirs(root)
    try:
        with open(root / "BENCHMARK.json") as f:
            bench = json.load(f)
        w, c, traffic = find_cell(root, bench, args.workload)
    except (OSError, KeyError, StopIteration, ValueError) as e:
        print(f"portbench: {e!r}", file=sys.stderr)
        return 4

    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"portbench: {w['chips']} CUDA device(s) needed, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2

    from portbench import compare
    from portbench.arch import arch_of, read_config

    conf = read_config(root / c["file"])
    cell = Cell(name=w["name"], arch=arch_of(c["name"], conf),
                traffic=traffic, limits=compare.load_limits(root, w["name"]),
                seed=args.seed % 2**62, seconds=args.seconds,
                trace=bool(args.trace), t_start=T_START)
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    torch.cuda.reset_peak_memory_stats()
    res = driver.run(cell, "cuda")

    if args.trace:
        metrics = {}
        for m in bench["per_layer"]:
            if applies(m, w["name"]):
                v = load_reader(root, m["name"])(res["readings"])
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["end_to_end"][m["name"]],
                               "unit": m["unit"]}
                   for m in bench["end_to_end"] if applies(m, w["name"])}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": w["chips"],
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    out = {"correct": bool(res["correct"]),
           "attempted": int(res["attempted"]),
           "failed": int(res["failed"]), "metrics": metrics}
    t = res["trace"]
    if args.trace:
        device.update(busy_s=t.busy_s if t else 0.0,
                      window_s=t.wall_s if t else 0.0)
    out["device"] = device
    if args.trace and t is not None:
        out["breakdown"] = t.breakdown()
    out["detail"] = res.get("detail", {})
    out["checks"] = res["checks"]

    bad = forbidden_loaded()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in res["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
