"""The numbers that decide ``correct``, and the judgement against the
cell's limits (``portbench/limits/<cell>.json``).

Training: the objective of each checked step (the largest absolute gap,
in nats), and per adapter leaf the norm of the first step's clipped
gradient and of the change over the checked steps, each as the gap
between the two norms over the reference's norm of that leaf or of the
median leaf, whichever is larger (the worst leaf). A leaf whose
reference gradient is under a thousandth of the median leaf's moves by
round-off alone and is left out of both.

Serving: the widest gap, over the served tokens of the sampled
requests, by which a served token's logit lies below the reference's
best at its position.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

NEGLIGIBLE = 1e-3


def _leaf_gap(prog: dict, ref: dict, keep) -> float:
    med = statistics.median(ref.values())
    return max(abs(prog[p] - ref[p]) / max(ref[p], med) for p in keep)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: ``losses`` (per checked step), ``grad_norms``
    and ``change_norms`` (per leaf)."""
    med = statistics.median(ref["grad_norms"].values())
    keep = [p for p, g in ref["grad_norms"].items() if g >= NEGLIGIBLE * med]
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["losses"],
                                                    ref["losses"])),
        "grad_gap": _leaf_gap(prog["grad_norms"], ref["grad_norms"], keep),
        "update_gap": _leaf_gap(prog["change_norms"], ref["change_norms"],
                                keep),
    }


def load_limits(root: Path, cell: str) -> dict:
    with open(root / "portbench" / "limits" / f"{cell}.json") as f:
        return json.load(f)["limits"]


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})`` over the numbers that
    have a limit: each finite and at or under it. A number without a
    limit is reported by the driver and not judged."""
    checks = {k: {"value": numbers.get(k, float("nan")), "limit": lim}
              for k, lim in limits.items()}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
