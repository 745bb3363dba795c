"""Shared ``run_meta`` header stamped on every storm artifact (the
port's copy of ``kubeflow_rm_tpu/controlplane/obs/runmeta.py``).

``ratchet.py`` diffs timing artifacts across commits; a diff between a
2-shard WAL run and a single-process run is garbage, and a diff across
hosts is suspect. Every harness (``spawn_conformance.py``,
``e2e_walk.py``, ``serve_bench.py``) stamps its output with this
header so the ratchet can *refuse* mismatched-arm comparisons (hard)
and *flag* cross-host ones (soft) instead of producing nonsense
deltas.
"""

from __future__ import annotations

import os
import platform
import time

SCHEMA_VERSION = 1


def build_run_meta(harness: str, arms: dict, *,
                   interleave_index: int | None = None) -> dict:
    """``harness`` names the producing tool; ``arms`` is the flat dict
    of arm-defining flags (mode, shards, wal, cache, ...) — the keys
    two artifacts must agree on to be comparable."""
    return {
        "schema_version": SCHEMA_VERSION,
        "harness": harness,
        "arms": {k: v for k, v in sorted(arms.items())},
        "host": {
            "node": platform.node(),
            "machine": platform.machine(),
            "python": platform.python_version(),
            "cpus": os.cpu_count(),
        },
        "interleave_index": interleave_index,
        "created_at": round(time.time(), 3),
    }


def compatible(a: dict | None, b: dict | None
               ) -> tuple[list[str], list[str]]:
    """``(refusals, warnings)`` for comparing artifact ``a`` (baseline)
    against ``b`` (fresh). Arm-flag or schema-major mismatches refuse;
    a missing header or a different host only warns (checked-in
    baselines predate stamping, CI hosts legitimately differ)."""
    refusals: list[str] = []
    warnings: list[str] = []
    if not a or not b:
        which = [side for side, m in (("baseline", a), ("fresh", b))
                 if not m]
        warnings.append(
            f"run_meta missing on {' and '.join(which)} — arm "
            f"compatibility not verifiable")
        return refusals, warnings
    if a.get("schema_version") != b.get("schema_version"):
        refusals.append(
            f"run_meta schema_version mismatch: "
            f"{a.get('schema_version')} vs {b.get('schema_version')}")
    if a.get("harness") and b.get("harness") \
            and a["harness"] != b["harness"]:
        refusals.append(f"harness mismatch: {a['harness']} vs "
                        f"{b['harness']}")
    arms_a, arms_b = a.get("arms") or {}, b.get("arms") or {}
    for key in sorted(set(arms_a) & set(arms_b)):
        if arms_a[key] != arms_b[key]:
            refusals.append(f"arm mismatch on '{key}': "
                            f"{arms_a[key]!r} vs {arms_b[key]!r}")
    for key in sorted(set(arms_a) ^ set(arms_b)):
        warnings.append(f"arm flag '{key}' present on only one side")
    host_a = (a.get("host") or {}).get("node")
    host_b = (b.get("host") or {}).get("node")
    if host_a and host_b and host_a != host_b:
        warnings.append(f"cross-host comparison ({host_a} vs "
                        f"{host_b}) — timing deltas are soft evidence")
    return refusals, warnings
