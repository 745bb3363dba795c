"""Kube-object helpers the port's seams call (copies of
``kubeflow_rm_tpu/controlplane/api/meta.py``'s)."""

from __future__ import annotations

import copy
import json
from typing import Any


def fast_deepcopy(obj):
    """Deep copy for JSON-shaped objects via serialize/parse; falls back
    to ``copy.deepcopy`` for non-JSON leaves."""
    try:
        return json.loads(json.dumps(obj))
    except (TypeError, ValueError):
        return copy.deepcopy(obj)


def name_of(obj: dict) -> str:
    return obj["metadata"]["name"]


def namespace_of(obj: dict) -> str | None:
    return obj["metadata"].get("namespace")


def annotations_of(obj: dict) -> dict:
    return obj["metadata"].get("annotations") or {}


def deep_get(obj: Any, *path, default=None):
    cur = obj
    for p in path:
        if isinstance(cur, dict):
            if p not in cur:
                return default
            cur = cur[p]
        elif isinstance(cur, list):
            if not isinstance(p, int) or p >= len(cur):
                return default
            cur = cur[p]
        else:
            return default
    return cur
