"""Compacting snapshots for the durable apiserver store (the port's
copy of ``kubeflow_rm_tpu/controlplane/persistence/snapshot.py``).

A snapshot is one JSON file holding every stored object plus the write
``seq`` and resourceVersion counters at the cut. Written atomically
(tmp + fsync + rename, etcd's snap/ recipe), so a crash mid-snapshot
leaves the previous snapshot intact and replay simply walks more WAL.
After a successful snapshot the WAL segments at-or-below the cut are
unlinked — the log stays O(writes since last snapshot), not O(history).
"""

from __future__ import annotations

import json
import os
import time

from kubeflow_rm_tpu_torch.controlplane import metrics

SNAP_PREFIX = "snap-"
SNAP_SUFFIX = ".json"


def snapshot_paths(dirpath: str) -> list[str]:
    names = [n for n in os.listdir(dirpath)
             if n.startswith(SNAP_PREFIX) and n.endswith(SNAP_SUFFIX)]
    return [os.path.join(dirpath, n) for n in sorted(names)]


def write_snapshot(dirpath: str, *, seq: int, rv: int,
                   objects: list[dict], shard: str | None = None) -> str:
    """Atomically persist one cut. Returns the snapshot path."""
    t0 = time.perf_counter()
    path = os.path.join(dirpath, f"{SNAP_PREFIX}{seq:012d}{SNAP_SUFFIX}")
    tmp = path + ".tmp"
    doc = {"seq": seq, "rv": rv, "objects": objects}
    with open(tmp, "w") as f:
        json.dump(doc, f, separators=(",", ":"))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    # older snapshots are fully superseded
    for old in snapshot_paths(dirpath):
        if old != path:
            os.unlink(old)
    shard_l = shard if shard is not None else metrics.shard_label()
    metrics.SNAPSHOT_DURATION_SECONDS.labels(shard=shard_l).observe(
        time.perf_counter() - t0)
    return path


def load_latest_snapshot(dirpath: str) -> dict | None:
    """The newest parseable snapshot, or None. A half-written ``.tmp``
    is never considered (rename is the commit point); an unparseable
    committed snapshot falls back to the previous one if present."""
    for path in reversed(snapshot_paths(dirpath)):
        try:
            with open(path) as f:
                doc = json.load(f)
            if isinstance(doc, dict) and "seq" in doc:
                return doc
        except (OSError, ValueError):
            continue
    return None
