"""Durable persistence for one apiserver shard: WAL + snapshots (the
port's copy of ``kubeflow_rm_tpu/controlplane/persistence``).

``Persistence`` is the single object the apiserver talks to. Boot
sequence (``recover``): load the newest snapshot, replay every WAL
record past its ``seq`` horizon as a blind upsert (records carry the
complete post-write object, so replay is idempotent and convergent),
and hand back the reconstructed store plus the counters the apiserver
must resume from — the rv counter continues where it left off, so a
restarted shard never re-issues resourceVersions and its watch stream
never emits duplicates.

Steady state (``log``): every acked write appends one group-committed
record. Every ``snapshot_every`` records a compacting snapshot runs on
a background thread: the apiserver cuts a consistent view under its
write lock, the WAL rotates inside the same critical section (so all
records at-or-below the cut live in closed segments), and the closed
segments are unlinked once the snapshot file is durable.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock
from kubeflow_rm_tpu_torch.controlplane.persistence import snapshot as snap_mod
from kubeflow_rm_tpu_torch.controlplane.persistence.wal import (
    WALCorruption,
    WriteAheadLog,
    iter_records,
    segment_paths,
)

__all__ = ["Persistence", "RecoveredState", "WALCorruption",
           "read_state", "tail_records"]

log = logging.getLogger("kubeflow_rm_tpu_torch.persistence")


@dataclass
class RecoveredState:
    """What a booting shard gets back: objects keyed the way the
    apiserver stores them, plus every counter that must resume."""
    objects: dict = field(default_factory=dict)  # (kind, ns, name) -> obj
    rv: int = 0
    seq: int = 0
    records_replayed: int = 0
    snapshot_seq: int = 0


def _key_of(obj: dict, cluster_scoped: set[str]) -> tuple:
    kind = obj["kind"]
    meta = obj.get("metadata") or {}
    if kind in cluster_scoped:
        return (kind, None, meta.get("name"))
    return (kind, meta.get("namespace"), meta.get("name"))


def read_state(dirpath: str, cluster_scoped: set[str]) -> RecoveredState:
    """Read-only recovery: rebuild a shard's state from its WAL
    directory WITHOUT opening the log for append. The elastic-shard
    handoff coordinator runs this against a LIVE donor (the donor keeps
    appending; we read snapshot + whatever closed-and-current segments
    exist at this instant) — blind-upsert replay makes the torn tail
    and any in-flight record harmless, and ``tail_records`` later
    catches everything past ``rec.seq``."""
    rec = RecoveredState()
    doc = snap_mod.load_latest_snapshot(dirpath)
    if doc:
        rec.snapshot_seq = rec.seq = int(doc["seq"])
        rec.rv = int(doc["rv"])
        for obj in doc["objects"]:
            rec.objects[_key_of(obj, cluster_scoped)] = obj
    for seg in segment_paths(dirpath):
        for record in iter_records(seg):
            seq = int(record.get("seq", 0))
            if seq <= rec.snapshot_seq:
                continue
            rec.seq = max(rec.seq, seq)
            rec.rv = max(rec.rv, int(record.get("rv", 0)))
            obj = record.get("obj")
            if obj is None:
                continue
            key = _key_of(obj, cluster_scoped)
            if record.get("verb") == "DELETE":
                rec.objects.pop(key, None)
            else:
                rec.objects[key] = obj
            rec.records_replayed += 1
    return rec


def tail_records(dirpath: str, after_seq: int) -> list[dict]:
    """Every WAL record with ``seq > after_seq``, in seq order — the
    tail-replay feed for a live handoff. Re-reads the segment files on
    every call (the donor appends concurrently); a torn tail ends a
    segment silently, exactly like boot replay.

    Compaction race: a snapshot the donor takes BETWEEN passes unlinks
    segments, folding their records into the snapshot file — records
    in ``(after_seq, snapshot_seq]`` are then invisible here. The
    handoff coordinator guards against this by checking the donor's
    ``snapshot_seq`` (``load_latest_snapshot``) each pass and falling
    back to a full :func:`read_state` + state diff when it advanced
    past its replay horizon."""
    out: list[dict] = []
    for seg in segment_paths(dirpath):
        for record in iter_records(seg):
            if int(record.get("seq", 0)) > after_seq:
                out.append(record)
    out.sort(key=lambda r: int(r.get("seq", 0)))
    return out


class Persistence:
    def __init__(self, dirpath: str, *, fsync: bool = True,
                 snapshot_every: int = 4096, shard: str | None = None):
        self.dir = dirpath
        self.shard = shard
        self._snapshot_every = snapshot_every
        self._since_snapshot = 0
        self._snapshotting = False
        self._guard = make_lock("persistence.snapshot_guard")
        self.wal = WriteAheadLog(dirpath, fsync=fsync, shard=shard)

    # ---- boot --------------------------------------------------------
    def recover(self, cluster_scoped: set[str]) -> RecoveredState:
        """Rebuild state from snapshot + WAL tail. Raises
        ``WALCorruption`` on a mid-log CRC failure (a torn tail record
        is tolerated — it was never acked)."""
        rec = RecoveredState()
        doc = snap_mod.load_latest_snapshot(self.dir)
        if doc:
            rec.snapshot_seq = rec.seq = int(doc["seq"])
            rec.rv = int(doc["rv"])
            for obj in doc["objects"]:
                rec.objects[_key_of(obj, cluster_scoped)] = obj
        for seg in segment_paths(self.dir):
            for record in iter_records(seg):
                seq = int(record.get("seq", 0))
                if seq <= rec.snapshot_seq:
                    continue  # the snapshot already reflects it
                rec.seq = max(rec.seq, seq)
                rec.rv = max(rec.rv, int(record.get("rv", 0)))
                obj = record.get("obj")
                if obj is None:
                    continue
                key = _key_of(obj, cluster_scoped)
                if record.get("verb") == "DELETE":
                    rec.objects.pop(key, None)
                else:
                    rec.objects[key] = obj
                rec.records_replayed += 1
        if rec.records_replayed or rec.objects:
            log.info("recovered %d objects (snapshot seq %d + %d WAL "
                     "records) from %s", len(rec.objects),
                     rec.snapshot_seq, rec.records_replayed, self.dir)
        return rec

    # ---- steady state ------------------------------------------------
    def log(self, *, seq: int, rv: int, verb: str, obj: dict,
            wait: bool = True) -> int:
        """Append one write record; return its commit ticket. With
        ``wait`` the call returns only once the record is fsync-durable
        (group commit); without it, the caller must later ``flush``
        up to the returned ticket before acking the write."""
        ticket = self.wal.append(
            {"seq": seq, "rv": rv, "verb": verb, "obj": obj}, wait=wait)
        self._since_snapshot += 1
        return ticket

    def flush(self, upto: int | None = None) -> None:
        self.wal.flush(upto=upto)

    def snapshot_due(self) -> bool:
        return self._since_snapshot >= self._snapshot_every \
            and not self._snapshotting

    def begin_snapshot(self) -> bool:
        """Claim the (single) snapshot slot; False if one is running."""
        with self._guard:
            if self._snapshotting:
                return False
            self._snapshotting = True
            return True

    def complete_snapshot(self, *, seq: int, rv: int,
                          objects: list[dict]) -> None:
        """Persist the cut the apiserver captured (its write lock held
        during capture + ``wal.rotate()``) and unlink compacted
        segments. Runs off the write path."""
        try:
            snap_mod.write_snapshot(self.dir, seq=seq, rv=rv,
                                    objects=objects, shard=self.shard)
            self.wal.compact()
            self._since_snapshot = 0
        finally:
            with self._guard:
                self._snapshotting = False

    def close(self) -> None:
        self.wal.close()
