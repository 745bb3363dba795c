"""Append-only write-ahead log with fsync-batched group commit (the
port's copy of ``kubeflow_rm_tpu/controlplane/persistence/wal.py``: the
frame format is byte for byte JAX's, so either package replays a log
the other wrote).

The durability half of the sharded control plane: every acked write is
a CRC-framed record on disk before the verb returns, so a SIGKILLed
shard replays to exactly the state its clients observed. The recipe is
etcd's (``wal/wal.go``): length+CRC framing, group commit (one fsync
covers every record buffered while the previous fsync was in flight),
segment files rotated at snapshot time so compaction is a file unlink,
a torn tail tolerated on replay, and anything else corrupt a loud
refusal to serve.

Frame layout (little-endian)::

    [u32 payload_len][u32 crc32(payload)][payload bytes]

The payload is one JSON record. Records carry the apiserver's write
sequence number (``seq``, total order across kinds) and the object's
resourceVersion (``rv``); replay filters on ``seq`` against the
snapshot horizon and applies records as blind upserts, so re-applying
a record that the snapshot already reflects is harmless.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import time
import zlib
from typing import Iterator

from kubeflow_rm_tpu_torch.controlplane import metrics
from kubeflow_rm_tpu_torch.analysis.lockgraph import make_condition, make_lock

_FRAME = struct.Struct("<II")  # payload length, crc32(payload)

SEGMENT_PREFIX = "wal-"
SEGMENT_SUFFIX = ".log"


class WALCorruption(Exception):
    """A full-length record failed its CRC check: the log is damaged in
    the middle, not merely torn at the tail — replaying past it could
    silently resurrect or lose acked writes, so recovery must stop and
    a human (or the chaos harness) must decide."""


def encode_frame(payload: bytes) -> bytes:
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def iter_frames(path: str) -> Iterator[bytes]:
    """Yield record payloads from one segment. A truncated tail (torn
    final write from a crash mid-append) ends iteration silently — the
    record was never acked, losing it is correct. A CRC mismatch on a
    full-length record raises ``WALCorruption``."""
    with open(path, "rb") as f:
        data = f.read()
    off, total = 0, len(data)
    while off < total:
        if total - off < _FRAME.size:
            return  # torn header at the tail
        length, crc = _FRAME.unpack_from(data, off)
        start = off + _FRAME.size
        if total - start < length:
            return  # torn payload at the tail
        payload = data[start:start + length]
        if zlib.crc32(payload) != crc:
            raise WALCorruption(
                f"{os.path.basename(path)}: CRC mismatch at byte {off} "
                f"(stored {crc:#010x}, computed {zlib.crc32(payload):#010x})"
                " — refusing to replay past corruption")
        yield payload
        off = start + length


def iter_records(path: str) -> Iterator[dict]:
    for payload in iter_frames(path):
        yield json.loads(payload)


def segment_paths(dirpath: str) -> list[str]:
    """Segment files in creation (= replay) order."""
    names = [n for n in os.listdir(dirpath)
             if n.startswith(SEGMENT_PREFIX) and n.endswith(SEGMENT_SUFFIX)]
    return [os.path.join(dirpath, n) for n in sorted(names)]


class WriteAheadLog:
    """One shard's log: segmented, CRC-framed, group-committed.

    ``append`` buffers the frame under the lock and (by default) blocks
    until an fsync covers it. Only one thread runs the write+fsync at a
    time; everything buffered while it ran rides the next flush — so N
    concurrent writers pay ~2 fsyncs, not N (group commit). ``fsync``
    can be disabled for tests/benchmarks that only need crash-ordering,
    not power-loss durability.
    """

    def __init__(self, dirpath: str, *, fsync: bool = True,
                 shard: str | None = None):
        os.makedirs(dirpath, exist_ok=True)
        self.dir = dirpath
        self._fsync = fsync
        self._cv = make_condition("wal.cv", lock=make_lock("wal.cv"))
        self._pending: list[bytes] = []
        self._submitted = 0   # frames accepted
        self._durable = 0     # frames flushed (+fsynced)
        self._flushing = False
        existing = segment_paths(dirpath)
        self._seg_index = len(existing) + 1
        if existing:
            # never append to a segment that may end in a torn record:
            # a fresh segment keeps "torn tail" a per-crash, tail-only
            # phenomenon instead of a mid-file one
            self._seg_index = 1 + max(
                int(os.path.basename(p)[len(SEGMENT_PREFIX):
                                        -len(SEGMENT_SUFFIX)])
                for p in existing)
        shard_l = shard if shard is not None else metrics.shard_label()
        self._m_fsync = metrics.WAL_FSYNC_SECONDS.labels(shard=shard_l)
        self._m_bytes = metrics.WAL_BYTES_TOTAL.labels(shard=shard_l)
        self._f = open(self._segment_path(self._seg_index), "ab")
        self.appends = 0

    def _segment_path(self, index: int) -> str:
        return os.path.join(
            self.dir, f"{SEGMENT_PREFIX}{index:06d}{SEGMENT_SUFFIX}")

    # ---- append / group commit --------------------------------------
    def append(self, record: dict, *, wait: bool = True) -> int:
        """Buffer one record; return its commit ticket. With ``wait``
        the call returns only after the record is durable (possibly
        fsynced by another thread's batch)."""
        frame = encode_frame(json.dumps(
            record, separators=(",", ":")).encode())
        with self._cv:
            self._pending.append(frame)
            self._submitted += 1
            ticket = self._submitted
            self.appends += 1
        if wait:
            self.flush(upto=ticket)
        return ticket

    def flush(self, upto: int | None = None) -> None:
        """Make every record up to ticket ``upto`` (default: all
        submitted) durable. One caller at a time becomes the flusher
        and commits the whole buffer; the rest wait on its fsync."""
        while True:
            with self._cv:
                if upto is None:
                    upto = self._submitted
                if self._durable >= upto:
                    return
                if self._flushing:
                    self._cv.wait(0.5)
                    continue
                batch = b"".join(self._pending)
                self._pending.clear()
                target = self._submitted
                self._flushing = True
            t0 = time.perf_counter()
            try:
                if batch:
                    self._f.write(batch)
                self._f.flush()
                if self._fsync:
                    os.fsync(self._f.fileno())
            finally:
                with self._cv:
                    self._durable = max(self._durable, target)
                    self._flushing = False
                    self._cv.notify_all()
            self._m_fsync.observe(time.perf_counter() - t0)
            if batch:
                self._m_bytes.inc(len(batch))

    def rotate(self) -> None:
        """Flush + fsync the open segment, then start a new one. The
        snapshot path calls this under the apiserver's write lock so
        every record at-or-below the snapshot's seq horizon lives in a
        now-closed segment (making compaction a plain unlink).

        The write+fsync+reopen run OUTSIDE the condvar, made exclusive
        by the same ``_flushing`` flag group commit uses — appends keep
        buffering during the fsync (they only touch ``_pending``), and
        anything buffered while we rotate simply lands in the new
        segment on its own flush."""
        with self._cv:
            while self._flushing:  # let an in-flight group commit land
                self._cv.wait(0.5)
            batch = b"".join(self._pending)
            self._pending.clear()
            target = self._submitted
            self._flushing = True
        ok = False
        try:
            if batch:
                self._f.write(batch)
            self._f.flush()
            if self._fsync:
                os.fsync(self._f.fileno())
            self._f.close()
            self._seg_index += 1
            self._f = open(self._segment_path(self._seg_index), "ab")
            ok = True
        finally:
            with self._cv:
                if ok:
                    self._durable = max(self._durable, target)
                    if batch:
                        self._m_bytes.inc(len(batch))
                self._flushing = False
                self._cv.notify_all()

    def compact(self, keep_from_index: int | None = None) -> int:
        """Unlink closed segments older than the open one (or than
        ``keep_from_index``). Returns the number removed."""
        limit = self._seg_index if keep_from_index is None \
            else keep_from_index
        removed = 0
        for path in segment_paths(self.dir):
            name = os.path.basename(path)
            idx = int(name[len(SEGMENT_PREFIX):-len(SEGMENT_SUFFIX)])
            if idx < limit:
                os.unlink(path)
                removed += 1
        return removed

    def close(self) -> None:
        try:
            self.flush()
        finally:
            self._f.close()
