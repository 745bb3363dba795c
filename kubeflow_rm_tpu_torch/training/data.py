"""Data pipeline (counterpart of ``kubeflow_rm_tpu/training/data.py``).

The port keeps its own copy of the JAX package's numpy pipeline — a
deterministic synthetic LM stream, greedy document packing with
per-document positions and segment ids, jsonl shards, and streamed
packed batches — so both frameworks read the same rows. Only
``device_prefetch`` is new: it stages batches on the card through
pinned host memory.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from kubeflow_rm_tpu_torch.ops.losses import IGNORE_INDEX


def synthetic_batches(batch_size: int, seq_len: int, vocab_size: int,
                      seed: int = 0):
    """Infinite iterator of {"tokens", "labels"} int32 batches."""
    rng = np.random.default_rng(seed)
    while True:
        tok = rng.integers(0, vocab_size, (batch_size, seq_len), dtype=np.int32)
        labels = np.roll(tok, -1, axis=1)
        labels[:, -1] = IGNORE_INDEX
        yield {"tokens": tok, "labels": labels.astype(np.int32)}


def pack_documents(docs: list[list[int]], seq_len: int,
                   pad_id: int = 0) -> dict:
    """Pack token lists into fixed-length rows with positions + segments.

    Documents are concatenated greedily; each row carries ``positions``
    restarting at 0 per document (correct RoPE) and ``segments`` — a
    per-row document id starting at 1, with padding as segment 0 — which
    the segment-aware mask in ``ops.attention`` ANDs into the causal mask
    so packed documents are fully independent and pad tokens are never
    attended. Positions alone are NOT sufficient: a later document's
    positions restart at 0, which a position-only causal mask would read
    as "in the past" of every other document.
    """
    rows, row, pos_rows, pos = [], [], [], []
    label_rows, labels = [], []
    seg_rows, segs = [], []
    next_seg = 1
    for doc in docs:
        i = 0
        while i < len(doc):
            space = seq_len - len(row)
            take = doc[i:i + space]
            row.extend(take)
            pos.extend(range(i, i + len(take)))
            segs.extend([next_seg] * len(take))
            labels.extend(doc[i + 1:i + len(take) + 1])
            if len(labels) < len(row):
                labels.append(IGNORE_INDEX)
            i += len(take)
            if len(row) == seq_len:
                rows.append(row); pos_rows.append(pos)
                label_rows.append(labels); seg_rows.append(segs)
                row, pos, labels, segs = [], [], [], []
        next_seg += 1
    if row:
        n = seq_len - len(row)
        rows.append(row + [pad_id] * n)
        pos_rows.append(pos + list(range(n)))
        label_rows.append(labels + [IGNORE_INDEX] * n)
        seg_rows.append(segs + [0] * n)  # pad = segment 0, attends nothing real
    return {
        "tokens": np.asarray(rows, np.int32).reshape(-1, seq_len),
        "labels": np.asarray(label_rows, np.int32).reshape(-1, seq_len),
        "positions": np.asarray(pos_rows, np.int32).reshape(-1, seq_len),
        "segments": np.asarray(seg_rows, np.int32).reshape(-1, seq_len),
    }


def jsonl_documents(paths, *, process_id: int = 0, num_processes: int = 1,
                    field: str = "tokens", tokenize=None,
                    seed: int | None = None, epoch: int = 0):
    """Yield token lists from jsonl shards, multi-host disjoint.

    The file-backed input path for real fine-tunes: every process reads
    the SAME globally-shuffled order (seeded per epoch, so shuffling is
    reproducible and advances between epochs) and keeps rows where
    ``row_index % num_processes == process_id`` — disjoint and jointly
    exhaustive without any coordination traffic, the property multi-host
    input needs (each host feeds its own slice of the dp×fsdp batch;
    a single process reads everything).

    Records carry either pre-tokenized ``field`` (a token list) or raw
    text that ``tokenize`` maps to one.
    """
    import json as _json

    paths = sorted(str(p) for p in paths)
    index = []  # (path_i, byte offset) per record
    for pi, path in enumerate(paths):
        off = 0
        with open(path, "rb") as f:
            for line in f:
                if line.strip():
                    index.append((pi, off))
                off += len(line)
    order = np.arange(len(index))
    if seed is not None:
        np.random.default_rng(seed + epoch).shuffle(order)

    handles = [open(p, "rb") for p in paths]
    try:
        for j in order[process_id::num_processes]:
            pi, off = index[j]
            handles[pi].seek(off)
            rec = _json.loads(handles[pi].readline())
            if field in rec:
                yield list(rec[field])
            elif tokenize is not None:
                yield list(tokenize(rec["text"]))
            else:
                raise KeyError(
                    f"record has no {field!r} and no tokenizer given "
                    f"(keys: {sorted(rec)})")
    finally:
        for h in handles:
            h.close()


def packed_batches(docs, batch_size: int, seq_len: int, *,
                   pad_id: int = 0, drop_remainder: bool = True):
    """Stream ``pack_documents`` rows in fixed-size batches, O(batch)
    memory for arbitrarily large corpora.

    Row-for-row identical to a one-shot ``pack_documents`` over the
    same document stream (asserted by the JAX package's tests): the partial
    row in flight carries ACROSS batch boundaries instead of being
    padded at each flush, so streaming inserts no extra padding.
    """
    keys = ("tokens", "labels", "positions", "segments")
    ready = {k: [] for k in keys}
    row, pos, labels, segs = [], [], [], []
    next_seg = 1

    def flush_row():
        nonlocal row, pos, labels, segs
        ready["tokens"].append(row)
        ready["labels"].append(labels)
        ready["positions"].append(pos)
        ready["segments"].append(segs)
        row, pos, labels, segs = [], [], [], []

    def take_batch():
        batch = {k: np.asarray(ready[k][:batch_size], np.int32)
                 for k in keys}
        for k in keys:
            del ready[k][:batch_size]
        return batch

    for doc in docs:
        i = 0
        while i < len(doc):
            space = seq_len - len(row)
            take = doc[i:i + space]
            row.extend(take)
            pos.extend(range(i, i + len(take)))
            segs.extend([next_seg] * len(take))
            labels.extend(doc[i + 1:i + len(take) + 1])
            if len(labels) < len(row):
                labels.append(IGNORE_INDEX)
            i += len(take)
            if len(row) == seq_len:
                flush_row()
                if len(ready["tokens"]) == batch_size:
                    yield take_batch()
        next_seg += 1
    if row:
        n = seq_len - len(row)
        row += [pad_id] * n
        pos += list(range(n))
        labels += [IGNORE_INDEX] * n
        segs += [0] * n  # pad = segment 0, attends nothing real
        flush_row()
    if not drop_remainder and ready["tokens"]:
        yield {k: np.asarray(ready[k], np.int32) for k in keys}


def to_device(batch: dict, device) -> dict:
    """Numpy (or tensor) batch -> int32 tensors on ``device``. For the
    card the host copy is pinned and the transfer does not block."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if device.type == "cuda" and not t.is_cuda:
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def device_prefetch(batches, device, depth: int = 2):
    """Overlap host-to-device transfer with compute: keep ``depth``
    batches already on ``device`` (pinned, ``non_blocking`` copies)."""
    queue = deque()
    for batch in batches:
        queue.append(to_device(batch, device))
        if len(queue) >= depth:
            yield queue.popleft()
    while queue:
        yield queue.popleft()
