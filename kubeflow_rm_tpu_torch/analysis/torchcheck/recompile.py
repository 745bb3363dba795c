"""An opt-in signature sentinel: catch unbounded shape growth at the
serving and training entry points (counterpart of
``kubeflow_rm_tpu/analysis/jaxcheck/recompile.py``).

In JAX every distinct (shape, dtype, static-arg) signature a jitted
entry point sees is a fresh XLA compile. The port runs eagerly and has
no compile cache, but the bound still matters to anything that keys a
cache on shapes: a CUDA graph captured per shape, a kernel's autotune
table, the caching allocator's block sizes. The serving engine's prefill
buckets (``models/generate.py _bucket_len``) keep the signature count at
most ``log2(slot_len) + 1`` whatever the storm looks like; this module
asserts it.

**Off by default, free when off.** Enable with ``KFRM_JIT_SENTINEL=1``
(or :func:`set_enabled`); the instrumented call sites record each entry
point's argument signatures, and :func:`over_limit` reports any entry
whose signature count exceeded its declared bound, with a witness stack
(first 12 frames) for the signature that crossed it.

Instrumentation points (all one attribute read when disabled):

- ``note(entry, *args, **static)`` — record the signature the entry
  point is about to be called with. Tensors contribute
  ``(shape, dtype)`` per leaf (dicts, lists and tuples are walked);
  everything else is static and contributes its ``repr``.
- ``set_limit(entry, n)`` — declare the expected signature bound (the
  engine declares ``log2(slot_len) + 1`` prefill buckets).
- ``track(entry, fn)`` — JAX reads the compiled-executable count of the
  callable behind the entry from it. An eager callable has none: the
  call is accepted so the instrumented sites read as JAX's, nothing is
  kept, and :func:`report`'s ``jit_cache_size`` is None.
"""

from __future__ import annotations

import os
import traceback

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock

_ENV = "KFRM_JIT_SENTINEL"
_enabled = os.environ.get(_ENV, "").strip().lower() not in (
    "", "0", "false", "no")

_STACK_LIMIT = 12

_lock = make_lock("torchcheck.recompile")
_entries: dict[str, dict] = {}
_observers: list = []


def add_observer(fn) -> None:
    """``fn(entry, n_signatures)`` on every NEW signature. Idempotent
    per callable; observers fire outside the sentinel's lock."""
    with _lock:
        if fn not in _observers:
            _observers.append(fn)


def remove_observer(fn) -> None:
    with _lock:
        if fn in _observers:
            _observers.remove(fn)


def enabled() -> bool:
    """Whether the sentinel is recording."""
    return _enabled


def set_enabled(value: bool) -> None:
    """Programmatic override of the ``KFRM_JIT_SENTINEL`` gate (tests
    flip this instead of mutating the environment)."""
    global _enabled
    _enabled = bool(value)


def reset() -> None:
    """Drop all recorded signatures and limits."""
    with _lock:
        _entries.clear()


def _leaves(x, out: list) -> list:
    if isinstance(x, dict):
        for v in x.values():
            _leaves(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _leaves(v, out)
    else:
        out.append(x)
    return out


def _signature(args: tuple, static: dict) -> tuple:
    """A hashable signature: (shape, dtype) per tensor leaf, ``repr``
    for everything else — what a shape-keyed cache would key on."""
    parts = []
    for a in args:
        for leaf in _leaves(a, []):
            if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
                parts.append((tuple(leaf.shape), str(leaf.dtype)))
            else:
                parts.append(repr(leaf))
    for k in sorted(static):
        parts.append((k, repr(static[k])))
    return tuple(parts)


def _entry(name: str) -> dict:
    e = _entries.get(name)
    if e is None:
        e = _entries[name] = {"signatures": {}, "limit": None,
                              "witnesses": []}
    return e


def set_limit(entry: str, limit: int) -> None:
    """Declare the expected signature bound for ``entry``."""
    if not _enabled:
        return
    with _lock:
        _entry(entry)["limit"] = int(limit)


def track(entry: str, fn) -> None:
    """JAX's hook for the callable behind ``entry``; an eager callable
    has no compile cache to read, so nothing is kept."""


def note(entry: str, *args, **static) -> None:
    """Record the signature ``entry`` is being called with.

    Call this immediately before the call with the same positional
    tensors and keyword statics. One attribute read when disabled."""
    if not _enabled:
        return
    sig = _signature(args, static)
    with _lock:
        e = _entry(entry)
        seen = e["signatures"]
        if sig in seen:
            seen[sig] += 1
            return
        seen[sig] = 1
        n = len(seen)
        limit = e["limit"]
        if limit is not None and n > limit:
            stack = traceback.format_list(
                traceback.extract_stack(limit=_STACK_LIMIT)[:-1])
            e["witnesses"].append({
                "entry": entry,
                "signature": sig,
                "count": n,
                "limit": limit,
                "stack": "".join(stack),
            })
        observers = list(_observers)
    for fn in observers:
        fn(entry, n)


def cache_size(entry: str) -> int | None:
    """The compiled-executable count behind ``entry``: always None in the
    port, whose entry points run eagerly with no compile cache (the key
    stays so reports read as JAX's do)."""
    return None


def report() -> dict:
    """Per-entry signature counts, limits, cache sizes and witnesses."""
    with _lock:
        out = {}
        for name, e in _entries.items():
            out[name] = {
                "signatures": len(e["signatures"]),
                "calls": sum(e["signatures"].values()),
                "limit": e["limit"],
                "jit_cache_size": cache_size(name),
                "witnesses": list(e["witnesses"]),
            }
        return out


def over_limit() -> list[dict]:
    """Entries whose recorded signature count exceeds their declared
    limit, each with the witness stacks of the crossing signatures.
    Empty list == the storm stayed inside its buckets."""
    findings = []
    for name, info in report().items():
        if info["limit"] is not None and \
                info["signatures"] > info["limit"]:
            findings.append({
                "entry": name,
                "signatures": info["signatures"],
                "limit": info["limit"],
                "jit_cache_size": info["jit_cache_size"],
                "witnesses": info["witnesses"],
            })
    return findings
