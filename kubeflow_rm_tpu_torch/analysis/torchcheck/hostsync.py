"""An opt-in probe for implicit device→host transfers in hot loops
(counterpart of ``kubeflow_rm_tpu/analysis/jaxcheck/hostsync.py``).

``bool(t)``, ``t.item()``, ``int(t)``, ``float(t)``, ``t.tolist()``,
``t.numpy()`` and ``np.asarray(t)`` on a CUDA tensor all block the Python
thread until the card's queue drains and the value lands on the host —
one hidden round trip per token in a decode loop, or per step in a
training loop, is enough to serialise the card behind Python. This
module patches those entry points on ``torch.Tensor`` (and
``np.asarray``/``np.array`` when given a tensor) and records a witness,
with the enclosing region and the first 12 stack frames, for every
implicit sync inside a declared hot region.

It records on any tensor, as JAX's probe records on any jax array, the
CPU's included: on the CPU the same call is the one that syncs on the
card, and that keeps the probe testable without one.

**Off by default, free when off**: ``region()`` returns a shared null
context manager and nothing is patched until :func:`install` runs.
Enable with ``KFRM_HOSTSYNC_PROBE=1`` (or :func:`set_enabled` +
:func:`install`).

Usage::

    from kubeflow_rm_tpu_torch.analysis.torchcheck import hostsync
    hostsync.install()                     # no-op unless enabled
    with hostsync.region("decode-step"):
        ...                                # hot loop body
    hostsync.witnesses()                   # -> [{kind, region, stack}]

Deliberate syncs are fine outside regions (a metrics read at a log
boundary). :func:`sanctioned` names a site whose syncs ARE the feature
(the host-offload step's ``train.offload_stream``): syncs under it are
tallied per site (:func:`sanctioned_counts`) instead of witnessed, while
an unsanctioned sync in the same region still trips.
"""

from __future__ import annotations

import contextlib
import os
import threading
import traceback

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock

_ENV = "KFRM_HOSTSYNC_PROBE"
_enabled = os.environ.get(_ENV, "").strip().lower() not in (
    "", "0", "false", "no")

_STACK_LIMIT = 12

_lock = make_lock("torchcheck.hostsync")
_observers: list = []
_witnesses: list[dict] = []
_sanctioned_counts: dict[tuple[str, str], int] = {}  # (site, kind) -> n
_installed = False
# (owner, attr, original, owned): owned = the attribute was the owner's
# own (setattr back) rather than inherited (delattr)
_originals: list[tuple] = []
_tls = threading.local()

#: the implicit-sync entry points on ``torch.Tensor``
_SYNC_METHODS = ("__bool__", "__int__", "__float__", "__index__",
                 "item", "tolist", "numpy")
_NUMPY_FUNCS = ("asarray", "array")


def enabled() -> bool:
    """Whether the probe is active."""
    return _enabled


def set_enabled(value: bool) -> None:
    """Programmatic override of the ``KFRM_HOSTSYNC_PROBE`` gate."""
    global _enabled
    _enabled = bool(value)


def _stack(name: str) -> list:
    stack = getattr(_tls, name, None)
    if stack is None:
        stack = []
        setattr(_tls, name, stack)
    return stack


# nullcontext is reusable and reentrant: one shared instance serves
# every disabled region() call
_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def _pushed(name: str, value: str):
    stack = _stack(name)
    stack.append(value)
    try:
        yield
    finally:
        stack.pop()


def region(name: str):
    """Declare a hot region: implicit syncs on this thread are recorded
    as witnesses while it is open. A shared null context manager when
    the probe is disabled."""
    if not _enabled:
        return _NULL
    return _pushed("regions", name)


def sanctioned(site: str):
    """Declare a deliberate-sync site: syncs on this thread while it is
    open are counted under ``site`` instead of witnessed. Null and free
    when the probe is disabled; syncs outside it (even inside the same
    hot region) still trip."""
    if not _enabled:
        return _NULL
    return _pushed("sanctioned", site)


def _record(kind: str) -> None:
    stack = _stack("regions")
    if not stack:
        return
    sanction = _stack("sanctioned")
    if sanction:
        with _lock:
            k = (sanction[-1], kind)
            _sanctioned_counts[k] = _sanctioned_counts.get(k, 0) + 1
        return
    # the caller's frames: not this one, _probing's two (the generator
    # and contextlib's __enter__) nor the patched method's
    frames = traceback.format_list(
        traceback.extract_stack(limit=_STACK_LIMIT + 4)[:-4])
    with _lock:
        _witnesses.append({
            "kind": kind,
            "region": stack[-1],
            "stack": "".join(frames),
        })
        observers = list(_observers)
    for fn in observers:
        fn(stack[-1], kind)


@contextlib.contextmanager
def _probing(kind: str):
    """Record ``kind`` once: the calls the original makes inside (a
    tensor's ``__array__`` calls its ``numpy``) are not syncs of their
    own."""
    if getattr(_tls, "inside", False):
        yield
        return
    _record(kind)
    _tls.inside = True
    try:
        yield
    finally:
        _tls.inside = False


def add_observer(fn) -> None:
    """``fn(region, kind)`` on every UNSANCTIONED implicit sync inside
    an open region. Idempotent per callable; observers fire outside the
    probe's lock."""
    with _lock:
        if fn not in _observers:
            _observers.append(fn)


def remove_observer(fn) -> None:
    with _lock:
        if fn in _observers:
            _observers.remove(fn)


def _wrap_method(cls, name: str):
    orig = getattr(cls, name)

    def probe(self, *args, **kwargs):
        with _probing(name):
            return orig(self, *args, **kwargs)

    probe.__name__ = name
    probe.__qualname__ = f"{cls.__name__}.{name}"
    return orig, probe


def _wrap_numpy(label: str, orig, cls):
    def probe(a, *args, **kwargs):
        if not isinstance(a, cls):
            return orig(a, *args, **kwargs)
        with _probing(label):
            return orig(a, *args, **kwargs)

    probe.__name__ = orig.__name__
    return probe


def install() -> bool:
    """Patch the sync entry points on ``torch.Tensor`` and numpy's
    ``asarray``/``array``. Idempotent; returns True if the probe is
    (now) installed. No-op when disabled."""
    global _installed
    if not _enabled:
        return False
    with _lock:
        if _installed:
            return True
        import numpy as np
        import torch

        cls = torch.Tensor
        for name in _SYNC_METHODS:
            owned = name in cls.__dict__
            orig, probe = _wrap_method(cls, name)
            _originals.append((cls, name, orig, owned))
            setattr(cls, name, probe)
        for fname in _NUMPY_FUNCS:
            orig = getattr(np, fname)
            _originals.append((np, fname, orig, True))
            setattr(np, fname, _wrap_numpy(f"np.{fname}", orig, cls))
        _installed = True
        return True


def uninstall() -> None:
    """Restore every patched attribute (tests pair this with install)."""
    global _installed
    with _lock:
        for owner, name, orig, owned in reversed(_originals):
            if owned:
                setattr(owner, name, orig)
            else:
                delattr(owner, name)
        _originals.clear()
        _installed = False


def witnesses() -> list[dict]:
    """All recorded implicit-sync witnesses."""
    with _lock:
        return list(_witnesses)


def sanctioned_counts() -> dict:
    """``{(site, kind): count}`` for syncs under :func:`sanctioned`."""
    with _lock:
        return dict(_sanctioned_counts)


def reset() -> None:
    """Drop recorded witnesses and sanctioned-site tallies (the patch,
    if installed, remains)."""
    with _lock:
        _witnesses.clear()
        _sanctioned_counts.clear()
