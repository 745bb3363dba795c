"""The serving gateway's rate limiter (counterpart of ``TokenBucket``
in ``kubeflow_rm_tpu/controlplane/deploy/kubeclient.py:111``; the rest
of that client is the JAX control plane's and is not ported)."""

from __future__ import annotations

import time
from typing import Callable

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock


class TokenBucket:
    """A qps/burst throttle — client-go's
    ``flowcontrol.NewTokenBucketRateLimiter``.

    ``acquire`` debits tokens, sleeping when the bucket is dry. Tokens
    refill at ``qps``; the bucket holds at most ``burst``, so a cold
    caller may spend ``burst`` back to back before the steady rate
    applies. Tokens may go negative (waiters queue by their computed
    wait). ``try_acquire`` never sleeps: the serving gateway sheds an
    over-limit request at once. Thread-safe; ``clock``/``sleep`` are
    injectable for deterministic tests."""

    def __init__(self, qps: float, burst: int | None = None, *,
                 clock: Callable[[], float] | None = None,
                 sleep: Callable[[float], None] | None = None):
        if qps <= 0:
            raise ValueError(f"qps must be > 0, got {qps}")
        self.qps = float(qps)
        self.burst = int(burst) if burst else max(1, int(2 * qps))
        self._clock = clock or time.monotonic
        self._sleep = sleep or time.sleep
        self._tokens = float(self.burst)
        self._last = self._clock()
        self._lock = make_lock("kubeclient.token_bucket")
        # total seconds of wait injected, and the calls throttled
        self.throttled_seconds = 0.0
        self.throttled_calls = 0

    def _refill_locked(self) -> None:
        now = self._clock()
        self._tokens = min(float(self.burst),
                           self._tokens + (now - self._last) * self.qps)
        self._last = now

    def acquire(self, n: float = 1.0) -> float:
        """Take ``n`` tokens, sleeping until they are covered. Returns
        the wait injected (0.0 when the bucket had capacity)."""
        with self._lock:
            self._refill_locked()
            self._tokens -= n
            wait = 0.0 if self._tokens >= 0 else -self._tokens / self.qps
            if wait > 0:
                self.throttled_seconds += wait
                self.throttled_calls += 1
        if wait > 0:
            self._sleep(wait)
        return wait

    def try_acquire(self, n: float = 1.0) -> bool:
        """Debit ``n`` tokens iff the bucket covers them now; else leave
        the bucket untouched and return False."""
        with self._lock:
            self._refill_locked()
            if self._tokens < n:
                self.throttled_calls += 1
                return False
            self._tokens -= n
            return True
