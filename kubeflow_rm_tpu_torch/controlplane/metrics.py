"""The control-plane counters the port's seams feed, on the standard
library alone (the JAX control plane's are ``prometheus_client``
metrics in ``kubeflow_rm_tpu/controlplane/metrics.py``, a package the
card's machine does not have).

A metric is labelled like ``prometheus_client``'s: ``.labels(**kw)``
gives the child series, which ``.inc()``s (counter) or ``.set()``s
(gauge), and ``.get()`` reads it back. :func:`render` writes the
Prometheus text format under the JAX control plane's series names
(``jit_recompiles_total{tenant="..."}``, ...), so a scrape of either
reads the same series.
"""

from __future__ import annotations

import logging
import math
import threading

_swallow_log = logging.getLogger("kubeflow_rm_tpu_torch.swallowed")


class _Series:
    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("a counter only goes up")
        with self._lock:
            self._value += amount

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def get(self) -> float:
        with self._lock:
            return self._value


class _Metric:
    kind = ""
    suffix = ""

    def __init__(self, name: str, documentation: str,
                 labelnames: tuple = ()):
        self.name = name + self.suffix
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._series: dict[tuple, _Series] = {}
        if not self.labelnames:
            self._series[()] = _Series()
        REGISTRY.append(self)

    def labels(self, **labels) -> _Series:
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name} takes labels "
                             f"{self.labelnames}, got {sorted(labels)}")
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            return self._series.setdefault(key, _Series())

    def _unlabelled(self) -> _Series:
        if self.labelnames:
            raise ValueError(f"{self.name} is labelled: use .labels()")
        return self._series[()]

    def get(self, **labels) -> float:
        """The series' value (0 for a series never touched)."""
        if not labels:
            return self._unlabelled().get()
        key = tuple(str(labels[n]) for n in self.labelnames)
        with self._lock:
            series = self._series.get(key)
        return 0.0 if series is None else series.get()

    def samples(self) -> list[tuple[dict, float]]:
        with self._lock:
            items = list(self._series.items())
        return [(dict(zip(self.labelnames, k)), s.get()) for k, s in items]


class Counter(_Metric):
    """A monotonic counter; its series carries the ``_total`` suffix, as
    ``prometheus_client``'s does."""
    kind = "counter"
    suffix = "_total"

    def inc(self, amount: float = 1.0) -> None:
        self._unlabelled().inc(amount)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float) -> None:
        self._unlabelled().set(value)


#: every metric of this module, in definition order
REGISTRY: list[_Metric] = []


def _format(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def render() -> str:
    """The Prometheus text exposition of this module's metrics."""
    lines = []
    for m in REGISTRY:
        lines.append(f"# HELP {m.name} {m.documentation}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for labels, value in m.samples():
            body = ",".join(f'{k}="{_escape(v)}"' for k, v in labels.items())
            lines.append(f"{m.name}{{{body}}} {_format(value)}" if body
                         else f"{m.name} {_format(value)}")
    return "\n".join(lines) + "\n"


DECLARED_HBM_DRIFT_RATIO = Gauge(
    "declared_hbm_drift_ratio",
    "Worst relative divergence between a workload's observed on-card "
    "peak memory and its webhook-priced declared peak "
    "(|observed - declared| / declared, max over tracked workloads) — "
    "sustained > 0.2 trips the warn-only declared-hbm-drift SLO",
)

JIT_RECOMPILES_TOTAL = Counter(
    "jit_recompiles",
    "New (shape, dtype, static-arg) signatures observed by the "
    "torchcheck recompile sentinel, per tenant (the JAX control plane's "
    "jit_recompiles_total series)",
    ["tenant"],
)

IMPLICIT_HOSTSYNCS_TOTAL = Counter(
    "implicit_hostsyncs",
    "Implicit device->host syncs (bool()/.item()/np.asarray on tensors) "
    "witnessed by the torchcheck host-sync probe inside instrumented "
    "regions, per tenant — each one stalls the card for a host round "
    "trip",
    ["tenant"],
)

SWALLOWED_ERRORS_TOTAL = Counter(
    "swallowed_errors",
    "Exceptions intentionally absorbed on best-effort paths, by module",
    ["module"],
)


def swallowed(module: str, context: str = "") -> None:
    """Account for an intentionally absorbed exception. Call from inside
    an ``except`` block: increments ``swallowed_errors_total{module}``
    and debug-logs the traceback."""
    SWALLOWED_ERRORS_TOTAL.labels(module=module).inc()
    _swallow_log.debug("swallowed in %s%s", module,
                       f" ({context})" if context else "", exc_info=True)
