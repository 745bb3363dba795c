"""The port's probe bridges into the per-tenant counters (counterpart of
``tenant_of`` and ``install_probe_bridges`` in
``kubeflow_rm_tpu/controlplane/obs/slo.py``).

The JAX control plane burns two warn-only per-tenant rate SLOs against
``jit_recompiles_total`` and ``implicit_hostsyncs_total``, fed by the
jaxcheck sentinel and probe. Here the port's sentinel and probe
(``analysis/torchcheck/recompile.py`` and ``hostsync.py``) feed the same
series in :mod:`..metrics`. The SLO engine and its time series are plain
Python of the control plane and are not ported; their thresholds are,
so a test or the smoke can state a burn in the port's terms.
"""

from __future__ import annotations

from kubeflow_rm_tpu_torch.analysis.lockgraph import make_lock

#: the warn-only per-tenant SLOs on these series (JAX's
#: ``jit-recompile-storm`` and ``implicit-hostsync-storm``): a tenant
#: faster than this many events a second burns its budget
RATE_LIMITS_PER_S = {
    "jit_recompiles_total": 1.0 / 30.0,
    "implicit_hostsyncs_total": 1.0 / 30.0,
}
#: the warn-only ``declared-hbm-drift`` gauge SLO's threshold
DECLARED_HBM_DRIFT_LIMIT = 0.2


def tenant_of(name: str) -> str:
    """Tenant from a probe entry/region name: the convention is
    ``<tenant>/<site>`` (``teamA/decode-step``); unprefixed names fold
    into ``default``."""
    tenant, sep, _ = name.partition("/")
    return tenant if sep and tenant else "default"


_bridges_lock = make_lock("obs.bridges")
_bridges_installed = False


def install_probe_bridges() -> None:
    """Wire the port's recompile sentinel and host-sync probe into the
    per-tenant ``jit_recompiles_total`` / ``implicit_hostsyncs_total``
    counters. Idempotent; the probes stay importable (and free) without
    this module — this is the only coupling point, one-directional."""
    global _bridges_installed
    with _bridges_lock:
        if _bridges_installed:
            return
        from kubeflow_rm_tpu_torch.analysis.torchcheck import (
            hostsync, recompile,
        )
        from kubeflow_rm_tpu_torch.controlplane import metrics

        def _on_recompile(entry: str, n_signatures: int) -> None:
            metrics.JIT_RECOMPILES_TOTAL.labels(
                tenant=tenant_of(entry)).inc()

        def _on_hostsync(region: str, kind: str) -> None:
            metrics.IMPLICIT_HOSTSYNCS_TOTAL.labels(
                tenant=tenant_of(region)).inc()

        recompile.add_observer(_on_recompile)
        hostsync.add_observer(_on_hostsync)
        _bridges_installed = True
