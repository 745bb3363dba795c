"""torchcheck: auditing what the port's programs do to the card
(counterpart of ``kubeflow_rm_tpu/analysis/jaxcheck``).

- :mod:`.costmodel` — a walker of eager programs on meta tensors with a
  per-op FLOPs/bytes model and a live-range peak-memory estimator that
  honours donation (the port's in-place updates), so "this config OOMs"
  becomes a prediction instead of a burned card-hour;
- :mod:`.memplan` — runs the cost model over the full-FT ladder for one
  card (its ``total_memory`` read from the card or given);
- :mod:`.pricer` — the memplan walker shaped for the control plane's
  admission path: parses and bounds a declared-workload annotation,
  prices it against the card's budget (memoized), and runs the
  auto-config advisor ladder for rejected configs;
- :mod:`.recompile` — an opt-in signature sentinel
  (``KFRM_JIT_SENTINEL=1``, free when off) that records (shape, dtype,
  static-arg) signatures per entry point and flags unbounded growth;
- :mod:`.hostsync` — probes for implicit device→host transfers
  (``bool()``, ``.item()``, ``np.asarray`` on tensors) inside decode and
  train loops, reported with witness stacks.

``python -m kubeflow_rm_tpu_torch.analysis.torchcheck`` runs the port's
lint rules KFRM001-008 (``analysis/lint``) over the tree and the cost
model's self-check, as the JAX gate does.
"""

from __future__ import annotations

__all__ = ["CostEstimate", "estimate", "selfcheck", "to_meta"]


def __getattr__(name: str):
    # the cost model imports torch: loaded on first use, so the probes
    # (``hostsync``, ``recompile``), which the control plane's SLO bridge
    # imports, load none
    if name in __all__:
        from . import costmodel
        return getattr(costmodel, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
