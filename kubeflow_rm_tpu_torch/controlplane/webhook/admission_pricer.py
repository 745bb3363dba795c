"""Predictive admission on the port's pricer (counterpart of
``kubeflow_rm_tpu/controlplane/webhook/admission_pricer.py``).

A Notebook or TPUJob that declares its training workload
(``tpu.kubeflow.org/declared-workload``) is priced at admission by
:mod:`kubeflow_rm_tpu_torch.analysis.torchcheck.pricer` against the card
slice its accelerator type names (:mod:`..api.gpu`), before any
placement:

- the verdict (predicted peak against the slice's memory budget, which
  phase binds, the breakdown) lands in ``status.admission``;
- the predicted slice memory and FLOPs are stamped as annotations;
- a config whose predicted peak exceeds the budget is marked
  ``verdict: rejected``, and the **advisor** writes the cheapest passing
  rung into the status;
- a declaration that fails to parse NEVER rejects: admission degrades to
  card-count-only with a ``Warning`` event and a
  ``swallowed_errors_total`` increment.

The CR itself is always admitted; "rejected" means the status says so
and an event says why. The seam takes the API server by duck typing: it
calls ``register_admission(kind, fn)`` and
``record_event(obj, type, reason, message)`` on whatever it is given.
An accelerator type the card table does not know is not priced, as the
JAX seam leaves a type its TPU table does not know.
"""

from __future__ import annotations

import json

from kubeflow_rm_tpu_torch.controlplane import metrics
from kubeflow_rm_tpu_torch.controlplane.api import gpu as gpu_api
from kubeflow_rm_tpu_torch.controlplane.api import notebook as nb_api
from kubeflow_rm_tpu_torch.controlplane.api import tpujob as tj_api
from kubeflow_rm_tpu_torch.controlplane.api.meta import (
    annotations_of,
    deep_get,
    fast_deepcopy,
    name_of,
    namespace_of,
)


def record_declared_drift(agreement) -> float:
    """Bridge ``memplan_agreement`` rows (a workload's observed on-card
    peak against what the pricer predicted from its declaration) into
    ``declared_hbm_drift_ratio`` as the worst absolute delta ratio, the
    gauge the warn-only ``declared-hbm-drift`` SLO reads. Returns the
    ratio it recorded."""
    worst = 0.0
    for row in agreement or ():
        declared = row.get("priced_on_chip_peak_gb")
        observed = row.get("native_on_chip_peak_gb")
        if declared:
            worst = max(worst, abs(observed - declared) / declared)
        elif row.get("delta_pct") is not None:
            worst = max(worst, abs(row["delta_pct"]) / 100.0)
    metrics.DECLARED_HBM_DRIFT_RATIO.set(worst)
    return worst


def slice_topology_of(obj: dict) -> gpu_api.SliceTopology | None:
    """The slice the declared workload would run on: a Notebook's
    ``spec.tpu``, or a TPUJob's learner role. None for a CPU workload or
    a type the card table does not know."""
    if obj.get("kind") == nb_api.KIND:
        try:
            return nb_api.tpu_spec(obj)
        except gpu_api.UnknownAcceleratorType:
            return None
    if obj.get("kind") == tj_api.KIND:
        learner = tj_api.learner_role(tj_api.roles(obj))
        acc = learner and tj_api.role_accelerator(learner)
        if acc:
            try:
                return gpu_api.lookup(acc)
            except gpu_api.UnknownAcceleratorType:
                return None
    return None


def admission_status(obj: dict) -> dict | None:
    """The priced verdict the webhook stamped, if any."""
    adm = deep_get(obj, "status", "admission")
    return adm if isinstance(adm, dict) else None


def is_admission_rejected(obj: dict) -> bool:
    adm = admission_status(obj)
    return bool(adm and adm.get("verdict") == "rejected")


class AdmissionPricer:
    """Prices declared workloads on Notebook and TPUJob CREATE/UPDATE."""

    def __init__(self, api):
        self.api = api

    def register(self) -> None:
        self.api.register_admission(nb_api.KIND, self)
        self.api.register_admission(tj_api.KIND, self)

    def __call__(self, op: str, obj: dict,
                 old: dict | None) -> dict | None:
        if op not in ("CREATE", "UPDATE"):
            return None
        declared = annotations_of(obj).get(
            gpu_api.DECLARED_WORKLOAD_ANNOTATION)
        if not declared:
            # declaration removed: drop the stale verdict so a
            # previously rejected CR isn't gated forever
            if admission_status(obj) is not None:
                obj = fast_deepcopy(obj)
                self._clear(obj)
                return obj
            return None
        topo = slice_topology_of(obj)
        if topo is None:
            return None   # CPU workload: nothing to price against
        obj = fast_deepcopy(obj)
        try:
            self._price(op, obj, old, declared, topo)
        except Exception as e:
            # an unparseable (or unwalkable) declaration degrades to
            # card-count-only admission: a warning and a counter, never
            # a reject, never a crash
            self._clear(obj)
            if old is None or annotations_of(old).get(
                    gpu_api.DECLARED_WORKLOAD_ANNOTATION) != declared:
                # warn once per distinct bad declaration, not on every
                # status-mirror UPDATE that re-runs admission
                metrics.swallowed("admission", "declared-workload pricing")
                try:
                    self.api.record_event(
                        obj, "Warning", "DeclaredWorkloadUnparseable",
                        f"cannot price "
                        f"{gpu_api.DECLARED_WORKLOAD_ANNOTATION}: {e};"
                        f" admitting on chip count only")
                except Exception:
                    metrics.swallowed("admission", "unparseable event")
        return obj

    # -- internals -----------------------------------------------------

    def _price(self, op: str, obj: dict, old: dict | None,
               declared: str, topo: gpu_api.SliceTopology) -> None:
        # imported here: the pricer's walker brings in torch, which a
        # process that only imports this module for the rejection
        # predicate (a shard worker's notebook controller) never needs
        from kubeflow_rm_tpu_torch.analysis.torchcheck import pricer
        decl = pricer.parse(declared)
        verdict = pricer.price(decl, chips=topo.cards,
                               hbm_gib_per_chip=topo.hbm_gib_per_chip)
        verdict["accelerator_type"] = topo.accelerator_type
        if verdict["verdict"] == "rejected":
            advice = pricer.advise(
                decl, chips=topo.cards,
                hbm_gib_per_chip=topo.hbm_gib_per_chip)
            verdict["advisor"] = advice  # None: no rung fits the slice
        obj.setdefault("status", {})["admission"] = verdict
        ann = obj["metadata"].setdefault("annotations", {})
        ann[gpu_api.PREDICTED_HBM_ANNOTATION] = str(
            verdict["predicted_peak_gb"])
        ann[gpu_api.PREDICTED_FLOPS_ANNOTATION] = str(
            verdict["flops_per_step"])
        if verdict["verdict"] == "rejected" and self._newly_rejected(
                obj, old, declared):
            advice = verdict.get("advisor")
            hint = (f"; advisor: {advice['note']} -> "
                    f"{json.dumps(advice['workload'], sort_keys=True)}"
                    if advice else
                    "; no ladder rung fits this slice — use a larger "
                    "accelerator")
            self.api.record_event(
                obj, "Warning", "AdmissionRejected",
                f"{obj['kind']} {namespace_of(obj)}/{name_of(obj)}: "
                f"{verdict['explanation']}{hint}")

    def _newly_rejected(self, obj: dict, old: dict | None,
                        declared: str) -> bool:
        """Emit the rejection event once per distinct declaration, not
        on every status-mirror UPDATE that flows through admission."""
        if old is None:
            return True
        old_declared = annotations_of(old).get(
            gpu_api.DECLARED_WORKLOAD_ANNOTATION)
        return old_declared != declared or not is_admission_rejected(old)

    @staticmethod
    def _clear(obj: dict) -> None:
        status = obj.get("status")
        if isinstance(status, dict):
            status.pop("admission", None)
        ann = obj["metadata"].get("annotations")
        if ann:
            ann.pop(gpu_api.PREDICTED_HBM_ANNOTATION, None)
            ann.pop(gpu_api.PREDICTED_FLOPS_ANNOTATION, None)
