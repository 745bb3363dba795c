"""The port's admission seam
(``kubeflow_rm_tpu_torch/controlplane/webhook/admission_pricer.py``)
against JAX's (``kubeflow_rm_tpu/controlplane/webhook/admission_pricer.py``)
on JAX's ``APIServer``, and the port's pricer behind it on the H100
slice table (``controlplane/api/gpu.py``).

JAX's seam cannot price on this jax (its walker reads ``jax.core.Var``),
so the parity test gives both seams one fixed verdict function in place
of their pricers' ``price`` and ``advise`` (each keeps its own ``parse``)
and runs the same CR sequence through both: create, update, a
status-mirror update, the declaration removed, an unparseable
declaration, and a TPUJob. ``status.admission`` (but its
``accelerator_type``, which names each table's own type), the
annotations, the events and the swallow counts must be equal."""

import json

import pytest

from kubeflow_rm_tpu.analysis.jaxcheck import pricer as jpricer
from kubeflow_rm_tpu.controlplane import metrics as jmetrics
from kubeflow_rm_tpu.controlplane.api.notebook import make_notebook
from kubeflow_rm_tpu.controlplane.api.tpu import (
    DECLARED_WORKLOAD_ANNOTATION,
)
from kubeflow_rm_tpu.controlplane.api.tpu import lookup as tpu_lookup
from kubeflow_rm_tpu.controlplane.api.tpujob import make_tpujob
from kubeflow_rm_tpu.controlplane.apiserver import APIServer
from kubeflow_rm_tpu.controlplane.webhook import admission_pricer as jseam
from kubeflow_rm_tpu_torch.analysis.torchcheck import pricer as tpricer
from kubeflow_rm_tpu_torch.controlplane import metrics as tmetrics
from kubeflow_rm_tpu_torch.controlplane.api import gpu
from kubeflow_rm_tpu_torch.controlplane.obs import slo
from kubeflow_rm_tpu_torch.controlplane.webhook import admission_pricer as tseam

NS = "user1"
FIT = {"preset": "llama2_7b", "optim": "adafactor", "batch": 32,
       "grad_accum": 32, "remat": "full", "seq": 2048}
REJECT = dict(FIT, optim="adamw")


def fixed_price(decl, *, chips, hbm_gib_per_chip=None):
    """One verdict for both seams, from the declaration alone."""
    d = decl.to_dict()
    fit = d["optim"] == "adafactor"
    peak = 53.91 if fit else 80.86
    return {
        "verdict": "fit" if fit else "rejected", "workload": d,
        "chips": chips, "predicted_peak_gb": peak,
        "predicted_peak_per_chip_gb": round(peak / chips, 2),
        "budget_per_chip_gb": 10.0, "hbm_margin": 0.05, "binds": "grads",
        "breakdown_gb": {"params": 13.48, "grads": 13.48},
        "flops_per_step": 1.25e15, "n_params": 6738415616,
        "tenant": d.get("tenant", "default"),
        "explanation": f"{d['optim']} predicted {peak} GB",
    }


def fixed_advise(decl, *, chips, hbm_gib_per_chip=None):
    return {"workload": dict(decl.to_dict(), offload="optimizer"),
            "predicted_peak_per_chip_gb": 1.0, "budget_per_chip_gb": 10.0,
            "note": "cheapest passing rung: offload=optimizer"}


def _swallows(metrics_mod, jax_side: bool) -> float:
    series = metrics_mod.SWALLOWED_ERRORS_TOTAL.labels(module="admission")
    return series._value.get() if jax_side else series.get()


class Side:
    """One seam on its own JAX APIServer."""

    def __init__(self, seam, accelerator: str, jax_side: bool):
        self.api = APIServer()
        self.api.ensure_namespace(NS)
        seam.AdmissionPricer(self.api).register()
        self.accelerator, self.jax_side = accelerator, jax_side
        self.metrics = jmetrics if jax_side else tmetrics
        self.swallowed0 = _swallows(self.metrics, jax_side)

    def view(self, kind: str, name: str) -> dict:
        obj = self.api.get(kind, name, NS)
        adm = (obj.get("status") or {}).get("admission")
        if adm is not None:
            adm = dict(adm)
            assert adm.pop("accelerator_type") == self.accelerator
        ann = {k: v for k, v in obj["metadata"].get("annotations",
                                                      {}).items()
               if k.startswith("tpu.kubeflow.org/")}
        events = [(e["type"], e["reason"], e["message"])
                  for e in self.api.events_for(obj)]
        return {"admission": adm, "annotations": ann, "events": events,
                "swallowed": _swallows(self.metrics, self.jax_side)
                - self.swallowed0}


def _set_declaration(api, kind, name, value):
    obj = api.get(kind, name, NS)
    ann = obj["metadata"].setdefault("annotations", {})
    if value is None:
        ann.pop(DECLARED_WORKLOAD_ANNOTATION, None)
    else:
        ann[DECLARED_WORKLOAD_ANNOTATION] = value
    api.update(obj)


def _mirror(api, kind, name):
    """A status-mirror UPDATE: admission runs again, nothing declared
    changes."""
    obj = api.get(kind, name, NS)
    labels = obj["metadata"].setdefault("labels", {})
    labels["mirror"] = str(int(labels.get("mirror", "0")) + 1)
    api.update(obj)


def test_seams_write_the_same_status_annotations_and_events(monkeypatch):
    for mod in (jpricer, tpricer):
        monkeypatch.setattr(mod, "price", fixed_price)
        monkeypatch.setattr(mod, "advise", fixed_advise)
    sides = [Side(jseam, "v5litepod-8", True),
             Side(tseam, "h100-80gb-8", False)]
    assert tpu_lookup("v5litepod-8").chips == gpu.lookup("h100-80gb-8").cards

    steps = [
        ("create", lambda s: s.api.create(make_notebook(
            "nb", NS, accelerator_type=s.accelerator,
            annotations={DECLARED_WORKLOAD_ANNOTATION: json.dumps(FIT)}))),
        ("update: rejected", lambda s: _set_declaration(
            s.api, "Notebook", "nb", json.dumps(REJECT))),
        ("status mirror", lambda s: _mirror(s.api, "Notebook", "nb")),
        ("removed", lambda s: _set_declaration(s.api, "Notebook", "nb",
                                               None)),
        ("unparseable", lambda s: _set_declaration(
            s.api, "Notebook", "nb", "{not json")),
        ("mirror of unparseable", lambda s: _mirror(s.api, "Notebook",
                                                    "nb")),
        ("unknown preset", lambda s: _set_declaration(
            s.api, "Notebook", "nb", json.dumps(dict(FIT, preset="nope")))),
        ("fits again", lambda s: _set_declaration(
            s.api, "Notebook", "nb", json.dumps(FIT))),
    ]
    trail = []
    for label, act in steps:
        views = []
        for s in sides:
            act(s)
            views.append(s.view("Notebook", "nb"))
        assert views[0] == views[1], label
        trail.append((label, views[0]))
    by = dict(trail)
    assert by["create"]["admission"]["verdict"] == "fit"
    assert by["update: rejected"]["admission"]["advisor"]["note"]
    assert [e[1] for e in by["status mirror"]["events"]] == \
        ["AdmissionRejected"]
    assert by["removed"]["admission"] is None
    assert by["removed"]["annotations"] == {}
    assert by["unparseable"]["swallowed"] == 1
    assert by["mirror of unparseable"]["swallowed"] == 1
    assert by["unknown preset"]["swallowed"] == 2
    assert by["fits again"]["admission"]["verdict"] == "fit"

    # a TPUJob: the learner role's accelerator is the slice priced
    views = []
    for s in sides:
        s.api.create(make_tpujob(
            "job", NS, roles=[
                {"name": "actors", "replicas": 2, "cpu": "1"},
                {"name": "learner", "replicas": 1,
                 "tpu": {"acceleratorType": s.accelerator}}],
            annotations={DECLARED_WORKLOAD_ANNOTATION: json.dumps(REJECT)}))
        views.append(s.view("TPUJob", "job"))
    assert views[0] == views[1]
    assert views[0]["admission"]["verdict"] == "rejected"


def test_unknown_accelerator_and_cpu_workloads_are_not_priced(monkeypatch):
    monkeypatch.setattr(tpricer, "price", fixed_price)
    seam = tseam.AdmissionPricer(None)
    for acc in ("v5litepod-8", None):
        nb = make_notebook("nb", NS, accelerator_type=acc,
                           annotations={DECLARED_WORKLOAD_ANNOTATION:
                                        json.dumps(FIT)})
        assert seam("CREATE", nb, None) is None
    assert tseam.slice_topology_of(make_notebook(
        "nb", NS, accelerator_type="h100-80gb-4")).cards == 4


def test_gpu_table():
    assert sorted(gpu.TOPOLOGIES) == ["h100-80gb-1", "h100-80gb-2x4",
                                      "h100-80gb-2x8", "h100-80gb-4",
                                      "h100-80gb-8"]
    for name, t in gpu.TOPOLOGIES.items():
        shape = name.rsplit("-", 1)[1]
        hosts, per_host = (1, int(shape)) if "x" not in shape else map(
            int, shape.split("x"))
        assert (t.hosts, t.cards_per_host) == (hosts, per_host)
        assert t.cards == hosts * per_host
        assert t.topology == str(per_host)
        assert t.gke_accelerator == "nvidia-h100-80gb"
        assert t.card_flops_bf16 == 989e12
        assert t.hbm_gib_per_chip == 79.1787109375
        assert t.multihost == (hosts > 1)
    with pytest.raises(gpu.UnknownAcceleratorType):
        gpu.lookup("v5litepod-8")


def test_declared_drift_gauge():
    rows = [{"priced_on_chip_peak_gb": 50.0, "native_on_chip_peak_gb": 52.0},
            {"priced_on_chip_peak_gb": None, "delta_pct": -3.0}]
    assert tseam.record_declared_drift(rows) == pytest.approx(0.04)
    assert tmetrics.DECLARED_HBM_DRIFT_RATIO.get() == pytest.approx(0.04)
    # the same rows through JAX's bridge record the same ratio
    assert jseam.record_declared_drift(rows) == pytest.approx(0.04)
    assert tseam.record_declared_drift([]) == 0.0
    # the warn-only SLO that reads the gauge, thresholded as JAX's
    (drift_slo,) = [s for s in slo.default_slos()
                    if s.metric == "declared_hbm_drift_ratio"]
    assert drift_slo.name == "declared-hbm-drift"
    assert drift_slo.threshold == 0.2


# PERF.md's declarations on the H100 slices, priced for real. The 7B
# adamw declaration fits one card since the accumulation adds in place
# (76.99 GB predicted, 80.84 with the margin, against 83.69 usable); it
# was rejected at 80.86 GB while the sum was rebuilt out of place
CASES = [
    ("7B adafactor", FIT, "h100-80gb-1", "fit"),
    ("7B adafactor", FIT, "h100-80gb-4", "fit"),
    ("7B adamw", REJECT, "h100-80gb-1", "fit"),
    ("7B adamw", REJECT, "h100-80gb-4", "fit"),
    ("13B adamw", dict(REJECT, preset="llama2_13b"), "h100-80gb-1",
     "rejected"),
]


def test_real_pricer_on_the_h100_table():
    api = APIServer()
    api.ensure_namespace(NS)
    tseam.AdmissionPricer(api).register()
    for i, (label, decl, acc, want) in enumerate(CASES):
        api.create(make_notebook(
            f"nb{i}", NS, accelerator_type=acc,
            annotations={DECLARED_WORKLOAD_ANNOTATION: json.dumps(decl)}))
        obj = api.get("Notebook", f"nb{i}", NS)
        adm = obj["status"]["admission"]
        topo = gpu.lookup(acc)
        direct = tpricer.price(tpricer.parse(decl), chips=topo.cards,
                               hbm_gib_per_chip=topo.hbm_gib_per_chip)
        assert adm["verdict"] == want, (label, acc, adm["explanation"])
        assert {k: v for k, v in adm.items()
                if k not in ("accelerator_type", "advisor")} == direct
        ann = obj["metadata"]["annotations"]
        assert ann[gpu.PREDICTED_HBM_ANNOTATION] == \
            str(direct["predicted_peak_gb"])
        assert ann[gpu.PREDICTED_FLOPS_ANNOTATION] == \
            str(direct["flops_per_step"])
        if label == "13B adamw":
            # the cheapest passing rung is the streamed host-offload
            # optimizer (79.49 GB a card since a stacked leaf's backward
            # builds its gradient in place; no rung fit while each layer
            # made a whole-leaf gradient tensor)
            assert adm["advisor"] == tpricer.advise(
                tpricer.parse(decl), chips=topo.cards,
                hbm_gib_per_chip=topo.hbm_gib_per_chip)
            assert adm["advisor"]["workload"]["offload"] == "optimizer"
            reasons = [e["reason"] for e in api.events_for(obj)]
            assert reasons == ["AdmissionRejected"]
