"""The port's observability seam
(``kubeflow_rm_tpu_torch/controlplane/obs/slo.py`` and its stdlib
``controlplane/metrics.py``) against JAX's bridges
(``kubeflow_rm_tpu/controlplane/obs/slo.py``): the same tenant-named
sequence of recompiles and region syncs, through each probe and each
bridge, gives the same per-tenant counts and the same exposition lines;
and a healthy CPU ``fit`` under the bridges (LoRA, then full fine-tuning
with adafactor, whose factored update rounds its Python scalars on the
host) leaves ``implicit_hostsyncs_total`` at 0."""

import itertools

import jax.numpy as jnp
import numpy as np
import prometheus_client
import pytest
import torch

from kubeflow_rm_tpu.analysis.jaxcheck import hostsync as jsync
from kubeflow_rm_tpu.analysis.jaxcheck import recompile as jrec
from kubeflow_rm_tpu.controlplane import metrics as jmetrics
from kubeflow_rm_tpu.controlplane.obs import slo as jslo
from kubeflow_rm_tpu_torch.analysis.torchcheck import hostsync as tsync
from kubeflow_rm_tpu_torch.analysis.torchcheck import recompile as trec
from kubeflow_rm_tpu_torch.controlplane import metrics as tmetrics
from kubeflow_rm_tpu_torch.controlplane.obs import slo as tslo

SERIES = ("jit_recompiles_total", "implicit_hostsyncs_total")
# tenants no other test names: their series start at 0 in either registry
TENANTS = ("obsA", "obsB", "default")


@pytest.fixture()
def probes():
    for mod in (jsync, tsync, jrec, trec):
        mod.set_enabled(True)
        mod.reset()
    assert jsync.install() and tsync.install()
    jslo.install_probe_bridges()
    tslo.install_probe_bridges()
    tslo.install_probe_bridges()       # idempotent
    yield
    jsync.uninstall()
    tsync.uninstall()
    for mod in (jsync, tsync, jrec, trec):
        mod.set_enabled(False)
        mod.reset()


def _jax_counts():
    return {(name, t): getattr(jmetrics, const).labels(tenant=t)._value.get()
            for name, const in (("jit_recompiles_total",
                                 "JIT_RECOMPILES_TOTAL"),
                                ("implicit_hostsyncs_total",
                                 "IMPLICIT_HOSTSYNCS_TOTAL"))
            for t in TENANTS}


def _port_counts():
    return {(name, t): getattr(tmetrics, const).get(tenant=t)
            for name, const in (("jit_recompiles_total",
                                 "JIT_RECOMPILES_TOTAL"),
                                ("implicit_hostsyncs_total",
                                 "IMPLICIT_HOSTSYNCS_TOTAL"))
            for t in TENANTS}


def _delta(after, before):
    return {k: after[k] - before[k] for k in after}


def _drive(sync, rec, ones, asarray):
    """The sequence: signatures noted per tenant (a repeat mints none),
    syncs inside regions (nested, sanctioned, unprefixed) and outside."""
    for n in (4, 8, 4, 16):
        rec.note("obsA/engine.prefill", ones(n))
    rec.note("obsB/engine.decode_step", ones(1), temperature=0.0)
    rec.note("obsB/engine.decode_step", ones(1), temperature=0.7)
    rec.note("engine.prefill", ones(3))
    x = ones(2)
    with sync.region("obsA/decode"):
        float(x.sum())
        bool(x.sum() > 0)
        asarray(x)
        with sync.region("obsB/inner"):
            x.tolist()
        with sync.sanctioned("obsA/stream"):
            float(x.sum())
    with sync.region("train.step"):
        int(x.sum())
    float(x.sum())                       # outside any region


def test_bridges_count_the_same_per_tenant(probes):
    j0, t0 = _jax_counts(), _port_counts()
    _drive(jsync, jrec, lambda n: jnp.ones((n,)), np.asarray)
    _drive(tsync, trec, lambda n: torch.ones(n), np.asarray)
    jd, td = _delta(_jax_counts(), j0), _delta(_port_counts(), t0)
    assert td == jd
    assert td[("jit_recompiles_total", "obsA")] == 3
    assert td[("jit_recompiles_total", "obsB")] == 2
    assert td[("implicit_hostsyncs_total", "obsA")] == 3
    assert td[("implicit_hostsyncs_total", "obsB")] == 1
    assert td[("implicit_hostsyncs_total", "default")] == 1

    # a scrape reads the same series, JAX's names and labels
    jtext = prometheus_client.generate_latest(jmetrics.REGISTRY).decode()
    ttext = tmetrics.render()
    for name in SERIES:
        for t in ("obsA", "obsB"):
            prefix = f'{name}{{tenant="{t}"}} '
            want = [ln for ln in jtext.splitlines() if ln.startswith(prefix)]
            got = [ln for ln in ttext.splitlines() if ln.startswith(prefix)]
            assert got == want and len(got) == 1
        assert f"# TYPE {name} counter" in ttext


def test_tenant_of_matches_jax():
    for name in ("teamA/decode-step", "decode-step", "/x", "a/b/c", "",
                 "train.step"):
        assert tslo.tenant_of(name) == jslo.tenant_of(name)


def test_rate_limits_are_jaxs():
    """The SLOs on the bridged series and on the drift gauge, read off
    each package's ``default_slos()``: the same names, kinds, windows and
    thresholds."""
    names = ("jit-recompile-storm", "implicit-hostsync-storm",
             "declared-hbm-drift")
    specs = {}
    for pkg, mod in (("jax", jslo), ("port", tslo)):
        specs[pkg] = {s.name: s.spec() for s in mod.default_slos()
                      if s.name in names}
        for spec in specs[pkg].values():
            spec.pop("description")
    assert specs["port"] == specs["jax"] and len(specs["port"]) == 3
    limits = {s.metric: s.allowed_per_s for s in tslo.default_slos()
              if isinstance(s, tslo.TenantRateSLO)}
    assert limits == {"jit_recompiles_total": 1.0 / 30.0,
                      "implicit_hostsyncs_total": 1.0 / 30.0}
    assert specs["port"]["declared-hbm-drift"]["threshold"] == 0.2
    # in the port's terms: one implicit sync a step of a 0.6 s step
    # burns the budget fifty-fold
    assert (1 / 0.6) / limits["implicit_hostsyncs_total"] == \
        pytest.approx(50.0)


@pytest.mark.parametrize("recipe", ["lora", "adafactor"])
def test_healthy_fit_burns_no_hostsync_budget(probes, recipe):
    from kubeflow_rm_tpu_torch.models.llama import LlamaConfig, init_params
    from kubeflow_rm_tpu_torch.models.lora import add_lora
    from kubeflow_rm_tpu_torch.training.data import synthetic_batches
    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.train import (
        TrainConfig, init_train_state,
    )

    cfg = LlamaConfig.tiny()
    if recipe == "lora":
        params = add_lora(init_params(cfg, torch.Generator().manual_seed(0),
                                      "cpu"), 4,
                          generator=torch.Generator().manual_seed(1))
        optim = OptimConfig(train_only="lora")
    else:
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        optim = OptimConfig(factored=True, factored_min_dim=16)
    tcfg = TrainConfig(model=cfg, optim=optim)
    before = tmetrics.IMPLICIT_HOSTSYNCS_TOTAL.get(tenant="default")
    _, history = fit(tcfg, itertools.islice(synthetic_batches(2, 16, 256),
                                            3),
                     LoopConfig(total_steps=3, log_every=1),
                     state=init_train_state(tcfg, params=params),
                     device="cpu")
    assert len(history) == 3 and all(np.isfinite(h.loss) for h in history)
    assert tsync.witnesses() == []
    assert tmetrics.IMPLICIT_HOSTSYNCS_TOTAL.get(tenant="default") == before
