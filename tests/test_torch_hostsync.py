"""The port's host-sync probe (``analysis/torchcheck/hostsync.py``)
beside JAX's (``analysis/jaxcheck/hostsync.py``): the same scenarios of
regions, sanctioned sites and resets give the same witnesses (kind and
region) and the same tallies, on CPU tensors and CPU jax arrays alike;
off records nothing; ``uninstall`` restores every patched attribute;
the training loop's ``train.step`` region and the offload step's
sanctioned ``train.offload_stream`` site are wired at JAX's sites.

Tolerance: none — witnesses and tallies are counted.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_rm_tpu.analysis.jaxcheck import hostsync as jsync
from kubeflow_rm_tpu_torch.analysis.torchcheck import hostsync as tsync


@pytest.fixture()
def probe():
    tsync.set_enabled(True)
    tsync.reset()
    assert tsync.install()
    yield tsync
    tsync.uninstall()
    tsync.set_enabled(False)
    tsync.reset()


def _in_region(p, x):
    with p.region("decode-loop"):
        bool(x > 0)
        float(x)
        np.asarray(x)


def _outside(p, x):
    float(x)                      # a deliberate log-boundary sync


def _sanctioned(p, x):
    with p.region("train.step"):
        with p.sanctioned("train.offload_stream"):
            np.asarray(x)
            float(x)


def _unsanctioned_trips(p, x):
    with p.region("train.step"):
        with p.sanctioned("train.offload_stream"):
            np.asarray(x)
        float(x)                  # the bug the probe exists to catch


def _reset_clears(p, x):
    with p.region("r"), p.sanctioned("s"):
        float(x)
    assert p.sanctioned_counts()
    p.reset()


def _nested_regions(p, x):
    # (not ``item()``: JAX's goes through ``np.asarray`` and records
    # both; the port's records one, test_item_is_one_witness)
    with p.region("outer"):
        int(x)
        with p.region("inner"):
            bool(x)
        x.tolist()


SCENARIOS = [_in_region, _outside, _sanctioned, _unsanctioned_trips,
             _reset_clears, _nested_regions]


def _run(mod, scenario, x):
    mod.set_enabled(True)
    mod.reset()
    assert mod.install()
    try:
        scenario(mod, x)
        return ([(w["kind"], w["region"]) for w in mod.witnesses()],
                mod.sanctioned_counts())
    finally:
        mod.uninstall()
        mod.set_enabled(False)
        mod.reset()


@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_same_witnesses_and_tallies_as_jax(scenario):
    want = _run(jsync, scenario, jnp.asarray(2.0))
    got = _run(tsync, scenario, torch.tensor(2.0))
    assert got == want


def test_witness_stack_names_the_caller(probe):
    x = torch.tensor(1.0)
    with probe.region("decode-loop"):
        float(x)
    w = probe.witnesses()[0]
    assert w["region"] == "decode-loop" and w["kind"] == "__float__"
    last = w["stack"].strip().splitlines()[-2]
    assert "test_torch_hostsync.py" in last


def test_numpy_of_a_tensor_is_one_witness(probe):
    """``np.asarray(t)`` reaches ``t.numpy()`` through ``__array__``:
    one sync, one witness."""
    x = torch.ones(3)
    with probe.region("r"):
        np.asarray(x)
        np.array(x)
        x.numpy()
        np.asarray([1, 2])        # not a tensor: no sync
    assert [w["kind"] for w in probe.witnesses()] == [
        "np.asarray", "np.array", "numpy"]


def test_item_is_one_witness(probe):
    x = torch.tensor(5)
    with probe.region("r"):
        x.item()
        x.__index__()
    assert [w["kind"] for w in probe.witnesses()] == ["item", "__index__"]


def test_off_records_nothing():
    tsync.set_enabled(False)
    tsync.reset()
    assert tsync.install() is False
    x = torch.tensor(3.0)
    with tsync.region("anything"):
        float(x)
    assert tsync.witnesses() == []
    # a disabled region or site is the one shared null context
    assert tsync.region("a") is tsync.region("b") is tsync.sanctioned("c")


def test_uninstall_restores_every_attribute():
    names = ("__bool__", "__int__", "__float__", "__index__", "item",
             "tolist", "numpy")
    before = {n: getattr(torch.Tensor, n) for n in names}
    own = {n for n in names if n in torch.Tensor.__dict__}
    np_before = (np.asarray, np.array)
    tsync.set_enabled(True)
    try:
        assert tsync.install() and tsync.install()   # idempotent
        assert all(getattr(torch.Tensor, n) is not before[n] for n in names)
        assert np.asarray is not np_before[0]
        tsync.uninstall()
    finally:
        tsync.set_enabled(False)
    assert {n: getattr(torch.Tensor, n) for n in names} == before
    assert {n for n in names if n in torch.Tensor.__dict__} == own
    assert (np.asarray, np.array) == np_before


def test_observers_fire_on_unsanctioned_syncs(probe):
    seen = []

    def obs(region, kind):
        seen.append((region, kind))

    probe.add_observer(obs)
    probe.add_observer(obs)           # idempotent
    try:
        x = torch.tensor(1.0)
        with probe.region("r"):
            float(x)
            with probe.sanctioned("s"):
                float(x)
    finally:
        probe.remove_observer(obs)
    assert seen == [("r", "__float__")]


@pytest.mark.parametrize("offload", ["optimizer", "none"])
def test_training_regions_are_wired(probe, offload, monkeypatch):
    """``fit`` opens ``train.step`` around the step. The on-card arm has
    no witness at all: the optimizer rounds its Python scalars on the
    host (``optim._weak``), without making or reading a tensor. The
    host-offload arm's transfers and host update run under the
    sanctioned ``train.offload_stream`` site: a sync there (here one put
    into the host update on purpose) is tallied, never witnessed."""
    from kubeflow_rm_tpu_torch.models.llama import LlamaConfig
    from kubeflow_rm_tpu_torch.training import optim
    from kubeflow_rm_tpu_torch.training.data import synthetic_batches
    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit
    from kubeflow_rm_tpu_torch.training.optim import OptimConfig
    from kubeflow_rm_tpu_torch.training.train import TrainConfig

    if offload == "optimizer":
        weak = optim._weak
        monkeypatch.setattr(optim, "_weak", lambda x, t: (
            torch.tensor(x, dtype=t.dtype).item(), weak(x, t))[1])
    cfg = TrainConfig(model=LlamaConfig.tiny(),
                      optim=OptimConfig(offload=offload))
    fit(cfg, itertools.islice(synthetic_batches(2, 16, 256), 2),
        LoopConfig(total_steps=2, log_every=1), device="cpu")
    counts = probe.sanctioned_counts()
    wit = probe.witnesses()
    if offload == "optimizer":
        assert wit == []
        assert set(counts) == {("train.offload_stream", "item")}
        assert counts[("train.offload_stream", "item")] > 0
    else:
        assert counts == {}
        assert wit == []
