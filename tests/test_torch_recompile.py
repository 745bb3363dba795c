"""The port's signature sentinel (``analysis/torchcheck/recompile.py``)
beside JAX's (``analysis/jaxcheck/recompile.py``): the engine's bucketed
prefill storm stays inside ``log2(slot_len) + 1`` signatures and decode
inside one, an unbucketed storm grows past its limit with witness
stacks, off records nothing, and for the same requests the port's
engine and JAX's (tiny float32 model, JAX's weights carried over) end
with the same signature and call counts per entry, in both cache arms.

Tolerance: none — signatures and calls are counted.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from kubeflow_rm_tpu.analysis.jaxcheck import recompile as jsent
from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu_torch.analysis.torchcheck import recompile as tsent
from kubeflow_rm_tpu_torch.models import llama as tllama
from kubeflow_rm_tpu_torch.models.params import from_numpy_params

jgen = importlib.import_module("kubeflow_rm_tpu.models.generate")
tgen = importlib.import_module("kubeflow_rm_tpu_torch.models.generate")

SLOT_LEN = 32
LENGTHS = (1, 2, 3, 5, 7, 9, 11, 13, 15, 16)      # 10 ragged prompts


@pytest.fixture()
def sentinel():
    tsent.set_enabled(True)
    tsent.reset()
    yield tsent
    tsent.set_enabled(False)
    tsent.reset()


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tcfg = tllama.LlamaConfig.tiny()
    tparams = from_numpy_params(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(1, vocab, size=n).tolist() for n in LENGTHS]


def _storm(gen, params, cfg, paged):
    eng = gen.ContinuousBatchingEngine(params, cfg, slots=2,
                                       slot_len=SLOT_LEN, paged=paged)
    for p in _prompts(cfg.vocab_size):
        eng.submit(p, max_new_tokens=2)
    eng.run()


def _counts(mod):
    return {e: (v["signatures"], v["calls"], v["limit"])
            for e, v in mod.report().items()}


def test_sentinel_bucketed_storm_stays_bounded(sentinel, model):
    """A ragged-length prefill storm through the port's engine holds
    the signature count at <= log2(slot_len)+1 and decode at one."""
    _, _, tcfg, tparams = model
    _storm(tgen, tparams, tcfg, paged=True)
    rep = sentinel.report()
    assert rep["engine.prefill"]["calls"] == len(LENGTHS)
    assert rep["engine.prefill"]["signatures"] <= SLOT_LEN.bit_length()
    assert rep["engine.prefill"]["limit"] == SLOT_LEN.bit_length()
    assert rep["engine.decode_step"]["signatures"] == 1
    assert rep["engine.decode_step"]["limit"] == 1
    # the port runs eagerly: no compile cache to read
    assert rep["engine.prefill"]["jit_cache_size"] is None
    assert sentinel.over_limit() == []


def test_sentinel_unbucketed_storm_grows_unbounded(sentinel):
    """The same storm WITHOUT bucketing: one signature per length, past
    its limit, with the witness stack of each crossing signature."""
    sentinel.set_limit("unbucketed.prefill", 6)
    sentinel.track("unbucketed.prefill", torch.sum)
    for n in range(1, 11):
        x = torch.zeros((1, n), dtype=torch.int32)
        sentinel.note("unbucketed.prefill", x)
        x.sum()
    findings = sentinel.over_limit()
    assert len(findings) == 1
    hit = findings[0]
    assert hit["signatures"] == 10 and hit["limit"] == 6
    assert hit["jit_cache_size"] is None
    assert len(hit["witnesses"]) == 4
    assert "test_torch_recompile" in hit["witnesses"][0]["stack"]


def test_signature_walks_trees_and_statics(sentinel):
    seen = []

    def obs(entry, n):
        seen.append((entry, n))

    sentinel.add_observer(obs)
    try:
        a = {"k": torch.zeros(2, 3),
             "v": [torch.zeros(4, dtype=torch.int8)]}
        sentinel.note("e", a, mode="greedy")
        sentinel.note("e", {"k": torch.ones(2, 3),
                            "v": [torch.ones(4, dtype=torch.int8)]},
                      mode="greedy")             # same shapes: same sig
        sentinel.note("e", a, mode="sampled")    # a static differs
    finally:
        sentinel.remove_observer(obs)
    rep = sentinel.report()["e"]
    assert (rep["signatures"], rep["calls"]) == (2, 3)
    assert seen == [("e", 1), ("e", 2)]


def test_sentinel_off_records_nothing():
    tsent.set_enabled(False)
    tsent.reset()
    tsent.note("ghost", torch.zeros(3))
    tsent.set_limit("ghost", 1)
    tsent.track("ghost", torch.sum)
    assert tsent.report() == {}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_same_signature_counts_as_jax_engine(model, paged):
    jcfg, jparams, tcfg, tparams = model
    jsent.set_enabled(True)
    jsent.reset()
    try:
        _storm(jgen, jparams, jcfg, paged)
        want = _counts(jsent)
    finally:
        jsent.set_enabled(False)
        jsent.reset()
    tsent.set_enabled(True)
    tsent.reset()
    try:
        _storm(tgen, tparams, tcfg, paged)
        got = _counts(tsent)
    finally:
        tsent.set_enabled(False)
        tsent.reset()
    assert set(want) == {"engine.prefill", "engine.decode_step"}
    assert got == want


def test_disabled_engine_declares_nothing(model):
    _, _, tcfg, tparams = model
    tsent.set_enabled(False)
    tsent.reset()
    _storm(tgen, tparams, tcfg, paged=True)
    assert tsent.report() == {}
