"""Port parity for KV-cached generation: ``decode_chunk`` logits against
JAX (atol 1e-4, float32 tiny model), greedy tokens of ``generate`` and
``generate_fused`` equal to JAX ``generate_fused`` token for token, the
ragged-batch contract, the eos latch, and sampling held to its
properties (``torch.Generator`` draws cannot match ``jax.random``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu_torch.models import llama as tllama
from kubeflow_rm_tpu_torch.models.params import from_numpy_params

# the packages export a function named ``generate``: import the modules
jgen = importlib.import_module("kubeflow_rm_tpu.models.generate")
tgen = importlib.import_module("kubeflow_rm_tpu_torch.models.generate")


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tcfg = tllama.LlamaConfig.tiny()
    tparams = from_numpy_params(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, jparams, tcfg, tparams


def _prompt(seed, B, T, lo=0):
    return np.random.default_rng(seed).integers(
        lo, 256, size=(B, T)).astype(np.int32)


def test_prefill_matches_jax(model):
    jcfg, jparams, tcfg, tparams = model
    tok = _prompt(1, 2, 16)
    ref, jcache = jgen.decode_chunk(jparams, jcfg, jgen.init_cache(jcfg, 2, 24),
                                    jnp.asarray(tok))
    cache = tgen.init_cache(tcfg, 2, 24, "cpu")
    got, cache = tgen.decode_chunk(tparams, tcfg, cache, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    assert cache.offset == 16
    np.testing.assert_array_equal(cache.positions.numpy(),
                                  np.asarray(jcache.positions))
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k),
                               atol=1e-5, rtol=1e-5)


def test_prefill_matches_forward(model):
    _, _, tcfg, tparams = model
    tok = torch.from_numpy(_prompt(2, 2, 16))
    cache = tgen.init_cache(tcfg, 2, 24, "cpu")
    logits, _ = tgen.decode_chunk(tparams, tcfg, cache, tok)
    ref = tllama.forward(tparams, tok, tcfg)
    np.testing.assert_allclose(logits.numpy(), ref.numpy(), atol=1e-4)


def test_tokenwise_decode_matches_forward(model):
    _, _, tcfg, tparams = model
    tok = torch.from_numpy(_prompt(3, 1, 10))
    ref = tllama.forward(tparams, tok, tcfg)
    cache = tgen.init_cache(tcfg, 1, 10, "cpu")
    outs = []
    for t in range(10):
        logits, cache = tgen.decode_chunk(tparams, tcfg, cache, tok[:, t:t + 1])
        outs.append(logits)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ref.numpy(),
                               atol=1e-4)


def test_cache_overflow_raises(model):
    _, _, tcfg, tparams = model
    cache = tgen.init_cache(tcfg, 1, 4, "cpu")
    with pytest.raises(ValueError, match="overflows"):
        tgen.decode_chunk(tparams, tcfg, cache,
                          torch.zeros(1, 5, dtype=torch.int32))


@pytest.mark.parametrize("entry", ["generate", "generate_fused"])
def test_greedy_tokens_equal_jax(model, entry):
    jcfg, jparams, tcfg, tparams = model
    prompt = _prompt(4, 3, 7)
    ref = jgen.generate_fused(jparams, jcfg, jnp.asarray(prompt),
                              max_new_tokens=10)
    got = getattr(tgen, entry)(tparams, tcfg, torch.from_numpy(prompt),
                               max_new_tokens=10)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_leftpad_ragged_batch_equals_jax_and_solo_rows(model):
    jcfg, jparams, tcfg, tparams = model
    short, long = _prompt(5, 1, 3, lo=1), _prompt(6, 1, 7, lo=1)
    T = 8
    batch = np.zeros((2, T), np.int32)
    batch[0, T - 3:] = short[0]
    batch[1, T - 7:] = long[0]
    pads = np.array([T - 3, T - 7], np.int32)
    got = tgen.generate_fused(tparams, tcfg, torch.from_numpy(batch),
                              max_new_tokens=6,
                              pad_counts=torch.from_numpy(pads))
    ref = jgen.generate_fused(jparams, jcfg, jnp.asarray(batch),
                              max_new_tokens=6, pad_counts=jnp.asarray(pads))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    solo_s = tgen.generate_fused(tparams, tcfg, torch.from_numpy(short),
                                 max_new_tokens=6)
    solo_l = tgen.generate_fused(tparams, tcfg, torch.from_numpy(long),
                                 max_new_tokens=6)
    np.testing.assert_array_equal(got[0, T - 3:].numpy(), solo_s[0].numpy())
    np.testing.assert_array_equal(got[1, T - 7:].numpy(), solo_l[0].numpy())


def test_eos_latch_equals_jax(model):
    jcfg, jparams, tcfg, tparams = model
    prompt = _prompt(7, 2, 5)
    free = tgen.generate(tparams, tcfg, torch.from_numpy(prompt),
                         max_new_tokens=8)
    eos = int(free[0, 5 + 2])        # row 0 emits it at step 2
    got = tgen.generate(tparams, tcfg, torch.from_numpy(prompt),
                        max_new_tokens=8, eos_id=eos)
    assert (got[0, 5 + 2:] == eos).all()
    ref = jgen.generate_fused(jparams, jcfg, jnp.asarray(prompt),
                              max_new_tokens=8, eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_topk_sampling_stays_in_topk_and_is_seeded(model):
    _, _, tcfg, tparams = model
    prompt = torch.from_numpy(_prompt(8, 2, 6))

    def sample(seed, **kw):
        return tgen.generate_fused(
            tparams, tcfg, prompt, max_new_tokens=8, temperature=1.0,
            generator=torch.Generator().manual_seed(seed), **kw)

    out = sample(0, top_k=5)
    assert torch.equal(out, sample(0, top_k=5))
    assert not torch.equal(sample(0), sample(1))
    # every sampled token is among the 5 highest logits at its step
    logits = tllama.forward(tparams, out[:, :-1], tcfg)
    top5 = torch.topk(logits[:, 5:], 5, dim=-1).indices
    assert (top5 == out[:, 6:, None].long()).any(-1).all()
    # top_k = 1 is greedy whatever the draw
    greedy = tgen.generate_fused(tparams, tcfg, prompt, max_new_tokens=8)
    assert torch.equal(sample(3, top_k=1), greedy)


def test_argument_checks(model):
    _, _, tcfg, tparams = model
    prompt = torch.zeros(1, 4, dtype=torch.int32)
    for entry in (tgen.generate, tgen.generate_fused):
        with pytest.raises(ValueError, match="max_len"):
            entry(tparams, tcfg, prompt, max_new_tokens=4, max_len=6)
        with pytest.raises(ValueError, match="Generator"):
            entry(tparams, tcfg, prompt, max_new_tokens=4, temperature=0.5)


@pytest.fixture(scope="module")
def moe_model():
    """``tiny_moe`` with room for every token (capacity factor 8, JAX's
    decode test): a decode step then routes as a full forward does."""
    from dataclasses import replace

    from kubeflow_rm_tpu.models import mixtral as jmixtral
    from kubeflow_rm_tpu_torch.models import mixtral as tmixtral

    jcfg = jmixtral.MixtralConfig.tiny_moe()
    jcfg = replace(jcfg, moe=replace(jcfg.moe, capacity_factor=8.0))
    jparams = jmixtral.init_params(jcfg, jax.random.key(0))
    tcfg = tmixtral.MixtralConfig.tiny_moe()
    tcfg = replace(tcfg, moe=replace(tcfg.moe, capacity_factor=8.0))
    tparams = from_numpy_params(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, jparams, tcfg, tparams


def test_mixtral_prefill_matches_forward_and_jax(moe_model):
    from kubeflow_rm_tpu_torch.models import mixtral as tmixtral

    jcfg, jparams, tcfg, tparams = moe_model
    tok = _prompt(7, 2, 9, lo=1)
    ref, _ = jgen.decode_chunk(jparams, jcfg, jgen.init_cache(jcfg, 2, 20),
                               jnp.asarray(tok))
    cache = tgen.init_cache(tcfg, 2, 20, "cpu")
    pre, _ = tgen.decode_chunk(tparams, tcfg, cache, torch.from_numpy(tok))
    fwd, _ = tmixtral.forward(tparams, torch.from_numpy(tok), tcfg)
    np.testing.assert_allclose(pre.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(pre.numpy(), fwd.numpy(), atol=1e-5)


@pytest.mark.parametrize("ragged", [False, True])
def test_mixtral_greedy_tokens_equal_jax(moe_model, ragged):
    """Greedy ``generate`` and ``generate_fused`` on the MoE family equal
    JAX's ``generate_fused`` token for token (and each other), with and
    without left padding."""
    jcfg, jparams, tcfg, tparams = moe_model
    tok = _prompt(8, 3, 10, lo=1)
    pads = np.array([0, 3, 6], np.int32) if ragged else None
    want = np.asarray(jgen.generate_fused(
        jparams, jcfg, jnp.asarray(tok), max_new_tokens=8,
        pad_counts=None if pads is None else jnp.asarray(pads)))
    kw = dict(max_new_tokens=8,
              pad_counts=None if pads is None else torch.from_numpy(pads))
    got = tgen.generate(tparams, tcfg, torch.from_numpy(tok), **kw)
    fused = tgen.generate_fused(tparams, tcfg, torch.from_numpy(tok), **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(fused, got)
