"""Port parity: ``kubeflow_rm_tpu_torch.models.llama.forward`` against the
JAX ``forward`` on ``LlamaConfig.tiny()`` (float32). JAX parameters are
built once and carried over with ``from_numpy_params``; the two random
generators are never compared.

Tolerance atol = rtol = 1e-4: two float32 layers of matmuls, norms and
softmax, summed in different orders.
"""

import jax
import numpy as np
import pytest
import torch

from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu.models.lora import add_lora
from kubeflow_rm_tpu_torch.models import llama as tllama
from kubeflow_rm_tpu_torch.models.params import from_numpy_params

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tcfg = tllama.LlamaConfig.tiny()
    tparams = from_numpy_params(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(seed, B=2, T=24, vocab=256):
    return np.random.default_rng(seed).integers(
        0, vocab, size=(B, T)).astype(np.int32)


def test_config_presets_match_jax():
    for name in tllama.PRESETS:
        j = getattr(jllama.LlamaConfig, name)()
        t = getattr(tllama.LlamaConfig, name)()
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "hidden_dim", "max_seq_len", "rope_theta", "norm_eps",
                  "lora_alpha"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert tllama.param_spec_shapes(t) == jllama.param_spec_shapes(j)
        assert str(t.dtype).split(".")[-1] == np.dtype(j.dtype).name


def test_forward_matches_jax(model):
    jcfg, jparams, tcfg, tparams = model
    tok = _tokens(1)
    ref = jllama.forward(jparams, jax.numpy.asarray(tok), jcfg)
    got = tllama.forward(tparams, torch.from_numpy(tok), tcfg)
    assert got.dtype == torch.float32 and got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_packed_forward_matches_jax(model, impl):
    """positions + segments + packed=True: the mask drops positions
    (local-causal ∧ same-segment), the flash contract."""
    jcfg, jparams, tcfg, tparams = model
    T = 32
    docs = (10, 14, 8)
    seg = np.concatenate([np.full(n, i + 1) for i, n in enumerate(docs)])
    pos = np.concatenate([np.arange(n) for n in docs])
    seg = np.stack([seg, seg[::-1]]).astype(np.int32)
    pos = np.stack([pos, np.concatenate([np.arange(n) for n in docs[::-1]])])
    pos = pos.astype(np.int32)
    tok = _tokens(2, T=T)
    ref = jllama.forward(jparams, jax.numpy.asarray(tok), jcfg,
                         positions=jax.numpy.asarray(pos),
                         segments=jax.numpy.asarray(seg), packed=True)
    got = tllama.forward(tparams, torch.from_numpy(tok), tcfg,
                         positions=torch.from_numpy(pos),
                         segments=torch.from_numpy(seg), packed=True,
                         impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_positions_without_packed_match_jax(model):
    """Explicit positions without ``packed`` keep the position-aware
    dense mask."""
    jcfg, jparams, tcfg, tparams = model
    tok = _tokens(3, T=16)
    pos = np.stack([np.arange(16), np.arange(16) + 5]).astype(np.int32)
    ref = jllama.forward(jparams, jax.numpy.asarray(tok), jcfg,
                         positions=jax.numpy.asarray(pos))
    got = tllama.forward(tparams, torch.from_numpy(tok), tcfg,
                         positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_forward_with_adapter_matches_jax(model):
    jcfg, jparams, tcfg, _ = model
    lp = add_lora(jparams, rank=4, key=jax.random.key(7))
    # give b a non-zero value so the adapter changes the output
    rng = np.random.default_rng(8)
    blocks = dict(lp["blocks"])
    for t in ("wq", "wv"):
        b = blocks[t + "_lora_b"]
        blocks[t + "_lora_b"] = jax.numpy.asarray(
            rng.standard_normal(b.shape).astype(np.float32) * 0.05)
    lp = dict(lp, blocks=blocks)
    tparams = from_numpy_params(jax.tree.map(np.asarray, lp), tcfg, "cpu")
    tok = _tokens(4)
    ref = jllama.forward(lp, jax.numpy.asarray(tok), jcfg)
    base = jllama.forward(jparams, jax.numpy.asarray(tok), jcfg)
    assert np.abs(np.asarray(ref) - np.asarray(base)).max() > 1e-3
    got = tllama.forward(tparams, torch.from_numpy(tok), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_from_numpy_params_layout(model):
    _, jparams, tcfg, tparams = model
    for name, w in tparams["blocks"].items():
        assert tuple(w.shape) == jparams["blocks"][name].shape
    # bf16 leaves survive the numpy hop bit for bit
    head = jax.random.normal(jax.random.key(3), (64, 256)).astype(
        jax.numpy.bfloat16)
    t = from_numpy_params({"lm_head": np.asarray(head)}, tcfg,
                          "cpu")["lm_head"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(head.astype(np.float32)))
    with pytest.raises(ValueError, match="shape"):
        from_numpy_params({"out_norm": np.zeros(3, np.float32)}, tcfg, "cpu")
    # quantized leaves are carried over as they are, their shapes checked
    # against the quantized form of the base weight's shape
    L, D = tcfg.n_layers, tcfg.dim
    q8 = {"q": np.ones((L, D, D), np.int8), "s": np.ones((L, 1, D),
                                                          np.float32)}
    t = from_numpy_params({"blocks": {"wq": q8}}, tcfg, "cpu")["blocks"]["wq"]
    assert t["q"].dtype == torch.int8 and t["s"].dtype == torch.float32
    q4 = {"q4": np.ones((L, 2, 16, D), np.int8),
          "s": np.ones((L, 2, 1, D), np.float32)}
    t = from_numpy_params({"blocks": {"wq": q4}}, tcfg, "cpu")["blocks"]["wq"]
    assert tuple(t["q4"].shape) == (L, 2, 16, D)
    with pytest.raises(ValueError, match="shape"):
        from_numpy_params({"blocks": {"wq": {"q": np.zeros(1), "s": 0}}},
                          tcfg, "cpu")
    with pytest.raises(ValueError, match="shape"):
        from_numpy_params({"blocks": {"wq": dict(q4, s=np.ones(
            (L, 4, 1, D), np.float32))}}, tcfg, "cpu")
    with pytest.raises(ValueError, match="quantized leaf"):
        from_numpy_params({"blocks": {"wq": {"w": np.zeros(1)}}}, tcfg,
                          "cpu")


def test_init_params_follows_init_rule():
    cfg = tllama.LlamaConfig.tiny(n_layers=4)
    p = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = tllama.param_spec_shapes(cfg)
    assert p["blocks"]["wq"].shape == shapes["blocks"]["wq"]
    assert torch.equal(p["out_norm"], torch.ones(cfg.dim))
    assert torch.equal(p["blocks"]["attn_norm"], torch.ones(4, cfg.dim))
    out_scale = 0.02 / (2.0 * 4) ** 0.5
    assert float(p["blocks"]["wo"].std()) == pytest.approx(out_scale, rel=0.1)
    assert float(p["blocks"]["w_up"].std()) == pytest.approx(0.02, rel=0.1)
    again = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p["lm_head"], again["lm_head"])
