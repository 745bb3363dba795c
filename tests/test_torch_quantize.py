"""Port parity for weight-only quantization (``models.quantize``) and its
consumers, on the tiny float32 model with JAX's weights carried over
(``from_numpy_params``).

Tolerances: packed bytes, scales and dequantized weights are compared
exactly (both sides round half to even, divide in float32, and convert
then multiply in the compute dtype); ``quantized_bytes`` and tokens
exactly; ``decode_chunk`` and ``forward`` logits against JAX at atol
1e-5 (float32, the same rounding points; the products' summation order
differs); a quantized forward against the forward of the dequantized
tree bit for bit (the same weights reach the same ops).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu.models import quantize as jq
from kubeflow_rm_tpu_torch.models import llama as tllama
from kubeflow_rm_tpu_torch.models import quantize as tq
from kubeflow_rm_tpu_torch.models.params import from_numpy_params
from kubeflow_rm_tpu_torch.training.optim import leaf_paths

jgen = importlib.import_module("kubeflow_rm_tpu.models.generate")
tgen = importlib.import_module("kubeflow_rm_tpu_torch.models.generate")

LOGIT_ATOL = 1e-5
# group sizes: the default, a real split of the tiny contraction dims
# (64 and 128), an odd group and an indivisible one (both fall back to
# one group of K)
GROUPS = (128, 32, 5, 48)


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tcfg = tllama.LlamaConfig.tiny()
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, np_params


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _quantized(model, bits, group_size=128):
    """JAX's quantized tree and the port's (carried over from JAX)."""
    jcfg, jparams, tcfg, _ = model
    jqp = jq.quantize_params(jparams, bits=bits, group_size=group_size)
    return jqp, from_numpy_params(_np_tree(jqp), tcfg, "cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    """Raw bits (bf16 as uint16) for an exact comparison."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("bits,group_size",
                         [(8, 128)] + [(4, g) for g in GROUPS])
def test_packed_bytes_and_scales_equal_jax(model, bits, group_size):
    _, jparams, tcfg, np_params = model
    tparams = from_numpy_params(np_params, tcfg, "cpu")
    got = tq.quantize_params(tparams, bits=bits, group_size=group_size)
    ref = jq.quantize_params(jparams, bits=bits, group_size=group_size)
    flat_ref = {"/".join(str(k.key) for k in path): leaf for path, leaf in
                jax.tree_util.tree_flatten_with_path(ref)[0]}
    flat = leaf_paths(got)
    assert set(flat) == set(flat_ref)
    for k, t in flat.items():
        r = np.asarray(flat_ref[k])
        assert t.dtype == getattr(torch, r.dtype.name), k
        np.testing.assert_array_equal(t.numpy(), r, err_msg=k)
    K = tcfg.dim
    if bits == 4:
        g = tq.int4_group(K, group_size)
        assert got["blocks"]["wq"]["q4"].shape == (2, K // g, g // 2, K)
        assert g == (K if group_size in (5, 48) else min(group_size, K))


def test_int4_odd_contraction_dim_raises():
    with pytest.raises(ValueError, match="even"):
        tq.quantize_params({"blocks": {"wq": torch.ones(1, 3, 4)},
                            "lm_head": torch.ones(4, 4)}, bits=4)
    with pytest.raises(ValueError, match="8 or 4"):
        tq.quantize_params({"blocks": {}, "lm_head": torch.ones(4, 4)},
                           bits=3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["int8", "int4", "int4_unpacked"])
def test_dequant_of_jax_leaves_is_bit_identical(model, dtype, form):
    jqp, tqp = _quantized(model, 8 if form == "int8" else 4, 32)
    if form == "int4_unpacked":
        jqp = jq.unpack_int4_params(jqp)
        tqp = from_numpy_params(_np_tree(jqp), tllama.LlamaConfig.tiny(),
                                "cpu")
        assert set(tqp["blocks"]["wq"]) == {"q8g", "s"}
    for name in ("wq", "w_down"):
        got = tq.maybe_dequant(tqp["blocks"][name], getattr(torch, dtype))
        ref = jq.maybe_dequant(jqp["blocks"][name], getattr(jnp, dtype))
        np.testing.assert_array_equal(_bits(got), _jbits(ref))
    got = tq.maybe_dequant(tqp["lm_head"], getattr(torch, dtype))
    ref = jq.maybe_dequant(jqp["lm_head"], getattr(jnp, dtype))
    np.testing.assert_array_equal(_bits(got), _jbits(ref))


def test_unpack_int4_on_all_byte_values():
    packed = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    leaf = {"q4": packed.view(1, 1, 256), "s": torch.ones(1, 1, 256)}
    got = tq.unpack_int4(leaf)["q8g"]
    assert got.shape == (1, 2, 256) and got.dtype == torch.int8

    def nibble(x):                 # two's-complement 4-bit value
        return x - 16 if x >= 8 else x

    hi = [nibble((v & 0xFF) >> 4) for v in range(-128, 128)]
    lo = [nibble(v & 0xF) for v in range(-128, 128)]
    assert got[0, 0].tolist() == hi and got[0, 1].tolist() == lo
    ref = jq.unpack_int4({"q4": jnp.asarray(packed.numpy()).reshape(1, 1, 256),
                          "s": jnp.ones((1, 1, 256))})["q8g"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # and back: packing every (hi, lo) pair gives the byte again
    repacked = (got[0, 0] << 4) | (got[0, 1] & 0xF)
    assert torch.equal(repacked, packed)


@pytest.mark.parametrize("bits", [8, 4])
def test_init_params_quantized_equals_two_step(bits):
    cfg = tllama.LlamaConfig.tiny()
    direct = tq.init_params_quantized(
        cfg, torch.Generator().manual_seed(3), "cpu", bits=bits,
        group_size=32)
    two = tq.quantize_params(
        tllama.init_params(cfg, torch.Generator().manual_seed(3), "cpu"),
        bits=bits, group_size=32)
    a, b = leaf_paths(direct), leaf_paths(two)
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert tq.is_quantized(direct["lm_head"])
    assert not tq.is_quantized(direct["embed"]["tokens"])


@pytest.mark.parametrize("bits", [8, 4])
def test_mixtral_init_params_quantized_equals_two_step(bits):
    """For the MoE family both paths draw every stacked leaf one layer at
    a time (``mixtral.init_params``), so building it quantized equals
    quantizing the drawn tree; the ``moe_*`` experts are quantized, the
    router and norms are not."""
    from kubeflow_rm_tpu_torch.models import mixtral as tmixtral

    cfg = tmixtral.MixtralConfig.tiny_moe(n_layers=3)
    direct = tq.init_params_quantized(
        cfg, torch.Generator().manual_seed(3), "cpu", bits=bits,
        group_size=32)
    two = tq.quantize_params(
        tmixtral.init_params(cfg, torch.Generator().manual_seed(3), "cpu"),
        bits=bits, group_size=32)
    a, b = leaf_paths(direct), leaf_paths(two)
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    blocks = direct["blocks"]
    assert all(tq.is_quantized(blocks[k])
               for k in ("moe_gate", "moe_up", "moe_down", "wq", "wo"))
    assert not tq.is_quantized(blocks["router"])
    assert not tq.is_quantized(blocks["mlp_norm"])


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_moe_decode_matches_jax(bits):
    """JAX's quantized MoE decode (``test_quantize.py``'s
    ``test_quantized_moe_decode_runs``, capacity factor 8): the port's
    ``decode_chunk`` on JAX's quantized tree gives JAX's logits, and
    greedy tokens equal JAX's ``generate_fused``."""
    from dataclasses import replace

    from kubeflow_rm_tpu.models import mixtral as jmixtral
    from kubeflow_rm_tpu_torch.models import mixtral as tmixtral

    jcfg = jmixtral.MixtralConfig.tiny_moe()
    jcfg = replace(jcfg, moe=replace(jcfg.moe, capacity_factor=8.0))
    tcfg = tmixtral.MixtralConfig.tiny_moe()
    tcfg = replace(tcfg, moe=replace(tcfg.moe, capacity_factor=8.0))
    jqp = jq.quantize_params(jmixtral.init_params(jcfg, jax.random.key(0)),
                             bits=bits, group_size=32)
    assert jq.is_quantized(jqp["blocks"]["moe_gate"])
    tqp = from_numpy_params(_np_tree(jqp), tcfg, "cpu")
    tok = np.random.default_rng(6).integers(1, 256, (2, 7)).astype(np.int32)
    ref, _ = jgen.decode_chunk(jqp, jcfg, jgen.init_cache(jcfg, 2, 16),
                               jnp.asarray(tok))
    got, _ = tgen.decode_chunk(tqp, tcfg, tgen.init_cache(tcfg, 2, 16, "cpu"),
                               torch.from_numpy(tok))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGIT_ATOL,
                               rtol=0)
    want = np.asarray(jgen.generate_fused(jqp, jcfg, jnp.asarray(tok),
                                          max_new_tokens=6))
    prompt = torch.from_numpy(tok)
    loop = tgen.generate(tqp, tcfg, prompt, max_new_tokens=6).tolist()
    fused = tgen.generate_fused(tqp, tcfg, prompt, max_new_tokens=6).tolist()
    assert loop == fused == want.tolist()


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_bytes_equal_jax(model, bits):
    jqp, tqp = _quantized(model, bits)
    assert tq.quantized_bytes(tqp) == jq.quantized_bytes(jqp)
    _, jparams, tcfg, np_params = model
    plain = from_numpy_params(np_params, tcfg, "cpu")
    assert tq.quantized_bytes(plain) == jq.quantized_bytes(jparams)
    assert tq.quantized_bytes(tqp) < tq.quantized_bytes(plain) / 2


def test_is_quantized_accepts_exactly_the_three_key_sets():
    t = torch.zeros(1)
    for keys in (("q", "s"), ("q4", "s"), ("q8g", "s")):
        leaf = dict.fromkeys(keys, t)
        assert tq.is_quantized(leaf) and jq.is_quantized(leaf)
    for keys in ((), ("q",), ("s",), ("q", "q4", "s"), ("q", "s", "z"),
                 ("tokens",)):
        assert not tq.is_quantized(dict.fromkeys(keys, t))
    assert not tq.is_quantized(t)


def test_unpack_params_is_a_no_op_on_int8_and_plain_trees(model):
    _, tqp = _quantized(model, 8)
    out = tq.unpack_int4_params(tqp)
    assert out["blocks"]["wq"]["q"] is tqp["blocks"]["wq"]["q"]
    _, tq4 = _quantized(model, 4)
    out = tq.unpack_int4_params(tq4)
    assert set(out["blocks"]["wq"]) == {"q8g", "s"}
    assert out["blocks"]["attn_norm"] is tq4["blocks"]["attn_norm"]
    assert set(tq4["blocks"]["wq"]) == {"q4", "s"}      # input untouched


@pytest.mark.parametrize("bits", [8, 4])
def test_forward_matches_jax_and_the_dequantized_tree(model, bits):
    jcfg, _, tcfg, _ = model
    jqp, tqp = _quantized(model, bits, 32)
    tok = np.random.default_rng(4).integers(0, 256, (2, 24)).astype(np.int32)
    ref = jllama.forward(jqp, jnp.asarray(tok), jcfg)
    with torch.no_grad():
        got = tllama.forward(tqp, torch.from_numpy(tok), tcfg, impl="auto")
        deq = {k: v for k, v in tqp.items()}
        deq["blocks"] = {k: tq.maybe_dequant(v, tcfg.param_dtype)
                         for k, v in tqp["blocks"].items()}
        deq["lm_head"] = tq.maybe_dequant(tqp["lm_head"], tcfg.param_dtype)
        plain = tllama.forward(deq, torch.from_numpy(tok), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGIT_ATOL,
                               rtol=0)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("bits", [8, 4])
def test_decode_and_generation_match_jax(model, bits):
    jcfg, _, tcfg, _ = model
    jqp, tqp = _quantized(model, bits, 32)
    tok = np.random.default_rng(5).integers(0, 256, (2, 9)).astype(np.int32)
    ref, _ = jgen.decode_chunk(jqp, jcfg, jgen.init_cache(jcfg, 2, 16),
                               jnp.asarray(tok))
    got, _ = tgen.decode_chunk(tqp, tcfg, tgen.init_cache(tcfg, 2, 16, "cpu"),
                               torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=LOGIT_ATOL,
                               rtol=0)
    want = np.asarray(jgen.generate_fused(jqp, jcfg, jnp.asarray(tok),
                                          max_new_tokens=6))
    # the per-token loop dequantizes the packed form at every step; the
    # fused call unpacks int4 once, ahead of its loop
    prompt = torch.from_numpy(tok)
    loop = tgen.generate(tqp, tcfg, prompt, max_new_tokens=6).tolist()
    fused = tgen.generate_fused(tqp, tcfg, prompt, max_new_tokens=6).tolist()
    assert loop == fused == want.tolist()


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_on_int4_gives_jax_engine_tokens(model, paged):
    jcfg, _, tcfg, _ = model
    jqp, tqp = _quantized(model, 4, 32)
    rng = np.random.default_rng(6)
    shared = rng.integers(1, 256, 8).tolist()
    reqs = [(shared + rng.integers(1, 256, n).tolist(), m)
            for n, m in ((3, 5), (6, 4), (0, 6))]
    reqs.append((rng.integers(1, 256, 5).tolist(), 3))
    kw = dict(slots=2, slot_len=32, block_size=4, paged=paged)
    je = jgen.ContinuousBatchingEngine(jqp, jcfg, **kw)
    te = tgen.ContinuousBatchingEngine(tqp, tcfg, **kw)
    assert set(te.params["blocks"]["wq"]) == {"q8g", "s"}
    jr = [je.submit(p, max_new_tokens=m) for p, m in reqs]
    tr = [te.submit(p, max_new_tokens=m) for p, m in reqs]
    je.run()
    te.run()
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert te.stats() == je.stats()
