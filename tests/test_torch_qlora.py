"""Port parity for QLoRA: LoRA adapters over a frozen int8 or int4 base,
on the tiny float32 model with JAX's weights carried over
(``from_numpy_params``).

Tolerances: adapter shapes, dtypes and the frozen base are compared
exactly; the loss at rtol 1e-5 and the adapter gradients at rtol 1e-4
(atol 1e-7 for elements near zero) against ``jax.grad`` of JAX's
``loss_fn`` — float32 on both sides, the same dequantized weights, the
products summed in different orders. A checkpointed QLoRA state must
come back bit for bit.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu.models import lora as jlora
from kubeflow_rm_tpu.models import quantize as jq
from kubeflow_rm_tpu.training import data as jdata
from kubeflow_rm_tpu.training import optim as joptim
from kubeflow_rm_tpu.training import train as jtrain
from kubeflow_rm_tpu_torch.models import llama as tllama
from kubeflow_rm_tpu_torch.models import lora as tlora
from kubeflow_rm_tpu_torch.models import quantize as tq
from kubeflow_rm_tpu_torch.models.params import from_numpy_params
from kubeflow_rm_tpu_torch.training import optim as toptim
from kubeflow_rm_tpu_torch.training import train as ttrain
from kubeflow_rm_tpu_torch.training.checkpoint import Checkpointer

OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=50)
GROUP = 32          # splits the tiny model's contraction dims (64, 128)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_base():
    cfg = jllama.LlamaConfig.tiny()
    return cfg, jllama.init_params(cfg, jax.random.key(0))


def _jax_qlora(jax_base, bits, param_dtype=jnp.float32):
    """JAX's quantized base with rank-4 adapters whose ``b`` is random
    (so every adapter leaf has a gradient)."""
    _, params = jax_base
    q = jq.quantize_params(params, bits=bits, group_size=GROUP)
    lp = jlora.add_lora(q, 4, key=jax.random.key(1), param_dtype=param_dtype)
    blocks = dict(lp["blocks"])
    for i, t in enumerate(("wq", "wv")):
        b = blocks[t + "_lora_b"]
        blocks[t + "_lora_b"] = (jax.random.normal(
            jax.random.key(10 + i), b.shape) * 0.05).astype(b.dtype)
    return dict(lp, blocks=blocks)


def _packed_batch(B=2, T=32, seed=3):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 256, n).tolist()
            for n in rng.integers(5, 20, 3 * B)]
    batch = jdata.pack_documents(docs, T)
    return {k: v[:B] for k, v in batch.items()}


def _port_cfg(**optim):
    return ttrain.TrainConfig(model=tllama.LlamaConfig.tiny(),
                              optim=toptim.OptimConfig(**{**OPT, **optim}))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [None, "float32"])
def test_add_lora_over_quantized_base_gives_jax_shapes(jax_base, bits, dtype):
    cfg, params = jax_base
    jqp = jq.quantize_params(params, bits=bits, group_size=GROUP)
    jl = jlora.add_lora(jqp, 4, key=jax.random.key(1),
                        param_dtype=dtype and getattr(jnp, dtype))
    tqp = from_numpy_params(np_tree(jqp), tllama.LlamaConfig.tiny(), "cpu")
    tl = tlora.add_lora(tqp, 4, generator=torch.Generator().manual_seed(1),
                        param_dtype=dtype and getattr(torch, dtype))
    for t in ("wq", "wv"):
        for suffix in ("_lora_a", "_lora_b"):
            j, p = jl["blocks"][t + suffix], tl["blocks"][t + suffix]
            assert tuple(p.shape) == j.shape
            assert str(p.dtype).split(".")[-1] == str(j.dtype)
        assert tl["blocks"][t] is tqp["blocks"][t]      # the base is shared
    if dtype is None:
        assert tl["blocks"]["wq_lora_a"].dtype == torch.bfloat16
    assert torch.count_nonzero(tl["blocks"]["wv_lora_b"]) == 0


@pytest.mark.parametrize("bits", [8, 4])
def test_adapter_grads_on_quantized_base_match_jax(jax_base, bits):
    """What one train step differentiates (``loss_fn``, remat ``dots`` on
    the flash node's CPU path) against ``jax.grad`` of JAX's loss over
    the adapters alone (JAX cannot differentiate int8 leaves either)."""
    jp = _jax_qlora(jax_base, bits)
    jcfg = jtrain.TrainConfig(model=jllama.LlamaConfig.tiny(),
                              optim=joptim.OptimConfig(train_only="lora"))
    batch = _packed_batch()
    names = [k for k in jp["blocks"] if jlora.is_lora_name(k)]

    def jloss(adapters):
        p = dict(jp, blocks=dict(jp["blocks"], **adapters))
        return jtrain.loss_fn(p, jax.tree.map(jnp.asarray, batch), jcfg)[0]

    adapters = {k: jp["blocks"][k] for k in names}
    jl, jg = jax.value_and_grad(jloss)(adapters)

    tcfg = _port_cfg(train_only="lora")
    tp = from_numpy_params(np_tree(jp), tcfg.model, "cpu")
    leaves = [tp["blocks"][k].requires_grad_(True) for k in names]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = ttrain.loss_fn(tp, tb, tcfg)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for k, g in zip(names, grads):
        assert float(g.abs().max()) > 0, k
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("bits", [8, 4])
def test_train_steps_freeze_the_quantized_base(jax_base, bits):
    tcfg = _port_cfg(train_only="lora")
    tp = from_numpy_params(np_tree(_jax_qlora(jax_base, bits)), tcfg.model,
                           "cpu")
    before = {k: v.clone() for k, v in toptim.leaf_paths(tp).items()}
    state = ttrain.init_train_state(tcfg, params=tp)
    adapters = {k for k in before if tlora.is_lora_name(k.split("/")[-1])}
    assert set(state.opt_state.mu) == set(state.opt_state.nu) == adapters
    step = ttrain.make_train_step(tcfg, state)
    batch = {k: torch.from_numpy(v) for k, v in _packed_batch().items()}
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    after = toptim.leaf_paths(state.params)
    q = "q4" if bits == 4 else "q"
    assert after[f"blocks/wq/{q}"].dtype == torch.int8
    for k, v in before.items():
        if k in adapters:
            assert not torch.equal(after[k], v), k
        else:
            assert not after[k].requires_grad, k
            assert torch.equal(after[k], v), k


def test_merge_lora_refuses_a_quantized_base(jax_base):
    tp = from_numpy_params(np_tree(_jax_qlora(jax_base, 4)),
                           tllama.LlamaConfig.tiny(), "cpu")
    with pytest.raises(ValueError, match="quantized base weight 'wq'"):
        tlora.merge_lora(tp, alpha=16.0)


def test_full_finetune_of_a_quantized_base_raises(jax_base):
    _, params = jax_base
    tqp = tq.quantize_params(
        from_numpy_params(np_tree(params), tllama.LlamaConfig.tiny(), "cpu"),
        bits=8)
    with pytest.raises(ValueError, match="QLoRA"):
        ttrain.init_train_state(_port_cfg(), params=tqp)


def test_qlora_state_survives_the_checkpointer(jax_base, tmp_path):
    tcfg = _port_cfg(train_only="lora")
    tp = from_numpy_params(np_tree(_jax_qlora(jax_base, 4)), tcfg.model,
                           "cpu")
    state = ttrain.init_train_state(tcfg, params=tp)
    step = ttrain.make_train_step(tcfg, state)
    batch = {k: torch.from_numpy(v) for k, v in _packed_batch().items()}
    state, _ = step(state, batch)
    ck = Checkpointer(tmp_path)
    assert ck.save(state)
    for back in (ck.restore(tcfg, device="cpu"), ck.restore(device="cpu")):
        assert isinstance(back, ttrain.TrainState) and back.step == 1
        got, want = (toptim.leaf_paths(s.params) for s in (back, state))
        assert list(got) == list(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
        assert back.opt_state.count == 1
        for k, v in state.opt_state.mu.items():
            assert torch.equal(back.opt_state.mu[k], v), k
    # a config whose shapes differ is refused
    with pytest.raises(ValueError, match="shape"):
        ck.restore(replace(tcfg, model=replace(tcfg.model, dim=32,
                                               n_heads=2, n_kv_heads=1)),
                   device="cpu")
