"""The training step's two repairs, held on the CPU.

- **The gradient accumulation adds in place** (``training/train.py``
  ``compute_grads``): the sum of the microbatches' gradients is the first
  microbatch's tree, added into and divided in place, so the step holds
  two gradient trees at the accumulation and not three. The gradients,
  losses and optimizer state after a step of ``grad_accum=4`` are bit-equal
  to the out-of-place sum (the formula before the repair, written out
  here) and close to JAX's scan, whose carry is aliased; the memory
  planner's walk of the step drops by one gradient tree where the
  accumulation binds.
- **``optim._weak`` rounds on the host** (no tensor made, none read):
  equal bit for bit to ``torch.tensor(x, dtype).item()`` for float16,
  bfloat16, float32 and float64, over subnormals, ±inf and NaN.
"""

import copy
import math
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu.parallel import MeshConfig, make_mesh
from kubeflow_rm_tpu.training import data as jdata
from kubeflow_rm_tpu.training import optim as joptim
from kubeflow_rm_tpu.training import train as jtrain
from kubeflow_rm_tpu_torch.analysis.torchcheck.memplan import walk_train_step
from kubeflow_rm_tpu_torch.models import llama as tllama
from kubeflow_rm_tpu_torch.models.params import from_numpy_params
from kubeflow_rm_tpu_torch.training import optim as toptim
from kubeflow_rm_tpu_torch.training import train as ttrain
from kubeflow_rm_tpu_torch.utils.pytree import tree_size_bytes

OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=50,
           mu_dtype="float32")
ACCUM = 4


def _bits(x: float) -> bytes:
    return struct.pack(">d", x)


def _packed_batch(B=8, T=32, seed=3):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 256, n).tolist()
            for n in rng.integers(5, 20, 3 * B)]
    batch = jdata.pack_documents(docs, T)
    return {k: v[:B] for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_tiny():
    jcfg = jtrain.TrainConfig(model=jllama.LlamaConfig.tiny(),
                              optim=joptim.OptimConfig(**OPT))
    state = jtrain.init_train_state(jcfg, jax.random.key(0))
    return jcfg, jax.tree.map(np.asarray, state.params)


def _out_of_place_grads(params, batch, tcfg):
    """The accumulation as it was written before the repair: each
    microbatch's gradients (rows m, K+m, …), summed out of place, then
    divided out of place by the same Python int."""
    flat = toptim.leaf_paths(params)
    paths = ttrain.trainable_paths(tcfg, params)
    grads, losses = None, []
    for m in range(ACCUM):
        micro = {k: v[m::ACCUM] for k, v in batch.items()}
        loss, _ = ttrain.loss_fn(params, micro, tcfg)
        g = dict(zip(paths, torch.autograd.grad(loss,
                                                [flat[p] for p in paths])))
        losses.append(loss.detach())
        grads = g if grads is None else {k: grads[k] + g[k] for k in grads}
    return ({k: g / ACCUM for k, g in grads.items()},
            torch.stack(losses).mean())


def test_accumulation_in_place_is_bit_equal_and_matches_jax(
        jax_tiny, devices8, monkeypatch):
    jcfg, params_np = jax_tiny
    batch = _packed_batch()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tcfg = ttrain.TrainConfig(model=tllama.LlamaConfig.tiny(),
                              optim=toptim.OptimConfig(**OPT))
    params = from_numpy_params(params_np, tcfg.model, "cpu")

    # the repaired step; its averaged gradients read where the norm takes
    # them
    seen = {}
    real_norm = ttrain.global_norm

    def spy(grads):
        seen.update({k: g.clone() for k, g in grads.items()})
        return real_norm(grads)

    monkeypatch.setattr(ttrain, "global_norm", spy)
    state = ttrain.init_train_state(tcfg, params=copy.deepcopy(params))
    state, metrics = ttrain.make_train_step(tcfg, state,
                                            grad_accum=ACCUM)(state, tb)
    monkeypatch.setattr(ttrain, "global_norm", real_norm)

    ref_params = copy.deepcopy(params)
    for t in toptim.leaf_paths(ref_params).values():
        t.requires_grad_(True)
    want, want_loss = _out_of_place_grads(ref_params, tb, tcfg)
    assert set(seen) == set(want)
    for k, g in want.items():
        assert torch.equal(seen[k], g), k
    assert torch.equal(metrics["loss"], want_loss)

    # the optimizer state and weights after the step: bit-equal to the
    # update of the out-of-place gradients
    ref_state = ttrain.init_train_state(tcfg, params=ref_params)
    flat = toptim.leaf_paths(ref_state.params)
    with torch.no_grad():
        toptim.make_optimizer(tcfg.optim).update(
            want, ref_state.opt_state, {k: flat[k] for k in want})
    got_flat = toptim.leaf_paths(state.params)
    for k in want:
        assert torch.equal(got_flat[k], flat[k]), k
        assert torch.equal(state.opt_state.mu[k], ref_state.opt_state.mu[k])
        assert torch.equal(state.opt_state.nu[k], ref_state.opt_state.nu[k])

    # against JAX's scan: the loss, and the float32 first moment after one
    # step (0.1 · the averaged gradient), as test_torch_train holds them
    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, sp=1, tp=1), devices8[:1])
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=jparams,
        opt_state=joptim.make_optimizer(jcfg.optim).init(jparams))
    jstep = jtrain.make_train_step(jcfg, mesh, jstate,
                                   batch_keys=tuple(batch),
                                   grad_accum=ACCUM)
    jstate, jm = jstep(jstate, jtrain.shard_batch(batch, mesh))
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    jmu = toptim.leaf_paths(jax.tree.map(np.asarray, jstate.opt_state[1].mu))
    for k, v in jmu.items():
        np.testing.assert_allclose(state.opt_state.mu[k].numpy(), v,
                                   rtol=1e-4, atol=1e-9, err_msg=k)


def test_shared_and_expanded_first_gradients_are_copied():
    """Autograd may hand one tensor to two leaves, or an expanded one:
    the first microbatch's tree is copied there before it is added
    into."""
    a = torch.ones(3)
    grads = {"x": a, "y": a, "z": torch.ones(1).expand(4), "v": a[:2]}
    owned = ttrain._owned(grads)
    assert owned["x"] is a
    assert owned["y"] is not a and torch.equal(owned["y"], a)
    assert owned["z"].stride() == (1,)
    assert owned["v"] is not grads["v"]     # a view of x's tensor
    for t in owned.values():
        t.add_(1)
    assert torch.equal(a, torch.full((3,), 2.0))


def test_walk_holds_two_gradient_trees_at_the_accumulation():
    """A full fine-tuning config whose accumulation binds the peak (wide,
    few tokens): the walk's peak at an accumulation of 2 is the state
    plus two gradient trees (the sum and a microbatch's) and no more; the
    out-of-place sum held three."""
    cfg = tllama.LlamaConfig.tiny(dim=512, n_layers=4, n_heads=4,
                                  n_kv_heads=2, hidden_dim=2048,
                                  max_seq_len=4, param_dtype=torch.bfloat16,
                                  remat_policy="full")
    tcfg = ttrain.TrainConfig(model=cfg,
                              optim=toptim.OptimConfig(factored=True))
    state = ttrain.init_train_state(tcfg, torch.Generator(), device="meta")
    tree = tree_size_bytes(state.params)
    resident = tree + tree_size_bytes(state.opt_state)
    peak = walk_train_step(tcfg, 2, 2)["peak_bytes"]
    assert 2 * tree <= peak - resident < 3 * tree, (
        (peak - resident) / tree)


# ---------------------------------------------------------------------
# _weak
# ---------------------------------------------------------------------

DTYPES = (torch.float16, torch.bfloat16, torch.float32, torch.float64)
EDGES = (0.0, -0.0, math.inf, -math.inf, math.nan, -math.nan,
         5e-324, -1e-310, 1e-45, 6e-8, 2.0 ** -24, 2.0 ** -133, 9.2e-41,
         65504.0, 65520.0, 3.3895313892515355e38, 3.4e38, 3.5e38, 1e300,
         1 + 2.0 ** -11 + 2.0 ** -40, 1 + 2.0 ** -8, 1 + 3 * 2.0 ** -8,
         0.1, 1e-8, 1e-30, 0.999, 0.9, 1e-3)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@settings(max_examples=400, deadline=None)
@given(x=st.floats(allow_nan=True, allow_infinity=True,
                   allow_subnormal=True))
def test_weak_rounds_like_a_tensor(dtype, x):
    t = torch.empty(0, dtype=dtype)
    want = torch.tensor(x, dtype=dtype).item()
    assert _bits(toptim._weak(x, t)) == _bits(want), (x, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("x", EDGES, ids=repr)
def test_weak_edges(dtype, x):
    t = torch.empty(0, dtype=dtype)
    want = torch.tensor(x, dtype=dtype).item()
    assert _bits(toptim._weak(x, t)) == _bits(want), (x, want)


@given(bits=st.integers(0, 2 ** 32 - 1))
@settings(max_examples=2000, deadline=None)
@example(bits=0x7F7FFFFF)
@example(bits=0x00008000)
@example(bits=0x3F808000)
def test_weak_bfloat16_over_float32_patterns(bits):
    """Every float32 bit pattern class: the round to bfloat16's upper 16
    bits (ties to even, carries into the exponent) as torch rounds it."""
    x = float(np.uint32(bits).view(np.float32))
    t = torch.empty(0, dtype=torch.bfloat16)
    want = torch.tensor(x, dtype=torch.bfloat16).item()
    assert _bits(toptim._weak(x, t)) == _bits(want), hex(bits)
