"""Port parity of the training path (``kubeflow_rm_tpu_torch.training``
and the model's remat/LoRA pieces) against the JAX package, on the CPU.

JAX state is built once and carried over with ``from_numpy_params``;
batches are numpy and go to both. Tolerances, with their reasons:

- loss terms: rtol 1e-6 (float32 logsumexp over 256 logits);
- optimizer: 5 optax steps, atol 1e-6 on ~0.02-scale params (float32
  arithmetic in the same order; bf16 ``mu`` rounded at the same points);
- train step on ``tiny``: losses rtol 1e-5; params atol 2e-6 (two
  float32 models whose matmuls and reductions sum in different orders,
  moved by an lr-1e-2 adam step per leaf element) for at least 99.9% of
  each leaf, and every element within 2·lr per real update. Adam's
  update mu/(sqrt(nu) + 1e-8) is ill-conditioned where sqrt(nu) nears
  its eps or where a gradient nearly cancels the first moment: there a
  last-bit gradient difference moves the element by up to a whole step
  (a handful of elements in 10^4). With bf16 ``mu`` the first moment's
  rounding also flips with such differences, so bf16 runs ONE step (lr
  0 under warmup: the state after it is the rounded first moment, held
  to one bf16 ulp) and float32 runs three.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu.models import lora as jlora
from kubeflow_rm_tpu.ops.losses import softmax_cross_entropy as j_xent
from kubeflow_rm_tpu.parallel import MeshConfig, make_mesh
from kubeflow_rm_tpu.training import data as jdata
from kubeflow_rm_tpu.training import optim as joptim
from kubeflow_rm_tpu.training import train as jtrain
from kubeflow_rm_tpu.utils import flops as jflops
from kubeflow_rm_tpu_torch.models import llama as tllama
from kubeflow_rm_tpu_torch.models import lora as tlora
from kubeflow_rm_tpu_torch.models.params import from_numpy_params
from kubeflow_rm_tpu_torch.ops import flash_attention as fa
from kubeflow_rm_tpu_torch.ops.losses import IGNORE_INDEX, softmax_cross_entropy
from kubeflow_rm_tpu_torch.training import data as tdata
from kubeflow_rm_tpu_torch.training import optim as toptim
from kubeflow_rm_tpu_torch.training import train as ttrain
from kubeflow_rm_tpu_torch.training.checkpoint import Checkpointer
from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit
from kubeflow_rm_tpu_torch.utils import flops as tflops

ROOT = Path(__file__).resolve().parents[1]


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t2n(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------

@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_jax(z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 17, 256)) * 3).astype(np.float32)
    labels = rng.integers(0, 256, (3, 17)).astype(np.int32)
    labels[0, :5] = IGNORE_INDEX
    labels[2, -1] = IGNORE_INDEX
    jl, jaux = j_xent(jnp.asarray(logits), jnp.asarray(labels), z_loss=z_loss)
    tl, taux = softmax_cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels), z_loss=z_loss)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=1e-6)


def test_cross_entropy_all_ignored_is_zero():
    logits = torch.zeros(2, 4, 8)
    labels = torch.full((2, 4), IGNORE_INDEX)
    loss, aux = softmax_cross_entropy(logits, labels)
    assert float(loss) == 0.0 and float(aux["n_valid"]) == 0.0


# ---------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------

def _opt_tree(rng):
    return {"embed": {"tokens": rng.standard_normal((16, 8)) * 0.02},
            "blocks": {"attn_norm": np.ones((2, 8)),
                       "wq": rng.standard_normal((2, 8, 8)) * 0.02},
            "out_norm": np.ones(8),
            "lm_head": rng.standard_normal((8, 16)) * 0.02}


@pytest.mark.parametrize("mu_dtype", ["bfloat16", "float32"])
def test_optimizer_matches_optax_chain(mu_dtype):
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: a.astype(np.float32), _opt_tree(rng))
    cfg = dict(learning_rate=1e-2, warmup_steps=2, total_steps=8,
               mu_dtype=mu_dtype)
    jopt = joptim.make_optimizer(joptim.OptimConfig(**cfg))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = toptim.leaf_paths(jax.tree.map(lambda a: torch.from_numpy(a.copy()),
                                        params))
    topt = toptim.make_optimizer(toptim.OptimConfig(**cfg))
    tstate = topt.init(tp)
    for step in range(5):
        # scale alternates so the global-norm clip both fires and not
        scale = 5.0 if step % 2 else 0.05
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale)
                         .astype(np.float32), params)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update({k: torch.from_numpy(v.copy()) for k, v in
                     toptim.leaf_paths(g).items()}, tstate, tp)
        for k, v in toptim.leaf_paths(np_tree(jp)).items():
            np.testing.assert_allclose(t2n(tp[k]), v, atol=1e-6, rtol=0)
    adam = jstate[1]
    for k, v in toptim.leaf_paths(np_tree(adam.mu)).items():
        assert tstate.mu[k].dtype == getattr(torch, mu_dtype)
        np.testing.assert_allclose(t2n(tstate.mu[k]),
                                   np.asarray(v, np.float32), atol=1e-6)
    assert tstate.count == int(adam.count) == 5


def test_schedule_matches_optax():
    for cfg in (dict(learning_rate=1e-2, warmup_steps=2, total_steps=200),
                dict(learning_rate=1e-3, warmup_steps=1, total_steps=6),
                dict(learning_rate=3e-4, warmup_steps=0, total_steps=10)):
        js = joptim._make_schedule(joptim.OptimConfig(**cfg))
        for c in range(12):
            np.testing.assert_allclose(
                toptim.schedule(toptim.OptimConfig(**cfg), c),
                float(js(jnp.int32(c))), rtol=1e-6)


def test_decay_mask_matches_jax():
    rng = np.random.default_rng(2)
    tree = _opt_tree(rng)
    jmask = toptim.leaf_paths(joptim._decay_mask(tree))
    assert {k: toptim.decays(k) for k in jmask} == jmask


def test_configs_have_jax_fields_and_defaults():
    def fields(obj):
        return {f.name: getattr(obj, f.name)
                for f in dataclasses.fields(obj)}

    assert fields(toptim.OptimConfig()) == fields(joptim.OptimConfig())
    tc, jc = ttrain.TrainConfig(), jtrain.TrainConfig()
    assert set(fields(tc)) == set(fields(jc)) == {"model", "optim", "z_loss"}
    assert tc.z_loss == jc.z_loss


@pytest.mark.parametrize("min_dim", [4, 128])
def test_adafactor_matches_optax_chain(min_dim):
    """``factored=True`` against optax's adafactor chain over 3 steps
    (the global-norm clip firing and not), stacked (L, D, D) and flat
    leaves factored where ``factored_min_dim`` allows (4: every matrix;
    128: none), norms never; the parameters at atol 1e-6 and the
    factored statistics at rtol 1e-5 (float32 means summed in another
    order)."""
    rng = np.random.default_rng(2)
    params = jax.tree.map(lambda a: a.astype(np.float32), _opt_tree(rng))
    cfg = dict(learning_rate=1e-2, warmup_steps=1, total_steps=8,
               factored=True, factored_min_dim=min_dim)
    jopt = joptim.make_optimizer(joptim.OptimConfig(**cfg))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = toptim.leaf_paths(jax.tree.map(lambda a: torch.from_numpy(a.copy()),
                                        params))
    topt = toptim.make_optimizer(toptim.OptimConfig(**cfg))
    tstate = topt.init(tp)
    assert isinstance(tstate, toptim.FactoredState)
    for step in range(3):
        scale = 5.0 if step % 2 else 0.05
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * scale)
                         .astype(np.float32), params)
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update({k: torch.from_numpy(v.copy()) for k, v in
                     toptim.leaf_paths(g).items()}, tstate, tp)
        for k, v in toptim.leaf_paths(np_tree(jp)).items():
            np.testing.assert_allclose(t2n(tp[k]), v, atol=1e-6, rtol=0,
                                       err_msg=k)
    fac = jstate[1][0]
    assert tstate.count == int(fac.count) == 3
    for f in ("v_row", "v_col", "v"):
        for k, v in toptim.leaf_paths(np_tree(getattr(fac, f))).items():
            got = getattr(tstate, f)[k]
            assert tuple(got.shape) == v.shape, (f, k)
            np.testing.assert_allclose(t2n(got), v, rtol=1e-5, atol=1e-12,
                                       err_msg=f"{f} {k}")
    factored = {k for k, v in tstate.v.items() if v.shape == (1,)}
    if min_dim == 4:
        assert factored == {"embed/tokens", "blocks/wq", "lm_head"}
    else:
        assert not factored


def test_factored_dims_take_the_two_largest_axes():
    """optax's ``_factored_dims``: a stacked (L, D, F) leaf keeps L, and
    a second-largest axis below the minimum means no factoring."""
    from optax._src.factorized import _factored_dims

    for shape in [(32, 4096, 11008), (32, 4096), (4096,), (2, 8, 8),
                  (8, 4, 64, 128), (32000, 4096), (16, 100)]:
        for min_dim in (4, 128):
            assert toptim.factored_dims(shape, min_dim) == \
                _factored_dims(shape, True, min_dim), (shape, min_dim)


# ---------------------------------------------------------------------
# train step against JAX's on a one-device mesh
# ---------------------------------------------------------------------

OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=50)


@pytest.fixture(scope="module")
def jax_tiny():
    jcfg = jtrain.TrainConfig(model=jllama.LlamaConfig.tiny(),
                              optim=joptim.OptimConfig(**OPT))
    state = jtrain.init_train_state(jcfg, jax.random.key(0))
    return jcfg, np_tree(state.params)


def _port_cfg(**optim):
    return ttrain.TrainConfig(model=tllama.LlamaConfig.tiny(),
                              optim=toptim.OptimConfig(**{**OPT, **optim}))


def _packed_batch(B=4, T=32, seed=3):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 256, n).tolist()
            for n in rng.integers(5, 20, 3 * B)]
    batch = jdata.pack_documents(docs, T)
    return {k: v[:B] for k, v in batch.items()}


def assert_params_close(got: dict, want: dict, updates: int):
    """``got`` equals ``want`` at atol 2e-6 on at least 99.9% of each
    leaf's elements and within 2·lr per real update everywhere (the
    module docstring says why)."""
    lr = OPT["learning_rate"]
    for k, v in want.items():
        err = np.abs(t2n(got[k]) - v)
        assert np.mean(err <= 2e-6) >= 0.999, (k, err.max())
        assert err.max() <= 2 * lr * updates + 2e-6, (k, err.max())


@pytest.mark.parametrize("mu_dtype,steps", [("bfloat16", 1),
                                            ("float32", 3)])
def test_train_step_matches_jax(jax_tiny, devices8, mu_dtype, steps):
    jcfg, params_np = jax_tiny
    jcfg = replace(jcfg, optim=replace(jcfg.optim, mu_dtype=mu_dtype))
    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, sp=1, tp=1), devices8[:1])
    jstate = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.asarray, params_np),
        opt_state=joptim.make_optimizer(jcfg.optim).init(
            jax.tree.map(jnp.asarray, params_np)))
    batch = _packed_batch()
    jstep = jtrain.make_train_step(jcfg, mesh, jstate,
                                   batch_keys=tuple(batch))
    tcfg = _port_cfg(mu_dtype=mu_dtype)
    tstate = ttrain.init_train_state(
        tcfg, params=from_numpy_params(params_np, tcfg.model, "cpu"))
    tstep = ttrain.make_train_step(tcfg, tstate)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(steps):
        jstate, jm = jstep(jstate, jtrain.shard_batch(batch, mesh))
        tstate, tm = tstep(tstate, tbatch)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5)
    assert tstate.step == int(jstate.step) == steps
    assert_params_close(toptim.leaf_paths(tstate.params),
                        toptim.leaf_paths(np_tree(jstate.params)),
                        updates=steps - 1)
    # the first moment: one bf16 ulp (2^-7 relative at most), and 1e-4 of
    # the leaf's largest moment where a sum of gradients nearly cancels
    for k, v in toptim.leaf_paths(np_tree(jstate.opt_state[1].mu)).items():
        v = np.asarray(v, np.float32)
        np.testing.assert_allclose(t2n(tstate.opt_state.mu[k]), v,
                                   rtol=2.0 ** -7,
                                   atol=1e-4 * np.abs(v).max(), err_msg=k)


def test_loss_and_grads_through_flash_node_match_jax(jax_tiny):
    """The slice as a whole: the packed loss, differentiated through the
    port's flash node (``impl="flash"``), against ``jax.value_and_grad``
    of JAX's ``loss_fn``, every leaf."""
    jcfg, params_np = jax_tiny
    batch = _packed_batch(seed=4)
    (jl, _), jg = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, params_np),
        jax.tree.map(jnp.asarray, batch), jcfg)
    tcfg = _port_cfg()
    params = from_numpy_params(params_np, tcfg.model, "cpu")
    flat = toptim.leaf_paths(params)
    for t in flat.values():
        t.requires_grad_(True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits = tllama.forward(params, tb["tokens"], tcfg.model,
                            positions=tb["positions"],
                            segments=tb["segments"], packed=True,
                            impl="flash")
    loss, _ = softmax_cross_entropy(logits, tb["labels"], z_loss=tcfg.z_loss)
    grads = torch.autograd.grad(loss, list(flat.values()))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for (k, g), jv in zip(zip(flat, grads),
                          [toptim.leaf_paths(np_tree(jg))[k] for k in flat]):
        np.testing.assert_allclose(t2n(g), jv, atol=2e-6, rtol=1e-4,
                                   err_msg=k)


def test_grad_accum_matches_full_batch():
    """Like JAX, accumulation averages the microbatches' masked means, so
    it equals the full batch where every microbatch holds as many valid
    labels: the synthetic stream's rows (one ignored label each). The
    float32 first moment after one step is 0.1·grad, so it holds the
    accumulated gradient itself."""
    tcfg = _port_cfg(mu_dtype="float32")
    params = tllama.init_params(tcfg.model, torch.Generator().manual_seed(0),
                                "cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             next(tdata.synthetic_batches(4, 32, 256, seed=3)).items()}
    out = []
    for accum in (1, 2):
        state = ttrain.init_train_state(tcfg, params=copy.deepcopy(params))
        step = ttrain.make_train_step(tcfg, state, grad_accum=accum)
        state, m = step(state, batch)
        out.append((state, m))
    (s1, m1), (s2, m2) = out
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(m1["grad_norm"]), rtol=1e-5)
    for k, v in s1.opt_state.mu.items():
        np.testing.assert_allclose(t2n(s2.opt_state.mu[k]), t2n(v),
                                   rtol=1e-4, atol=1e-9, err_msg=k)
    with pytest.raises(ValueError, match="divisible"):
        ttrain.make_train_step(tcfg, s1, grad_accum=3)(s1, batch)


def test_grad_accum_takes_interleaved_rows(monkeypatch):
    """Microbatch m holds rows m, K+m, … (JAX's fold)."""
    seen = []
    monkeypatch.setattr(ttrain, "loss_fn", lambda p, b, c: (
        seen.append(b["tokens"][:, 0].tolist()),
        (sum(t.sum() for t in toptim.leaf_paths(p).values()) * 0, {}))[1])
    tcfg = _port_cfg()
    state = ttrain.init_train_state(tcfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    tokens = torch.arange(6)[:, None].expand(6, 4)
    ttrain.make_train_step(tcfg, state, grad_accum=3)(
        state, {"tokens": tokens, "labels": tokens})
    assert seen == [[0, 3], [1, 4], [2, 5]]


# ---------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------

def _lora_params(seed=0, rank=4):
    cfg = tllama.LlamaConfig.tiny()
    base = tllama.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    return cfg, base, tlora.add_lora(base, rank,
                                     generator=torch.Generator()
                                     .manual_seed(seed + 1))


def test_add_lora_is_a_zero_delta_and_shares_the_base():
    cfg, base, lp = _lora_params()
    blocks = lp["blocks"]
    assert blocks["wq_lora_a"].shape == (2, 64, 4)
    assert blocks["wv_lora_b"].shape == (2, 4, 32)
    assert torch.count_nonzero(blocks["wq_lora_b"]) == 0
    assert float(blocks["wq_lora_a"].std()) == pytest.approx(0.02, rel=0.2)
    assert blocks["wq"] is base["blocks"]["wq"]
    tok = torch.randint(0, 256, (2, 12), generator=torch.Generator()
                        .manual_seed(5))
    with torch.no_grad():
        assert torch.equal(tllama.forward(lp, tok, cfg),
                           tllama.forward(base, tok, cfg))
    with pytest.raises(KeyError):
        tlora.add_lora(base, 2, generator=torch.Generator(),
                       targets=("nope",))
    # a quantized base takes adapters too (QLoRA), bf16 by default
    q = {"q4": torch.zeros(2, 2, 16, 64, dtype=torch.int8),
         "s": torch.ones(2, 2, 1, 64)}
    ql = tlora.add_lora({"blocks": {"wq": q}}, 2,
                        generator=torch.Generator(), targets=("wq",))
    assert ql["blocks"]["wq"] is q
    assert ql["blocks"]["wq_lora_a"].shape == (2, 64, 2)
    assert ql["blocks"]["wq_lora_b"].dtype == torch.bfloat16


def test_merge_lora_equals_adapted_forward_and_jax():
    cfg, _, lp = _lora_params()
    g = torch.Generator().manual_seed(9)
    for t in ("wq", "wv"):
        lp["blocks"][t + "_lora_b"] = torch.randn(
            lp["blocks"][t + "_lora_b"].shape, generator=g) * 0.05
    merged = tlora.merge_lora(lp, alpha=cfg.lora_alpha)
    assert not any(tlora.is_lora_name(k) for k in merged["blocks"])
    tok = torch.randint(0, 256, (2, 12), generator=g)
    with torch.no_grad():
        np.testing.assert_allclose(
            tllama.forward(merged, tok, cfg).numpy(),
            tllama.forward(lp, tok, cfg).numpy(), atol=1e-4, rtol=1e-4)
    jm = jlora.merge_lora(jax.tree.map(lambda t: jnp.asarray(t.numpy()), lp),
                          alpha=cfg.lora_alpha)
    for k, v in merged["blocks"].items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jm["blocks"][k]),
                                   atol=1e-7)
    assert tlora.lora_mask(lp) == jax.tree.map(
        bool, jlora.lora_mask(jax.tree.map(lambda t: t.numpy(), lp)))


def test_lora_partition_trains_only_adapters():
    cfg, base, lp = _lora_params()
    before = {k: v.clone() for k, v in toptim.leaf_paths(lp).items()}
    tcfg = ttrain.TrainConfig(model=cfg, optim=toptim.OptimConfig(
        train_only="lora", **OPT))
    state = ttrain.init_train_state(tcfg, params=lp)
    adapters = {k for k in before if tlora.is_lora_name(k.split("/")[-1])}
    assert set(state.opt_state.mu) == set(state.opt_state.nu) == adapters
    step = ttrain.make_train_step(tcfg, state)
    batch = {k: torch.from_numpy(v) for k, v in _packed_batch().items()}
    for _ in range(3):
        state, m = step(state, batch)
        assert np.isfinite(float(m["loss"]))
    after = toptim.leaf_paths(state.params)
    for k, v in before.items():
        if k in adapters:
            assert after[k].requires_grad
        else:
            assert torch.equal(after[k], v), k
            assert not after[k].requires_grad
    assert torch.count_nonzero(after["blocks/wq_lora_b"]) > 0
    with pytest.raises(ValueError, match="matched no parameters"):
        ttrain.init_train_state(tcfg, params=base)


# ---------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------

class _ProjectionCounter(TorchDispatchMode):
    """Counts, per weight name, the products ``h @ w`` (``aten.mm`` with
    the weight itself, not its transpose, as second operand) — i.e.
    forward projections, which in a backward are recomputations."""

    def __init__(self, blocks, n_layers):
        super().__init__()
        self.weights = [(n, blocks[n][i]) for n in
                        ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
                        for i in range(n_layers)]
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            b = args[1]
            for name, w in self.weights:
                if (b.data_ptr() == w.data_ptr() and b.stride() == w.stride()
                        and b.shape == w.shape):
                    self.seen.add(name)
        return func(*args, **(kwargs or {}))


RECOMPUTED = {
    "full": {"wq", "wk", "wv", "wo", "w_gate", "w_up"},
    "dots": set(),
    "attn": {"wo", "w_gate", "w_up"},
    "mlp": {"wq", "wk", "wv", "wo"},
    "attn+mlp": {"wo"},
}


@pytest.mark.parametrize("policy", list(RECOMPUTED))
def test_remat_policy_grads_and_recompute_set(policy):
    """Each policy's gradients equal remat=False's bit for bit, and its
    backward recomputes exactly JAX's set of projections (w_down never:
    its output is unread). The flash forward reruns under every policy
    (its lse is never saved), so the node runs twice per layer."""
    cfg = tllama.LlamaConfig.tiny()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    flat = toptim.leaf_paths(params)
    for t in flat.values():
        t.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _packed_batch().items()}

    def grads(c, counter=None):
        calls = []
        orig = fa.flash_attention_reference_bh

        def counted(*a, **kw):
            calls.append(1)
            return orig(*a, **kw)

        fa.flash_attention_reference_bh = counted
        try:
            logits = tllama.forward(params, batch["tokens"], c,
                                    positions=batch["positions"],
                                    segments=batch["segments"], packed=True,
                                    impl="flash")
            loss, _ = softmax_cross_entropy(logits, batch["labels"])
            if counter is None:
                return torch.autograd.grad(loss, list(flat.values())), calls
            with counter:
                return torch.autograd.grad(loss, list(flat.values())), calls
        finally:
            fa.flash_attention_reference_bh = orig

    ref, ref_calls = grads(replace(cfg, remat=False))
    assert len(ref_calls) == cfg.n_layers
    counter = _ProjectionCounter(params["blocks"], cfg.n_layers)
    got, calls = grads(replace(cfg, remat=True, remat_policy=policy), counter)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert counter.seen == RECOMPUTED[policy]
    assert len(calls) == 2 * cfg.n_layers


def test_unknown_remat_policy_raises():
    cfg = tllama.LlamaConfig.tiny(remat_policy="nope")
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="remat_policy"):
        tllama.forward(params, torch.zeros(1, 4, dtype=torch.int64), cfg)


def test_config_remat_defaults_match_jax():
    j, t = jllama.LlamaConfig(), tllama.LlamaConfig()
    assert (t.remat, t.remat_policy) == (j.remat, j.remat_policy)


# ---------------------------------------------------------------------
# data, flops
# ---------------------------------------------------------------------

def test_data_functions_match_jax(tmp_path):
    for a, b in zip(tdata.synthetic_batches(3, 16, 100, seed=4),
                    jdata.synthetic_batches(3, 16, 100, seed=4)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        break
    rng = np.random.default_rng(6)
    docs = [rng.integers(1, 99, n).tolist() for n in rng.integers(1, 40, 30)]
    p, q = tdata.pack_documents(docs, 24), jdata.pack_documents(docs, 24)
    for k in q:
        np.testing.assert_array_equal(p[k], q[k])
    for a, b in zip(tdata.packed_batches(iter(docs), 3, 24),
                    jdata.packed_batches(iter(docs), 3, 24)):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    paths = []
    for i in range(2):
        path = tmp_path / f"shard{i}.jsonl"
        path.write_text("".join(json.dumps({"tokens": d}) + "\n"
                                for d in docs[i::2]))
        paths.append(path)
    assert list(tdata.jsonl_documents(paths, seed=1)) == list(
        jdata.jsonl_documents(paths, seed=1))


def test_device_prefetch_keeps_order_and_dtype():
    batches = [b for b, _ in zip(tdata.synthetic_batches(2, 8, 50, seed=1),
                                 range(5))]
    out = list(tdata.device_prefetch(iter(batches), "cpu", depth=2))
    assert len(out) == 5
    for a, b in zip(out, batches):
        assert a["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(a["tokens"].numpy(), b["tokens"])


def test_flops_match_jax():
    for name in tllama.PRESETS:
        j = getattr(jllama.LlamaConfig, name)()
        t = getattr(tllama.LlamaConfig, name)()
        assert tflops.matmul_param_count(t) == jflops.matmul_param_count(j)
        for frozen in (False, True):
            assert tflops.train_flops_per_token(t, 2048, frozen_base=frozen) \
                == jflops.train_flops_per_token(j, 2048, frozen_base=frozen)
    assert tflops.device_peak_flops("cpu") is None
    assert tflops.device_peaks("NVIDIA H100 80GB HBM3")[1] == 989e12
    assert tflops.device_peaks("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    assert tflops.device_peaks("NVIDIA GeForce") is None


# ---------------------------------------------------------------------
# checkpoint, fit, entry point
# ---------------------------------------------------------------------

def test_checkpointer_retention_and_roundtrip(tmp_path):
    tcfg = _port_cfg()
    state = ttrain.init_train_state(tcfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    ck = Checkpointer(tmp_path, max_to_keep=2)
    assert ck.latest_step() is None and ck.restore(device="cpu") is None
    for s in (1, 2, 3):
        state.step = s
        assert ck.save(state)
    assert not ck.save(state)
    assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == ["2", "3"]
    back = ck.restore(device="cpu")
    assert back.step == 3 and back.opt_state.count == 0
    for k, v in toptim.leaf_paths(state.params).items():
        assert torch.equal(toptim.leaf_paths(back.params)[k], v)
    ck.close()


def test_checkpointer_restore_defaults_to_the_card(tmp_path, monkeypatch):
    """Like every entry point of the port, ``restore`` with no device
    lands on the card, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ck = Checkpointer(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        ck.restore()
    assert ck.restore(device="cpu") is None


def test_fit_resume_is_bit_exact(tmp_path):
    tcfg = _port_cfg()

    def data():
        return tdata.synthetic_batches(4, 16, 256, seed=2)

    straight, hist = fit(tcfg, data(), LoopConfig(total_steps=4, log_every=1),
                         device="cpu")
    assert [h.step for h in hist] == [1, 2, 3, 4]
    assert all(h.mfu_pct == 0.0 for h in hist)   # no peak for the CPU
    loop2 = LoopConfig(total_steps=2, log_every=1,
                       checkpoint_dir=str(tmp_path))
    fit(tcfg, data(), loop2, device="cpu")
    assert Checkpointer(tmp_path).latest_step() == 2
    resumed, hist = fit(tcfg, data(), replace(loop2, total_steps=4),
                        device="cpu")
    assert [h.step for h in hist] == [3, 4]
    assert resumed.step == straight.step == 4
    assert resumed.opt_state.count == straight.opt_state.count == 4
    for k, v in toptim.leaf_paths(straight.params).items():
        assert torch.equal(toptim.leaf_paths(resumed.params)[k], v), k
    for k, v in straight.opt_state.mu.items():
        assert torch.equal(resumed.opt_state.mu[k], v), k


def test_loop_config_and_metrics_have_jax_fields():
    from kubeflow_rm_tpu.training import loop as jloop
    from kubeflow_rm_tpu_torch.training import loop as tloop

    def fields(cls):
        return {f.name: f.default for f in dataclasses.fields(cls)}

    assert fields(tloop.LoopConfig) == fields(jloop.LoopConfig)
    assert fields(tloop.LoopMetrics) == fields(jloop.LoopMetrics)


def test_tensorboard_callback_writes_the_five_tags(tmp_path):
    """``TensorboardCallback`` writes JAX's five scalars under JAX's tags,
    one point per call."""
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    from kubeflow_rm_tpu_torch.training.loop import LoopMetrics
    from kubeflow_rm_tpu_torch.utils.tensorboard import TensorboardCallback

    cb = TensorboardCallback(str(tmp_path))
    for step in (1, 2):
        cb(LoopMetrics(step=step, loss=5.0 / step, grad_norm=1.5,
                       tokens_per_sec=100.0 * step, mfu_pct=0.0,
                       step_time_ms=12.5))
    cb.close()
    acc = EventAccumulator(str(tmp_path))
    acc.Reload()
    tags = {"train/loss", "train/grad_norm", "perf/tokens_per_sec",
            "perf/mfu_pct", "perf/step_time_ms"}
    assert set(acc.Tags()["scalars"]) == tags
    loss = acc.Scalars("train/loss")
    assert [(e.step, e.value) for e in loss] == [(1, 5.0), (2, 2.5)]
    assert [e.value for e in acc.Scalars("perf/tokens_per_sec")] == \
        [100.0, 200.0]


def test_finetune_tb_logdir_writes_events(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    from kubeflow_rm_tpu_torch import finetune

    assert finetune.main(["--preset", "tiny", "--device", "cpu", "--steps",
                          "2", "--batch", "2", "--seq-len", "32",
                          "--no-sample", "--tb-logdir", str(tmp_path)]) == 0
    acc = EventAccumulator(str(tmp_path))
    acc.Reload()
    assert [e.step for e in acc.Scalars("train/loss")] == [1, 2]


def test_finetune_entry_point_runs_on_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "kubeflow_rm_tpu_torch.finetune", "--preset",
         "tiny", "--device", "cpu", "--steps", "2", "--batch", "2",
         "--seq-len", "32", "--lora-rank", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "step 2 loss" in r.stdout and "sample token ids" in r.stdout


def test_checkpointer_takes_jax_call_shapes(tmp_path):
    """``save(state, *, force=False)`` takes a TrainState or any dict
    with a "step" entry; ``restore(cfg=None, mesh=None, step=None)``
    gives the tree back as saved, or a TrainState with a cfg; with a mesh
    only a TrainState restores (its shards: ``test_torch_mesh_train``)."""
    ck = Checkpointer(tmp_path)
    tree = {"step": 4, "notebook": {"x": torch.arange(3.0)}, "phase": "up"}
    assert ck.save(tree)
    assert not ck.save(dict(tree, phase="down"))
    assert ck.save({"step": torch.tensor(4), "notebook": {
        "x": torch.zeros(3)}, "phase": "down"}, force=True)
    assert ck.all_steps() == [4]
    back = ck.restore(device="cpu")
    assert back["phase"] == "down" and int(back["step"]) == 4
    assert torch.equal(back["notebook"]["x"], torch.zeros(3))
    tcfg = _port_cfg()
    with pytest.raises(ValueError, match="no train state"):
        ck.restore(tcfg, device="cpu")
    state = ttrain.init_train_state(tcfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    state.step = 5
    assert ck.save(state)
    got = ck.restore(tcfg, None, 5, device="cpu")
    assert isinstance(got, ttrain.TrainState) and got.step == 5
    assert isinstance(ck.restore(step=4, device="cpu"), dict)
    with pytest.raises(ValueError, match="sharded restore needs one"):
        ck.restore(tcfg, object(), 4, device="cpu")
    with pytest.raises(TypeError, match="step"):
        ck.save({"no_step": 1})


def test_finetune_quantized_base_and_export(tmp_path, capsys):
    """``--int4-base`` trains adapters over a packed base;
    ``--export-hf`` writes JAX's ``to_hf_llama`` arrays of the final
    weights, which a ``transformers.LlamaForCausalLM`` loads (adapters
    are left out, as in JAX)."""
    from kubeflow_rm_tpu.models import convert as jconvert
    from kubeflow_rm_tpu_torch import finetune

    common = ["--preset", "tiny", "--device", "cpu", "--steps", "2",
              "--batch", "2", "--seq-len", "32", "--lora-rank", "4"]
    assert finetune.main(common + ["--int4-base"]) == 0
    out = capsys.readouterr().out
    assert "step 2 loss" in out and "sample token ids" in out
    for bad in (["--int4-base", "--export-hf", str(tmp_path / "x.npz")],
                ["--int8-base", "--int4-base"]):
        with pytest.raises(SystemExit):
            finetune.main(common + bad)
    with pytest.raises(SystemExit):
        finetune.main(common[:-2] + ["--int8-base"])     # no --lora-rank

    npz = tmp_path / "hf.npz"
    ckdir = tmp_path / "ck"
    assert finetune.main(common + ["--no-sample", "--export-hf", str(npz),
                                   "--checkpoint-dir", str(ckdir)]) == 0
    final = Checkpointer(ckdir).restore(device="cpu")
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()),
                           final.params)
    want = jconvert.to_hf_llama(jcfg, jparams)
    got = np.load(npz)
    assert sorted(got.files) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    transformers = pytest.importorskip("transformers")
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128))
    hf.load_state_dict({k: torch.tensor(got[k]) for k in got.files})


def test_finetune_reads_an_hf_directory(tmp_path, capsys):
    """``--hf-model DIR`` trains from a local ``save_pretrained``
    directory: adapters over its int8-quantized weights here."""
    from kubeflow_rm_tpu_torch import finetune

    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=172,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256)).save_pretrained(tmp_path)
    assert finetune.main(["--hf-model", str(tmp_path), "--device", "cpu",
                          "--steps", "2", "--batch", "2", "--seq-len", "16",
                          "--lora-rank", "4", "--int8-base"]) == 0
    out = capsys.readouterr().out
    assert "step 2 loss" in out and "sample token ids" in out
