"""Port parity of the Mixtral/MoE family (``kubeflow_rm_tpu_torch.
parallel.moe`` and ``models.mixtral``) against the JAX package, on the
CPU, float32 throughout.

JAX draws the weights; ``from_numpy_params`` carries them over.
Tolerances, with their reasons:

- routing (dispatch, combine): exact for dispatch (0/1 from the same
  top-k choices and the same cumulative counts), atol 1e-6 for combine
  and the aux loss (float32 softmax and renormalisation);
- ``moe_ffn`` output and its gradients: atol 1e-5 (float32 products
  summed in another order);
- Mixtral logits atol 1e-4 (as the Llama forward's test), aux 1e-6;
  every gradient atol 2e-6, rtol 1e-4 (as the Llama loss's test).
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kubeflow_rm_tpu.models import mixtral as jmixtral
from kubeflow_rm_tpu.parallel import moe as jmoe
from kubeflow_rm_tpu.training import data as jdata
from kubeflow_rm_tpu.training import optim as joptim
from kubeflow_rm_tpu.training import train as jtrain
import kubeflow_rm_tpu_torch.models as tmodels
from kubeflow_rm_tpu_torch.models import mixtral as tmixtral
from kubeflow_rm_tpu_torch.models.params import (
    check_params, from_numpy_params,
)
from kubeflow_rm_tpu_torch.models.remat import REMAT_POLICIES
from kubeflow_rm_tpu_torch.parallel import moe as tmoe
from kubeflow_rm_tpu_torch.training import optim as toptim
from kubeflow_rm_tpu_torch.training import train as ttrain

def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def t2n(t):
    return t.detach().float().numpy()


def _logits(seed, N=12, E=4, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((N, E)) * scale).astype(np.float32)


def _tcfg(cfg: jmoe.MoeConfig) -> tmoe.MoeConfig:
    return tmoe.MoeConfig(**vars(cfg))


# ---------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------

def test_configs_match_jax():
    assert vars(tmoe.MoeConfig()) == vars(jmoe.MoeConfig())
    for name in ("mixtral_8x7b", "tiny_moe"):
        j = getattr(jmixtral.MixtralConfig, name)()
        t = getattr(tmixtral.MixtralConfig, name)()
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "hidden_dim", "max_seq_len", "rope_theta", "norm_eps"):
            assert getattr(t, f) == getattr(j, f), (name, f)
        assert vars(t.moe) == vars(j.moe), name
    t, j = tmixtral.MixtralConfig.mixtral_8x7b(), \
        jmixtral.MixtralConfig.mixtral_8x7b()
    assert tmixtral.param_spec_shapes(t) == jax.tree.map(
        tuple, jmixtral.param_spec_shapes(j),
        is_leaf=lambda x: isinstance(x, tuple))
    for n in (1, 7, 2048):
        assert tmoe.expert_capacity(t.moe, n) == jmoe.expert_capacity(j.moe,
                                                                      n)


@pytest.mark.parametrize("rows", [
    np.zeros((3, 8), np.float32),                       # all tied
    np.array([[1, 3, 3, 0, 3, 1, 0, 2]], np.float32),   # a three-way tie
    np.array([[0, 0, 5, 5], [2, 2, 2, 1]], np.float32),
])
def test_top_k_breaks_ties_like_lax(rows):
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(rows), k)
        tv, ti = tmoe.top_k(torch.from_numpy(rows), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("case", ["ample", "drops", "tied", "top1_drops"])
def test_route_matches_jax(case):
    """Dispatch, combine and aux against ``route``: with room for every
    token, with capacity drops (slot 0 of every token before any slot
    1), with all-zero (fully tied) logits, and top-1 over a skewed
    router."""
    N, E = 16, 4
    if case == "ample":
        cfg, logits = jmoe.MoeConfig(n_experts=E, capacity_factor=4.0), \
            _logits(0, N, E)
    elif case == "drops":
        cfg, logits = jmoe.MoeConfig(n_experts=E, capacity_factor=0.5), \
            _logits(1, N, E, scale=3.0)
    elif case == "tied":
        cfg, logits = jmoe.MoeConfig(n_experts=E, capacity_factor=1.0), \
            np.zeros((N, E), np.float32)
    else:
        cfg = jmoe.MoeConfig(n_experts=E, top_k=1, capacity_factor=1.0)
        logits = _logits(2, N, E) + np.array([4, 0, 0, 0], np.float32)
    cap = jmoe.expert_capacity(cfg, N)
    jd, jc, ja = jmoe.route(jnp.asarray(logits), cfg, cap)
    td, tc, ta = tmoe.route(torch.from_numpy(logits), _tcfg(cfg), cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)
    if case in ("drops", "top1_drops"):
        assert td.sum() < N * cfg.top_k          # something was dropped
    assert (td.sum((0, 2)) <= cap).all()


def test_route_respects_capacity():
    """JAX's capacity contract: all 8 tokens want expert 0 with room for
    4; the first 4 by token order take its slots, the rest fall through
    (nothing in combine)."""
    cfg = tmoe.MoeConfig(n_experts=2, top_k=1, capacity_factor=1.0)
    logits = torch.tensor([[5.0, 0.0]]).repeat(8, 1)
    cap = tmoe.expert_capacity(cfg, 8)
    assert cap == 4
    dispatch, combine, _ = tmoe.route(logits, cfg, cap)
    assert int(dispatch.sum()) == 4
    assert dispatch[:, 0, :].sum(0).tolist() == [1, 1, 1, 1]
    assert float(combine[4:].sum()) == 0.0


def _moe_params(seed, cfg, D=16, F=32):
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal(shape) * 0.1).astype(np.float32)
            for name, shape in sorted(jmoe.moe_param_shapes(cfg, D, F)
                                      .items())}


@pytest.mark.parametrize("capacity_factor", [4.0, 1.0])
def test_moe_ffn_and_grads_match_jax(capacity_factor):
    """Output, aux and the gradients of every weight and of x."""
    cfg = jmoe.MoeConfig(n_experts=4, top_k=2,
                         capacity_factor=capacity_factor)
    params = _moe_params(3, cfg)
    x = np.random.default_rng(4).standard_normal((2, 8, 16)).astype(
        np.float32)
    proj = np.random.default_rng(5).standard_normal((2, 8, 16)).astype(
        np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_ffn(p, x, cfg, dtype=jnp.float32)
        return jnp.sum(out * proj) + aux, (out, aux)

    (jl, (jout, jaux)), jg = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    tout, taux = tmoe.moe_ffn(tp, tx, _tcfg(cfg), dtype=torch.float32)
    tl = (tout * torch.from_numpy(proj)).sum() + taux
    grads = torch.autograd.grad(tl, [*tp.values(), tx])
    np.testing.assert_allclose(t2n(tout), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(float(taux.detach()), float(jaux), atol=1e-6)
    for (k, g) in zip(tp, grads):
        np.testing.assert_allclose(t2n(g), np.asarray(jg[0][k]), atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(t2n(grads[-1]), np.asarray(jg[1]), atol=1e-5)


# ---------------------------------------------------------------------
# the Mixtral model
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    jcfg = jmixtral.MixtralConfig.tiny_moe()
    jparams = np_tree(jmixtral.init_params(jcfg, jax.random.key(0)))
    tcfg = tmixtral.MixtralConfig.tiny_moe()
    return jcfg, jparams, tcfg, from_numpy_params(jparams, tcfg, "cpu")


def _packed_batch(B=2, T=32, seed=3):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 256, n).tolist()
            for n in rng.integers(5, 20, 3 * B)]
    batch = jdata.pack_documents(docs, T)
    return {k: v[:B] for k, v in batch.items()}


def test_mixtral_forward_matches_jax(tiny):
    jcfg, jparams, tcfg, tparams = tiny
    tok = np.random.default_rng(6).integers(0, 256, (2, 24)).astype(np.int32)
    jl, ja = jmixtral.forward(jax.tree.map(jnp.asarray, jparams),
                              jnp.asarray(tok), jcfg)
    tl, ta = tmodels.forward_with_aux(tparams, torch.from_numpy(tok), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(float(ta), float(ja), atol=1e-6)
    assert 1.0 <= float(ta) <= tcfg.moe.n_experts


def test_llama_forward_with_aux_has_no_aux():
    from kubeflow_rm_tpu_torch.models import llama as tllama

    cfg = tllama.LlamaConfig.tiny()
    params = tmodels.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    logits, aux = tmodels.forward_with_aux(
        params, torch.zeros(1, 4, dtype=torch.int32), cfg)
    assert aux is None and logits.shape == (1, 4, cfg.vocab_size)


@pytest.mark.parametrize("policy", [None, *REMAT_POLICIES])
def test_mixtral_loss_and_grads_match_jax(tiny, policy):
    """The training loss (cross-entropy + z-loss + router_aux_weight ·
    router aux) and the gradient of every leaf against JAX's ``loss_fn``
    on a packed batch, remat off and under each policy."""
    jcfg, jparams, tcfg, _ = tiny
    remat = dict(remat=False) if policy is None else dict(
        remat=True, remat_policy=policy)
    jt = jtrain.TrainConfig(model=replace(jcfg, **remat))
    tt = ttrain.TrainConfig(model=replace(tcfg, **remat))
    batch = _packed_batch()
    (jl, jaux), jg = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        jax.tree.map(jnp.asarray, jparams),
        jax.tree.map(jnp.asarray, batch), jt)
    params = from_numpy_params(jparams, tt.model, "cpu")
    flat = toptim.leaf_paths(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss, aux = ttrain.loss_fn(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, tt)
    grads = torch.autograd.grad(loss, list(flat.values()))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    assert set(aux) == set(jaux) and "router_aux" in aux
    np.testing.assert_allclose(float(aux["router_aux"].detach()),
                               float(jaux["router_aux"]), atol=1e-6)
    jflat = toptim.leaf_paths(np_tree(jg))
    for k, g in zip(flat, grads):
        np.testing.assert_allclose(t2n(g), jflat[k], atol=2e-6, rtol=1e-4,
                                   err_msg=k)


class _ExpertCounter(TorchDispatchMode):
    """Counts, per weight name, forward products with one layer's weight
    (``mm``/``bmm`` with the weight itself as second operand): in a
    backward these are recomputations."""

    def __init__(self, blocks, n_layers):
        super().__init__()
        self.weights = [(n, blocks[n][i]) for n in
                        ("wq", "wk", "wv", "wo", "moe_gate", "moe_up",
                         "moe_down") for i in range(n_layers)]
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
            b = args[1]
            for name, w in self.weights:
                if (b.data_ptr() == w.data_ptr() and b.stride() == w.stride()
                        and b.shape == w.shape):
                    self.seen.add(name)
        return func(*args, **(kwargs or {}))


#: JAX's recomputation under each policy: the expert down product's
#: output feeds the combine's backward and is never saved; "dots" saves
#: only products without batch dims, so all three expert products rerun
MOE_RECOMPUTED = {
    "full": {"wq", "wk", "wv", "wo", "moe_gate", "moe_up", "moe_down"},
    "dots": {"moe_gate", "moe_up", "moe_down"},
    "attn": {"wo", "moe_gate", "moe_up", "moe_down"},
    "mlp": {"wq", "wk", "wv", "wo", "moe_down"},
    "attn+mlp": {"wo", "moe_down"},
}


@pytest.mark.parametrize("policy", list(MOE_RECOMPUTED))
def test_mixtral_remat_recompute_set(policy):
    """Each policy's gradients equal remat=False's bit for bit, and the
    named policies save the expert activations (``mlp_gate``/``mlp_up``)
    instead of recomputing the products that made them."""
    cfg = tmixtral.MixtralConfig.tiny_moe()
    params = tmixtral.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    flat = toptim.leaf_paths(params)
    for t in flat.values():
        t.requires_grad_(True)
    tok = torch.randint(0, 256, (2, 16),
                        generator=torch.Generator().manual_seed(1))

    def grads(c, counter=None):
        logits, aux = tmixtral.forward(params, tok, c)
        loss = logits.logsumexp(-1).mean() + aux
        if counter is None:
            return torch.autograd.grad(loss, list(flat.values()))
        with counter:
            return torch.autograd.grad(loss, list(flat.values()))

    ref = grads(replace(cfg, remat=False))
    counter = _ExpertCounter(params["blocks"], cfg.n_layers)
    got = grads(replace(cfg, remat=True, remat_policy=policy), counter)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert counter.seen == MOE_RECOMPUTED[policy]


def test_init_params_shapes_and_residual_scale():
    """``param_spec_shapes``' tree, drawn layer by layer; the residual
    writers (wo, moe_down) scaled by 1/sqrt(2L) as in JAX's init_leaf."""
    cfg = tmixtral.MixtralConfig.tiny_moe(n_layers=4)
    params = tmodels.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    check_params(params, cfg)
    b = params["blocks"]
    assert torch.equal(b["attn_norm"], torch.ones_like(b["attn_norm"]))
    for name, scale in (("wq", 0.02), ("moe_gate", 0.02), ("router", 0.02),
                        ("wo", 0.02 / 8 ** 0.5),
                        ("moe_down", 0.02 / 8 ** 0.5)):
        assert abs(float(b[name].std()) / scale - 1) < 0.1, name


def test_train_step_with_router_aux_matches_jax(tiny, devices8):
    """Three adam steps of the port's trainer on Mixtral against JAX's:
    losses and every metric (``router_aux`` among them) rtol 1e-5."""
    from kubeflow_rm_tpu.parallel import MeshConfig, make_mesh

    jcfg, jparams, tcfg, _ = tiny
    opt = dict(learning_rate=1e-2, warmup_steps=1, total_steps=50,
               mu_dtype="float32")
    jt = jtrain.TrainConfig(model=jcfg, optim=joptim.OptimConfig(**opt))
    tt = ttrain.TrainConfig(model=tcfg, optim=toptim.OptimConfig(**opt))
    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, sp=1, tp=1), devices8[:1])
    jstate = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32),
        params=jax.tree.map(jnp.asarray, jparams),
        opt_state=joptim.make_optimizer(jt.optim).init(
            jax.tree.map(jnp.asarray, jparams)))
    batch = _packed_batch(B=4)
    jstep = jtrain.make_train_step(jt, mesh, jstate, batch_keys=tuple(batch))
    tstate = ttrain.init_train_state(
        tt, params=from_numpy_params(jparams, tcfg, "cpu"))
    tstep = ttrain.make_train_step(tt, tstate)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(3):
        jstate, jm = jstep(jstate, jtrain.shard_batch(batch, mesh))
        tstate, tm = tstep(tstate, tbatch)
        assert set(tm) == set(jm) and "router_aux" in tm
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=k)
