"""Two repairs to the training step, held on the CPU.

- **A stacked leaf's backward makes no whole-leaf tensor per layer**
  (``models/llama.layer_slices``). A training forward takes layer ``i``
  of a stacked ``(L, ...)`` leaf through ``_StackedSlice``, whose
  backward copies the slice's gradient into one per-leaf buffer in place
  (``leaf[i]``'s own backward, ``select_backward``, was a zero-filled
  tensor of the whole leaf, one a layer). The gradients of a tiny
  full-FT Llama, a Mixtral and a pp=2 GPipe step are equal to the
  per-layer ``select`` they replace (each element has one non-zero term)
  and close to JAX's (atol 2e-6, rtol 1e-4, the parity tests' bound:
  float32 matmuls summed in another order). The meta walk's peak of a
  tiny full-remat rung drops by at least one stacked leaf, and no
  ``select_backward`` of a trained stacked leaf runs.
- **Adafactor fills its step count on the device**
  (``training/optim._adafactor``): ``torch.full`` in place of
  ``torch.tensor`` (a synchronous copy from pageable host memory on a
  card). ``(t + 1)^-decay_rate`` is bit-equal to the old value for every
  count to 5,000 and to optax's float32 value for the first 20 (XLA's
  ``pow`` and torch's part in the last bit at counts 21, 80, 101, …),
  and three adafactor steps are bit-equal to the old formula's.
"""

import ast
import copy
import importlib
import inspect
import textwrap
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu.models import mixtral as jmixtral
from kubeflow_rm_tpu.training import data as jdata
from kubeflow_rm_tpu.training import train as jtrain
from kubeflow_rm_tpu_torch.analysis.torchcheck.memplan import walk_train_step
from kubeflow_rm_tpu_torch.models import llama as tllama
from kubeflow_rm_tpu_torch.models import mixtral as tmixtral
from kubeflow_rm_tpu_torch.models.params import from_numpy_params
from kubeflow_rm_tpu_torch.training import optim as toptim
from kubeflow_rm_tpu_torch.training import train as ttrain

from torch_mesh_ranks import start_worlds

tmodels = importlib.import_module("kubeflow_rm_tpu_torch.models")


def _packed_batch(B=4, T=32, seed=3):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 256, n).tolist()
            for n in rng.integers(5, 20, 3 * B)]
    batch = jdata.pack_documents(docs, T)
    return {k: v[:B] for k, v in batch.items()}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


class _select_slices:
    """The per-layer views the training forwards took before the repair:
    ``leaf[i]`` (whose backward is ``select_backward``), made afresh as
    each loop over the layers reaches layer ``i``."""

    def __init__(self, blocks):
        self.blocks = blocks

    def __iter__(self):
        return (tllama.layer_params(self.blocks, i)
                for i in range(tllama.stacked_layers(self.blocks)))


def _grads(params, cfg, batch):
    flat = toptim.leaf_paths(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss, _ = ttrain.loss_fn(params, batch, ttrain.TrainConfig(model=cfg))
    return loss, dict(zip(flat, torch.autograd.grad(
        loss, list(flat.values()))))


def _both_arms(monkeypatch, params, cfg, batch):
    """(loss, grads) through ``layer_slices`` and through the old
    per-layer select, from copies of the same parameters."""
    new = _grads(copy.deepcopy(params), cfg, batch)
    with monkeypatch.context() as m:
        m.setattr(tllama, "layer_slices", _select_slices)
        m.setattr(tmixtral, "layer_slices", _select_slices)
        old = _grads(copy.deepcopy(params), cfg, batch)
    return new, old


FAMILIES = {
    "llama": (jllama, tllama, jllama.LlamaConfig.tiny,
              tllama.LlamaConfig.tiny),
    "mixtral": (jmixtral, tmixtral, jmixtral.MixtralConfig.tiny_moe,
                tmixtral.MixtralConfig.tiny_moe),
}


@pytest.mark.parametrize("remat", [None, "full", "dots"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_stacked_slices_give_the_selects_gradients_and_jaxs(
        monkeypatch, family, remat):
    jmod, _, jtiny, ttiny = FAMILIES[family]
    kw = dict(remat=remat is not None)
    if remat is not None:
        kw["remat_policy"] = remat
    jcfg, tcfg = replace(jtiny(), **kw), replace(ttiny(), **kw)
    if family == "mixtral":     # capacity for every token: nothing drops
        jcfg = replace(jcfg, moe=replace(jcfg.moe, capacity_factor=8.0))
        tcfg = replace(tcfg, moe=replace(tcfg.moe, capacity_factor=8.0))
    jparams = jmod.init_params(jcfg, jax.random.key(1))
    batch = _packed_batch()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    params = from_numpy_params(_np_tree(jparams), tcfg, "cpu")
    (loss, grads), (old_loss, old_grads) = _both_arms(
        monkeypatch, params, tcfg, tb)
    assert torch.equal(loss, old_loss)
    for k, g in grads.items():
        assert torch.equal(g, old_grads[k]), k
    (jl, _), jg = jax.value_and_grad(jtrain.loss_fn, has_aux=True)(
        jparams, jax.tree.map(jnp.asarray, batch),
        jtrain.TrainConfig(model=jcfg))
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    jflat = toptim.leaf_paths(_np_tree(jg))
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jflat[k], atol=2e-6,
                                   rtol=1e-4, err_msg=k)


class _Ops(TorchDispatchMode):
    """Records each op's name and its output's shape."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor):
            self.seen.append((func.overloadpacket.__name__,
                              tuple(out.shape)))
        return out


def test_no_whole_leaf_select_backward_runs(monkeypatch):
    cfg = tllama.LlamaConfig.tiny()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    stacked = {tuple(t.shape) for t in params["blocks"].values()}
    tb = {k: torch.from_numpy(v) for k, v in _packed_batch().items()}
    whole = {}
    for arm, slices in (("new", tllama.layer_slices),
                        ("old", _select_slices)):
        monkeypatch.setattr(tllama, "layer_slices", slices)
        with _Ops() as ops:
            _grads(copy.deepcopy(params), cfg, tb)
        whole[arm] = [shape for name, shape in ops.seen
                      if name == "select_backward" and shape in stacked]
    # one whole-leaf tensor a layer and leaf before; none now
    assert len(whole["old"]) == cfg.n_layers * len(params["blocks"])
    assert whole["new"] == []


def test_frozen_leaves_stay_plain_views():
    cfg = tllama.LlamaConfig.tiny()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    blocks = params["blocks"]
    blocks["wq"].requires_grad_(True)
    layers = tllama.layer_slices(blocks)
    assert layers[1]["wo"]._base is blocks["wo"]
    assert layers[1]["wo"].grad_fn is None
    assert type(layers[1]["wq"].grad_fn).__name__ == "_StackedSliceBackward"
    with torch.no_grad():
        assert tllama.layer_slices(blocks)[0]["wq"].grad_fn is None
    torch.testing.assert_close(layers[1]["wq"], blocks["wq"][1], rtol=0,
                               atol=0)


def test_a_slice_left_out_of_the_loss_is_an_error():
    w = torch.randn(3, 4, 4, requires_grad=True)
    x = torch.randn(2, 4)
    layers = tllama.layer_slices({"w": w})
    for i in range(2):                                  # layer 2 unused
        x = x @ layers[i]["w"]
    with pytest.raises(RuntimeError, match="1 of 3 layer slices"):
        torch.autograd.grad(x.sum(), [w])


def test_reused_slices_sum_over_microbatches():
    """A slice used by several microbatches (the GPipe stage body) sums
    its gradient in the slice before it enters the leaf's buffer."""
    w = torch.randn(2, 4, 4, requires_grad=True)
    xs = torch.randn(3, 2, 4)
    layers = tllama.layer_slices({"w": w})
    total = 0
    for x in xs:
        for layer in layers:
            x = x @ layer["w"]
        total = total + x.sum()
    (g,) = torch.autograd.grad(total, [w])
    ref = 0
    for x in xs:
        for i in range(2):
            x = x @ w[i]
        ref = ref + x.sum()
    (want,) = torch.autograd.grad(ref, [w])
    torch.testing.assert_close(g, want, rtol=0, atol=1e-6)


def _tiny_rung(family):
    """A tiny full-remat adafactor rung whose stacked leaves outweigh its
    activations (wide, 16 tokens a row), so the backward's gradient
    buffers bind the peak as they do at 7B."""
    kw = dict(dim=256, hidden_dim=1024, n_heads=4, n_kv_heads=2,
              max_seq_len=16, remat=True, remat_policy="full")
    model = (tllama.LlamaConfig.tiny(**kw) if family == "llama"
             else tmixtral.MixtralConfig.tiny_moe(**kw))
    return ttrain.TrainConfig(model=model, optim=toptim.OptimConfig(
        factored=True, factored_min_dim=4))


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_the_walk_drops_by_a_stacked_leaf(monkeypatch, family):
    """The planner's walk of a tiny full-remat adafactor rung (two
    microbatches) on meta tensors: with the repair the peak is at least
    one stacked leaf (the largest) lower."""
    tcfg = _tiny_rung(family)
    new = walk_train_step(tcfg, 2, 2)
    with monkeypatch.context() as m:
        m.setattr(tllama, "layer_slices", _select_slices)
        m.setattr(tmixtral, "layer_slices", _select_slices)
        old = walk_train_step(tcfg, 2, 2)
    params = tmodels.init_params(tcfg.model, torch.Generator(), "meta")
    leaf = max(t.numel() * t.element_size()
               for t in params["blocks"].values())
    assert old["peak_bytes"] - new["peak_bytes"] >= leaf, (old, new, leaf)
    # the old path's zero fills and sums were elementwise work too
    assert new["flops_per_step"] <= old["flops_per_step"]


def test_pp2_gpipe_step_gradients_equal_the_selects(tmp_path):
    """A pp=2 GPipe step on a gloo world of two: every leaf's gradient
    (each rank's stage, gathered) through ``layer_slices`` equals the
    per-layer select's, and the losses are equal."""
    cfg = jllama.LlamaConfig.tiny(n_layers=4)
    params = _np_tree(jllama.init_params(cfg, jax.random.key(2)))
    rng = np.random.default_rng(7)
    tokens = rng.integers(1, 256, (4, 16)).astype(np.int32)
    case = ("arms", "stacked_slice_arms", dict(
        axes=dict(pp=2), params=params, n_microbatches=2,
        batch={"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)},
        overrides={"n_layers": 4}))
    worlds = start_worlds({2: [case]}, tmp_path, timeout=420,
                          collective_timeout=60)
    for r in worlds.results()[2]["arms"]:
        assert "error" not in r, r.get("error")
        assert r["loss_new"] == r["loss_old"]
        assert r["equal"] and r["leaves"] == len(toptim.leaf_paths(params))


# -- C8: adafactor's step count --------------------------------------------


def test_decay_is_the_old_value_and_optaxs():
    b2 = toptim.OptimConfig().b2
    for n in range(1, 5001):
        new = 1.0 - torch.full((), n, dtype=torch.float32) ** -b2
        old = 1.0 - torch.tensor(n, dtype=torch.float32) ** -b2
        assert new.numpy().view(np.uint32) == old.numpy().view(np.uint32)
    for n in range(1, 21):
        new = (1.0 - torch.full((), n, dtype=torch.float32) ** -b2).numpy()
        want = np.asarray(1.0 - (jnp.asarray(n - 1, jnp.float32) + 1.0)
                          ** (-b2))
        assert new.view(np.uint32) == want.view(np.uint32), n


def _opt_tree(rng):
    return {"blocks": {"w": rng.standard_normal((2, 8, 16)) * 0.02,
                       "norm": np.ones((2, 8))},
            "lm_head": rng.standard_normal((8, 32)) * 0.02}


def test_adafactor_steps_bit_equal_to_the_upload_formula(monkeypatch):
    """Three adafactor steps with the count filled on the device equal,
    bit for bit, the same steps with it uploaded by ``torch.tensor``."""
    rng = np.random.default_rng(5)
    tree = {k: v.astype(np.float32) for k, v in
            toptim.leaf_paths(_opt_tree(rng)).items()}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32)
              for k, v in tree.items()} for s in (0.05, 5.0, 0.3)]
    cfg = toptim.OptimConfig(learning_rate=1e-2, warmup_steps=1,
                             total_steps=8, factored=True,
                             factored_min_dim=4)

    def run():
        p = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
        opt = toptim.make_optimizer(cfg)
        state = opt.init(p)
        for g in grads:
            opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                       state, p)
        return p, state

    p_new, s_new = run()
    real_full = torch.full

    def uploaded(size, value, *, dtype=None, device=None, **kw):
        if size == () and dtype == torch.float32:
            return torch.tensor(value, dtype=dtype, device=device)
        return real_full(size, value, dtype=dtype, device=device, **kw)

    monkeypatch.setattr(torch, "full", uploaded)
    p_old, s_old = run()
    monkeypatch.setattr(torch, "full", real_full)
    for k in tree:
        assert torch.equal(p_new[k], p_old[k]), k
        for f in ("v_row", "v_col", "v"):
            assert torch.equal(getattr(s_new, f)[k], getattr(s_old, f)[k])


def test_adafactor_uploads_nothing(monkeypatch):
    """No ``torch.tensor`` call in ``_adafactor``'s source, and none made
    while it runs three steps."""
    src = textwrap.dedent(inspect.getsource(toptim.Optimizer._adafactor))
    calls = [ast.unparse(n.func) for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Call)]
    assert "torch.tensor" not in calls and "torch.full" in calls
    made = []
    real = torch.tensor

    def spy(*a, **kw):
        made.append(kw.get("device"))
        return real(*a, **kw)

    rng = np.random.default_rng(6)
    tree = {k: torch.from_numpy(v.astype(np.float32)) for k, v in
            toptim.leaf_paths(_opt_tree(rng)).items()}
    opt = toptim.make_optimizer(toptim.OptimConfig(factored=True,
                                                   factored_min_dim=4))
    state = opt.init(tree)
    grads = {k: torch.ones_like(v) for k, v in tree.items()}
    monkeypatch.setattr(torch, "tensor", spy)
    for _ in range(3):
        opt.update(grads, state, tree)
    monkeypatch.setattr(torch, "tensor", real)
    assert made == []
