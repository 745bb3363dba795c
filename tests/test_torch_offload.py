"""The streamed host-offload optimizer of the port
(``OptimConfig(offload="optimizer")``, ``training.train``'s offload arm)
on the CPU.

The contract, after JAX's ``tests/test_offload.py``:

- the offload arm equals the on-card arm **bit for bit** (loss, grad
  norm, every parameter) for adam and adafactor, with and without grad
  accumulation and with one-layer chunks: both run
  ``Optimizer.update_leaf`` on the same numbers, so no tolerance is
  needed on one device;
- its optimizer state lives in host memory and stays there across a
  step and across a checkpoint restore, whatever device the parameters
  go to, and a resumed run continues bit for bit;
- it refuses ``train_only`` (LoRA) and an on-card state layout.
"""

from dataclasses import replace

import pytest
import torch

from kubeflow_rm_tpu_torch.models import LlamaConfig, MixtralConfig
from kubeflow_rm_tpu_torch.training import optim as toptim
from kubeflow_rm_tpu_torch.training import train as ttrain
from kubeflow_rm_tpu_torch.training.checkpoint import Checkpointer
from kubeflow_rm_tpu_torch.training.data import synthetic_batches, to_device
from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit


def _cfg(model=None, **optim):
    return ttrain.TrainConfig(
        model=model or LlamaConfig.tiny(),
        optim=toptim.OptimConfig(learning_rate=1e-2, warmup_steps=2,
                                 total_steps=200, **optim))


def _batch(seed=0):
    return to_device(next(synthetic_batches(8, 32, 256, seed=seed)), "cpu")


def _run(cfg, *, steps=3, grad_accum=1):
    state = ttrain.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    step = ttrain.make_train_step(cfg, state, grad_accum=grad_accum)
    metrics = None
    for _ in range(steps):
        state, metrics = step(state, _batch())
    return state, metrics


def _assert_params_equal(a, b):
    fa, fb = toptim.leaf_paths(a.params), toptim.leaf_paths(b.params)
    assert list(fa) == list(fb)
    for k in fa:
        assert torch.equal(fa[k], fb[k]), k


def _host_tensors(opt_state):
    return [t for s in opt_state.values()
            for f in s.__dataclass_fields__ if f != "count"
            for t in getattr(s, f).values()]


@pytest.mark.parametrize("grad_accum", [1, 4])
@pytest.mark.parametrize("factored", [False, True],
                         ids=["adamw", "adafactor"])
def test_offload_parity_bit_exact(factored, grad_accum):
    """Same seed, same batch, 3 steps: the streamed host update equals
    the on-card arm bit for bit: loss, grad norm, parameters."""
    opt = dict(factored=factored, factored_min_dim=16)
    on_card, m_ref = _run(_cfg(**opt), grad_accum=grad_accum)
    off, m_off = _run(_cfg(offload="optimizer", **opt),
                      grad_accum=grad_accum)
    assert float(m_off["loss"]) == float(m_ref["loss"])
    assert float(m_off["grad_norm"]) == float(m_ref["grad_norm"])
    _assert_params_equal(off, on_card)
    assert m_off["offload_transfer_ms"] >= 0.0
    assert 0.0 <= m_off["offload_overlap_frac"] <= 1.0


def test_offload_parity_on_mixtral_with_one_layer_chunks():
    """The MoE tree (4-D expert leaves, the router aux in the loss)
    through one-layer chunks: still the on-card arm bit for bit."""
    model = MixtralConfig.tiny_moe()
    opt = dict(factored=True, factored_min_dim=16, offload_chunk_layers=1)
    on_card, m_ref = _run(_cfg(model, **opt))
    off, m_off = _run(_cfg(model, offload="optimizer", **opt))
    assert float(m_off["router_aux"]) == float(m_ref["router_aux"])
    assert float(m_off["loss"]) == float(m_ref["loss"])
    _assert_params_equal(off, on_card)


def test_offload_chunk_plan_covers_stacked_leaves():
    """Stacked (L, ...) leaves stream in layer groups; everything else
    whole (JAX's chunk plan)."""
    cfg = _cfg(LlamaConfig.tiny(n_layers=5), offload="optimizer",
               offload_chunk_layers=2)
    state = ttrain.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    step = ttrain.make_train_step(cfg, state)
    plan = step.chunk_plan
    assert list(plan) == [toptim.leaf_key(p)
                          for p in toptim.leaf_paths(state.params)]
    assert plan["blocks.wq"] == [(0, 2), (2, 4), (4, 5)]
    # norms (L, D) and flat leaves move whole
    assert plan["blocks.attn_norm"] is None
    assert plan["embed.tokens"] is None and plan["lm_head"] is None


def test_offload_state_is_host_resident_and_stays_there():
    cfg = _cfg(offload="optimizer", factored=True, factored_min_dim=16)
    state = ttrain.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    assert set(state.opt_state) == {toptim.leaf_key(p) for p in
                                    toptim.leaf_paths(state.params)}
    assert all(t.device.type == "cpu"
               for t in _host_tensors(state.opt_state))
    step = ttrain.make_train_step(cfg, state)
    state, _ = step(state, _batch())
    assert all(s.count == 1 for s in state.opt_state.values())
    assert all(t.device.type == "cpu"
               for t in _host_tensors(state.opt_state))


def test_restore_keeps_offload_state_on_the_host(tmp_path):
    """A restore puts the parameters on the requested device and the
    offload state in host memory, never on the card (here ``meta``
    stands in for the card: the parameters go there, the state does
    not)."""
    cfg = _cfg(offload="optimizer")
    state, _ = _run(cfg, steps=1)
    ck = Checkpointer(tmp_path)
    assert ck.save(state)
    back = ck.restore(cfg, device="meta")
    assert all(t.device.type == "meta"
               for t in toptim.leaf_paths(back.params).values())
    assert set(back.opt_state) == set(state.opt_state)
    for k, s in state.opt_state.items():
        b = back.opt_state[k]
        assert type(b) is type(s) and b.count == s.count == 1
        for f in s.__dataclass_fields__:
            if f != "count":
                assert torch.equal(getattr(b, f)["leaf"],
                                   getattr(s, f)["leaf"])
                assert getattr(b, f)["leaf"].device.type == "cpu"


@pytest.mark.parametrize("factored", [False, True],
                         ids=["adamw", "adafactor"])
def test_fit_offload_resume_is_bit_exact(tmp_path, factored):
    cfg = _cfg(offload="optimizer", factored=factored, factored_min_dim=16)

    def data():
        return synthetic_batches(4, 16, 256, seed=2)

    straight, hist = fit(cfg, data(), LoopConfig(total_steps=4, log_every=1),
                         device="cpu")
    assert all(h.offload_transfer_ms >= 0.0
               and 0.0 <= h.offload_overlap_frac <= 1.0 for h in hist)
    loop2 = LoopConfig(total_steps=2, log_every=1,
                       checkpoint_dir=str(tmp_path))
    fit(cfg, data(), loop2, device="cpu")
    resumed, hist = fit(cfg, data(), replace(loop2, total_steps=4),
                        device="cpu")
    assert [h.step for h in hist] == [3, 4]
    _assert_params_equal(resumed, straight)
    for k, s in straight.opt_state.items():
        r = resumed.opt_state[k]
        assert r.count == s.count == 4
        for t, u in zip(_host_tensors({k: r}), _host_tensors({k: s})):
            assert torch.equal(t, u), k


def test_fit_loop_offload_needs_the_offload_config():
    """``LoopConfig(offload="optimizer")`` asks for the streamed arm; as
    in JAX, the optimizer config must say so too (its state layout is
    built from it), or the step refuses."""
    cfg = _cfg()
    state = ttrain.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    with pytest.raises(ValueError, match="expected 'optimizer'"):
        fit(cfg, synthetic_batches(4, 16, 256, seed=2),
            LoopConfig(total_steps=1, offload="optimizer"), state=state)


def test_offload_rejects_lora_and_unknown_policies():
    with pytest.raises(ValueError, match="train_only"):
        ttrain.init_train_state(
            _cfg(offload="optimizer", train_only="lora"),
            torch.Generator().manual_seed(0), device="cpu")
    params = {"blocks": {"wq": torch.zeros(2, 4, 4)}}
    with pytest.raises(ValueError, match="train_only"):
        toptim.make_offload_optimizer(
            toptim.OptimConfig(offload="optimizer", train_only="lora"),
            params)
    with pytest.raises(ValueError, match="expected 'optimizer'"):
        toptim.make_offload_optimizer(toptim.OptimConfig(), params)
    state = ttrain.init_train_state(_cfg(), torch.Generator().manual_seed(0),
                                    device="cpu")
    with pytest.raises(ValueError, match="unknown offload"):
        ttrain.make_train_step(_cfg(), state, offload="disk")
    off = ttrain.init_train_state(_cfg(offload="optimizer"),
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
    with pytest.raises(ValueError, match="host-offload layout"):
        ttrain.make_train_step(_cfg(), off, offload="none")
