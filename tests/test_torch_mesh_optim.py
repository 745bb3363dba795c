"""Port parity of adafactor and the host-offload optimizer on a mesh
against the JAX package, on one gloo world of 4 processes (fsdp=2 ×
tp=2) against JAX's ``make_train_step`` on a mesh of the same shape over
4 virtual CPU devices.

- Adafactor (``factored_min_dim`` 64, so the tiny model's 64-wide dims
  factor): several leaves' factored dims are ≥ 64 globally and < 64 on a
  rank (``embed/tokens``: (256, 64) whole, (128, 32) a rank's; ``w_gate``:
  (2, 64, 128), (2, 32, 64)), so a rank that factored its own shard would
  run another algorithm. 3 steps of ``fit``: losses and grad norms rtol
  1e-5; the final parameters atol 2e-6 on 99.9% of each leaf and within
  ``lr`` everywhere (an unfactored leaf's first update is sign(g)·lr·rms,
  which flips where g is rounding noise).
- The host-offload arm with grad accumulation 4 (``tests/test_offload.py``'s
  mesh recipe, adam (float32 moments) and adafactor, 3 steps of one
  batch): against the port's on-card arm on the
  same mesh bit for bit (losses, grad norms, parameters: the two arms run
  the same arithmetic on the same CPU), and against JAX's on-chip arm
  (loss and grad norm rtol 1e-5, parameters as above).
- The offload state saved at fsdp=2 × tp=2 and restored at fsdp=4 and on
  one device, exact; the refusals (pp > 1 in JAX's words, ``train_only``);
  ``fit``'s offload metrics on the mesh.

The world runs with a 60 s collective timeout and a 420 s join timeout.
"""

import jax
import numpy as np
import pytest

from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu.parallel import MeshConfig, make_mesh
from kubeflow_rm_tpu.training import data as jdata
from kubeflow_rm_tpu.training import optim as joptim
from kubeflow_rm_tpu.training import train as jtrain
from kubeflow_rm_tpu_torch.models.llama import LlamaConfig
from kubeflow_rm_tpu_torch.training.checkpoint import Checkpointer
from kubeflow_rm_tpu_torch.training.optim import OptimConfig, leaf_paths
from kubeflow_rm_tpu_torch.training.train import TrainConfig

from torch_mesh_ranks import start_worlds

AXES = dict(fsdp=2, tp=2)
ADAFACTOR = dict(factored=True, factored_min_dim=64, learning_rate=1e-2,
                 warmup_steps=1, total_steps=50)
# tests/test_offload.py's _cfg, with float32 first moments: bf16 ones
# round differently once an update has moved the weights by a few ulps,
# which is why test_torch_train holds bf16 adam to one step
OFFLOAD = dict(learning_rate=1e-2, warmup_steps=2, total_steps=200,
               mu_dtype="float32")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params():
    return jllama.init_params(jllama.LlamaConfig.tiny(), jax.random.key(0))


def _packed_batch(B=4, T=32, seed=3):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 256, n).tolist()
            for n in rng.integers(5, 20, 3 * B)]
    batch = jdata.pack_documents(docs, T)
    return {k: v[:B] for k, v in batch.items()}


def _batches(steps):
    return [_packed_batch(seed=10 + s) for s in range(steps)]


def _synthetic():
    return next(jdata.synthetic_batches(8, 32, 256, seed=0))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    params = np_tree(_params())
    cases = [("adafactor_fit", "fit_losses", dict(
        axes=AXES, params=params, batches=_batches(3), optim=ADAFACTOR))]
    for name, fac in (("adam", False), ("adafactor", True)):
        cases.append((f"offload_{name}", "optimizer_arms", dict(
            axes=AXES, params=params, batches=[_synthetic()] * 3,
            optim=dict(OFFLOAD, factored=fac), grad_accum=4)))
    ckdir = tmp_path_factory.mktemp("offload_ckpt")
    cases += [
        ("offload_ckpt", "offload_checkpoint", dict(
            params=params, batch=_packed_batch(), optim=ADAFACTOR,
            directory=str(ckdir))),
        ("refusals", "offload_refusals", dict(optim=OFFLOAD)),
        ("fit_offload", "fit_offload_metrics", dict(
            axes=AXES, batches=[_synthetic()] * 3,
            optim=dict(OFFLOAD, factored=True)))]
    out = start_worlds({4: cases}, tmp_path_factory.mktemp("mesh_optim"),
                       timeout=420, collective_timeout=60)
    out.ckdir = ckdir
    return out


def _ok(results):
    for r in results:
        assert "error" not in r, r["error"]
    return results


def _jax_run(optim, batches, devices8, grad_accum=1):
    cfg = jtrain.TrainConfig(model=jllama.LlamaConfig.tiny(),
                             optim=joptim.OptimConfig(**optim))
    mesh = make_mesh(MeshConfig(**AXES), devices8[:4])
    params = _params()
    state = jtrain.TrainState(
        step=jax.numpy.zeros((), jax.numpy.int32), params=params,
        opt_state=joptim.make_optimizer(cfg.optim).init(params))
    step = jtrain.make_train_step(cfg, mesh, state,
                                  batch_keys=tuple(batches[0]),
                                  grad_accum=grad_accum)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, jtrain.shard_batch(b, mesh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, leaf_paths(np_tree(state.params))


def _params_close(got: dict, want: dict, lr: float):
    for k, v in want.items():
        err = np.abs(got[k] - v)
        assert np.mean(err <= 2e-6) >= 0.999, (k, err.max())
        assert err.max() <= lr, (k, err.max())


def test_adafactor_on_a_mesh_matches_jax(worlds, devices8):
    losses, norms, params = _jax_run(ADAFACTOR, _batches(3), devices8)
    got = _ok(worlds.results()[4]["adafactor_fit"])
    for r in got:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"], norms, rtol=1e-5)
    _params_close(got[0]["params"], params, ADAFACTOR["learning_rate"])


def test_adafactor_factors_by_the_global_shape():
    """The leaves the test above relies on: factored whole, not on a
    rank's shard (optax's rule, ``optim.factored_dims``)."""
    from kubeflow_rm_tpu_torch.training.optim import factored_dims

    for whole, local in (((256, 64), (128, 32)),
                         ((2, 64, 128), (2, 32, 64)),
                         ((64, 256), (32, 128))):
        assert factored_dims(whole, 64) is not None
        assert factored_dims(local, 64) is None


@pytest.mark.parametrize("name", ["adam", "adafactor"])
def test_offload_on_a_mesh_matches_both_arms(worlds, devices8, name):
    got = _ok(worlds.results()[4][f"offload_{name}"])
    optim = dict(OFFLOAD, factored=name == "adafactor")
    losses, norms, params = _jax_run(optim, [_synthetic()] * 3, devices8,
                                     grad_accum=4)
    for r in got:
        on, off = r["none"], r["optimizer"]
        assert off["losses"] == on["losses"]
        assert off["grad_norms"] == on["grad_norms"]
        assert off["host"]
        np.testing.assert_allclose(off["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(off["grad_norms"], norms, rtol=1e-5)
        for m in off["metrics"]:
            assert m["offload_transfer_ms"] >= m["offload_collective_ms"]
            assert 0.0 <= m["offload_overlap_frac"] <= 1.0
    on, off = got[0]["none"]["params"], got[0]["optimizer"]["params"]
    for k in on:
        np.testing.assert_array_equal(off[k], on[k], err_msg=k)
    _params_close(off, params, OFFLOAD["learning_rate"])


def test_offload_state_restores_at_another_mesh_and_one_device(worlds):
    got = _ok(worlds.results()[4]["offload_ckpt"])
    for r in got:
        assert r["host"] and r["keys_equal"]
    assert got[0]["opt_equal"]
    tcfg = TrainConfig(model=LlamaConfig.tiny(), optim=OptimConfig(
        **ADAFACTOR, offload="optimizer"))
    back = Checkpointer(worlds.ckdir).restore(tcfg, device="cpu")
    assert back.step == 1 and set(back.opt_state) == set(
        got[0]["saved_opt"])
    for k, s in back.opt_state.items():
        assert s.count == 1
        for f, want in got[0]["saved_opt"][k].items():
            t = getattr(s, f)["leaf"]
            assert t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), want, err_msg=(k, f))
    # the factored statistics are the whole leaf's
    assert got[0]["saved_opt"]["embed.tokens"]["v_row"].shape == (64,)
    assert got[0]["saved_opt"]["embed.tokens"]["v_col"].shape == (256,)


def test_offload_refusals_on_a_mesh(worlds):
    for r in _ok(worlds.results()[4]["refusals"]):
        assert r["pp"] == ("offload='optimizer' targets the single-chip "
                           "memory wall; pp meshes keep the update "
                           "on-chip (state is already sharded)")
        assert "train_only" in r["train_only"]


def test_fit_with_offload_on_a_mesh_reports_stream_metrics(worlds):
    for r in _ok(worlds.results()[4]["fit_offload"]):
        assert r["step"] == 3
        rec = r["records"][-1]
        assert np.isfinite(rec["loss"])
        assert rec["transfer_ms"] > 0.0
        assert 0.0 <= rec["overlap"] <= 1.0
