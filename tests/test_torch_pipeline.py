"""Port parity of the GPipe schedule (``kubeflow_rm_tpu_torch.parallel.
pipeline``) against the JAX package's, every case of
``tests/test_pipeline.py`` on gloo worlds of 2 and 4 processes against
JAX's ``pipeline_forward`` on as many virtual CPU devices in a mesh of
the same shape.

Each case builds its weights in JAX from a seed and carries them over
with ``from_numpy_params``; every rank computes its stage of its rows
(``torch_mesh_ranks``) and the logits and gradients come back gathered
to global arrays. Tolerances are JAX's own for the schedule (float32):

- logits atol 2e-5, rtol 1e-5 (the pipeline against the plain forward);
- the gradient test's loss rtol 1e-6 and every gradient atol 3e-5, rtol
  2e-4, the embedding and the head checked on every pp rank;
- ``make_train_step`` at pp=2 × fsdp=2 with 4 microbatches against
  JAX's flat fsdp=4 step: loss rtol 1e-5, grad norm rtol 1e-4;
- ``loss_fn``'s gradients on a pp mesh (LoRA, tp, MoE) against JAX's
  ``loss_fn`` on the same mesh: ``test_torch_mesh_train``'s bounds
  (loss rtol 1e-5, logits atol 1e-5, gradients atol 2e-6, rtol 1e-4);
- Mixtral's router aux at one microbatch: rtol 1e-6 of the plain
  forward's (exact up to float32 summation order);
- the checkpoint written at pp=2 × fsdp=2 and restored at fsdp=4: bytes
  exact;
- decode at pp=2 × tp=2 (the stages in turn): prefill logits atol 1e-5
  of JAX's one-device ``decode_chunk``, greedy tokens exact.

The worlds run with a 60 s collective timeout and a 420 s join timeout:
a schedule that deadlocks fails its tests instead of holding the run.
"""

import importlib
import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu.models import lora as jlora
from kubeflow_rm_tpu.models import mixtral as jmixtral
from kubeflow_rm_tpu.parallel import MeshConfig, make_mesh
from kubeflow_rm_tpu.parallel.pipeline import (
    pipeline_forward, pipeline_forward_with_aux,
)
from kubeflow_rm_tpu.parallel.sharding import param_shardings
from kubeflow_rm_tpu.training import data as jdata
from kubeflow_rm_tpu.training import train as jtrain
from kubeflow_rm_tpu_torch.models.llama import LlamaConfig
from kubeflow_rm_tpu_torch.models.params import check_params
from kubeflow_rm_tpu_torch.training.checkpoint import Checkpointer
from kubeflow_rm_tpu_torch.training.optim import OptimConfig, leaf_paths
from kubeflow_rm_tpu_torch.training.train import TrainConfig

from torch_mesh_ranks import start_worlds

# by full path: the package namespace shadows the module with a function
jgen = importlib.import_module("kubeflow_rm_tpu.models.generate")

OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=50,
           mu_dtype="float32")
L4 = {"n_layers": 4}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfg4():
    return jllama.LlamaConfig.tiny(n_layers=4)


def _params4():
    return jllama.init_params(_cfg4(), jax.random.key(0))


def _tokens(cfg, B=4, T=16):
    return np.asarray(jax.random.randint(jax.random.key(1), (B, T), 0,
                                         cfg.vocab_size))


def _packed():
    rng = np.random.default_rng(0)
    docs = [rng.integers(1, 256, size=10).tolist() for _ in range(8)]
    packed = jdata.pack_documents(docs, seq_len=16)
    return {"tokens": packed["tokens"][:4],
            "positions": packed["positions"][:4],
            "segments": packed["segments"][:4]}


def _packed_batch(B=4, T=32, seed=3):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 256, n).tolist()
            for n in rng.integers(5, 20, 3 * B)]
    batch = jdata.pack_documents(docs, T)
    return {k: v[:B] for k, v in batch.items()}


def _prompt():
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, 256, (4, 12)).astype(np.int32)
    pads = np.asarray([0, 3, 5, 0], np.int32)
    for i, p in enumerate(pads):
        prompt[i, :p] = 0
    return prompt, pads


def _lora_params():
    """The tiny model with adapters on every projection, ``b`` drawn
    nonzero so every adapter has a gradient."""
    base = jllama.init_params(jllama.LlamaConfig.tiny(), jax.random.key(0))
    out = jlora.add_lora(base, 4, key=jax.random.key(1),
                         targets=("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                  "w_down"))
    blocks = dict(out["blocks"])
    for i, k in enumerate(sorted(b for b in blocks if b.endswith("_lora_b"))):
        blocks[k] = jax.random.normal(jax.random.key(100 + i),
                                      blocks[k].shape) * 0.02
    return dict(out, blocks=blocks)


def _moe_cfg(**ov):
    cfg = jmixtral.MixtralConfig.tiny_moe(**ov)
    return replace(cfg, moe=replace(cfg.moe, capacity_factor=1.0))


# name -> (world, mesh axes, microbatches, batch kind)
FWD_CASES = {
    "pp2_m2": (2, dict(pp=2), 2, "tokens"),
    "pp2_m4": (2, dict(pp=2), 4, "tokens"),
    "pp4_m4": (4, dict(pp=4), 4, "tokens"),
    "pp2_fsdp2_m2": (4, dict(pp=2, fsdp=2), 2, "tokens"),
    "pp2_tp2": (4, dict(pp=2, tp=2), 2, "tokens"),
    "packed": (2, dict(pp=2), 2, "packed"),
    "pp1_fallback": (2, dict(fsdp=2), 2, "tokens"),
}

# name -> (world, mesh axes, params, family, LoRA only): loss_fn on a pp
# mesh against JAX's loss_fn on the same mesh (microbatches: pp)
GRAD_CASES = {
    "loss_pp2_fsdp2_lora": (4, dict(pp=2, fsdp=2), "lora", "dense", True),
    "loss_pp2_tp2": (4, dict(pp=2, tp=2), "dense", "dense", False),
    "loss_pp2_moe": (2, dict(pp=2), "moe", "moe", False),
}


def _grad_params(name):
    if name == "lora":
        return _lora_params()
    if name == "moe":
        return jmixtral.init_params(_moe_cfg(), jax.random.key(0))
    return jllama.init_params(jllama.LlamaConfig.tiny(), jax.random.key(0))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    specs = {2: [], 4: []}
    p4 = np_tree(_params4())
    for name, (n, axes, M, kind) in FWD_CASES.items():
        batch = _packed() if kind == "packed" else {
            "tokens": _tokens(_cfg4())}
        specs[n].append((name, "pipeline_case", dict(
            axes=axes, params=p4, batch=batch, n_microbatches=M,
            overrides=L4)))
    tokens = _tokens(_cfg4())
    specs[4].append(("grads", "pipeline_case", dict(
        axes=dict(pp=2, fsdp=2), params=p4, n_microbatches=2,
        batch={"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)},
        overrides=L4, grads=True)))
    specs[2].append(("bad_batch", "pipeline_case", dict(
        axes=dict(pp=2), params=p4, n_microbatches=2, overrides=L4,
        batch={"tokens": _tokens(_cfg4(), B=3)}, raw_params=True)))
    cfg3 = jllama.LlamaConfig.tiny(n_layers=3)
    specs[2].append(("bad_layers", "pipeline_case", dict(
        axes=dict(pp=2), n_microbatches=2, overrides={"n_layers": 3},
        params=np_tree(jllama.init_params(cfg3, jax.random.key(0))),
        batch={"tokens": _tokens(cfg3)}, raw_params=True)))
    t8 = _tokens(_cfg4(), B=8)
    specs[4].append(("train_step", "train_step_metrics", dict(
        axes=dict(pp=2, fsdp=2), params=p4, n_microbatches=4, optim={},
        batch={"tokens": t8, "labels": np.roll(t8, -1, axis=1)},
        overrides=L4)))
    moe1 = _moe_cfg()
    specs[2].append(("moe_m1", "pipeline_case", dict(
        axes=dict(pp=2), params=np_tree(jmixtral.init_params(
            moe1, jax.random.key(0))), n_microbatches=1, family="moe",
        overrides={"moe": {"capacity_factor": 1.0}},
        batch={"tokens": _tokens(moe1)})))
    for name, (n, axes, pname, family, lora) in GRAD_CASES.items():
        specs[n].append((name, "model_grads", dict(
            axes=axes, params=np_tree(_grad_params(pname)),
            batch=_packed_batch(), family=family,
            overrides={"moe": {"capacity_factor": 1.0}}
            if family == "moe" else {},
            optim={"train_only": "lora"} if lora else {})))
    prompt, pads = _prompt()
    specs[4].append(("gen_pp2_tp2", "generate_tokens", dict(
        axes=dict(pp=2, tp=2), params=np_tree(_grad_params("dense")),
        prompt=prompt, pad_counts=pads, max_new_tokens=6)))
    ckdir = tmp_path_factory.mktemp("pp_ckpt")
    specs[4].append(("ckpt", "pp_checkpoint", dict(
        params=p4, batches=[_packed_batch(seed=10 + s) for s in range(2)],
        optim=OPT, directory=str(ckdir), restore_axes=dict(fsdp=4))))
    out = start_worlds(specs, tmp_path_factory.mktemp("pipeline"),
                       timeout=420, collective_timeout=60)
    out.ckdir = ckdir
    return out


def _ok(results):
    for r in results:
        assert "error" not in r, r["error"]
    return results


def _jax_mesh(axes, devices8):
    n = math.prod(axes.values())
    return make_mesh(MeshConfig(**{"fsdp": 1, **axes}), devices8[:n])


@pytest.mark.parametrize("name", sorted(FWD_CASES))
def test_pipeline_forward_matches_jax(worlds, devices8, name):
    n, axes, M, kind = FWD_CASES[name]
    cfg, params = _cfg4(), _params4()
    mesh = _jax_mesh(axes, devices8)
    if kind == "packed":
        b = _packed()
        kw = dict(positions=b["positions"], segments=b["segments"],
                  packed=True)
        tokens = b["tokens"]
    else:
        kw, tokens = {}, _tokens(cfg)
    want = np.asarray(jax.jit(lambda p, t: pipeline_forward(
        p, t, cfg, mesh, n_microbatches=M, **kw))(params, tokens))
    plain = np.asarray(jllama.forward(params, tokens, cfg, **kw))
    np.testing.assert_allclose(want, plain, atol=2e-5, rtol=1e-5)
    for r in _ok(worlds.results()[n][name]):
        assert r["aux"] is None
        np.testing.assert_allclose(r["logits"], want, atol=2e-5, rtol=1e-5)


def test_pipeline_grads_match_jax_value_and_grad(worlds, devices8):
    cfg, params = _cfg4(), _params4()
    tokens = _tokens(cfg)
    labels = jnp.roll(tokens, -1, axis=1)

    def loss(p):
        logits = pipeline_forward(p, tokens, cfg, mesh, n_microbatches=2)
        logp = jax.nn.log_softmax(logits, -1)
        return -jnp.take_along_axis(logp, labels[..., None], -1).mean()

    mesh = _jax_mesh(dict(pp=2, fsdp=2), devices8)
    jl, jg = jax.jit(jax.value_and_grad(loss))(params)
    jg = {k: np.asarray(v) for k, v in leaf_paths(jg).items()}
    got = _ok(worlds.results()[4]["grads"])
    for rank, r in enumerate(got):
        np.testing.assert_allclose(r["loss"], float(jl), rtol=1e-6)
        assert set(r["grads"]) == set(jg)
        # every rank: its stage's layers and the pp-replicated leaves
        for k, g in r["grads"].items():
            np.testing.assert_allclose(g, jg[k], atol=3e-5, rtol=2e-4,
                                       err_msg=f"rank {rank} {k}")


def test_pipeline_validates_divisibility(worlds):
    for r in _ok(worlds.results()[2]["bad_batch"]):
        assert "not divisible by microbatches" in r["value_error"]
    for r in _ok(worlds.results()[2]["bad_layers"]):
        assert "not divisible by pp" in r["value_error"]


def test_pipeline_train_step_matches_flat_mesh(worlds, devices8):
    """``make_train_step`` at pp=2 × fsdp=2, 4 microbatches, against
    JAX's step on the flat fsdp=4 mesh (same batch and weights)."""
    cfg = _cfg4()
    tcfg = jtrain.TrainConfig(model=cfg)
    tokens = _tokens(cfg, B=8)
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1)}
    flat = _jax_mesh(dict(fsdp=4), devices8)
    s0 = jtrain.init_train_state(tcfg, jax.random.key(0))
    _, m = jtrain.make_train_step(tcfg, flat, s0)(
        s0, jtrain.shard_batch(batch, flat))
    for r in _ok(worlds.results()[4]["train_step"]):
        np.testing.assert_allclose(r["loss"], float(m["loss"]), rtol=1e-5)
        np.testing.assert_allclose(r["grad_norm"], float(m["grad_norm"]),
                                   rtol=1e-4)


def test_pipeline_moe_aux_exact_at_one_microbatch(worlds):
    cfg = _moe_cfg()
    params = jmixtral.init_params(cfg, jax.random.key(0))
    tokens = _tokens(cfg)
    logits, aux = jmixtral.forward(params, jnp.asarray(tokens), cfg)
    for r in _ok(worlds.results()[2]["moe_m1"]):
        np.testing.assert_allclose(r["logits"], np.asarray(logits),
                                   atol=2e-5, rtol=1e-5)
        np.testing.assert_allclose(r["aux"], float(aux), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_loss_fn_on_a_pp_mesh_matches_jax(worlds, devices8, name):
    n, axes, pname, family, lora = GRAD_CASES[name]
    model = _moe_cfg() if family == "moe" else jllama.LlamaConfig.tiny()
    cfg = jtrain.TrainConfig(model=model)
    mesh = _jax_mesh(axes, devices8)
    params = _grad_params(pname)
    params = jax.device_put(params, param_shardings(params, mesh))
    batch = jtrain.shard_batch(_packed_batch(), mesh)

    @jax.jit
    def run(p, b):
        return jax.value_and_grad(
            lambda p: jtrain.loss_fn(p, b, cfg, mesh), has_aux=True)(p)

    (jl, jaux), jg = run(params, batch)
    logits, _ = jax.jit(lambda p, b: pipeline_forward_with_aux(
        p, b["tokens"], model, mesh, positions=b["positions"],
        segments=b["segments"], packed=True))(params, batch)
    jgrads = {k: np.asarray(v) for k, v in leaf_paths(jg).items()
              if not lora or "_lora_" in k}
    for got in _ok(worlds.results()[n][name]):
        np.testing.assert_allclose(got["loss"], float(jl), rtol=1e-5)
        for k, v in jaux.items():
            np.testing.assert_allclose(got["aux"][k], float(v), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got["logits"], np.asarray(logits),
                                   atol=1e-5)
        assert set(got["grads"]) == set(jgrads)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, jgrads[k], atol=2e-6, rtol=1e-4,
                                       err_msg=k)


def test_checkpoint_saved_at_pp2_fsdp2_restores_at_fsdp4(worlds):
    got = _ok(worlds.results()[4]["ckpt"])
    for r in got:
        assert r["step"] == 2 and np.isfinite(r["losses"]).all()
        assert r["pp_shapes"]["blocks/wq"] == (2, 32, 64)   # a stage's 2
        assert r["local_shapes"]["blocks/wq"] == (4, 16, 64)
    assert got[0]["params_equal"] and got[0]["moments_equal"]
    tcfg = TrainConfig(model=LlamaConfig.tiny(**L4),
                       optim=OptimConfig(**OPT))
    back = Checkpointer(worlds.ckdir).restore(tcfg, device="cpu")
    check_params(back.params, tcfg.model)
    assert back.step == 2
    for k, t in leaf_paths(back.params).items():
        np.testing.assert_array_equal(t.numpy(), got[0]["saved_params"][k],
                                      err_msg=k)


def test_decode_on_a_pp_mesh_equals_one_device(worlds):
    """Decode at pp=2 × tp=2: each stage runs its layer on its own cache
    and hands the activation on; the prefill logits are each rank's tp
    share of JAX's one-device ``decode_chunk`` (atol 1e-5) and greedy
    tokens equal JAX's ``generate_fused``."""
    cfg, params = jllama.LlamaConfig.tiny(), _grad_params("dense")
    prompt, pads = _prompt()
    want, _ = jgen.decode_chunk(params, cfg, jgen.init_cache(cfg, 4, 13),
                                jnp.asarray(prompt))
    want = np.asarray(want)
    one = np.asarray(jgen.generate_fused(
        params, cfg, jnp.asarray(prompt), max_new_tokens=6,
        pad_counts=jnp.asarray(pads)))
    V = want.shape[-1]
    for rank, r in enumerate(_ok(worlds.results()[4]["gen_pp2_tp2"])):
        c = (rank % 2) * (V // 2)
        np.testing.assert_allclose(r["prefill_logits_local"],
                                   want[..., c:c + V // 2], atol=1e-5)
        np.testing.assert_array_equal(r["tokens"], one)
