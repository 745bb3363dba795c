"""Port parity of the model and the trainer on a mesh (``forward(...,
mesh=)``, ``loss_fn``/``make_train_step``/``fit``, the sharded checkpoint
and decode) against the JAX package's GSPMD versions, on gloo worlds of 2
and 4 processes against as many virtual CPU devices.

Every case builds its state in JAX from a seed and carries it over with
``from_numpy_params``; each rank computes on its shards and its share of
the batch (``torch_mesh_ranks``), and the gradients come back gathered to
global arrays. Tolerances (float32 throughout):

- loss rtol 1e-5; logits atol 1e-5 (sums over D = 64 and the vocabulary
  in other orders than XLA's);
- every trainable leaf's gradient atol 2e-6, rtol 1e-4 (the single-device
  parity tests' bound: a sharded product sums its partial products in
  another order); a bf16 leaf (QLoRA's adapters) atol 2^-6 of the
  leaf's largest gradient: each rank's partial gradient is rounded to
  bf16 at the leaf before the cross-rank sum, where JAX sums first and
  rounds once;
- ``fit``: per-step losses and grad norms rtol 1e-5; final parameters by
  ``test_torch_train.assert_params_close``'s rule (atol 2e-6 on 99.9% of
  each leaf, within 2·lr a step everywhere: adam's update flips where
  sqrt(nu) nears eps);
- decode tokens and checkpoint bytes exact.
"""

import importlib
import math
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_rm_tpu import models as jmodels
from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu.models import lora as jlora
from kubeflow_rm_tpu.models import mixtral as jmixtral
from kubeflow_rm_tpu.models import quantize as jquant
from kubeflow_rm_tpu.parallel import MeshConfig, make_mesh
from kubeflow_rm_tpu.parallel.sharding import param_shardings
from kubeflow_rm_tpu.training import data as jdata
from kubeflow_rm_tpu.training import optim as joptim
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
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _packed_batch(B=4, T=32, seed=3):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 256, n).tolist()
            for n in rng.integers(5, 20, 3 * B)]
    batch = jdata.pack_documents(docs, T)
    return {k: v[:B] for k, v in batch.items()}


def _jax_cfg(family, overrides):
    overrides = dict(overrides)
    moe = overrides.pop("moe", None)
    if family == "moe":
        cfg = jmixtral.MixtralConfig.tiny_moe(**overrides)
        return replace(cfg, moe=replace(cfg.moe, **moe)) if moe else cfg
    return jllama.LlamaConfig.tiny(**overrides)


def _with_lora(params, seed=1):
    """Adapters on every projection, ``b`` drawn nonzero so every
    adapter leaf has a gradient."""
    out = jlora.add_lora(params, 4, key=jax.random.key(seed),
                         targets=LORA_TARGETS)
    blocks = dict(out["blocks"])
    for i, k in enumerate(sorted(b for b in blocks if b.endswith("_lora_b"))):
        blocks[k] = jax.random.normal(jax.random.key(100 + i),
                                      blocks[k].shape) * 0.02
    return dict(out, blocks=blocks)


def _params(name):
    key = jax.random.key(0)
    base = jllama.init_params(jllama.LlamaConfig.tiny(), key)
    if name == "dense":
        return base
    if name == "lora":
        return _with_lora(base)
    if name == "int4_lora":
        return jlora.add_lora(jquant.quantize_params(base, bits=4), 4,
                              key=jax.random.key(1))
    if name == "int8_lora":
        return _with_lora(jquant.quantize_params(base, bits=8))
    if name == "moe":
        return jmixtral.init_params(jmixtral.MixtralConfig.tiny_moe(), key)
    raise KeyError(name)


# name -> (world, mesh axes, params, family, config overrides, LoRA only)
GRAD_CASES = {
    "fsdp2": (2, dict(fsdp=2), "dense", "dense", {}, False),
    "tp2": (2, dict(tp=2), "dense", "dense", {}, False),
    "tp2_no_remat": (2, dict(tp=2), "dense", "dense", dict(remat=False),
                     False),
    "dp2": (2, dict(dp=2), "dense", "dense", {}, False),
    "tp2_lora": (2, dict(tp=2), "lora", "dense", {}, True),
    "fsdp2_lora": (2, dict(fsdp=2), "lora", "dense", {}, True),
    "fsdp2_int4_lora": (2, dict(fsdp=2), "int4_lora", "dense", {}, True),
    "tp2_int8_lora": (2, dict(tp=2), "int8_lora", "dense", {}, True),
    "sp2_ring": (2, dict(sp=2), "dense", "dense",
                 dict(attention_backend="ring"), False),
    "sp2_ulysses": (2, dict(sp=2), "dense", "dense",
                    dict(attention_backend="ulysses"), False),
    "sp2_auto": (2, dict(sp=2), "dense", "dense", {}, False),
    "ep2_moe": (2, dict(ep=2), "moe", "moe",
                dict(moe=dict(capacity_factor=1.0)), False),
    "fsdp2_moe": (2, dict(fsdp=2), "moe", "moe",
                  dict(moe=dict(capacity_factor=1.0)), False),
    "dp2_fsdp2": (4, dict(dp=2, fsdp=2), "dense", "dense", {}, False),
    "fsdp2_tp2_lora": (4, dict(fsdp=2, tp=2), "lora", "dense", {}, True),
    "dp2_sp2_ring": (4, dict(dp=2, sp=2), "dense", "dense",
                     dict(attention_backend="ring"), False),
    "ep2_tp2_moe": (4, dict(ep=2, tp=2), "moe", "moe",
                    dict(moe=dict(capacity_factor=1.0)), False),
}

# name -> (world, mesh axes, steps)
FIT_CASES = {"fit_fsdp2": (2, dict(fsdp=2), 3),
             "fit_dp2_fsdp2": (4, dict(dp=2, fsdp=2), 3),
             "fit_tp2_accum2": (2, dict(tp=2), 2)}

# name -> (world, mesh axes)
GEN_CASES = {"gen_tp2": (2, dict(tp=2)),
             "gen_fsdp2_tp2": (4, dict(fsdp=2, tp=2))}


SERVE_PROMPT = [5, 17, 33, 2, 250, 9, 1]

# name -> (world, axes, family, bits, lora, fit steps): the rank's own
# init (``init_params(..., mesh=)``), no global tree on any rank
INIT_CASES = {
    "init_fsdp2_fit": (2, dict(fsdp=2), "dense", None, False, 2),
    "init_fsdp2_tp2_int8_lora": (4, dict(fsdp=2, tp=2), "dense", 8, True, 0),
    "init_fsdp2_int4_lora": (2, dict(fsdp=2), "dense", 4, True, 0),
    "init_ep2_moe": (2, dict(ep=2), "moe", None, False, 0),
    "init_pp2_fsdp2_lora": (4, dict(pp=2, fsdp=2), "dense", None, True, 0),
}


def _batches(steps):
    return [_packed_batch(seed=10 + s) for s in range(steps)]


def _prompt():
    rng = np.random.default_rng(7)
    prompt = rng.integers(1, 256, (4, 12)).astype(np.int32)
    pads = np.asarray([0, 3, 5, 0], np.int32)
    for i, p in enumerate(pads):
        prompt[i, :p] = 0
    return prompt, pads


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    specs = {2: [], 4: []}
    for name, (n, axes, pname, family, ov, lora) in GRAD_CASES.items():
        specs[n].append((name, "model_grads", dict(
            axes=axes, params=np_tree(_params(pname)), batch=_packed_batch(),
            family=family, overrides=ov,
            optim={"train_only": "lora"} if lora else {})))
    for name, (n, axes, steps) in FIT_CASES.items():
        specs[n].append((name, "fit_losses", dict(
            axes=axes, params=np_tree(_params("dense")),
            batches=_batches(steps), optim=OPT,
            grad_accum=2 if "accum" in name else 1)))
    prompt, pads = _prompt()
    for name, (n, axes) in GEN_CASES.items():
        specs[n].append((name, "generate_tokens", dict(
            axes=axes, params=np_tree(_params("dense")), prompt=prompt,
            pad_counts=pads, max_new_tokens=6)))
    specs[4].append(("serve", "serve_round_trip", dict(
        params=np_tree(_params("dense")), prompt=SERVE_PROMPT,
        max_new_tokens=5, axes=dict(fsdp=2, tp=2))))
    for name, (n, axes, family, bits, lora, steps) in INIT_CASES.items():
        specs[n].append((name, "sharded_init", dict(
            axes=axes, family=family, bits=bits, lora=lora,
            fit_steps=steps)))
    ckdir = tmp_path_factory.mktemp("ckpt")
    specs[2].append(("ckpt", "checkpoint_round_trip", dict(
        params=np_tree(_params("dense")), batch=_packed_batch(),
        optim=OPT, directory=str(ckdir))))
    out = start_worlds(specs, tmp_path_factory.mktemp("mesh_train"))
    out.ckdir = ckdir
    return out


def _ok(results):
    for r in results:
        assert "error" not in r, r["error"]
    return results


def _jax_mesh(axes, devices8):
    n = math.prod(axes.values())
    return make_mesh(MeshConfig(**{"fsdp": 1, **axes}), devices8[:n])


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_loss_logits_and_every_gradient_match_jax(worlds, devices8, name):
    n, axes, pname, family, ov, lora = GRAD_CASES[name]
    cfg = jtrain.TrainConfig(model=_jax_cfg(family, ov))
    mesh = _jax_mesh(axes, devices8)
    params = _params(pname)
    params = jax.device_put(params, param_shardings(params, mesh))
    batch = jtrain.shard_batch(_packed_batch(), mesh)

    def loss(p, b):
        return jtrain.loss_fn(p, b, cfg, mesh)

    @jax.jit
    def run(p, b):
        # a quantized base's int8 leaves take a float0 gradient
        out = jax.value_and_grad(loss, has_aux=True, allow_int=True)(p, b)
        logits, _ = jmodels.forward_with_aux(
            p, b["tokens"], cfg.model, positions=b["positions"],
            segments=b["segments"], packed=True, mesh=mesh)
        return out, logits

    ((jl, jaux), jg), jlogits = run(params, batch)
    jgrads = {k: np.asarray(v, np.float32) for k, v in leaf_paths(jg).items()
              if v.dtype != jax.dtypes.float0}
    jgrads_dtype = {k: v.dtype for k, v in leaf_paths(jg).items()}
    for got in _ok(worlds.results()[n][name]):
        np.testing.assert_allclose(got["loss"], float(jl), rtol=1e-5)
        for k, v in jaux.items():
            np.testing.assert_allclose(got["aux"][k], float(v), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got["logits"], np.asarray(jlogits),
                                   atol=1e-5)
        want = {k: v for k, v in jgrads.items()
                if not lora or "_lora_" in k}
        assert set(got["grads"]) == set(want)
        for k, g in got["grads"].items():
            atol = 2e-6
            if jgrads_dtype[k] == jnp.bfloat16:
                atol = 2.0 ** -6 * np.abs(want[k]).max()
            np.testing.assert_allclose(g, want[k], atol=atol, rtol=1e-4,
                                       err_msg=k)


def _jax_fit(axes, devices8, steps, grad_accum=1):
    jcfg = jtrain.TrainConfig(model=jllama.LlamaConfig.tiny(),
                              optim=joptim.OptimConfig(**OPT))
    mesh = _jax_mesh(axes, devices8)
    params = _params("dense")
    state = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=joptim.make_optimizer(jcfg.optim).init(params))
    batches = _batches(steps)
    step = jtrain.make_train_step(jcfg, mesh, state,
                                  batch_keys=tuple(batches[0]),
                                  grad_accum=grad_accum)
    losses, norms = [], []
    for b in batches:
        state, m = step(state, jtrain.shard_batch(b, mesh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, leaf_paths(np_tree(state.params))


@pytest.mark.parametrize("name", sorted(FIT_CASES))
def test_fit_matches_jax_make_train_step(worlds, devices8, name):
    n, axes, steps = FIT_CASES[name]
    losses, norms, params = _jax_fit(axes, devices8, steps,
                                     2 if "accum" in name else 1)
    lr = OPT["learning_rate"]
    got = _ok(worlds.results()[n][name])
    for r in got:
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"], norms, rtol=1e-5)
    assert all(r["params"] is None for r in got[1:])
    for k, v in params.items():
        err = np.abs(got[0]["params"][k] - v)
        assert np.mean(err <= 2e-6) >= 0.999, (k, err.max())
        assert err.max() <= 2 * lr * (steps - 1) + 2e-6, (k, err.max())


@pytest.mark.parametrize("name", sorted(GEN_CASES))
def test_generate_step_tokens_match_jax(worlds, devices8, name):
    n, axes = GEN_CASES[name]
    mesh = _jax_mesh(axes, devices8)
    cfg = jllama.LlamaConfig.tiny()
    params = _params("dense")
    prompt, pads = _prompt()
    step = jgen.make_generate_step(params, cfg, mesh, max_new_tokens=6,
                                   total_len=prompt.shape[1] + 6)
    want = np.asarray(step(params, jnp.asarray(prompt), None,
                           jnp.asarray(pads)))
    one = np.asarray(jgen.generate_fused(
        params, cfg, jnp.asarray(prompt), max_new_tokens=6,
        pad_counts=jnp.asarray(pads)))
    np.testing.assert_array_equal(want, one)
    for r in _ok(worlds.results()[n][name]):
        np.testing.assert_array_equal(r["tokens"], want)
        assert r["cache_offset"] == prompt.shape[1]


def test_decode_step_prefill_is_the_rows_forward(worlds):
    """``make_decode_step``'s prefill logits are each rank's rows and its
    tp share of the vocabulary (JAX's come back vocabulary-sharded) of
    the one-device forward (pads ignored: the prompt as given)."""
    params = _params("dense")
    prompt, _ = _prompt()
    want = np.asarray(jllama.forward(params, jnp.asarray(prompt),
                                     jllama.LlamaConfig.tiny()))
    V = want.shape[-1]
    for n, name in ((2, "gen_tp2"), (4, "gen_fsdp2_tp2")):
        rows = 1 if n == 2 else 2
        for rank, r in enumerate(_ok(worlds.results()[n][name])):
            b = (rank // (n // rows)) * (4 // rows)
            c = (rank % 2) * (V // 2)               # tp = 2
            assert r["prefill_logits_local"].shape == (4 // rows, 12, V // 2)
            np.testing.assert_allclose(
                r["prefill_logits_local"],
                want[b:b + 4 // rows, :, c:c + V // 2], atol=1e-5)


def test_checkpoint_saved_at_fsdp2_restores_at_tp2_and_world_1(worlds):
    got = _ok(worlds.results()[2]["ckpt"])
    assert [r["wrote"] for r in got] == [True, True]
    assert [r["again"] for r in got] == [False, False]
    for r in got:
        assert r["step"] == 1 and r["specs_kept"]
        assert r["local_shapes"]["blocks/wq"] == (2, 64, 32)   # tp halves
        assert r["local_shapes"]["blocks/wo"] == (2, 32, 64)
        assert r["local_shapes"]["embed/tokens"] == (128, 64)
    assert got[0]["params_equal"] and got[0]["mu_equal"] \
        and got[0]["nu_equal"]
    tcfg = TrainConfig(model=LlamaConfig.tiny(), optim=OptimConfig(**OPT))
    back = Checkpointer(worlds.ckdir).restore(tcfg, device="cpu")
    check_params(back.params, tcfg.model)
    assert back.step == 1 and back.opt_state.count == 1
    for k, t in leaf_paths(back.params).items():
        np.testing.assert_array_equal(t.numpy(), got[0]["saved_params"][k],
                                      err_msg=k)


def test_mesh_server_answers_with_generate_fused_tokens(worlds):
    """Rank 0's ``make_app(..., mesh=)`` answers one request over a
    fsdp=2 × tp=2 mesh while ranks 1-3 ``follow`` it: the batch is padded
    to the mesh's two data rows and the tokens are JAX's one-device
    ``generate_fused`` of the request as the server pads it (left, into
    the 16-token bucket)."""
    got = _ok(worlds.results()[4]["serve"])
    assert got[0]["status"] == 200 and got[0]["rows_multiple"] == 2
    assert [r["followed"] for r in got[1:]] == [1, 1, 1]
    n = len(SERVE_PROMPT)
    ids = np.zeros((2, 16), np.int32)
    ids[:, 16 - n:] = SERVE_PROMPT
    want = np.asarray(jgen.generate_fused(
        _params("dense"), jllama.LlamaConfig.tiny(), jnp.asarray(ids),
        max_new_tokens=5, pad_counts=jnp.asarray([16 - n] * 2, jnp.int32)))
    assert got[0]["body"]["tokens"] == want[0, 16 - n:].tolist()


def _launch(module: str, args: list, nproc: int = 0) -> str:
    """``python -m module args`` (under ``torchrun --nproc-per-node
    nproc`` when ``nproc``) from the repo root; its stdout."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    run = [sys.executable, "-m"]
    if nproc:
        run += ["torch.distributed.run", "--standalone", "--nproc-per-node",
                str(nproc), "-m"]
    r = subprocess.run(run + [module] + args, cwd=root, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def _finetune_lines(args: list, nproc: int = 0) -> list:
    out = _launch("kubeflow_rm_tpu_torch.finetune", args, nproc)
    return [ln for ln in out.splitlines()
            if ln.startswith(("step", "sample", "process"))]


def _losses(lines):
    return [float(ln.split()[3]) for ln in lines if ln.startswith("step")]


def test_finetune_on_a_torchrun_gloo_world(tmp_path):
    """The README's CPU recipe: ``torchrun --nproc-per-node 2 -m
    kubeflow_rm_tpu_torch.finetune --device cpu --fsdp 2``; the fsdp=2
    run logs the losses of one process (the mesh is the whole story)."""
    args = ["--preset", "tiny", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq-len", "32"]
    runs = {"mesh": _finetune_lines(args + ["--fsdp", "2"], nproc=2),
            "one": _finetune_lines(args)}
    assert runs["mesh"][0].startswith("process 0/2 mesh")
    assert "'fsdp': 2" in runs["mesh"][0]
    np.testing.assert_allclose(_losses(runs["mesh"][1:]),
                               _losses(runs["one"]), rtol=1e-4)
    assert runs["mesh"][-1] == runs["one"][-1]      # the greedy sample


def test_finetune_qlora_on_a_torchrun_gloo_world():
    """QLoRA on fsdp=2: each rank draws its int8 base and its adapters'
    slices (``init_params_quantized``/``add_lora`` with ``mesh``) and
    trains the losses and the sample of one process (rtol 1e-4, as
    above)."""
    args = ["--preset", "tiny", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq-len", "32", "--lora-rank", "4",
            "--int8-base"]
    mesh = _finetune_lines(args + ["--fsdp", "2"], nproc=2)
    one = _finetune_lines(args)
    np.testing.assert_allclose(_losses(mesh[1:]), _losses(one), rtol=1e-4)
    assert mesh[-1] == one[-1]


def test_serve_selftest_on_a_torchrun_gloo_world():
    """``serve --fsdp 2 --int8 --selftest`` under torchrun: rank 0
    answers its request over the sharded int8 weights, rank 1 follows
    the one batch."""
    out = _launch("kubeflow_rm_tpu_torch.serve",
                  ["--preset", "tiny", "--device", "cpu", "--fsdp", "2",
                   "--int8", "--selftest", "--max-new-tokens", "4"], nproc=2)
    assert "selftest ok: 7 tokens, 1 batch(es) on cpu" in out
    assert "rank 1: 1 batch(es) run" in out


@pytest.mark.parametrize("name", sorted(INIT_CASES))
def test_sharded_init_never_holds_a_whole_leaf(worlds, name):
    """``init_params(..., mesh=)`` (quantized, with adapters, Mixtral's
    experts) equals ``shard_params`` of the one-device draw bit for bit
    with the same specs, while every draw it made was one layer of a
    stacked leaf or one top-level leaf; ``fit`` without a state trains
    on such local leaves and moments, with the one-device losses."""
    from kubeflow_rm_tpu_torch.models.mixtral import (
        MixtralConfig, param_spec_shapes,
    )
    from kubeflow_rm_tpu_torch.models.llama import (
        param_spec_shapes as llama_shapes,
    )
    from kubeflow_rm_tpu_torch.training.data import synthetic_batches
    from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit

    n, axes, family, bits, lora, steps = INIT_CASES[name]
    cfg = MixtralConfig.tiny_moe() if family == "moe" else LlamaConfig.tiny()
    shapes = (param_spec_shapes if family == "moe" else llama_shapes)(cfg)
    stacked = {tuple(s) for s in shapes["blocks"].values()}
    allowed = {tuple(s[1:]) for s in shapes["blocks"].values()} | {
        tuple(s) for k, s in leaf_paths(shapes).items()
        if not k.startswith("blocks/")}
    for r in _ok(worlds.results()[n][name]):
        assert r["keys_equal"] and not r["unequal"], r["unequal"]
        assert not r["spec_differs"], r["spec_differs"]
        assert r["drawn"] and not stacked & set(r["drawn"])
        assert set(r["drawn"]) <= allowed, set(r["drawn"]) - allowed
        if steps:
            assert r["fit_param_shapes"] == r["local_shapes"]
            assert r["fit_moment_shapes"] == r["local_shapes"]
            assert r["local_shapes"]["blocks/wq"] == (2, 32, 64)
            tcfg = TrainConfig(model=cfg, optim=OptimConfig(
                learning_rate=1e-2))
            _, one = fit(tcfg, synthetic_batches(4, 16, cfg.vocab_size),
                         LoopConfig(total_steps=steps, log_every=1),
                         device="cpu")
            np.testing.assert_allclose(r["fit_losses"],
                                       [h.loss for h in one], rtol=1e-5)
