"""Port parity of the two repaired mesh faults against the JAX package,
on one gloo world of 4 processes against JAX's sharded functions on 4
virtual CPU devices.

- C3, tp ∤ KV heads: the tiny model has 2 KV heads; at tp = 4 the port
  repeats them to 4 and gathers wk/wv over tp in the block. ``loss_fn``'s
  loss, logits and every gradient (full and LoRA) against JAX's
  ``loss_fn`` on the tp = 4 mesh (``test_torch_mesh_train``'s bounds:
  loss rtol 1e-5, logits atol 1e-5, gradients atol 2e-6, rtol 1e-4), 2
  steps of ``fit`` against JAX's ``make_train_step`` (losses and grad
  norms rtol 1e-5), and greedy decode at tp = 4 equal to one device's.
- C4, the vocabulary on tp: ``make_decode_step``'s prefill logits are
  each rank's (rows, T, V/tp), equal to the slices of JAX's
  ``make_decode_step`` output at fsdp=2 × tp=2 and of the one-device
  ``decode_chunk`` at tp = 4 (atol 1e-5); greedy ``make_generate_step``
  tokens equal JAX's one-device ``generate_fused``; the
  vocabulary-parallel cross-entropy (z-loss, ignored labels) equals the
  gathered one (loss and aux rtol 1e-6, gradient atol 1e-7); ``loss_fn``
  gathers no logits over tp while the public ``forward`` still does.

The world runs with a 60 s collective timeout and a 420 s join timeout.
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu.models import lora as jlora
from kubeflow_rm_tpu.parallel import MeshConfig, make_mesh
from kubeflow_rm_tpu.parallel.sharding import param_shardings
from kubeflow_rm_tpu.training import data as jdata
from kubeflow_rm_tpu.training import optim as joptim
from kubeflow_rm_tpu.training import train as jtrain
from kubeflow_rm_tpu_torch.training.optim import leaf_paths

from torch_mesh_ranks import start_worlds

jgen = importlib.import_module("kubeflow_rm_tpu.models.generate")

OPT = dict(learning_rate=1e-2, warmup_steps=1, total_steps=50,
           mu_dtype="float32")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params(lora=False):
    base = jllama.init_params(jllama.LlamaConfig.tiny(), jax.random.key(0))
    if not lora:
        return base
    out = jlora.add_lora(base, 4, key=jax.random.key(1),
                         targets=("wq", "wk", "wv", "wo"))
    blocks = dict(out["blocks"])
    for i, k in enumerate(sorted(b for b in blocks if b.endswith("_lora_b"))):
        blocks[k] = jax.random.normal(jax.random.key(100 + i),
                                      blocks[k].shape) * 0.02
    return dict(out, blocks=blocks)


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


def _logits_case():
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((2, 6, 256)) * 4).astype(np.float32)
    labels = rng.integers(0, 256, (2, 6)).astype(np.int64)
    labels[0, :2] = -100                     # ignore_index
    return logits, labels


# name -> (mesh axes, LoRA)
GRAD_CASES = {"tp4_kvh2": (dict(tp=4), False),
              "tp4_kvh2_lora": (dict(tp=4), True)}
GEN_CASES = {"gen_tp4": dict(tp=4), "gen_fsdp2_tp2": dict(fsdp=2, tp=2)}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cases = []
    for name, (axes, lora) in GRAD_CASES.items():
        cases.append((name, "model_grads", dict(
            axes=axes, params=np_tree(_params(lora)), batch=_packed_batch(),
            optim={"train_only": "lora"} if lora else {})))
    cases.append(("fit_tp4", "fit_losses", dict(
        axes=dict(tp=4), params=np_tree(_params()),
        batches=[_packed_batch(seed=10 + s) for s in range(2)], optim=OPT)))
    prompt, pads = _prompt()
    for name, axes in GEN_CASES.items():
        cases.append((name, "generate_tokens", dict(
            axes=axes, params=np_tree(_params()), prompt=prompt,
            pad_counts=pads, max_new_tokens=6)))
    logits, labels = _logits_case()
    cases.append(("vocab_loss", "vocab_parallel_loss", dict(
        logits=logits, labels=labels, z_loss=1e-4)))
    cases.append(("gathers", "loss_gathers", dict(
        axes=dict(tp=4), params=np_tree(_params()),
        batch=_packed_batch())))
    return start_worlds({4: cases}, tmp_path_factory.mktemp("mesh_heads"),
                        timeout=420, collective_timeout=60)


def _ok(results):
    for r in results:
        assert "error" not in r, r["error"]
    return results


def _jax_mesh(axes, devices8):
    n = math.prod(axes.values())
    return make_mesh(MeshConfig(**{"fsdp": 1, **axes}), devices8[:n])


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_tp_beyond_the_kv_heads_matches_jax(worlds, devices8, name):
    axes, lora = GRAD_CASES[name]
    cfg = jtrain.TrainConfig(model=jllama.LlamaConfig.tiny())
    assert cfg.model.n_kv_heads % axes["tp"]       # the case C3 was
    mesh = _jax_mesh(axes, devices8)
    params = _params(lora)
    params = jax.device_put(params, param_shardings(params, mesh))
    batch = jtrain.shard_batch(_packed_batch(), mesh)

    @jax.jit
    def run(p, b):
        out = jax.value_and_grad(
            lambda p: jtrain.loss_fn(p, b, cfg, mesh), has_aux=True)(p)
        logits = jllama.forward(p, b["tokens"], cfg.model,
                                positions=b["positions"],
                                segments=b["segments"], packed=True)
        return out, logits

    ((jl, jaux), jg), jlogits = run(params, batch)
    want = {k: np.asarray(v) for k, v in leaf_paths(jg).items()
            if not lora or "_lora_" in k}
    for got in _ok(worlds.results()[4][name]):
        np.testing.assert_allclose(got["loss"], float(jl), rtol=1e-5)
        for k, v in jaux.items():
            np.testing.assert_allclose(got["aux"][k], float(v), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        np.testing.assert_allclose(got["logits"], np.asarray(jlogits),
                                   atol=1e-5)
        assert set(got["grads"]) == set(want)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, want[k], atol=2e-6, rtol=1e-4,
                                       err_msg=k)


def test_train_steps_at_tp_beyond_the_kv_heads_match_jax(worlds, devices8):
    jcfg = jtrain.TrainConfig(model=jllama.LlamaConfig.tiny(),
                              optim=joptim.OptimConfig(**OPT))
    mesh = _jax_mesh(dict(tp=4), devices8)
    params = _params()
    state = jtrain.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        opt_state=joptim.make_optimizer(jcfg.optim).init(params))
    batches = [_packed_batch(seed=10 + s) for s in range(2)]
    step = jtrain.make_train_step(jcfg, mesh, state,
                                  batch_keys=tuple(batches[0]))
    losses, norms = [], []
    for b in batches:
        state, m = step(state, jtrain.shard_batch(b, mesh))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    for r in _ok(worlds.results()[4]["fit_tp4"]):
        np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
        np.testing.assert_allclose(r["grad_norms"], norms, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(GEN_CASES))
def test_decode_logits_stay_vocabulary_sharded(worlds, devices8, name):
    axes = GEN_CASES[name]
    cfg, params = jllama.LlamaConfig.tiny(), _params()
    prompt, pads = _prompt()
    tp, rows = axes["tp"], axes.get("fsdp", 1)
    if cfg.n_kv_heads % tp == 0:
        # JAX's own sharded decode step (it cannot shard 2 KV heads 4 ways)
        mesh = _jax_mesh(axes, devices8)
        step = jgen.make_decode_step(params, cfg, mesh)
        want, _ = step(params, jgen.init_cache(cfg, 4, 13),
                       jnp.asarray(prompt))
    else:
        want, _ = jgen.decode_chunk(params, cfg, jgen.init_cache(cfg, 4, 13),
                                    jnp.asarray(prompt))
    want = np.asarray(want)
    V, B = want.shape[-1], want.shape[0]
    one = np.asarray(jgen.generate_fused(
        params, cfg, jnp.asarray(prompt), max_new_tokens=6,
        pad_counts=jnp.asarray(pads)))
    for rank, r in enumerate(_ok(worlds.results()[4][name])):
        b = (rank // tp) * (B // rows)
        c = (rank % tp) * (V // tp)
        assert r["prefill_logits_local"].shape == (B // rows, 12, V // tp)
        np.testing.assert_allclose(
            r["prefill_logits_local"],
            want[b:b + B // rows, :, c:c + V // tp], atol=1e-5)
        np.testing.assert_array_equal(r["tokens"], one)


def test_vocab_parallel_cross_entropy_equals_the_gathered_one(worlds):
    for r in _ok(worlds.results()[4]["vocab_loss"]):
        g, p = r["gathered"], r["parallel"]
        np.testing.assert_allclose(p["loss"], g["loss"], rtol=1e-6)
        assert set(p["aux"]) == set(g["aux"]) == {"nll", "n_valid",
                                                  "z_loss"}
        for k in g["aux"]:
            np.testing.assert_allclose(p["aux"][k], g["aux"][k], rtol=1e-6,
                                       err_msg=k)
        np.testing.assert_allclose(p["grad"], g["grad"], atol=1e-7)
        assert g["aux"]["n_valid"] == 10


def test_loss_fn_gathers_no_logits_over_tp(worlds):
    for r in _ok(worlds.results()[4]["gathers"]):
        assert r == {"in_loss": 0, "in_forward": 1}
