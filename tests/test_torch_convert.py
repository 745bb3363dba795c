"""Hugging Face Llama conversion in the port (``models.convert``): every
test of ``tests/test_convert.py`` against the port, then the port's
``from_hf_llama`` against JAX's on the same HF model, and the
directory reader ``load_hf_dir`` on what ``save_pretrained`` writes.

The reference is a random-init ``transformers.LlamaForCausalLM`` built
from an in-code config (nothing is fetched). Tolerances: logits against
the HF forward at atol 2e-4 and the round trip back into HF at 1e-5 (as
``tests/test_convert.py``, float32); tokens, leaves and the reader's
tensors exactly.
"""

import ast
import importlib
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from kubeflow_rm_tpu.models import convert as jconvert  # noqa: E402
from kubeflow_rm_tpu_torch.models import convert as tconvert  # noqa: E402
from kubeflow_rm_tpu_torch.models import llama as tllama  # noqa: E402
from kubeflow_rm_tpu_torch.training.optim import leaf_paths  # noqa: E402

tgen = importlib.import_module("kubeflow_rm_tpu_torch.models.generate")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def hf_model():
    torch.manual_seed(0)
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=172,
        num_hidden_layers=3, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=256,
        rms_norm_eps=1e-5, rope_theta=10000.0,
    )
    model = transformers.LlamaForCausalLM(hf_cfg)
    model.eval()
    return model


def _f32(cfg):
    return replace(cfg, dtype=torch.float32, remat=False)


def _leaves_equal(a: dict, b: dict):
    fa, fb = leaf_paths(a), leaf_paths(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


def test_config_derivation(hf_model):
    cfg = tconvert.config_from_hf(hf_model.config)
    assert cfg.dim == 64 and cfg.n_layers == 3
    assert cfg.n_heads == 4 and cfg.n_kv_heads == 2
    assert cfg.hidden_dim == 172 and cfg.vocab_size == 128
    # the same from config.json's keys, read as attributes
    ns = hf_model.config.to_dict()
    from types import SimpleNamespace
    assert tconvert.config_from_hf(SimpleNamespace(**ns)) == cfg
    assert tconvert.config_from_hf(hf_model.config, n_layers=1).n_layers == 1


def test_logits_match_hf(hf_model):
    cfg, params = tconvert.from_hf_llama(hf_model, device="cpu")
    tokens = np.random.default_rng(0).integers(0, 128, (2, 17))
    with torch.no_grad():
        ref = hf_model(torch.tensor(tokens)).logits.numpy()
        got = tllama.forward(params, torch.tensor(tokens, dtype=torch.int32),
                             _f32(cfg)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-4)


def test_greedy_generation_matches_hf(hf_model):
    cfg, params = tconvert.from_hf_llama(hf_model, device="cpu")
    prompt = np.random.default_rng(1).integers(0, 128, (1, 6))
    with torch.no_grad():
        ref = hf_model.generate(
            torch.tensor(prompt), max_new_tokens=8, do_sample=False,
            pad_token_id=0).numpy()
    got = tgen.generate(params, _f32(cfg),
                        torch.tensor(prompt, dtype=torch.int32),
                        max_new_tokens=8)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_tied_embeddings_fallback(hf_model):
    state = {k: v for k, v in hf_model.state_dict().items()
             if "lm_head" not in k}
    cfg = tconvert.config_from_hf(hf_model.config)
    _, params = tconvert.from_hf_llama(state, cfg, device="cpu")
    assert torch.equal(params["lm_head"], params["embed"]["tokens"].T)
    assert params["lm_head"].is_contiguous()


def test_bare_state_dict_requires_cfg(hf_model):
    with pytest.raises(ValueError, match="cfg"):
        tconvert.from_hf_llama(hf_model.state_dict(), device="cpu")


def test_roundtrip_back_into_hf(hf_model):
    """Export → load_state_dict into a fresh HF model → identical
    logits: the full both-ways bridge."""
    cfg, params = tconvert.from_hf_llama(hf_model, device="cpu")
    exported = tconvert.to_hf_llama(cfg, params)
    assert all(v.dtype == np.float32 for v in exported.values())
    fresh = transformers.LlamaForCausalLM(hf_model.config)
    fresh.load_state_dict({k: torch.tensor(v) for k, v in exported.items()})
    fresh.eval()
    tokens = torch.tensor(np.random.default_rng(2).integers(0, 128, (1, 11)))
    with torch.no_grad():
        a = hf_model(tokens).logits.numpy()
        b = fresh(tokens).logits.numpy()
    np.testing.assert_allclose(b, a, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_hf_llama_equals_jax_leaf_for_leaf(hf_model, dtype):
    jcfg, jparams = jconvert.from_hf_llama(
        hf_model, param_dtype=getattr(jax.numpy, dtype))
    cfg, params = tconvert.from_hf_llama(
        hf_model, param_dtype=getattr(torch, dtype), device="cpu")
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
            cfg.hidden_dim, cfg.vocab_size, cfg.max_seq_len, cfg.rope_theta,
            cfg.norm_eps) == (jcfg.dim, jcfg.n_layers, jcfg.n_heads,
                              jcfg.n_kv_heads, jcfg.hidden_dim,
                              jcfg.vocab_size, jcfg.max_seq_len,
                              jcfg.rope_theta, jcfg.norm_eps)
    flat = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    got = leaf_paths(params)
    assert sorted(got) == sorted(flat)    # JAX flattens in sorted order
    for k, t in got.items():
        ref = flat[k]
        if dtype == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          ref.view(np.int16), err_msg=k)
        else:
            np.testing.assert_array_equal(t.numpy(), ref, err_msg=k)
    # and the export: the same arrays under the same keys
    mine = tconvert.to_hf_llama(cfg, params)
    theirs = jconvert.to_hf_llama(jcfg, jparams)
    assert list(mine) == list(theirs)
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("layout", ["safetensors", "safetensors_sharded",
                                    "pytorch_bin"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_hf_dir_equals_from_hf_llama(hf_model, tmp_path, layout, dtype):
    model = hf_model if dtype == "float32" else \
        transformers.LlamaForCausalLM(hf_model.config).to(torch.bfloat16)
    if dtype == "bfloat16":
        model.load_state_dict(hf_model.state_dict())
    kw = {"safe_serialization": layout != "pytorch_bin"}
    if layout == "safetensors_sharded":
        kw["max_shard_size"] = "40KB"
    model.save_pretrained(tmp_path, **kw)
    names = {p.name for p in tmp_path.iterdir()}
    if layout == "safetensors_sharded":
        assert "model.safetensors.index.json" in names
    elif layout == "safetensors":
        assert "model.safetensors" in names
    else:
        assert "pytorch_model.bin" in names
    cfg, params = tconvert.load_hf_dir(tmp_path, device="cpu",
                                       param_dtype=torch.float32)
    want_cfg, want = tconvert.from_hf_llama(model, device="cpu")
    assert cfg == want_cfg
    _leaves_equal(params, want)
    _, p16 = tconvert.load_hf_dir(tmp_path, device="cpu",
                                  param_dtype=torch.bfloat16)
    assert p16["blocks"]["wq"].dtype == torch.bfloat16


def test_read_safetensors_and_refusals(hf_model, tmp_path):
    hf_model.save_pretrained(tmp_path)
    from safetensors.torch import load_file
    ours = tconvert.read_safetensors(tmp_path / "model.safetensors")
    theirs = load_file(tmp_path / "model.safetensors")
    assert set(ours) == set(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k
    with pytest.raises(FileNotFoundError, match="config.json"):
        tconvert.load_hf_dir(tmp_path / "nowhere", device="cpu")
    (tmp_path / "model.safetensors").unlink()
    with pytest.raises(FileNotFoundError, match="weights"):
        tconvert.load_hf_dir(tmp_path, device="cpu")


CONFIG_REFUSALS = {
    "model_type": ({"model_type": "mistral"}, "model_type"),
    "rope_scaling": ({"rope_scaling": {
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0,
        "original_max_position_embeddings": 8192}}, "rope_scaling"),
    "head_dim": ({"head_dim": 32}, "head_dim"),
    "attention_bias": ({"attention_bias": True}, "attention_bias"),
    "mlp_bias": ({"mlp_bias": True}, "mlp_bias"),
    "hidden_act": ({"hidden_act": "gelu"}, "hidden_act"),
}


@pytest.mark.parametrize("case", list(CONFIG_REFUSALS))
def test_load_hf_dir_refuses_a_model_it_does_not_compute(hf_model, tmp_path,
                                                        case):
    """A config the port's Llama does not compute (Llama-3.1 RoPE
    scaling, biases, another head_dim or model) would load and give
    wrong logits: ``load_hf_dir`` and ``config_from_hf`` refuse it."""
    import json
    from types import SimpleNamespace

    change, match = CONFIG_REFUSALS[case]
    hf_model.save_pretrained(tmp_path)
    conf = json.loads((tmp_path / "config.json").read_text())
    (tmp_path / "config.json").write_text(json.dumps({**conf, **change}))
    with pytest.raises(ValueError, match=match):
        tconvert.load_hf_dir(tmp_path, device="cpu")
    with pytest.raises(ValueError, match=match):
        tconvert.config_from_hf(SimpleNamespace(**{**conf, **change}))


STATE_REFUSALS = {
    "bias": lambda st: {**st, "model.layers.0.self_attn.q_proj.bias":
                        torch.zeros(64)},
    "extra_layer": lambda st: {**st, **{
        k.replace("layers.2.", "layers.3."): v for k, v in st.items()
        if "layers.2." in k}},
}


@pytest.mark.parametrize("case", list(STATE_REFUSALS))
def test_from_hf_llama_refuses_keys_it_does_not_read(hf_model, case):
    state = STATE_REFUSALS[case](hf_model.state_dict())
    cfg = tconvert.config_from_hf(hf_model.config)
    with pytest.raises(ValueError, match="not part of this Llama"):
        tconvert.from_hf_llama(state, cfg, device="cpu")
    # the rotary buffers are no weights: they pass
    ok = dict(hf_model.state_dict(),
              **{"model.rotary_emb.inv_freq": torch.ones(8)})
    tconvert.from_hf_llama(ok, cfg, device="cpu")


def test_load_hf_dir_ties_the_head_only_when_the_config_says_so(
        hf_model, tmp_path):
    import json

    hf_model.save_pretrained(tmp_path, safe_serialization=False)
    state = torch.load(tmp_path / "pytorch_model.bin", weights_only=True)
    del state["lm_head.weight"]
    torch.save(state, tmp_path / "pytorch_model.bin")
    with pytest.raises(ValueError, match="lm_head"):
        tconvert.load_hf_dir(tmp_path, device="cpu")
    conf = json.loads((tmp_path / "config.json").read_text())
    conf["tie_word_embeddings"] = True
    (tmp_path / "config.json").write_text(json.dumps(conf))
    _, params = tconvert.load_hf_dir(tmp_path, device="cpu",
                                     param_dtype=torch.float32)
    assert torch.equal(params["lm_head"], params["embed"]["tokens"].T)


def test_export_refuses_a_quantized_tree(hf_model):
    from kubeflow_rm_tpu_torch.models.quantize import quantize_params

    cfg, params = tconvert.from_hf_llama(hf_model, device="cpu")
    with pytest.raises(ValueError, match="quantized"):
        tconvert.to_hf_llama(cfg, quantize_params(params, bits=8))


def test_package_imports_transformers_only_inside_serve_main():
    """The card has no ``transformers``: the port may import it only
    lazily, inside ``serve.main`` (``--hf-tokenizer``)."""
    for path in sorted((ROOT / "kubeflow_rm_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text())
        allowed = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef) and node.name == "main" \
                    and path.name == "serve.py":
                allowed |= {id(n) for n in ast.walk(node)}
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module] if isinstance(node, ast.ImportFrom)
                    else [])
            if any((m or "").split(".")[0] in ("transformers", "safetensors")
                   for m in mods):
                assert id(node) in allowed, f"{path.name} imports {mods}"
