"""The port's admission pricer (``analysis/torchcheck/pricer.py``)
against JAX's (``analysis/jaxcheck/pricer.py``): the same parse of a
table of valid and invalid declarations (``to_dict``/``key`` and the
same ``DeclarationError`` cases), the same advisor ladder rung for rung,
the same walker-free breakdown (params, grads, optimizer state, logits;
JAX's needs no walker for them), the verdict flipping at the budget
boundary, and the memo cache hit once per key.

Tolerance: none — parsing is exact, the breakdown is compared at the
verdict's two decimals (the JAX pricer's rounding), and the boundary is
checked one byte-sized step either side.
"""

import json

import jax
import pytest
import torch

from kubeflow_rm_tpu.analysis.jaxcheck import pricer as jpricer
from kubeflow_rm_tpu_torch.analysis.torchcheck import memplan as tplan
from kubeflow_rm_tpu_torch.analysis.torchcheck import pricer as tpricer

VALID = [
    {"preset": "tiny"},
    {"preset": "llama2_7b", "optim": "adamw", "batch": 32,
     "grad_accum": 32, "remat": "full", "seq": 2048},
    {"preset": "bench_1b", "optim": "adafactor", "batch": 128,
     "grad_accum": 64, "remat": "dots", "offload": "optimizer",
     "tenant": "team-a"},
    {"model": {"dim": 256, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
               "hidden_dim": 512, "vocab_size": 256}, "batch": 8,
     "grad_accum": 2, "param_dtype": "float32", "remat": "attn+mlp"},
    '{"preset": "llama2_13b", "optim": "adamw", "batch": 4}',
]
INVALID = [
    "not json",
    "[1, 2]",
    {},
    {"preset": "gpt5"},
    {"preset": 7},
    {"model": "big"},
    {"model": {"dim": 256, "n_layers": 2, "n_heads": 3, "n_kv_heads": 1,
               "hidden_dim": 512, "vocab_size": 256}},
    {"model": {"dim": 256, "n_layers": 201, "n_heads": 4, "n_kv_heads": 2,
               "hidden_dim": 512, "vocab_size": 256}},
    {"model": {"dim": 256, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
               "hidden_dim": 512}},
    {"preset": "tiny", "optim": "sgd"},
    {"preset": "tiny", "remat": "some"},
    {"preset": "tiny", "offload": "params"},
    {"preset": "tiny", "batch": 0},
    {"preset": "tiny", "batch": 10, "grad_accum": 3},
    {"preset": "tiny", "batch": 70000},
    {"preset": "tiny", "seq": 8},
    {"preset": "tiny", "seq": 100000},
    {"preset": "tiny", "param_dtype": "float16"},
    {"preset": "tiny", "tenant": "x" * 64},
]


def _raw(d):
    return d if isinstance(d, str) else json.loads(json.dumps(d))


@pytest.mark.parametrize("raw", VALID, ids=range(len(VALID)))
def test_parse_agrees_with_jax(raw):
    want, got = jpricer.parse(_raw(raw)), tpricer.parse(_raw(raw))
    assert got.to_dict() == want.to_dict()
    assert got.key() == want.key()
    assert got.microbatch == want.microbatch


@pytest.mark.parametrize("raw", INVALID, ids=range(len(INVALID)))
def test_parse_refuses_what_jax_refuses(raw):
    with pytest.raises(jpricer.DeclarationError) as jerr:
        jpricer.parse(_raw(raw))
    with pytest.raises(tpricer.DeclarationError) as terr:
        tpricer.parse(_raw(raw))
    assert str(terr.value) == str(jerr.value)


LADDER_CASES = [
    {"preset": "llama2_7b", "optim": "adamw", "batch": 32,
     "grad_accum": 4, "remat": "dots", "seq": 2048},
    {"preset": "llama2_13b", "optim": "adamw", "batch": 32,
     "grad_accum": 32, "remat": "full", "seq": 2048},
    {"preset": "bench_2b", "batch": 64, "grad_accum": 2, "remat": "attn"},
    {"preset": "tiny", "batch": 12, "grad_accum": 1,
     "offload": "optimizer"},
    {"preset": "tiny", "batch": 1024, "grad_accum": 1, "remat": "mlp"},
]


@pytest.mark.parametrize("raw", LADDER_CASES, ids=range(len(LADDER_CASES)))
def test_ladder_equals_jax(raw):
    want = [r.to_dict() for r in jpricer._ladder(jpricer.parse(raw))]
    got = [r.to_dict() for r in tpricer._ladder(tpricer.parse(raw))]
    assert got == want
    assert len(got) <= 8


def _jax_breakdown(raw) -> dict:
    """JAX's walker-free breakdown (``pricer._walk`` without its
    estimate): the state's bytes from ``eval_shape``."""
    from kubeflow_rm_tpu.training.optim import OptimConfig
    from kubeflow_rm_tpu.training.train import TrainConfig, init_train_state

    decl = jpricer.parse(raw)
    model = jpricer._model_config(decl)
    kw = {"factored": decl.optim == "adafactor"}
    if decl.offload:
        kw["offload"] = decl.offload
    cfg = TrainConfig(model=model, optim=OptimConfig(**kw))
    state = jax.eval_shape(lambda k: init_train_state(cfg, k),
                           jax.random.PRNGKey(0))
    params_b = jpricer._tree_bytes(state.params)
    opt_b = 0 if decl.offload else jpricer._tree_bytes(state.opt_state)
    logits_b = decl.microbatch * model.max_seq_len * model.vocab_size * 4
    gb = jpricer.GB
    return {"params": round(params_b / gb, 2),
            "grads": round(params_b / gb, 2),
            "opt_state": round(opt_b / gb, 2),
            "logits": round(logits_b / gb, 2),
            "n_params": params_b // (2 if decl.param_dtype == "bfloat16"
                                     else 4)}


BREAKDOWN_CASES = [
    {"preset": "tiny", "optim": "adamw", "batch": 8, "grad_accum": 4},
    {"preset": "tiny", "batch": 4, "grad_accum": 2, "offload": "optimizer",
     "remat": "dots"},
    {"model": {"dim": 256, "n_layers": 2, "n_heads": 4, "n_kv_heads": 2,
               "hidden_dim": 512, "vocab_size": 256}, "batch": 4,
     "grad_accum": 2, "param_dtype": "float32"},
    {"preset": "bench_1b", "optim": "adamw", "batch": 4, "grad_accum": 2,
     "remat": "dots"},
]


@pytest.mark.parametrize("raw", BREAKDOWN_CASES,
                         ids=range(len(BREAKDOWN_CASES)))
def test_walker_free_breakdown_equals_jax(raw):
    want = _jax_breakdown(raw)
    tpricer.cache_clear()
    v = tpricer.price(tpricer.parse(raw), chips=1, hbm_gib_per_chip=80.0)
    got = {k: v["breakdown_gb"][k]
           for k in ("params", "grads", "opt_state", "logits")}
    got["n_params"] = v["n_params"]
    assert got == want
    assert set(v) == {"verdict", "workload", "chips", "predicted_peak_gb",
                      "predicted_peak_per_chip_gb", "budget_per_chip_gb",
                      "hbm_margin", "binds", "breakdown_gb",
                      "flops_per_step", "n_params", "tenant",
                      "explanation"}
    assert v["flops_per_step"] > 0


def test_verdict_flips_at_the_budget_boundary():
    decl = tpricer.parse({"preset": "tiny", "batch": 4, "grad_accum": 2})
    tpricer.cache_clear()
    peak = tpricer._walk_cached(decl)["peak_bytes"]
    # the smallest card (in bytes) the peak fits on, with the margin
    need = peak * (1 + tplan.HBM_MARGIN) / tplan.USABLE_FRACTION
    above = (need + 2 ** 12) / 2 ** 30
    below = (need - 2 ** 12) / 2 ** 30
    assert tpricer.price(decl, chips=1, hbm_gib_per_chip=above)[
        "verdict"] == "fit"
    assert tpricer.price(decl, chips=1, hbm_gib_per_chip=below)[
        "verdict"] == "rejected"
    # two chips halve the per-chip peak
    assert tpricer.price(decl, chips=2, hbm_gib_per_chip=below)[
        "verdict"] == "fit"


def test_memo_cache_walks_once_per_key(monkeypatch):
    calls = []
    real = tpricer._walk

    def counting(decl):
        calls.append(decl.key())
        return real(decl)

    monkeypatch.setattr(tpricer, "_walk", counting)
    tpricer.cache_clear()
    a = tpricer.parse({"preset": "tiny", "batch": 4, "grad_accum": 2})
    b = tpricer.parse({"preset": "tiny", "batch": 4, "grad_accum": 4})
    for chips in (1, 2, 4):
        tpricer.price(a, chips=chips, hbm_gib_per_chip=16.0)
    tpricer.price(b, chips=1, hbm_gib_per_chip=16.0)
    tpricer.price(a, chips=1, hbm_gib_per_chip=8.0)
    assert calls == [a.key(), b.key()]
    tpricer.cache_clear()
    tpricer.price(a, chips=1, hbm_gib_per_chip=16.0)
    assert calls == [a.key(), b.key(), a.key()]


def test_advise_returns_the_cheapest_fitting_rung():
    decl = tpricer.parse({"preset": "tiny", "optim": "adamw", "batch": 16,
                          "grad_accum": 1, "remat": "dots"})
    tpricer.cache_clear()
    peaks = {r.key(): tpricer._walk_cached(r)["peak_bytes"]
             for r in [decl] + tpricer._ladder(decl)}
    # a card the declaration misses but a cheaper rung fits
    gib = sorted(peaks.values())[0] * (1 + tplan.HBM_MARGIN) \
        / tplan.USABLE_FRACTION / 2 ** 30 * 1.001
    assert tpricer.price(decl, chips=1, hbm_gib_per_chip=gib)[
        "verdict"] == "rejected"
    advice = tpricer.advise(decl, chips=1, hbm_gib_per_chip=gib)
    assert advice is not None
    fitting = [r for r in tpricer._ladder(decl)
               if tpricer.price(r, chips=1, hbm_gib_per_chip=gib)[
                   "verdict"] == "fit"]
    assert advice["workload"] == fitting[0].to_dict()
    assert advice["note"].startswith("cheapest passing rung: ")
    assert tpricer.advise(decl, chips=1, hbm_gib_per_chip=1e-6) is None


def test_price_reads_the_card_or_refuses(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    decl = tpricer.parse({"preset": "tiny"})
    with pytest.raises(RuntimeError, match="CUDA"):
        tpricer.price(decl, chips=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpricer.advise(decl, chips=1)
