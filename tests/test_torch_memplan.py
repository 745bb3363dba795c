"""The port's memory plan (``analysis/torchcheck/memplan.py``) against
the JAX plan (``analysis/jaxcheck/memplan.py`` and ``MEMPLAN_r01.json``):

- the ladder's names and recipes are JAX's, plus the 13B adamw rung;
- every rung's walker-free numbers (params, grads, optimizer state and
  logits in GB, the FLOPs convention) equal JAX's, which need no walker
  (``jax.eval_shape`` of its ``init_train_state``, and its
  ``utils.flops``) — exactly, at the plan's two decimals;
- every JAX rung's executed FLOPs agree with the value stored in
  ``MEMPLAN_r01.json`` within ``FLOPS_RTOL``; the JAX walker itself does
  not run on this tree's jax, so the stored artifact is the reference;
- the 13B rung does not fit an H100 80GB HBM3's memory, given
  explicitly; a tiny rung's peak tracks its microbatch.

``FLOPS_RTOL`` = 2%: both walkers count 2·M·N·K a product and one flop
an element, but their elementwise ops differ (aten's against jax's
primitives), which moves 11 of the 12 rungs by at most 0.2%; under the
``attn+mlp`` policy the flash forward's replay reruns the P·V product
that JAX's pruned recompute skips (its output is saved), +1.87% there.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

from kubeflow_rm_tpu.analysis.jaxcheck import memplan as jplan
from kubeflow_rm_tpu.utils.flops import train_flops_per_token as jflops
from kubeflow_rm_tpu_torch.analysis.torchcheck import memplan as tplan
from kubeflow_rm_tpu_torch.training.optim import OptimConfig
from kubeflow_rm_tpu_torch.training.train import TrainConfig

ROOT = Path(__file__).resolve().parents[1]
FLOPS_RTOL = 2e-2
#: an H100 80GB HBM3's memory as CUDA reports it
#: (``torch.cuda.get_device_properties(0).total_memory``, 79.18 GiB)
H100_TOTAL_MEMORY = 85_017_493_504
JAX_RUNGS = len(jplan.LADDER)


def _recipe(r):
    return (r.name, r.preset, r.optim, r.batch, r.accum, r.remat, r.seq,
            r.extrapolated)


def test_ladder_is_jaxs_plus_the_13b_rung():
    assert [_recipe(r) for r in tplan.LADDER[:JAX_RUNGS]] == \
        [_recipe(r) for r in jplan.LADDER]
    assert _recipe(tplan.LADDER[JAX_RUNGS]) == (
        "13B full-FT adamw mb1 full seq2048", "llama2_13b", "adamw", 32, 32,
        "full", 2048, True)
    assert len(tplan.LADDER) == JAX_RUNGS + 1


def _jax_walker_free(rung) -> dict:
    """JAX's plan row without its walker: the state's bytes from
    ``eval_shape`` of its ``init_train_state``."""
    from kubeflow_rm_tpu.models.llama import LlamaConfig
    from kubeflow_rm_tpu.training.optim import OptimConfig as JOptim
    from kubeflow_rm_tpu.training.train import TrainConfig as JTrain
    from kubeflow_rm_tpu.training.train import init_train_state

    kw = {"param_dtype": jnp.bfloat16, "remat_policy": rung.remat}
    if rung.seq:
        kw["max_seq_len"] = rung.seq
    model = getattr(LlamaConfig, rung.preset)(**kw)
    cfg = JTrain(model=model,
                 optim=JOptim(factored=rung.optim == "adafactor"))
    state = jax.eval_shape(lambda k: init_train_state(cfg, k),
                           jax.random.PRNGKey(0))
    params_b = jplan._tree_bytes(state.params)
    seq = model.max_seq_len
    mb = rung.batch // rung.accum
    return {
        "params_gb": round(params_b / jplan.GB, 2),
        "grads_gb": round(params_b / jplan.GB, 2),
        "opt_state_gb": round(jplan._tree_bytes(state.opt_state)
                              / jplan.GB, 2),
        "logits_gb": round(mb * seq * model.vocab_size * 4 / jplan.GB, 2),
        "flops_per_token_convention": round(jflops(model, seq), 1),
        "n_params": params_b // 2,
        "microbatch": mb, "seq": seq,
    }


@pytest.mark.parametrize("i", range(len(tplan.LADDER)),
                         ids=lambda i: tplan.LADDER[i].name)
def test_walker_free_numbers_equal_jax(i):
    rung = tplan.LADDER[i]
    jrung = (jplan.LADDER[i] if i < JAX_RUNGS else
             jplan.Rung(rung.name, rung.preset, rung.optim, rung.batch,
                        rung.accum, rung.remat, seq=rung.seq))
    want = _jax_walker_free(jrung)
    free = tplan.walker_free(rung)
    GB = tplan.GB
    got = {
        "params_gb": round(free["params_bytes"] / GB, 2),
        "grads_gb": round(free["grads_bytes"] / GB, 2),
        "opt_state_gb": round(free["opt_state_bytes"] / GB, 2),
        "logits_gb": round(free["logits_bytes"] / GB, 2),
        "flops_per_token_convention": free["flops_per_token_convention"],
        "n_params": free["n_params"],
        "microbatch": free["recipe"]["microbatch"],
        "seq": free["recipe"]["seq"],
    }
    assert got == want


_rows: dict = {}


def _row(i):
    if i not in _rows:
        _rows[i] = tplan.plan_rung(tplan.LADDER[i], H100_TOTAL_MEMORY)
    return _rows[i]


@pytest.fixture(scope="module")
def stored():
    with open(ROOT / "MEMPLAN_r01.json", encoding="utf-8") as f:
        return {r["name"]: r for r in json.load(f)["rungs"]}


@pytest.mark.parametrize("i", range(JAX_RUNGS),
                         ids=lambda i: tplan.LADDER[i].name)
def test_flops_per_step_agree_with_the_jax_plan(stored, i):
    row = _row(i)
    want = stored[row["name"]]["predicted"]["flops_per_step"]
    assert row["predicted"]["flops_per_step"] == pytest.approx(
        want, rel=FLOPS_RTOL)
    assert row["unknown_primitives"] == {}
    # the walker-free columns of the full row are walker_free's
    assert row["predicted"]["params_gb"] == \
        stored[row["name"]]["predicted"]["params_gb"]


def test_13b_rung_does_not_fit_an_h100():
    row = _row(JAX_RUNGS)
    assert row["preset"] == "llama2_13b"
    assert not row["predicted"]["fit"]
    # params, grads and both adam moments alone exceed the card
    p = row["predicted"]
    assert (p["params_gb"] + p["grads_gb"] + p["opt_state_gb"]) * 1e9 > \
        tplan.budget_bytes(H100_TOTAL_MEMORY)
    assert row["unknown_primitives"] == {}


def test_the_7b_full_ft_rung_fits_an_h100():
    """On the H100 the 7B adafactor rung (the JAX plan's v5e OOM) is
    predicted to fit: params plus two gradient trees (the accumulated
    sum, added into in place, and a microbatch's) and the backward's
    transient stacked-leaf gradients, ~47 GB; never the three trees of
    an out-of-place sum."""
    row = _row(JAX_RUNGS - 1)
    assert row["preset"] == "llama2_7b" and row["predicted"]["fit"]
    p = row["predicted"]
    assert p["params_gb"] + 2 * p["grads_gb"] <= p["peak_gb"] < \
        p["params_gb"] + 3 * p["grads_gb"] - 0.05


def test_tiny_rung_peak_tracks_its_microbatch():
    """The same tiny step at microbatch 1, 2, 4, 8 (two microbatches a
    step): the peak rises with every doubling, by a steady amount per
    row (each row's activations, within 10% of each other)."""
    tcfg = TrainConfig(model=tplan.model_config("tiny", "dots"),
                       optim=OptimConfig(factored=True))
    mbs = (1, 2, 4, 8)
    peaks = [tplan.walk_train_step(tcfg, 2 * mb, 2)["peak_bytes"]
             for mb in mbs]
    assert peaks == sorted(set(peaks))
    per_row = [(peaks[k + 1] - peaks[k]) / (mbs[k + 1] - mbs[k])
               for k in range(len(mbs) - 1)]
    assert max(per_row) <= 1.1 * min(per_row)


def test_accumulation_counts_each_microbatch():
    """A step of 8 microbatches, walked as two plus six times the
    second one's region (and the rest of the batch), against the walk of
    all 8: the same but for the further microbatches' 0-dim metrics (the
    loss and its aux terms, one flop and one 512-byte block each)."""
    tcfg = TrainConfig(model=tplan.model_config("tiny", "full"))
    counted = tplan.walk_train_step(tcfg, 8, 8)
    assert counted["walked_accum"] == 2

    from kubeflow_rm_tpu_torch.analysis.torchcheck.costmodel import estimate
    from kubeflow_rm_tpu_torch.training.train import (
        init_train_state, make_train_step,
    )

    state = init_train_state(tcfg, torch.Generator(), device="meta")
    step = make_train_step(tcfg, state, grad_accum=8)
    seq = tcfg.model.max_seq_len
    batch = {k: torch.zeros(8, seq, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    walked = estimate(step, state, batch, donate_argnums=(0,))
    metrics = 6 * 4          # 6 further microbatches, <= 4 metrics each
    assert 0 <= walked.flops - counted["flops_per_step"] <= metrics
    assert 0 <= walked.peak_bytes - counted["peak_bytes"] <= metrics * 512


def test_cli_writes_the_plan_for_a_given_card(tmp_path, monkeypatch):
    monkeypatch.setattr(tplan, "LADDER", (tplan.Rung(
        "tiny full-FT adafactor", "tiny", "adafactor", 4, 2, "dots"),))
    monkeypatch.setattr(tplan, "offload_native_rows", lambda mem: [])
    out = tmp_path / "plan.json"
    assert tplan.main(["--hbm-gib", "80", "--out", str(out)]) == 0
    plan = json.loads(out.read_text())
    assert plan["device"]["total_memory"] == 80 * 2 ** 30
    assert plan["rungs"][0]["predicted"]["fit"]
    with pytest.raises(SystemExit):
        tplan.main(["--hbm-gib", "80", "--out",
                    str(tmp_path / "MEMPLAN_r01.json")])


def test_the_card_is_read_from_cuda_or_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tplan.card()
    assert tplan.card(H100_TOTAL_MEMORY)["total_memory"] == \
        H100_TOTAL_MEMORY
