"""The port's cost model (``analysis/torchcheck/costmodel.py``): its
self-check, exact matmul FLOPs, donation in miniature, the tiny train
step's double buffer, and the card's path (the flash custom ops) against
the CPU's plain path.

Tolerance: none — FLOPs and bytes are counted, not measured, so every
comparison is exact. The JAX walker (``analysis/jaxcheck/costmodel.py``)
does not run on this tree's jax (``jax.core.Var`` is gone), so the
port's counts are held to hand-computed values and to each other here,
and to the JAX plan's stored FLOPs in ``test_torch_memplan.py``.
"""

import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import pytest
import torch

from kubeflow_rm_tpu_torch.analysis.torchcheck import costmodel
from kubeflow_rm_tpu_torch.models.llama import LlamaConfig, forward, init_params
from kubeflow_rm_tpu_torch.ops import flash_attention as fa
from kubeflow_rm_tpu_torch.training.train import (
    TrainConfig, init_train_state, make_train_step,
)
from kubeflow_rm_tpu_torch.utils.profiling import annotate
from kubeflow_rm_tpu_torch.utils.pytree import tree_size_bytes

ROOT = Path(__file__).resolve().parents[1]

# head dim 64 and bf16: flash-eligible on the card
FLASH_TINY = LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=2,
                              hidden_dim=512, param_dtype=torch.bfloat16,
                              dtype=torch.bfloat16)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_selfcheck_is_green():
    assert costmodel.selfcheck() == []


def test_cli_runs_the_selfcheck():
    r = subprocess.run([sys.executable, "-m",
                        "kubeflow_rm_tpu_torch.analysis.torchcheck",
                        "--json"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert '"selfcheck_failures": []' in r.stdout


@pytest.mark.parametrize("real", [False, True], ids=["meta", "cpu"])
def test_matmul_flops_exact(real):
    make = torch.randn if real else _meta
    est = costmodel.estimate(torch.matmul, make(64, 128), make(128, 32))
    assert est.flops == 2 * 64 * 32 * 128
    assert est.unknown_primitives == {}
    assert est.arg_bytes == (64 * 128 + 128 * 32) * 4
    assert est.out_bytes == 64 * 32 * 4


def test_donation_prevents_double_buffering():
    """The in-place update given up by the caller peaks at one buffer;
    kept by the caller, its write needs a second."""
    x = _meta(1024, 1024)
    nbytes = 1024 * 1024 * 4
    donated = costmodel.estimate(lambda v: v.add_(1.0), x,
                                 donate_argnums=(0,))
    plain = costmodel.estimate(lambda v: v.add_(1.0), x)
    assert donated.peak_bytes < 2 * nbytes
    assert plain.peak_bytes >= 2 * nbytes
    assert donated.donation_savings_bytes > 0
    # donate_argnames resolves against the signature
    named = costmodel.estimate(lambda v: v.add_(1.0), x,
                               donate_argnames=("v",))
    assert named.peak_bytes == donated.peak_bytes


def test_temporaries_die_with_their_last_reference():
    """A chain of temporaries peaks at the argument plus two live
    buffers: each dies once the next is made."""
    x = _meta(1 << 18)
    nbytes = (1 << 18) * 4

    def chain(v):
        for _ in range(5):
            v = v * 2.0
        return v

    est = costmodel.estimate(chain, x)
    assert est.flops == 5 * (1 << 18)
    assert est.peak_bytes == 3 * nbytes


def test_train_step_donation_savings_cover_params():
    """A NON-donated in-place train step double-buffers what it writes:
    the walk of the tiny model's real step both ways differs by at least
    the params' bytes (every leaf and both moments are written), and
    every op it runs is in the cost tables."""
    cfg = TrainConfig(model=LlamaConfig.tiny())
    state = init_train_state(cfg, torch.Generator(), device="meta")
    step = make_train_step(cfg, state)
    batch = {k: _meta(2, 16, dtype=torch.int32) for k in ("tokens", "labels")}
    est = costmodel.estimate(step, state, batch, donate_argnums=(0,))
    assert est.donation_savings_bytes >= tree_size_bytes(state.params)
    assert est.unknown_primitives == {}
    assert est.while_loops == 0


def _flash_calls(monkeypatch):
    calls = []
    real = fa.flash_attention_with_lse

    def spy(*a, **k):
        calls.append(a[0].shape)
        return real(*a, **k)

    monkeypatch.setattr(fa, "flash_attention_with_lse", spy)
    return calls


def test_card_path_and_plain_path_count_the_same_forward_flops(monkeypatch):
    """``as_device="cuda"`` takes the card's path (one flash custom op a
    layer) on meta tensors; the op is costed as the dense attention it
    replaces, so the whole forward counts the same FLOPs as the CPU's
    plain path — what JAX's walk counts for its XLA attention."""
    params = init_params(FLASH_TINY, torch.Generator(), "meta")
    tokens = _meta(2, 64, dtype=torch.int32)
    calls = _flash_calls(monkeypatch)
    card = costmodel.estimate(forward, params, tokens, FLASH_TINY)
    assert len(calls) == FLASH_TINY.n_layers
    plain = costmodel.estimate(forward, params, tokens, FLASH_TINY,
                               as_device=None)
    assert len(calls) == FLASH_TINY.n_layers   # the plain path took none
    assert card.flops == plain.flops
    assert card.unknown_primitives == plain.unknown_primitives == {}


@pytest.mark.parametrize("policy", ["dots", "full", "attn+mlp"])
def test_card_path_train_step_counts_the_plain_flops(monkeypatch, policy):
    """Forward, remat replay and backward: the flash backward op is
    costed as the dense attention's gradient, so the step's FLOPs equal
    the plain path's under every policy."""
    tcfg = TrainConfig(model=replace(FLASH_TINY, remat_policy=policy))
    state = init_train_state(tcfg, torch.Generator(), device="meta")
    step = make_train_step(tcfg, state)
    batch = {k: _meta(2, 64, dtype=torch.int32) for k in ("tokens", "labels")}
    calls = _flash_calls(monkeypatch)
    card = costmodel.estimate(step, state, batch, donate_argnums=(0,))
    assert len(calls) == FLASH_TINY.n_layers * 2   # forward + replay
    plain = costmodel.estimate(step, state, batch, donate_argnums=(0,),
                               as_device=None)
    assert card.flops == plain.flops
    assert card.unknown_primitives == {}


def test_flash_backward_holds_its_float32_scratch():
    """The card's backward computes δ from float32 copies of dO and O:
    its walk holds three (B·H, T, D) float32 arrays beside its inputs."""
    B, H, T, D = 1, 2, 128, 64
    q = torch.empty(B * H, T, D, dtype=torch.bfloat16, device="meta")
    out = torch.empty_like(q)
    lse = torch.empty(B * H, T, device="meta")

    def bwd(do, q, k, v, out, lse):
        return torch.ops.kfrm.flash_attention_bwd(do, q, k, v, None, None,
                                                  out, lse, H, 1, True)

    est = costmodel.estimate(bwd, q, q.clone(), q.clone(), q.clone(), out,
                             lse)
    wide = B * H * T * D * 4
    assert est.peak_bytes >= est.arg_bytes + 3 * wide


def test_regions_report_their_own_flops():
    """The program's spans (``profiling.annotate``) come back with the
    FLOPs inside each entry — what the planner multiplies by the
    accumulation count."""
    x = _meta(1000)

    def two(v):
        for n in (1, 3):
            with annotate("body"):
                for _ in range(n):
                    v = v + 1.0
        return v * 2.0

    regions = {}
    est = costmodel.estimate(two, x, regions=regions)
    assert regions == {"body": [1000.0, 3000.0]}
    assert est.flops == 5000.0


def test_regions_leave_out_other_threads_spans():
    """A span another thread opens while the walk runs is not one of
    the walk's regions: only the walk's own thread's spans count."""
    import threading

    x = _meta(1000)

    def elsewhere():
        with annotate("elsewhere"):
            pass

    def body(v):
        t = threading.Thread(target=elsewhere)
        t.start()
        t.join()
        with annotate("here"):
            v = v + 1.0
        return v

    regions = {}
    costmodel.estimate(body, x, regions=regions)
    assert regions == {"here": [1000.0]}
