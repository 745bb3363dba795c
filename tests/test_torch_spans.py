"""The port's named spans (``utils.profiling.annotate``) on the CPU: free
when nothing listens, present under ``torch.profiler`` in the forward
and in ``remat.replay`` for both families and two remat policies,
invisible to the checkpoint policy, without effect on the numbers; the
benchmark's attribution of kernels and idle gaps to them
(``portbench.spans``); the set-up parts an observer records; and the
port's model-FLOPs count held to the benchmark's.

Tolerance: none — the spans must not change a single bit, and the
counts are integers.
"""

from __future__ import annotations

import copy
from dataclasses import replace
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd.profiler_util import Kernel

from kubeflow_rm_tpu_torch.models import init_params
from kubeflow_rm_tpu_torch.models import remat
from kubeflow_rm_tpu_torch.models.llama import LlamaConfig
from kubeflow_rm_tpu_torch.models.lora import add_lora
from kubeflow_rm_tpu_torch.models.mixtral import MixtralConfig
from kubeflow_rm_tpu_torch.training.loop import LoopConfig, fit
from kubeflow_rm_tpu_torch.training.optim import OptimConfig, leaf_paths
from kubeflow_rm_tpu_torch.training.train import (
    TrainConfig, init_train_state, loss_fn,
)
from kubeflow_rm_tpu_torch.utils import flops as tflops
from kubeflow_rm_tpu_torch.utils import profiling
from portbench import flops as bflops
from portbench import spans
from portbench.arch import arch_of, read_config
from portbench.port import model_config

ROOT = Path(__file__).resolve().parents[1]

STEP_SPANS = {"fit.data", "fit.to_device", "fit.first_step",
              "train.forward", "train.backward", "train.optimizer",
              "make_train_step", "embed", "block.attn", "block.mlp",
              "head", "loss", "remat.replay"}
MOE_SPANS = {"moe.route", "moe.dispatch", "moe.experts", "moe.combine"}
FAMILIES = {"llama": LlamaConfig.tiny, "mixtral": MixtralConfig.tiny_moe}


def _state(family: str, policy: str):
    model = replace(FAMILIES[family](), remat_policy=policy)
    g = torch.Generator().manual_seed(0)
    params = add_lora(init_params(model, g, "cpu"), 4, generator=g)
    cfg = TrainConfig(model=model, optim=OptimConfig(train_only="lora"))
    return cfg, init_train_state(cfg, params=params)


def _batches(n: int, B: int = 2, T: int = 32):
    rng = np.random.default_rng(1)
    return [{"tokens": rng.integers(0, 256, (B, T)).astype(np.int32),
             "labels": rng.integers(0, 256, (B, T)).astype(np.int32)}
            for _ in range(n)]


def _profiled_step(family: str, policy: str):
    cfg, state = _state(family, policy)
    with torch.profiler.profile() as prof:
        fit(cfg, iter(_batches(1)), LoopConfig(total_steps=1, log_every=1),
            state=state)
    return prof.events()


# ---- the primitive ------------------------------------------------------

def test_annotate_is_one_shared_null_when_nothing_listens():
    a, b = profiling.annotate("block.attn"), profiling.annotate("x")
    assert a is b
    with a:
        with b:                     # reentrant: spans nest
            pass
    # nothing recorded: a profile started afterwards holds no such span
    with torch.profiler.profile() as prof:
        torch.ones(2) + 1
    assert not {"block.attn", "x"} & {e.name for e in prof.events()}


def test_annotate_opens_a_range_only_while_a_profile_runs():
    with torch.profiler.profile() as prof:
        span = profiling.annotate("block.attn")
        assert span is not profiling.annotate("block.attn")
        with span:
            torch.ones(2) + 1
    assert profiling.annotate("block.attn") is profiling.annotate("x")
    ev = [e for e in prof.events() if e.name == "block.attn"]
    assert len(ev) == 1
    kids = {c.name for c in ev[0].cpu_children}
    assert "aten::add" in kids


def test_observe_records_each_span_into_a_phase_recorder():
    rec = profiling.PhaseRecorder()
    with profiling.observe(rec.phase):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                pass
        with profiling.annotate("inner"):
            pass
    s = rec.summary()
    assert s["outer"]["count"] == 1 and s["inner"]["count"] == 2
    with profiling.annotate("after"):       # uninstalled: not recorded
        pass
    assert set(rec.summary()) == {"outer", "inner"}
    assert profiling.annotate("a") is profiling.annotate("b")


def test_observers_nest_and_leave_in_order():
    seen = []

    def hook(tag):
        def cm(name):
            import contextlib

            @contextlib.contextmanager
            def span():
                seen.append((tag, "enter", name))
                yield
                seen.append((tag, "exit", name))
            return span()
        return cm

    with profiling.observe(hook("a")):
        with profiling.observe(hook("b")):
            with profiling.annotate("s"):
                pass
        with profiling.annotate("t"):
            pass
    assert seen == [("a", "enter", "s"), ("b", "enter", "s"),
                    ("b", "exit", "s"), ("a", "exit", "s"),
                    ("a", "enter", "t"), ("a", "exit", "t")]


def test_every_span_of_the_package_is_named_in_spans():
    """``profiling.SPANS`` (what the attribution reads) holds each name
    that the port's compute path and set-up pass to ``annotate``, and
    no other: a span added later cannot fall silently under no span."""
    import ast

    pkg = ROOT / "kubeflow_rm_tpu_torch"
    opened = set()
    for path in pkg.rglob("*.py"):
        if "controlplane" in path.parts or "analysis" in path.parts:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "annotate"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)):
                opened.add(node.args[0].value)
    assert opened == profiling.SPANS
    assert spans.SPANS is profiling.SPANS


# ---- the spans of a training step ---------------------------------------

def _replayed(e) -> bool:
    x = e.cpu_parent
    while x is not None:
        if x.name == "remat.replay":
            return True
        x = x.cpu_parent
    return False


@pytest.mark.parametrize("policy", ["dots", "attn+mlp"])
@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_a_lora_step_emits_every_span(family, policy):
    events = _profiled_step(family, policy)
    names = {e.name for e in events}
    want = STEP_SPANS | (MOE_SPANS if family == "mixtral" else set())
    assert want <= names, want - names
    if family == "llama":
        assert not MOE_SPANS & names
    # every block span runs in the forward and again in the replay,
    # once a layer each
    layers = FAMILIES[family]().n_layers
    block = {"block.attn", "block.mlp"} | (MOE_SPANS if family == "mixtral"
                                           else set())
    for name in block:
        ev = [e for e in events if e.name == name]
        replayed = sum(map(_replayed, ev))
        assert replayed == layers and len(ev) - replayed == layers, name
    assert sum(e.name == "remat.replay" for e in events) == layers
    # the MoE spans sit inside the block's MLP span, which holds no other
    if family == "mixtral":
        for e in events:
            if e.name in MOE_SPANS:
                assert e.cpu_parent.name == "block.mlp"


@pytest.mark.parametrize("policy", ["dots", "attn+mlp"])
def test_the_checkpoint_policy_never_sees_a_span(monkeypatch, policy):
    seen = []
    name_policy, dots_policy = remat._save_names, remat._save_dots

    def spy_names(names, ctx, func, *args, **kwargs):
        seen.append(func)
        return name_policy(names, ctx, func, *args, **kwargs)

    def spy_dots(ctx, func, *args, **kwargs):
        seen.append(func)
        return dots_policy(ctx, func, *args, **kwargs)

    monkeypatch.setattr(remat, "_save_names", spy_names)
    monkeypatch.setattr(remat, "_save_dots", spy_dots)
    events = _profiled_step("mixtral", policy)
    assert "remat.replay" in {e.name for e in events}
    assert seen, "the policy saw no op: the spy is not wired"
    assert not [f for f in seen if f.namespace == "profiler"]


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_spans_change_no_bit_of_the_loss_or_the_gradients(family):
    cfg, state = _state(family, "dots")
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    flat = leaf_paths(state.params)
    adapters = [p for p in flat if "_lora_" in p]
    assert adapters

    def grads():
        loss, _ = loss_fn(state.params, batch, cfg)
        return loss, torch.autograd.grad(loss, [flat[p] for p in adapters])

    for p in adapters:
        flat[p].requires_grad_(True)
    loss0, g0 = grads()
    with torch.profiler.profile():
        loss1, g1 = grads()
    assert torch.equal(loss0, loss1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))

    # and a whole step through fit: the same losses, the same update
    twin = copy.deepcopy(state)
    batches = _batches(2)
    _, h0 = fit(cfg, iter(batches), LoopConfig(total_steps=2, log_every=1),
                state=state)
    with torch.profiler.profile():
        _, h1 = fit(cfg, iter(batches), LoopConfig(total_steps=2,
                                                   log_every=1), state=twin)
    assert [h.loss for h in h0] == [h.loss for h in h1]
    assert [h.grad_norm for h in h0] == [h.grad_norm for h in h1]
    a, b = leaf_paths(state.params), leaf_paths(twin.params)
    assert all(torch.equal(a[p], b[p]) for p in adapters)


def test_fit_records_its_setup_parts():
    cfg = TrainConfig(model=LlamaConfig.tiny())
    rec = profiling.PhaseRecorder()
    with profiling.observe(rec.phase):
        state = init_train_state(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
        fit(cfg, iter(_batches(2)), LoopConfig(total_steps=2, log_every=1),
            state=state)
    s = rec.summary()
    for name in ("init_train_state", "make_train_step", "fit.first_step"):
        assert s[name]["count"] == 1, name
    assert s["fit.data"]["count"] == 2 and s["fit.to_device"]["count"] == 2
    assert s["block.attn"]["count"] == 2 * 2 * cfg.model.n_layers


def test_the_memory_planner_reads_the_microbatch_span():
    """The cost model counts FLOPs by span: an accumulated step opens
    ``train.microbatch`` once a microbatch, each with its own FLOPs (the
    second adds its gradients into the first's)."""
    from kubeflow_rm_tpu_torch.analysis.torchcheck import costmodel
    from kubeflow_rm_tpu_torch.training.train import make_train_step

    cfg = TrainConfig(model=replace(LlamaConfig.tiny(), remat=False))
    state = init_train_state(cfg, torch.Generator(), device="meta")
    step = make_train_step(cfg, state, grad_accum=2)
    batch = {k: torch.zeros(4, 32, dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    regions = {}
    costmodel.estimate(step, state, batch, donate_argnums=(0,),
                       regions=regions)
    mb = regions["train.microbatch"]
    assert len(mb) == 2 and mb[1] > mb[0] > 0
    assert sum(regions["block.attn"]) > 0


# ---- attribution --------------------------------------------------------

def _device(start, end, name="gemm"):
    return SimpleNamespace(
        name=name, device_type=torch.autograd.DeviceType.CUDA,
        time_range=SimpleNamespace(start=start, end=end), kernels=[])


def _two_layer_step():
    """A CPU profile of a forward and backward through spans, one block
    checkpointed under the ``dots`` policy."""
    from torch.utils.checkpoint import checkpoint

    from kubeflow_rm_tpu_torch.utils.profiling import annotate

    w = torch.randn(16, 16)
    x = torch.randn(16, 16, requires_grad=True)

    def block(h):
        with annotate("moe.dispatch"):
            h = torch.tanh(h @ w)
        with annotate("block.attn"):
            return torch.tanh(h @ w)

    with torch.profiler.profile() as prof:
        with annotate("train.forward"):
            with annotate("block.mlp"):
                h = x @ w
            h = checkpoint(block, h, use_reentrant=False,
                           context_fn=remat.remat_context_fn("dots"))
            with annotate("loss"):
                loss = h.sum()
        with annotate("train.backward"):
            torch.autograd.grad(loss, [x])
    return list(prof.events())


def _find(events, name, pred=lambda e: True):
    return [e for e in events if e.name == name and pred(e)]


def test_a_backward_lands_on_the_span_of_its_forward_op():
    events = _two_layer_step()
    chains = spans._Chains(events)
    mm_bwd = _find(events, "MmBackward0")
    assert mm_bwd
    # every mm's backward: the spans of the forward mm it differentiates
    got = {chains.of(e) for e in mm_bwd}
    assert (("train.forward", "block.mlp"), "backward") in got
    assert (("train.forward", "moe.dispatch"), "backward") in got
    assert (("train.forward", "block.attn"), "backward") in got
    # an op inside the backward node is the node's: the mm it runs
    inner = [c for e in mm_bwd for c in e.cpu_children
             if c.name == "aten::mm"]
    assert inner and all(chains.of(c)[1] == "backward" for c in inner)
    # the replay's forward ops keep their own spans, phase "replay"
    tanh = _find(events, "aten::tanh", _replayed)
    assert tanh and all(chains.of(e)[1] == "replay" for e in tanh)
    assert {chains.of(e)[0][-2:] for e in tanh} == {
        ("remat.replay", "moe.dispatch"), ("remat.replay", "block.attn")}


def test_attribution_of_kernels_and_idle_gaps():
    events = _two_layer_step()
    us = 100.0
    # one kernel a host op: each forward mm, each backward mm, the
    # replay's tanh, and one the profiler could not tie to a span
    launched = {}
    for e in events:
        if e.name in ("aten::mm", "aten::tanh", "aten::ones_like"):
            e.kernels.append(Kernel(f"k_{e.name}", 0, us))
            launched[id(e)] = e
    n = len(launched)
    dev = [_device(i * 1000.0, i * 1000.0 + us) for i in range(n + 1)]
    s = spans.attribute(events + dev)
    assert s.kernel_s == pytest.approx((n + 1) * us * 1e-6)
    assert s.linked_s == pytest.approx(n * us * 1e-6)
    chains = spans._Chains(events)
    want = {"moe": 0, "replay": 0, "spanned": 0}
    for e in launched.values():
        chain, phase = chains.of(e)
        want["spanned"] += bool(chain)
        want["moe"] += "moe.dispatch" in chain
        want["replay"] += phase == "replay"
    assert want["moe"] >= 3 and want["replay"] >= 2
    assert s.moe_dispatch_s == pytest.approx(want["moe"] * us * 1e-6)
    assert s.replay_s == pytest.approx(want["replay"] * us * 1e-6)
    pct = s.pct(wall_s=1.0)
    assert pct["unattributed"] == pytest.approx(
        100.0 * (1 - want["spanned"] / (n + 1)))
    assert s.device["moe.dispatch (backward)"] > 0
    assert s.device["moe.dispatch (replay)"] > 0
    assert s.device["block.mlp"] == pytest.approx(us * 1e-6)

    # an idle gap over a replayed op is the replay's
    op = _find(events, "aten::tanh", _replayed)[0]
    a, b = op.time_range.start, op.time_range.end
    s = spans.attribute(events + [_device(a - 10, a), _device(b, b + 10)])
    assert s.idle_s == pytest.approx((b - a) * 1e-6)
    assert s.replay_idle_s == s.idle_s
    assert list(s.idle) in (["moe.dispatch (replay)"],
                            ["block.attn (replay)"])
    assert spans.attribute(events + [_device(a - 10, a)]).idle_s == 0


def test_a_kernel_counts_once_for_its_launching_op():
    """The profiler's own stall events ("Command Buffer Full") carry the
    correlation id of the op they interrupt, and so its kernels too: the
    op, which started first, takes them, once."""
    events = _two_layer_step()
    op = _find(events, "aten::mm")[0]
    a, b = op.time_range.start, op.time_range.end
    op.kernels.append(Kernel("gemm", 0, 100.0))
    stall = SimpleNamespace(
        name="Command Buffer Full", id=op.id, thread=op.thread,
        fwd_thread=0, sequence_nr=-1, cpu_parent=op, kernels=[
            Kernel("gemm", 0, 100.0)], time_range=SimpleNamespace(
            start=(a + b) / 2, end=(a + b) / 2 + 0.1),
        device_type=op.device_type)
    s = spans.attribute(events + [stall, _device(0, 100.0)])
    assert s.linked_s == pytest.approx(100e-6) == s.kernel_s
    assert dict(s.callers["gemm"]) == {("block.mlp", "aten::mm"):
                                       pytest.approx(100e-6)}
    assert s.pct(1.0)["unattributed"] == pytest.approx(0.0)


def test_the_attribution_counts_what_the_benchmark_trace_counts():
    """Kernel seconds and busy time as ``portbench.trace`` reads them."""
    from portbench import trace

    events = _two_layer_step()
    dev = [_device(0, 50, "a"), _device(40, 90, "b"), _device(200, 260, "a")]

    class Prof:
        def events(self):
            return events + dev

    t = trace._read(Prof())
    s = spans.attribute(Prof().events())
    assert s.busy_s == pytest.approx(t.busy_s)
    assert s.kernel_s == pytest.approx(sum(v[0] for v in t.ops.values()))
    assert s.idle_s == pytest.approx(sum(t.gaps.values()))


# ---- the port's MFU counter ---------------------------------------------

@pytest.mark.parametrize("config", ["mistral-7b", "mixtral-8x7b-l16"])
def test_model_flops_match_the_benchmark_count(config):
    """The matmul and routing terms of ``utils.flops`` are the
    benchmark's (``portbench/flops.py``: a mixture's router and top-k
    experts); the attention terms differ by design (a full causal row
    against the benchmark's same-document pairs)."""
    a = arch_of(config, read_config(ROOT / "portbench" / "configs"
                                    / f"{config}.json"))
    cfg = model_config(a)
    assert tflops.matmul_param_count(cfg) == bflops.frozen_matmul_params(a)
    T = 2048
    attn = 6.0 * cfg.n_layers * cfg.n_heads * cfg.head_dim * T
    for frozen, per in ((True, 4.0), (False, 6.0)):
        assert tflops.train_flops_per_token(cfg, T, frozen_base=frozen) \
            == per * bflops.frozen_matmul_params(a) + attn
    # a document that fills the row: the same attention pairs as the
    # benchmark counts, so the whole step agrees bar the adapters
    step = bflops.train_step_flops(a, [[T]], 16, ("wq", "wv"))
    lora = 6.0 * bflops.lora_params(a, 16, ("wq", "wv")) * T
    assert tflops.train_flops_per_token(cfg, T, frozen_base=True) * T \
        == pytest.approx(step - lora - 6.0 * cfg.n_layers * cfg.n_heads
                         * cfg.head_dim * T, rel=1e-12)


def test_a_mixture_counts_its_router_and_top_k_experts():
    dense = LlamaConfig.tiny()
    moe = MixtralConfig.tiny_moe()
    D, F, L = moe.dim, moe.hidden_dim, moe.n_layers
    k, E = moe.moe.top_k, moe.moe.n_experts
    assert tflops.matmul_param_count(moe) - tflops.matmul_param_count(
        replace(dense, hidden_dim=F)) == L * ((k - 1) * 3 * D * F + D * E)
