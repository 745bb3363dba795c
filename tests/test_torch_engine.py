"""Port parity for the continuous-batching engine and speculative decode,
on the tiny float32 model with JAX's weights carried over
(``from_numpy_params``).

Tolerance: none — every comparison here is exact. Tokens are compared
token for token (against the JAX engine, against the port's solo
``generate_fused(max_len=slot_len)`` and against JAX's speculative
decoder), ``stats()`` dicts and admission orders for equality, and the
rewound cache's positions bit for bit; the logits after a rewind are
held to a fresh prefill at atol 1e-5 (float32, the same rounding points
on both sides).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu_torch.models import llama as tllama
from kubeflow_rm_tpu_torch.models import paging as tpaging
from kubeflow_rm_tpu_torch.models.params import from_numpy_params

# the packages export a function named ``generate``: import the modules
jgen = importlib.import_module("kubeflow_rm_tpu.models.generate")
tgen = importlib.import_module("kubeflow_rm_tpu_torch.models.generate")


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tcfg = tllama.LlamaConfig.tiny()
    tparams = from_numpy_params(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, jparams, tcfg, tparams


def _solo(tparams, tcfg, prompt, budget, slot_len=32, eos_id=None):
    out = tgen.generate_fused(tparams, tcfg,
                              torch.tensor([prompt], dtype=torch.int32),
                              max_new_tokens=budget, max_len=slot_len,
                              eos_id=eos_id)
    toks = out[0, len(prompt):].tolist()
    if eos_id is not None and eos_id in toks:   # the engine retires there
        toks = toks[:toks.index(eos_id) + 1]
    return toks


def _mixed_requests(tparams, tcfg):
    """A shared prefix (block hits), an exact repeat of a prompt that
    ends mid-block (a copy-on-write fork), an early eos, ragged lengths,
    all three classes, and more requests than slots."""
    rng = np.random.default_rng(0)
    system = rng.integers(1, 256, 9).tolist()
    reqs = [(system + rng.integers(1, 256, n).tolist(), m, c)
            for n, m, c in ((3, 6, "interactive"), (5, 4, "batch"),
                            (0, 5, "interactive"), (7, 3, "best_effort"),
                            (2, 7, "batch"))]
    reqs += [(rng.integers(1, 256, n).tolist(), m, "interactive")
             for n, m in ((4, 5), (11, 3))]
    reqs.append((list(reqs[0][0]), 6, "interactive"))     # exact repeat
    eos = _solo(tparams, tcfg, reqs[5][0], 1)[0]          # retires at once
    return [(p, m, c, eos if i == 5 else None)
            for i, (p, m, c) in enumerate(reqs)]


def _run_both(model, reqs, **kw):
    jcfg, jparams, tcfg, tparams = model
    je = jgen.ContinuousBatchingEngine(jparams, jcfg, **kw)
    te = tgen.ContinuousBatchingEngine(tparams, tcfg, **kw)
    jr = [je.submit(p, max_new_tokens=m, slo_class=c, eos_id=e)
          for p, m, c, e in reqs]
    tr = [te.submit(p, max_new_tokens=m, slo_class=c, eos_id=e)
          for p, m, c, e in reqs]
    je.run()
    te.run()
    return je, jr, te, tr


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_tokens_and_stats_equal_jax(model, paged):
    _, _, tcfg, tparams = model
    reqs = _mixed_requests(tparams, tcfg)
    je, jr, te, tr = _run_both(model, reqs, slots=2, slot_len=32,
                               block_size=4, paged=paged)
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert [(r.admitted_step, r.finished_step) for r in tr] == \
        [(r.admitted_step, r.finished_step) for r in jr]
    assert te.stats() == je.stats()
    assert tr[5].tokens == [reqs[5][3]]                   # early eos
    if paged:
        st = te.stats()
        assert st["prefix_hit_tokens"] > 0 and st["cow_forks"] >= 1


@pytest.fixture(scope="module")
def moe_model():
    """``tiny_moe`` as JAX defines it (capacity factor 2 = E / top_k:
    no token is ever dropped, whatever the rows of a step)."""
    from kubeflow_rm_tpu.models import mixtral as jmixtral
    from kubeflow_rm_tpu_torch.models import mixtral as tmixtral

    jcfg = jmixtral.MixtralConfig.tiny_moe()
    jparams = jmixtral.init_params(jcfg, jax.random.key(0))
    tcfg = tmixtral.MixtralConfig.tiny_moe()
    tparams = from_numpy_params(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_mixtral_engine_tokens_and_stats_equal_jax(moe_model, paged):
    """The engine serves the MoE family: tokens, admission and retirement
    steps and ``stats()`` equal JAX's engine on ``tiny_moe``."""
    _, _, tcfg, tparams = moe_model
    reqs = _mixed_requests(tparams, tcfg)
    je, jr, te, tr = _run_both(moe_model, reqs, slots=2, slot_len=32,
                               block_size=4, paged=paged)
    assert [r.tokens for r in tr] == [r.tokens for r in jr]
    assert [(r.admitted_step, r.finished_step) for r in tr] == \
        [(r.admitted_step, r.finished_step) for r in jr]
    assert te.stats() == je.stats()


def test_mixtral_speculative_tokens_equal_jax(moe_model):
    jcfg, jparams, tcfg, tparams = moe_model
    prompt, new, _ = SPEC_CASES["periodic"]
    js, ts = {}, {}
    ref = jgen.generate_speculative_fused(
        jparams, jcfg, jnp.asarray(prompt, jnp.int32), max_new_tokens=new,
        stats=js)
    got = tgen.generate_speculative_fused(
        tparams, tcfg, torch.tensor(prompt, dtype=torch.int32),
        max_new_tokens=new, stats=ts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert ts == js


def test_slo_admission_order_equals_jax(model):
    """One slot, three backed-up queues: the weighted round-robin admits
    in JAX's order (test_paging.py:225), interactive first by weight but
    nothing starves."""
    reqs = [([3, 5, 7], 2, c, None)
            for c in ("interactive", "batch", "best_effort")
            for _ in range(12)]
    je, jr, te, tr = _run_both(model, reqs, slots=1, slot_len=16,
                               block_size=4)
    order = [r.slo_class for r in sorted(tr, key=lambda r: r.admitted_step)]
    assert order == [r.slo_class
                     for r in sorted(jr, key=lambda r: r.admitted_step)]
    head = order[:12]
    assert head.count("interactive") >= 7 and head.count("best_effort") >= 1
    assert te.stats()["admitted_by_class"] == {
        "interactive": 12, "batch": 12, "best_effort": 12}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_engine_equals_solo_generate_fused(model, paged):
    """Each request decodes what the port's solo ``generate_fused``
    gives with a slot-sized cache — with a cached prefix (a sibling and
    a later repeat of the same prompt) and without."""
    _, _, tcfg, tparams = model
    eng = tgen.ContinuousBatchingEngine(tparams, tcfg, slots=2, slot_len=32,
                                        block_size=4, paged=paged)
    prompt = [5, 9, 2, 7, 1, 1, 3]          # 7 = not block-aligned
    sibling = prompt + [8]                  # shares one full block
    plan = [(prompt, 6), (prompt, 6), (sibling, 5), (prompt, 6)]
    reqs = [eng.submit(list(p), max_new_tokens=b) for p, b in plan]
    eng.run()
    late = eng.submit(list(prompt), max_new_tokens=4)   # retained prefix
    eng.run()
    for r, (p, b) in zip(reqs + [late], plan + [(prompt, 4)]):
        assert r.tokens == _solo(tparams, tcfg, p, b)
    st = eng.stats()
    assert st["active_slots"] == 0 and st["queue_depth"] == 0
    assert 0 < st["batch_occupancy"] <= 1.0
    if paged:
        assert st["prefix_hit_tokens"] > 0 and st["cow_forks"] >= 1


def test_cow_fork_preserves_the_source_block(model):
    _, _, tcfg, tparams = model
    eng = tgen.ContinuousBatchingEngine(tparams, tcfg, slots=2, slot_len=32,
                                        block_size=4)
    prompt = [5, 9, 2, 7, 1, 1]             # partial second block
    r0 = eng.submit(list(prompt), max_new_tokens=2)
    eng.run()                               # registers the chain
    src = eng.pool.lookup_chain(tpaging.prefix_keys(prompt, 4))
    assert src
    before = eng.cache.k[:, src].clone()
    r1 = eng.submit(list(prompt), max_new_tokens=6)
    eng.run()                               # adopts, forks, decodes
    assert torch.equal(eng.cache.k[:, src], before)
    assert eng.pool.cow_forks >= 1
    assert r0.tokens == _solo(tparams, tcfg, prompt, 2)
    assert r1.tokens == _solo(tparams, tcfg, prompt, 6)


def test_recycled_slot_never_reads_a_stale_prefix(model):
    _, _, tcfg, tparams = model
    eng = tgen.ContinuousBatchingEngine(
        tparams, tcfg, slots=1, slot_len=32, block_size=4,
        num_blocks=tpaging.RESERVED_BLOCKS + 5)
    pa = [5, 9, 2, 7, 1, 1, 3]
    pb = [11, 4, 6, 2, 9, 9, 1, 3, 5, 8, 2, 7]
    ra = eng.submit(list(pa), max_new_tokens=8)        # 4 blocks
    eng.run()
    assert eng.pool.lookup_chain(tpaging.prefix_keys(pa, 4))  # retained
    rb = eng.submit(list(pb), max_new_tokens=8)        # all 5: evicts
    eng.run()
    assert eng.pool.evictions >= 1
    assert eng.pool.lookup_chain(tpaging.prefix_keys(pa, 4)) == []
    hit_before = eng.stats()["prefix_hit_tokens"]
    ra2 = eng.submit(list(pa), max_new_tokens=8)
    eng.run()
    assert eng.stats()["prefix_hit_tokens"] == hit_before   # a true miss
    assert ra.tokens == ra2.tokens == _solo(tparams, tcfg, pa, 8)
    assert rb.tokens == _solo(tparams, tcfg, pb, 8)


def test_block_oom_waits_cleanly_then_recovers(model):
    _, _, tcfg, tparams = model
    eng = tgen.ContinuousBatchingEngine(
        tparams, tcfg, slots=2, slot_len=32, block_size=4,
        num_blocks=tpaging.RESERVED_BLOCKS + 5)
    with pytest.raises(ValueError, match="blocks"):
        eng.submit([1] * 8, max_new_tokens=24)     # 8 blocks > 5
    p1, p2 = [5, 9, 2, 7, 1, 1, 3, 4], [11, 4, 6, 2, 9, 9, 1, 3]
    r1 = eng.submit(p1, max_new_tokens=12)
    r2 = eng.submit(p2, max_new_tokens=12)
    eng.step()
    assert r1.admitted_step is not None and r2.admitted_step is None
    assert eng.pool.alloc_failures >= 1
    eng.run()
    assert r1.tokens == _solo(tparams, tcfg, p1, 12)
    assert r2.tokens == _solo(tparams, tcfg, p2, 12)
    assert eng.pool.available() == eng.pool.usable_blocks
    assert all(eng.pool.ref_of(b) == 0
               for b in range(tpaging.RESERVED_BLOCKS, eng.pool.num_blocks))


def test_evict_queued_returns_the_unadmitted_only(model):
    _, _, tcfg, tparams = model
    eng = tgen.ContinuousBatchingEngine(tparams, tcfg, slots=1, slot_len=16,
                                        block_size=4)
    r1 = eng.submit([3, 5, 7], max_new_tokens=4)
    r2 = eng.submit([2, 4], max_new_tokens=4, slo_class="batch")
    eng.step()                                  # r1 takes the slot
    assert eng.evict_queued() == [r2] and eng.queue_depth == 0
    eng.run()
    assert r1.done and not r2.done
    assert r1.tokens == _solo(tparams, tcfg, [3, 5, 7], 4, slot_len=16)


def test_engine_validation_and_sampling(model):
    _, _, tcfg, tparams = model
    eng = tgen.ContinuousBatchingEngine(tparams, tcfg, slots=1, slot_len=16)
    with pytest.raises(ValueError, match="slot_len"):
        eng.submit(list(range(1, 10)), max_new_tokens=8)   # 16 + 8 > 16
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], max_new_tokens=2)
    with pytest.raises(ValueError, match="Generator"):
        eng.submit([1, 2], max_new_tokens=2, temperature=0.7)
    with pytest.raises(ValueError, match="slo_class"):
        eng.submit([1, 2], max_new_tokens=1, slo_class="platinum")
    with pytest.raises(ValueError, match="batch/best_effort"):
        eng.submit([1, 2, 3, 4], max_new_tokens=1, speculative=True)
    with pytest.raises(ValueError, match="paged"):
        tgen.ContinuousBatchingEngine(tparams, tcfg, slots=1, slot_len=16,
                                      paged=False).prefill_chain([1, 2])
    outs = []
    for _ in range(2):
        e = tgen.ContinuousBatchingEngine(tparams, tcfg, slots=1,
                                          slot_len=16)
        r = e.submit([3, 5, 7], max_new_tokens=6, temperature=0.8, top_k=5,
                     generator=torch.Generator().manual_seed(42))
        e.run()
        outs.append(r.tokens)
    assert outs[0] == outs[1] and len(outs[0]) == 6


def test_engine_refuses_quantized_weights_at_construction(model):
    """Weights are checked against the config at construction, so a
    malformed quantized leaf is refused there, before any request.
    Packed int4 is then unpacked once; int8 is kept as given."""
    from kubeflow_rm_tpu_torch.models.quantize import quantize_params

    _, _, tcfg, tparams = model
    q4 = quantize_params(tparams, bits=4, group_size=16)
    wq = q4["blocks"]["wq"]
    bad = [
        ({"q4": None, "s": None}, "not an array"),
        ({"q4": wq["q4"], "s": wq["s"][:, :1]}, "shape"),           # groups
        ({"q4": wq["q4"][..., :-1], "s": wq["s"][..., :-1]}, "shape"),
        ({"q4": wq["q4"][:, :, :-1], "s": wq["s"]}, "shape"),     # packing
    ]
    for leaf, match in bad:
        q = dict(q4, blocks=dict(q4["blocks"], wq=leaf))
        with pytest.raises(ValueError, match=match):
            tgen.ContinuousBatchingEngine(q, tcfg, slots=1, slot_len=16)
    e = tgen.ContinuousBatchingEngine(quantize_params(tparams, bits=4), tcfg,
                                      slots=1, slot_len=16)
    assert set(e.params["blocks"]["wq"]) == {"q8g", "s"}
    q8 = quantize_params(tparams, bits=8)
    e = tgen.ContinuousBatchingEngine(q8, tcfg, slots=1, slot_len=16)
    assert e.params["blocks"]["wq"]["q"] is q8["blocks"]["wq"]["q"]


def test_engine_caches_live_on_the_parameters_device(model):
    _, _, tcfg, tparams = model
    for paged in (True, False):
        eng = tgen.ContinuousBatchingEngine(tparams, tcfg, slots=1,
                                            slot_len=16, paged=paged)
        assert eng.cache.k.device == tparams["embed"]["tokens"].device


# -- speculative decode -------------------------------------------------


SPEC_CASES = {
    "repetitive": ([[7, 11, 13, 17] * 6], 12, None),
    "periodic": ([[5, 9, 2] * 8], 24, None),
    "random": (np.random.default_rng(21).integers(0, 256, (1, 10)).tolist(),
               9, None),
    "eos": ([[1, 1, 1, 1]], 5, "first"),
}


@pytest.mark.parametrize("case", list(SPEC_CASES))
def test_speculative_tokens_and_stats_equal_jax(model, case):
    jcfg, jparams, tcfg, tparams = model
    prompt, new, eos = SPEC_CASES[case]
    if eos == "first":
        eos = _solo(tparams, tcfg, prompt[0], 1)[0]
    js, ts = {}, {}
    ref = jgen.generate_speculative_fused(
        jparams, jcfg, jnp.asarray(prompt, jnp.int32), max_new_tokens=new,
        eos_id=eos, stats=js)
    got = tgen.generate_speculative_fused(
        tparams, tcfg, torch.tensor(prompt, dtype=torch.int32),
        max_new_tokens=new, eos_id=eos, stats=ts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert ts == js
    # and the greedy loop's tokens
    plain = tgen.generate(tparams, tcfg, torch.tensor(prompt,
                                                      dtype=torch.int32),
                          max_new_tokens=new, eos_id=eos)
    assert torch.equal(got, plain)
    if case == "periodic":
        assert ts["tokens_out"] == new and ts["model_calls"] < new


def test_speculative_argument_checks(model):
    _, _, tcfg, tparams = model
    with pytest.raises(ValueError, match="batch-1"):
        tgen.generate_speculative_fused(
            tparams, tcfg, torch.ones(2, 5, dtype=torch.int32),
            max_new_tokens=2)
    with pytest.raises(ValueError, match="longer than"):
        tgen.generate_speculative_fused(
            tparams, tcfg, torch.ones(1, 2, dtype=torch.int32),
            max_new_tokens=2)


def test_speculative_submit_equals_solo(model):
    _, _, tcfg, tparams = model
    eng = tgen.ContinuousBatchingEngine(tparams, tcfg, slots=2, slot_len=64,
                                        block_size=8)
    prompt = [7, 3, 9, 1, 4, 4, 2, 8, 5, 6, 1, 2]
    plain = eng.submit(prompt[:5], max_new_tokens=4)
    req = eng.submit(prompt, max_new_tokens=8, speculative=True,
                     slo_class="best_effort")
    eng.run()
    assert req.done and req.tokens == _solo(tparams, tcfg, prompt, 8, 64)
    assert plain.tokens == _solo(tparams, tcfg, prompt[:5], 4, 64)
    st = eng.stats()
    assert st["speculative_requests"] == 1
    assert 1 <= st["speculative_model_calls"] <= 9
    assert st["admitted_by_class"]["best_effort"] == 1


def test_rewind_cache_equals_jax(model):
    jcfg, jparams, tcfg, tparams = model
    toks = np.random.default_rng(30).integers(0, 256, (1, 8)).astype(np.int32)
    cont = np.random.default_rng(31).integers(0, 256, (1, 2)).astype(np.int32)
    jc = jgen.init_cache(jcfg, 1, 12)
    _, jc = jgen.decode_chunk(jparams, jcfg, jc, jnp.asarray(toks))
    jc = jgen.rewind_cache(jc, 5)
    tc = tgen.init_cache(tcfg, 1, 12, "cpu")
    _, tc = tgen.decode_chunk(tparams, tcfg, tc, torch.from_numpy(toks))
    tc = tgen.rewind_cache(tc, 5)
    assert tc.offset == int(jc.offset) == 5
    np.testing.assert_array_equal(tc.positions.numpy(),
                                  np.asarray(jc.positions))
    got, _ = tgen.decode_chunk(tparams, tcfg, tc, torch.from_numpy(cont))
    fresh = tgen.init_cache(tcfg, 1, 12, "cpu")
    _, fresh = tgen.decode_chunk(tparams, tcfg, fresh,
                                 torch.from_numpy(toks[:, :5]))
    ref, _ = tgen.decode_chunk(tparams, tcfg, fresh, torch.from_numpy(cont))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
