"""Port parity for ``models/paging`` and the slot decode step, on the tiny
float32 model with JAX's weights carried over (``from_numpy_params``).

Tolerances: logits of ``slot_decode_step``, ``paged_decode_step`` and
``paged_prefill`` against JAX's at atol 1e-4 (float32, the same rounding
points; the matmuls' summation order differs between XLA and PyTorch);
gathered K/V strips at atol 1e-5. Everything host-side is exact:
prefix-key bytes, the pool's alloc/evict sequence, positions, block
tables, counters, chunk checksums and decoded tokens.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_rm_tpu.models import llama as jllama
from kubeflow_rm_tpu.models import paging as jpaging
from kubeflow_rm_tpu_torch.models import llama as tllama
from kubeflow_rm_tpu_torch.models import paging as tpaging
from kubeflow_rm_tpu_torch.models.params import from_numpy_params

jgen = importlib.import_module("kubeflow_rm_tpu.models.generate")
tgen = importlib.import_module("kubeflow_rm_tpu_torch.models.generate")

IMPLS = {"jax": jpaging, "torch": tpaging}
impls = pytest.mark.parametrize("pg", list(IMPLS.values()),
                                ids=list(IMPLS))


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.LlamaConfig.tiny()
    jparams = jllama.init_params(jcfg, jax.random.key(0))
    tcfg = tllama.LlamaConfig.tiny()
    tparams = from_numpy_params(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return jcfg, jparams, tcfg, tparams


# -- host-side pool invariants (test_paging.py:37-101, both packages) ----


@impls
def test_prefix_keys_chain_and_divergence(pg):
    a = pg.prefix_keys([1, 2, 3, 4, 5, 6, 7, 8, 9], 4)
    assert [c for c, _ in a] == [4, 8, 9]
    b = pg.prefix_keys([1, 2, 3, 4, 5, 6, 7, 99, 9], 4)
    assert a[0][1] == b[0][1]
    assert a[1][1] != b[1][1] and a[2][1] != b[2][1]
    assert [c for c, _ in pg.prefix_keys([1, 2, 3, 4], 4)] == [4]


@impls
def test_pool_alloc_release_to_zero_returns_blocks(pg):
    pool = pg.BlockPool(pg.RESERVED_BLOCKS + 4, 8)
    assert pool.usable_blocks == 4 and pool.available() == 4
    got = pool.alloc(3)
    assert len(got) == 3 and pool.available() == 1
    assert all(pool.ref_of(b) == 1 for b in got)
    pool.decref(got)
    assert pool.available() == 4 and pool.free_count() == 4
    assert len(pool.alloc(4)) == 4


@impls
def test_pool_registered_blocks_are_retained_then_evicted(pg):
    pool = pg.BlockPool(pg.RESERVED_BLOCKS + 3, 8)
    keys = pg.prefix_keys([1, 2, 3, 4, 5, 6, 7, 8], 4)
    (b0, b1) = pool.alloc(2)
    pool.register(keys[0][1], b0)
    pool.register(keys[1][1], b1)
    pool.decref([b0, b1])
    assert pool.free_count() == 1 and pool.evictable_count() == 2
    assert pool.lookup_chain(keys) == [b0, b1]
    got = pool.alloc(2)
    assert len(got) == 2 and pool.evictions == 1
    assert pool.lookup_chain(keys) == []


@impls
def test_pool_alloc_is_atomic_on_oom(pg):
    pool = pg.BlockPool(pg.RESERVED_BLOCKS + 3, 8)
    first = pool.alloc(2)
    before = (pool.free_count(), pool.available(),
              {b: pool.ref_of(b) for b in first})
    assert pool.alloc(2) is None
    assert (pool.free_count(), pool.available(),
            {b: pool.ref_of(b) for b in first}) == before
    assert pool.alloc_failures == 1
    assert len(pool.alloc(1)) == 1


@impls
def test_pool_refcount_underflow_raises(pg):
    pool = pg.BlockPool(pg.RESERVED_BLOCKS + 2, 8)
    (b,) = pool.alloc(1)
    pool.decref([b])
    with pytest.raises(RuntimeError, match="below zero"):
        pool.decref([b])


@impls
def test_pool_incref_pins_against_eviction(pg):
    pool = pg.BlockPool(pg.RESERVED_BLOCKS + 2, 8)
    keys = pg.prefix_keys([1, 2, 3, 4], 4)
    (b,) = pool.alloc(1)
    pool.register(keys[0][1], b)
    pool.decref([b])
    pool.incref([b])
    assert pool.alloc(2) is None
    assert pool.lookup_chain(keys) == [b]
    pool.decref([b])


def _pool_script(pg):
    """One fixed sequence of pool operations; returns everything it saw."""
    rng = np.random.default_rng(5)
    pool = pg.BlockPool(pg.RESERVED_BLOCKS + 9, 4)
    seen, live = [], []
    pool.on_evict = lambda key, b: seen.append(("evict", key, b))
    for step in range(40):
        toks = rng.integers(0, 6, int(rng.integers(1, 14))).tolist()
        keys = pg.prefix_keys(toks, 4)
        seen.append(keys)
        chain = pool.lookup_chain(keys)
        pool.incref(chain)
        fresh = pool.alloc(int(rng.integers(0, 4)))
        seen.append((chain, fresh))
        if fresh is None:
            pool.decref(chain)
            continue
        parent = None
        for j, (covered, key) in enumerate(keys[len(chain):]):
            if j < len(fresh):
                seen.append(pool.register(key, fresh[j], parent=parent,
                                          covered=covered))
            parent = key
        live.append(chain + fresh)
        if len(live) > 2 or step % 3 == 0:
            pool.decref(live.pop(0))
        seen.append(pool.stats())
    return seen


def test_pool_sequences_and_key_bytes_equal_jax():
    seen = _pool_script(tpaging)
    assert any(e[0] == "evict" for e in seen if isinstance(e, tuple))
    assert seen == _pool_script(jpaging)


# -- device ops against JAX ----------------------------------------------


def _slot_caches(model, slots=3, slot_len=16):
    """Both packages' SlotCaches with rows 0 and 2 prefilled (ragged,
    left-padded to their buckets) and row 1 empty."""
    jcfg, jparams, tcfg, tparams = model
    jc = jgen.init_slot_cache(jcfg, slots, slot_len)
    tc = tgen.init_slot_cache(tcfg, slots, slot_len, "cpu")
    for row, prompt in ((0, [5, 9, 2]), (2, [7, 1, 1, 3, 8])):
        Tb = tgen._bucket_len(len(prompt))
        padded = np.asarray([[0] * (Tb - len(prompt)) + prompt], np.int32)
        pads = np.asarray([Tb - len(prompt)], np.int32)
        jtmp = jgen.init_cache(jcfg, 1, slot_len)
        _, jtmp = jgen.decode_chunk(jparams, jcfg, jtmp, jnp.asarray(padded),
                                    jnp.asarray(pads))
        jc = jgen._install_row(jc, jtmp, jnp.asarray(row, jnp.int32),
                               jnp.asarray(len(prompt), jnp.int32))
        ttmp = tgen.init_cache(tcfg, 1, slot_len, "cpu")
        _, ttmp = tgen.decode_chunk(tparams, tcfg, ttmp,
                                    torch.from_numpy(padded),
                                    torch.from_numpy(pads))
        tgen._install_row(tc, ttmp, row, len(prompt))
    return jc, tc


def test_slot_decode_step_matches_jax(model):
    jcfg, jparams, tcfg, tparams = model
    jc, tc = _slot_caches(model)
    for tokens, active in (([4, 0, 6], [True, False, True]),
                           ([3, 0, 2], [True, False, False])):
        jl, jc = jgen.slot_decode_step(jparams, jcfg, jc,
                                       jnp.asarray(tokens, jnp.int32),
                                       jnp.asarray(active))
        tl, tc = tgen.slot_decode_step(
            tparams, tcfg, tc, torch.tensor(tokens, dtype=torch.int32),
            torch.tensor(active))
        live = np.asarray(active)
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=1e-4, rtol=1e-4)
        for f in ("positions", "write_idx", "pos_next"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          np.asarray(getattr(jc, f)))


def _paged_caches(model):
    """Both packages' paged pools after the same two admissions: slot 0
    holds a fresh prompt; slot 1 adopts its first block and forks the
    partial one (load_row names the source, dest_row diverts the shared
    chunk to SINK)."""
    jcfg, jparams, tcfg, tparams = model
    slots, slot_len, nb, bs = 2, 16, 12, 4
    jc = jpaging.init_paged_cache(jcfg, slots, slot_len, nb, bs)
    tc = tpaging.init_paged_cache(tcfg, slots, slot_len, nb, bs, "cpu")
    N = tpaging.NULL_BLOCK
    S = tpaging.SINK_BLOCK
    prompt = [5, 9, 2, 7, 1, 1]
    plans = [  # (slot, load_row, n_hit, tokens, final_row, dest_row)
        (0, [N] * 4, 0, prompt, [2, 3, 4, N], [2, 3, 4, S]),
        (1, [2, 3, N, N], 5, prompt[5:], [2, 5, 6, N], [S, 5, 6, S]),
    ]
    lasts = []
    for slot, load, n_hit, toks, final, dest in plans:
        Tc = tgen._bucket_len(len(toks))
        padded = np.asarray([toks + [0] * (Tc - len(toks))], np.int32)
        jl, jk, jv, jp = jpaging.paged_prefill(
            jparams, jcfg, jc, jnp.asarray(load, jnp.int32),
            jnp.asarray(n_hit, jnp.int32), jnp.asarray(padded),
            jnp.asarray(len(toks), jnp.int32))
        jc = jpaging.paged_install(
            jc, jk, jv, jp, jnp.asarray(slot, jnp.int32),
            jnp.asarray(final, jnp.int32), jnp.asarray(dest, jnp.int32),
            jnp.asarray(len(prompt), jnp.int32))
        tl, tk, tv, tp = tpaging.paged_prefill(
            tparams, tcfg, tc, load, n_hit, torch.from_numpy(padded),
            len(toks))
        tpaging.paged_install(tc, tk, tv, tp, slot, final, dest,
                              len(prompt))
        lasts.append((np.asarray(jl), tl.numpy()))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    return jc, tc, lasts


def test_paged_prefill_matches_jax(model):
    _, _, lasts = _paged_caches(model)
    for jl, tl in lasts:                   # fresh, then a cached prefix
        np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=1e-4)


def _assert_strips_equal(jc, tc, slots):
    for slot in range(slots):
        jk, jv, jp = jpaging.gather_slot_strip(jc, jnp.asarray(slot))
        tk, tv, tp = tpaging.gather_slot_strip(tc, slot)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def test_paged_decode_step_and_strips_match_jax(model):
    jcfg, jparams, tcfg, tparams = model
    jc, tc, _ = _paged_caches(model)
    _assert_strips_equal(jc, tc, 2)
    for tokens, active in (([4, 6], [True, True]), ([3, 0], [True, False]),
                           ([0, 0], [False, False])):
        jl, jc = jpaging.paged_decode_step(
            jparams, jcfg, jc, jnp.asarray(tokens, jnp.int32),
            jnp.asarray(active))
        tl, tc = tpaging.paged_decode_step(
            tparams, tcfg, tc, torch.tensor(tokens, dtype=torch.int32),
            torch.tensor(active))
        live = np.asarray(active)
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=1e-4, rtol=1e-4)
        for f in ("block_tables", "write_idx", "pos_next"):
            np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                          np.asarray(getattr(jc, f)))
        _assert_strips_equal(jc, tc, 2)


def test_paged_prefill_overflow_raises(model):
    _, _, tcfg, tparams = model
    tc = tpaging.init_paged_cache(tcfg, 1, 8, 6, 4, "cpu")
    with pytest.raises(ValueError, match="overflows"):
        tpaging.paged_prefill(tparams, tcfg, tc, [0, 0], 4,
                              torch.zeros(1, 8, dtype=torch.int32), 8)


# -- chains --------------------------------------------------------------

PROMPT = [7, 3, 9, 1, 4, 4, 2, 8, 5, 6, 1, 2, 9, 9, 3, 1, 0, 2, 4, 6,
          11, 12, 13]


def _tengine(tparams, tcfg, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("slot_len", 64)
    kw.setdefault("block_size", 8)
    return tgen.ContinuousBatchingEngine(tparams, tcfg, **kw)


def _jengine(jparams, jcfg, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("slot_len", 64)
    kw.setdefault("block_size", 8)
    return jgen.ContinuousBatchingEngine(jparams, jcfg, **kw)


def _solo(tparams, tcfg, prompt, n):
    out = tgen.generate_fused(tparams, tcfg,
                              torch.tensor([prompt], dtype=torch.int32),
                              max_new_tokens=n, max_len=64)
    return out[0, len(prompt):].tolist()


def _drain(eng, req):
    while not req.done:
        eng.step()
    return req.tokens


def test_chains_verify_across_packages(model):
    jcfg, jparams, tcfg, tparams = model
    ja, ta = _jengine(jparams, jcfg), _tengine(tparams, tcfg)
    _drain(ja, ja.submit(PROMPT, max_new_tokens=4))
    _drain(ta, ta.submit(PROMPT, max_new_tokens=4))
    jchain = jpaging.export_chain(ja.cache, ja.pool, PROMPT)
    tchain = tpaging.export_chain(ta.cache, ta.pool, PROMPT)
    tpaging.verify_chain(jchain)           # JAX's chain in the port
    jpaging.verify_chain(tchain)           # the port's chain in JAX
    # one block exported alone carries the chain's bytes for that chunk
    for i, blk in enumerate(ta.pool.lookup_chain(
            tpaging.prefix_keys(PROMPT, 8))):
        one = tpaging.export_block_chunk(ta.cache, blk,
                                         tchain["covers"][i] - 8 * i)
        np.testing.assert_array_equal(one["k"], tchain["chunks_k"][:, i])
        assert one["sum"] == tchain["sums"][i]
    assert tchain["keys"] == jchain["keys"]
    assert tchain["covers"] == jchain["covers"]
    np.testing.assert_array_equal(tchain["chunks_pos"],
                                  np.asarray(jchain["chunks_pos"]))
    np.testing.assert_allclose(tchain["chunks_k"],
                               np.asarray(jchain["chunks_k"]), atol=1e-5)
    # a JAX chain adopted into a port pool decodes what solo gives
    tb = _tengine(tparams, tcfg)
    free = tb.pool.available()
    assert tb.adopt_chain(jchain) == len(jchain["keys"])
    assert tb.adopt_chain(jchain) == 0          # already local
    assert tb.chain_coverage(PROMPT) == len(PROMPT)
    rb = tb.submit(PROMPT, max_new_tokens=8)
    assert _drain(tb, rb) == _solo(tparams, tcfg, PROMPT, 8)
    assert tb.prefix_hit_tokens >= len(PROMPT) - 1
    assert tb.pool.available() == free


def test_bf16_chunk_checksum_equals_jax_on_the_same_bits():
    bits = np.random.default_rng(3).integers(0, 2**16, (3, 2, 4, 2, 8),
                                             dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0      # no inf/nan patterns
    jk = bits[0].view(jnp.bfloat16)          # JAX's numpy bfloat16
    tk = torch.from_numpy(bits[0].view(np.int16)).view(torch.bfloat16)
    host = tpaging.to_host(tk)
    assert host.dtype == np.uint16
    np.testing.assert_array_equal(host, bits[0])
    pos = np.arange(4, dtype=np.int32)
    assert tpaging._chunk_checksum(host, bits[1], pos) == \
        jpaging._chunk_checksum(jk, bits[1].view(jnp.bfloat16), pos)
    back = tpaging.from_host(jk, torch.bfloat16, "cpu")
    assert torch.equal(back, tk)
    assert torch.equal(tpaging.from_host(host, torch.bfloat16, "cpu"), tk)


def test_bf16_chain_round_trip_verifies_in_both(model):
    from dataclasses import replace

    _, _, tcfg, tparams = model
    cfg16 = replace(tcfg, dtype=torch.bfloat16)
    a = _tengine(tparams, cfg16)
    chain = a.prefill_chain(PROMPT)
    assert chain["chunks_k"].dtype == np.uint16
    jpaging.verify_chain(chain)
    jview = dict(chain, chunks_k=chain["chunks_k"].view(jnp.bfloat16),
                 chunks_v=chain["chunks_v"].view(jnp.bfloat16))
    jpaging.verify_chain(jview)           # the same bytes as JAX bf16
    b = _tengine(tparams, cfg16)
    req = b.install_chain(jview, max_new_tokens=4)
    _drain(b, req)
    blocks = b.pool.lookup_chain(tpaging.prefix_keys(PROMPT, 8))
    ours = tpaging.export_chain(b.cache, b.pool, PROMPT)
    np.testing.assert_array_equal(ours["chunks_k"], chain["chunks_k"])
    assert ours["sums"] == chain["sums"] and len(blocks) == 3


def test_corrupted_chunk_is_refused_without_pool_damage(model):
    _, _, tcfg, tparams = model
    a, b = _tengine(tparams, tcfg), _tengine(tparams, tcfg)
    _drain(a, a.submit(PROMPT, max_new_tokens=4))
    chain = tpaging.export_chain(a.cache, a.pool, PROMPT)
    chain["chunks_k"][:, 0, 0] += 1
    free = b.pool.available()
    k_before = b.cache.k.clone()
    with pytest.raises(ValueError, match="chunk 0 checksum"):
        tpaging.import_chain(b.cache, b.pool, chain)
    with pytest.raises(ValueError, match="chunk 0 checksum"):
        b.install_chain(dict(chain, last_logits=np.zeros(256, np.float32)),
                        max_new_tokens=2)
    assert b.pool.available() == free and b.queue_depth == 0
    assert torch.equal(b.cache.k, k_before)
    good = tpaging.export_chain(a.cache, a.pool, PROMPT)
    good["tokens"] = list(PROMPT[:-1]) + [99]
    with pytest.raises(ValueError, match="chained hashes"):
        tpaging.verify_chain(good)


def test_import_oom_is_a_clean_none(model):
    _, _, tcfg, tparams = model
    a = _tengine(tparams, tcfg)
    _drain(a, a.submit(PROMPT, max_new_tokens=4))
    chain = tpaging.export_chain(a.cache, a.pool, PROMPT)
    tiny = _tengine(tparams, tcfg, slots=1, num_blocks=4)
    assert tpaging.import_chain(tiny.cache, tiny.pool, chain) is None
    assert tiny.pool.available() == tiny.pool.usable_blocks


@pytest.mark.parametrize("source", ["torch", "jax"])
def test_prefill_chain_install_chain_equals_solo(model, source):
    jcfg, jparams, tcfg, tparams = model
    if source == "torch":
        pf = _tengine(tparams, tcfg)
        chain = pf.prefill_chain(PROMPT)
        assert pf.prefills == 1 and pf.chains_exported == 1
        assert all(pf.pool.ref_of(b) == 0 for b in range(
            tpaging.RESERVED_BLOCKS, pf.pool.num_blocks))
    else:
        chain = _jengine(jparams, jcfg).prefill_chain(PROMPT)
    dc = _tengine(tparams, tcfg)
    req = dc.install_chain(chain, max_new_tokens=8)
    assert _drain(dc, req) == _solo(tparams, tcfg, PROMPT, 8)
    assert dc.prefills == 0 and dc.chain_installs == 1
    assert dc.prefix_hit_tokens == len(PROMPT)
    # a second install of the same prompt adopts the local blocks
    again = dc.install_chain(chain, max_new_tokens=8)
    assert _drain(dc, again) == req.tokens
    assert dc.chain_installs == 1 and dc.prefills == 1
