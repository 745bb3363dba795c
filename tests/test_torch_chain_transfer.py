"""Port parity for the global block store, the chain wire format and the
disaggregated serving fleet (``controlplane/serving_fleet``): the store
and fleet scenarios of JAX's ``tests/test_chain_transfer.py:222-393``,
each run in both packages on the same numpy-seeded tiny Llama (float32;
the wire cases in bf16 too).

Tolerance: none. Store counters (hits, misses, chains, bytes and the
rest), tokens (also against the port's solo ``generate_fused``),
handoffs, installs and prefills are compared for equality, and frames
byte for byte: for the same chain, ``chain_to_bytes`` writes the same
bytes in both packages (a bf16 cache's K/V named ``bfloat16``, which
the port holds as ``uint16`` bits), and each package reads the other's.
"""

import importlib
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_rm_tpu.controlplane import serving_fleet as jfleet
from kubeflow_rm_tpu.controlplane.webapps import serving as jserving
from kubeflow_rm_tpu.models import paging as jpaging
from kubeflow_rm_tpu_torch.controlplane import serving_fleet as tfleet
from kubeflow_rm_tpu_torch.controlplane.webapps import serving as tserving
from kubeflow_rm_tpu_torch.models import paging as tpaging

from torch_fleet_helpers import both_models, solo_torch, wsgi

jgen = importlib.import_module("kubeflow_rm_tpu.models.generate")
tgen = importlib.import_module("kubeflow_rm_tpu_torch.models.generate")

PKGS = ("jax", "torch")
FLEET = {"jax": jfleet, "torch": tfleet}
SERVING = {"jax": jserving, "torch": tserving}
PAGING = {"jax": jpaging, "torch": tpaging}

PROMPT = [7, 3, 9, 1, 4, 4, 2, 8, 5, 6, 1, 2, 9, 9, 3, 1, 0, 2, 4, 6,
          11, 12, 13]


@pytest.fixture(scope="module")
def model():
    return both_models()


def _engine(model, pkg, dtype=None, **kw):
    """A paged engine of ``pkg``; ``dtype=torch.bfloat16`` computes (and
    caches) in bf16 in either package."""
    jcfg, jparams, tcfg, tparams = model
    kw.setdefault("slots", 2)
    kw.setdefault("slot_len", 64)
    kw.setdefault("block_size", 8)
    if pkg == "jax":
        cfg = jcfg if dtype is None else replace(jcfg, dtype=jnp.bfloat16)
        return jgen.ContinuousBatchingEngine(jparams, cfg, paged=True,
                                             prefix_cache=True, **kw)
    cfg = tcfg if dtype is None else replace(tcfg, dtype=torch.bfloat16)
    return tgen.ContinuousBatchingEngine(tparams, cfg, paged=True,
                                         prefix_cache=True, **kw)


def _solo(model, prompt, n):
    return solo_torch(model[3], model[2], prompt, n, 64)


# -- the wire format -------------------------------------------------------


def _jax_view(chain):
    """The same chain as JAX holds it: bf16 K/V as numpy bfloat16."""
    if chain["chunks_k"].dtype != np.uint16:
        return chain
    return dict(chain, chunks_k=chain["chunks_k"].view(jnp.bfloat16),
                chunks_v=chain["chunks_v"].view(jnp.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_frames_are_byte_identical_and_cross_read(model, dtype):
    bf16 = dtype == "bfloat16"
    eng = _engine(model, "torch", dtype=torch.bfloat16 if bf16 else None)
    chain = eng.prefill_chain(PROMPT)
    assert chain["chunks_k"].dtype == (np.uint16 if bf16 else np.float32)
    tframe = tfleet.chain_to_bytes(chain)
    jframe = jfleet.chain_to_bytes(_jax_view(chain))
    assert tframe == jframe
    # each package reads the other's frame back to the same bytes
    jback = jfleet.chain_from_bytes(tframe)
    tback = tfleet.chain_from_bytes(jframe)
    assert jback["chunks_k"].dtype.name == dtype
    assert tback["chunks_k"].dtype == chain["chunks_k"].dtype
    jpaging.verify_chain(jback)
    tpaging.verify_chain(tback)
    assert jfleet.chain_to_bytes(jback) == tfleet.chain_to_bytes(tback) \
        == tframe
    for k in ("keys", "covers", "sums", "tokens", "covered", "nbytes",
              "block_size"):
        assert tback[k] == chain[k]
    np.testing.assert_array_equal(tback["last_logits"],
                                  chain["last_logits"])


def test_a_jax_bf16_frame_installs_in_the_port(model):
    """A chain prefilled by JAX's bf16 engine crosses the wire into the
    port's bf16 engine, which decodes from it without prefilling."""
    jeng = _engine(model, "jax", dtype=torch.bfloat16)
    jchain = jeng.prefill_chain(PROMPT)
    frame = jfleet.chain_to_bytes(jchain)
    chain = tfleet.chain_from_bytes(frame)
    assert chain["chunks_k"].dtype == np.uint16
    np.testing.assert_array_equal(chain["chunks_k"],
                                  np.asarray(jchain["chunks_k"]).view(
                                      np.uint16))
    eng = _engine(model, "torch", dtype=torch.bfloat16)
    req = eng.install_chain(chain, max_new_tokens=4)
    eng.run()
    assert req.done and len(req.tokens) == 4
    assert eng.prefills == 0 and eng.chain_installs == 1
    assert tfleet.chain_to_bytes(chain) == frame


@pytest.mark.parametrize("frame", [b"", b"\x00\x00",
                                   b"\x00\x00\x00\x05xxxxx",
                                   b"\x00\x00\x00\x09\xff\xfe{}{}{}\x00"],
                         ids=["empty", "short", "not-json", "not-utf8"])
def test_malformed_frames_raise_valueerror_in_both(frame):
    for mod in (jfleet, tfleet):
        with pytest.raises(ValueError):
            mod.chain_from_bytes(frame)


def test_truncated_frames_raise_valueerror_in_both(model):
    chain = _engine(model, "torch").prefill_chain(PROMPT)
    frame = tfleet.chain_to_bytes(chain)
    for cut in (len(frame) - 1, len(frame) // 2, 10):
        for mod in (jfleet, tfleet):
            with pytest.raises(ValueError):
                mod.chain_from_bytes(frame[:cut])


# -- the global block store ------------------------------------------------


def _publish_prompt(store, eng, prompt):
    chain = eng.prefill_chain(prompt)
    store.publish(chain)
    return chain


def test_store_lookup_full_and_truncated(model):
    def run(pkg):
        eng, store = _engine(model, pkg), FLEET[pkg].GlobalBlockStore()
        _publish_prompt(store, eng, PROMPT)
        pg = PAGING[pkg]
        hit = store.lookup(pg.prefix_keys(PROMPT, 8))
        other = PROMPT[:16] + [21, 22, 23]
        part = store.lookup(pg.prefix_keys(other, 8))
        pg.verify_chain(part)             # a truncation stays verifiable
        miss = store.lookup(pg.prefix_keys([31, 32, 33, 34], 8))
        return (hit["tokens"], "last_logits" in hit, part["covered"],
                part["tokens"], "last_logits" in part, miss,
                store.stats())

    got = {pkg: run(pkg) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    t = got["torch"]
    assert t[:6] == (PROMPT, True, 16, PROMPT[:16], False, None)
    assert (t[6]["hits"], t[6]["misses"], t[6]["chains"]) == (2, 1, 1)


def test_store_supersedes_prefixes_and_respects_byte_budget(model):
    def run(pkg):
        eng = _engine(model, pkg)
        mod = FLEET[pkg]
        short = _publish_prompt(mod.GlobalBlockStore(), eng, PROMPT[:8])
        store = mod.GlobalBlockStore(max_bytes=4 * short["nbytes"])
        store.publish(short)
        store.publish(eng.prefill_chain(PROMPT[:16]))
        after_supersede = store.stats()
        for i in range(4):
            _publish_prompt(store, eng, [40 + i] * 16)
        again = store.publish(eng.prefill_chain([43] * 16))
        return after_supersede, store.stats(), again

    got = {pkg: run(pkg) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    first, last, again = got["torch"]
    assert first["superseded"] == 1 and first["chains"] == 1
    assert last["evicted"] > 0 and last["bytes"] <= last["max_bytes"]
    assert again is False


def test_store_wire_roundtrip_and_the_chain_endpoint(model):
    """``/api/store/chain/<key>``: the bytes of one stored chain, which
    ``chain_from_bytes`` and ``verify_chain`` accept, in both
    packages."""
    cfgs = {"jax": model[0], "torch": model[2]}

    def run(pkg):
        mod, pg = FLEET[pkg], PAGING[pkg]
        gws = {n: SERVING[pkg].ServingGateway(
            _engine(model, pkg), default_policy=SERVING[pkg].TenantPolicy(
                **POLICY)) for n in ("pf0", "dc0")}
        fleet = mod.ServingFleet(gws, roles={"pf0": "prefill",
                                             "dc0": "decode"})
        try:
            fleet.submit_and_wait("t", PROMPT, max_new_tokens=4)
            app = mod.make_fleet_app(fleet, cfgs[pkg])
            key = pg.prefix_keys(PROMPT, 8)[1][1]
            status, hdrs, body = wsgi(app, "GET",
                                      f"/api/store/chain/{key.hex()}")
            back = mod.chain_from_bytes(body)
            pg.verify_chain(back)
            bad = [wsgi(app, "GET", p)[0] for p in (
                "/api/store/chain/zz", "/api/store/chain/" + "00" * 16)]
            return (status, hdrs["Content-Type"], back["covered"],
                    back["tokens"], "last_logits" in back, bad,
                    fleet.store.stats())
        finally:
            fleet.close()

    got = {pkg: run(pkg) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    assert got["torch"][:6] == (200, "application/octet-stream", 16,
                                PROMPT[:16], False, [400, 404])


# -- the disaggregated fleet -----------------------------------------------

POLICY = dict(qps=1e9, burst=10**6, tokens_per_s=1e9, token_burst=10**7,
              slo_p95_ms=1e9)


def _fleet(model, pkg, blocks=None):
    blocks = blocks or {}
    gws = {n: SERVING[pkg].ServingGateway(
        _engine(model, pkg, num_blocks=blocks.get(n)),
        default_policy=SERVING[pkg].TenantPolicy(**POLICY))
        for n in ("pf0", "dc0", "dc1")}
    return FLEET[pkg].ServingFleet(gws, roles={
        "pf0": "prefill", "dc0": "decode", "dc1": "decode"}), gws


def _counts(eng):
    return dict(installs=eng.chain_installs, prefills=eng.prefills,
                exported=eng.chains_exported, adopted=eng.chains_adopted,
                hit=eng.prefix_hit_tokens, prompt=eng.prompt_tokens)


def _disagg(model, scenario, blocks=None):
    out = {}
    for pkg in PKGS:
        fleet, gws = _fleet(model, pkg, blocks)
        try:
            out[pkg] = scenario(fleet, gws)
        finally:
            fleet.close()
    return out


def test_disagg_fleet_routes_through_prefill_tier(model):
    def run(fleet, gws):
        toks, info = fleet.submit_and_wait("t", PROMPT, max_new_tokens=8)
        snap = fleet.snapshot()
        return (toks, info, fleet.handoffs,
                {n: _counts(g.engine) for n, g in gws.items()},
                snap["roles"], snap["store"])

    got = _disagg(model, run)
    assert got["torch"] == got["jax"]
    toks, info, handoffs, counts, roles, store = got["torch"]
    assert toks == _solo(model, PROMPT, 8)
    assert info["replicas"][0].startswith("dc") and handoffs == 1
    assert counts["pf0"]["exported"] == 1
    dc = counts[info["replicas"][0]]
    assert dc["installs"] == 1 and dc["prefills"] == 0
    assert roles["pf0"] == "prefill" and store["chains"] >= 1


def test_disagg_fleet_validates_roles(model):
    for pkg in PKGS:
        gw = SERVING[pkg].ServingGateway(_engine(model, pkg))
        try:
            mod = FLEET[pkg]
            with pytest.raises(ValueError, match="decode replica"):
                mod.ServingFleet({"a": gw}, roles={"a": "prefill"})
            with pytest.raises(ValueError, match="unknown roles"):
                mod.ServingFleet({"a": gw}, roles={"a": "router"})
            with pytest.raises(ValueError, match="every replica"):
                mod.ServingFleet({"a": gw}, roles={})
        finally:
            gw.close()


def test_disagg_survives_prefill_replica_death(model):
    def run(fleet, gws):
        fleet.kill("pf0")
        return fleet.submit_and_wait("t", PROMPT, max_new_tokens=8), \
            fleet.handoffs

    got = _disagg(model, run)
    assert got["torch"] == got["jax"]
    (toks, _), handoffs = got["torch"]
    assert toks == _solo(model, PROMPT, 8) and handoffs == 0


def test_disagg_prefix_survives_decode_replica_death(model):
    """Kill the decode replica whose pool holds the hot prefix: the
    survivor adopts the chain from the store by hash, the prefix hit
    ratio survives, and outputs stay exact."""

    def run(fleet, gws):
        fleet.kill("pf0")   # decode-local prefill: the prefix lives in
        toks, info = fleet.submit_and_wait("t", PROMPT, max_new_tokens=8)
        holder = info["replicas"][0]
        for i in range(12):      # churn the holder's pool: promotion
            fleet.submit_and_wait("t", [30 + i, 31 + i, 32 + i] * 8,
                                  max_new_tokens=4)
        promoted = fleet.store.stats()
        fleet.kill(holder)
        survivor = next(n for n, r in fleet.roles.items()
                        if r == "decode" and n != holder)
        eng = gws[survivor].engine
        hit0, tok0 = eng.prefix_hit_tokens, eng.prompt_tokens
        toks2, info2 = fleet.submit_and_wait("t", PROMPT, max_new_tokens=8)
        hit = (eng.prefix_hit_tokens - hit0) / (eng.prompt_tokens - tok0)
        return (toks, holder, promoted, toks2, info2, survivor, hit,
                fleet.store.stats())

    got = _disagg(model, run, blocks={"dc0": 34})
    assert got["torch"] == got["jax"]
    toks, holder, promoted, toks2, info2, survivor, hit, _ = got["torch"]
    ref = _solo(model, PROMPT, 8)
    assert toks == ref and toks2 == ref
    assert promoted["promoted"] > 0
    assert info2["replicas"] == [survivor] and hit > 0.5


def test_disagg_speculative_is_exact_through_the_fleet(model):
    def run(fleet, gws):
        return fleet.submit_and_wait("t", PROMPT, max_new_tokens=8,
                                     slo_class="best_effort",
                                     speculative=True)

    got = _disagg(model, run)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == _solo(model, PROMPT, 8)


def test_disagg_add_and_remove_replicas(model):
    def run(fleet, gws):
        pkg = "jax" if isinstance(fleet, jfleet.ServingFleet) else "torch"
        with pytest.raises(ValueError):
            fleet.add_replica("dc2", None)       # no role given
        fleet.add_replica("dc2", SERVING[pkg].ServingGateway(
            _engine(model, pkg)), role="decode")
        fleet.remove_replica("dc0")
        fleet.remove_replica("dc1")
        with pytest.raises(ValueError, match="last decode"):
            fleet.remove_replica("dc2")
        return fleet.states(), fleet.submit_and_wait(
            "t", PROMPT, max_new_tokens=4), fleet.snapshot()["roles"]

    got = _disagg(model, run)
    assert got["torch"] == got["jax"]
    states, (toks, info), roles = got["torch"]
    assert states == {"pf0": "ready", "dc2": "ready"}
    assert toks == _solo(model, PROMPT, 4) and info["replicas"] == ["dc2"]
    assert roles == {"pf0": "prefill", "dc2": "decode"}
