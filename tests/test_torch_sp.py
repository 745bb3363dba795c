"""Port parity of the sequence-parallel attention schedules
(``kubeflow_rm_tpu_torch.parallel.{ring_attention,zigzag_ring,ulysses}``)
against the JAX package's, on gloo worlds of 2 and 4 processes against
JAX's ``shard_map`` versions on as many virtual CPU devices.

Both worlds are spawned once for this file (``torch_mesh_ranks.start_worlds``)
and runs every case; each rank attends over its contiguous chunk of the
same global float32 inputs, and the chunks are put back together here.
Tolerances: outputs and gradients atol 2e-5 (float32 online softmax in
another summation order than XLA's; the values are O(1)); the
permutation helpers are equal as index arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kubeflow_rm_tpu.parallel import MeshConfig, make_mesh
from kubeflow_rm_tpu.parallel.ring_attention import ring_self_attention
from kubeflow_rm_tpu.parallel.ulysses import ulysses_self_attention
from kubeflow_rm_tpu.parallel import zigzag_ring as jzz
from kubeflow_rm_tpu_torch.parallel import zigzag_ring as tzz

from torch_mesh_ranks import start_worlds

ATOL = 2e-5
B, T, D = 2, 32, 16
WORLDS = (2, 4)


def _inputs(seed, H, KVH, T=T):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, T, KVH, D)).astype(np.float32)
    cot = rng.standard_normal((B, T, H, D)).astype(np.float32)
    return q, k, v, cot


def _segments():
    seg = np.zeros((B, T), np.int32)
    seg[0, 10:] = 1
    seg[0, 23:] = 2
    seg[1, 5:] = 1
    return seg


# name -> (kind, heads, kv heads, causal, segments, with gradients)
CASES = {
    "ring_causal": ("ring", 4, 4, True, False, False),
    "ring_noncausal": ("ring", 4, 4, False, False, False),
    "ring_gqa": ("ring", 4, 2, True, False, False),
    "ring_segments": ("ring", 4, 2, True, True, False),
    "ring_grads": ("ring", 4, 2, True, False, True),
    "ring_segment_grads": ("ring", 4, 2, True, True, True),
    "zigzag_causal": ("zigzag", 4, 4, True, False, False),
    "zigzag_gqa": ("zigzag", 4, 2, True, False, False),
    "zigzag_grads": ("zigzag", 4, 2, True, False, True),
    "ulysses_causal": ("ulysses", 8, 8, True, False, False),
    "ulysses_noncausal": ("ulysses", 8, 8, False, False, False),
    "ulysses_kv_below_sp": ("ulysses", 8, 2, True, False, False),
    "ulysses_segments": ("ulysses", 8, 4, True, True, False),
    "ulysses_grads": ("ulysses", 8, 2, True, False, True),
}


def _case_inputs(name):
    kind, H, KVH, causal, seg, grads = CASES[name]
    q, k, v, cot = _inputs(sorted(CASES).index(name), H, KVH)
    kw = dict(kind=kind, q=q, k=k, v=v, causal=causal,
              cot=cot if grads else None)
    if seg:
        kw["segments"] = _segments()
    return kw


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cases = [(name, "sp_attention", _case_inputs(name)) for name in CASES]
    q, k, v, _ = _inputs(99, 6, 6)
    cases.append(("ulysses_indivisible", "sp_attention",
                  dict(kind="ulysses", q=q, k=k, v=v)))
    return start_worlds({n: cases for n in WORLDS},
                      tmp_path_factory.mktemp("sp"))


def _joined(results, key):
    for r in results:
        assert "error" not in r, r.get("error")
    return np.concatenate([r[key] for r in results], axis=1)


def _jax_attention(n, devices8, kind, q, k, v, causal, segments=None,
                   cot=None):
    """JAX's schedule on ``n`` virtual devices, jitted: the output and,
    with a cotangent, the input gradients. Zigzag runs on inputs put in
    zigzag order here (``inputs_zigzag=True``; its own permutation is
    not traceable under jit), the results put back in natural order."""
    mesh = make_mesh(MeshConfig(dp=1, fsdp=1, sp=n, tp=1), devices8[:n])
    perm = inv = slice(None)
    if kind == "zigzag":
        perm = jzz.zigzag_permutation(q.shape[1], n)
        inv = jzz.inverse_permutation(perm)

    def run(q, k, v):
        if kind == "ring":
            return ring_self_attention(q, k, v, mesh, causal=causal,
                                       segments=segments)
        if kind == "ulysses":
            return ulysses_self_attention(q, k, v, mesh, causal=causal,
                                          segments=segments, impl="xla")
        return jzz.zigzag_ring_self_attention(q, k, v, mesh, causal=causal,
                                              inputs_zigzag=True)

    args = tuple(jnp.asarray(a[:, perm]) for a in (q, k, v))
    if cot is None:
        return np.asarray(jax.jit(run)(*args))[:, inv], None

    @jax.jit
    def with_grads(q, k, v, cot):
        out, vjp = jax.vjp(run, q, k, v)
        return out, vjp(cot)

    out, grads = with_grads(*args, jnp.asarray(cot[:, perm]))
    return (np.asarray(out)[:, inv],
            [np.asarray(g)[:, inv] for g in grads])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(worlds, devices8, n, name):
    kw = _case_inputs(name)
    seg = kw.get("segments")
    want, want_grads = _jax_attention(
        n, devices8, kw["kind"], kw["q"], kw["k"], kw["v"], kw["causal"],
        None if seg is None else jnp.asarray(seg), kw["cot"])
    got = worlds.results()[n][name]
    np.testing.assert_allclose(_joined(got, "out"), want, atol=ATOL)
    if want_grads is not None:
        for key, w in zip(("dq", "dk", "dv"), want_grads):
            np.testing.assert_allclose(_joined(got, key), w, atol=ATOL,
                                       err_msg=key)


@pytest.mark.parametrize("n", WORLDS)
def test_ulysses_rejects_indivisible_heads(worlds, n):
    """6 heads over sp=2 divide; over sp=4 they do not: every rank raises
    JAX's error before any collective."""
    got = worlds.results()[n]["ulysses_indivisible"]
    if n == 2:
        assert all("out" in r for r in got)
    else:
        assert all(r.get("value_error") == (
            "ulysses needs sp (4) to divide n_heads (6)") for r in got)


@pytest.mark.parametrize("T_, n", [(16, 2), (32, 4), (64, 4), (48, 3),
                                   (8, 1)])
def test_zigzag_permutation_equals_jax(T_, n):
    perm = tzz.zigzag_permutation(T_, n)
    np.testing.assert_array_equal(perm, jzz.zigzag_permutation(T_, n))
    assert perm.dtype == jzz.zigzag_permutation(T_, n).dtype
    np.testing.assert_array_equal(tzz.inverse_permutation(perm),
                                  jzz.inverse_permutation(perm))
    np.testing.assert_array_equal(tzz.zigzag_positions(T_, n),
                                  jzz.zigzag_positions(T_, n))
    # round trip: natural -> zigzag -> natural
    x = np.arange(T_) * 10
    np.testing.assert_array_equal(x[perm][tzz.inverse_permutation(perm)], x)
