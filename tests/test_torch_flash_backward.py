"""Port parity of the flash-attention backward.

- ``flash_attention_bwd_reference`` (the plain version the CUDA dQ and
  dK/dV kernels are held against on the card) against the JAX Pallas
  backward run by its interpreter (``_flash_bwd_pallas(...,
  interpret=True)``) and against ``_flash_bwd_xla``, called directly
  with the same residuals (q, k, v, segments, O, lse) and dO. Tolerance
  atol = rtol = 3e-5, the JAX grad tests' own: float32 on both sides,
  blockwise there, one pass here.
- Autograd through the port's ``flash_attention`` against autograd
  through ``dot_product_attention(impl="dense")``.
- The kernel branch's wiring: the launch functions replaced by their
  plain versions (run without autograd, as a kernel writes its output
  through a pointer) must still give q, k and v their gradients — the
  autograd node, not the launch, carries the graph.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_rm_tpu.ops.flash_attention import (
    _flash_bwd_pallas, _flash_bwd_xla, _flash_call,
)
from kubeflow_rm_tpu_torch.ops import flash_attention as fa
from kubeflow_rm_tpu_torch.ops.attention import dot_product_attention

TOL = dict(atol=3e-5, rtol=3e-5)
BLOCK = 64


def packed_segments(lengths, T):
    seg = np.zeros(T, np.int32)
    at = 0
    for i, n in enumerate(lengths, start=1):
        seg[at:at + n] = i
        at += n
    return seg


CASES = {
    "causal_T128": dict(T=128, H=4, KVH=4, causal=True),
    "noncausal_T128": dict(T=128, H=2, KVH=2, causal=False),
    "gqa_kvh2_T128": dict(T=128, H=4, KVH=2, causal=True),
    "gqa_kvh1_T128": dict(T=128, H=4, KVH=1, causal=True),
    "packed_T128": dict(T=128, H=2, KVH=1, causal=True,
                        seg=[(40, 30, 25, 20), (70, 50)]),
    "orphan_rows": dict(T=128, H=2, KVH=2, causal=False,
                        seg=[(64, 64), (128,)], orphan=True),
}


def make_case(name, B=2, D=16):
    c = CASES[name]
    rng = np.random.default_rng(10 + list(CASES).index(name))
    T, H, KVH = c["T"], c["H"], c["KVH"]
    q = rng.standard_normal((B, H, T, D)).astype(np.float32)
    k = rng.standard_normal((B, KVH, T, D)).astype(np.float32)
    v = rng.standard_normal((B, KVH, T, D)).astype(np.float32)
    do = rng.standard_normal((B, H, T, D)).astype(np.float32)
    segq = segkv = None
    if "seg" in c:
        segq = np.stack([packed_segments(s, T) for s in c["seg"]])
        segkv = segq.copy()
        if c.get("orphan"):
            segq[0, 10:20] = 99    # rows that match no key
    return c, q, k, v, do, segq, segkv


def to_bh(a):
    """(B, H, T, D) numpy -> the kernels' (B·H, T, D) tensor."""
    B, H, T, D = a.shape
    return torch.from_numpy(np.array(a)).reshape(B * H, T, D)


@pytest.mark.parametrize("name", list(CASES))
def test_bwd_reference_matches_pallas_and_xla(name):
    c, q, k, v, do, segq, segkv = make_case(name)
    B, H, T, D = q.shape
    KVH = k.shape[1]
    group = H // KVH
    # JAX gets its own copies (jnp.array copies; jnp.asarray may share
    # the numpy buffers), and one host snapshot of the forward's
    # residuals feeds both frameworks
    jseg = [None if s is None else jnp.array(s) for s in (segq, segkv)]
    jq, jk, jv, jdo = (jnp.array(a) for a in (q, k, v, do))
    out, lse = _flash_call(jq, jk, jv, *jseg, c["causal"], BLOCK, BLOCK,
                           group, True)
    out, lse = np.array(out), np.array(lse)
    res = (jq, jk, jv, *jseg, jnp.array(out), jnp.array(lse))
    pallas = _flash_bwd_pallas(c["causal"], BLOCK, BLOCK, group, True, res,
                               jdo)[:3]
    xla = _flash_bwd_xla(c["causal"], BLOCK, BLOCK, group, True, res,
                         jdo)[:3]
    tseg = [None if s is None else torch.from_numpy(s) for s in (segq, segkv)]
    got = fa.flash_attention_bwd_reference(
        to_bh(q), to_bh(k), to_bh(v), to_bh(out),
        torch.from_numpy(lse.copy()).reshape(B * H, T), to_bh(do),
        *tseg, heads=H, group=group, causal=c["causal"])
    for ours, p, x in zip(got, pallas, xla):
        p = np.asarray(p).reshape(ours.shape)
        np.testing.assert_allclose(ours.numpy(), p, **TOL)
        np.testing.assert_allclose(ours.numpy(), np.asarray(x).reshape(
            ours.shape), **TOL)
    if c.get("orphan"):
        dq = got[0].view(B, H, T, D).numpy()
        assert np.all(dq[0, :, 10:20] == 0.0)
        assert np.all(np.isfinite(got[1].numpy()))


def _grads(fn, q, k, v, seed=3):
    q, k, v = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    out = fn(q, k, v)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    (out * w).sum().backward()
    return out.detach(), q.grad, k.grad, v.grad


@pytest.mark.parametrize("name", ["causal_T128", "gqa_kvh2_T128",
                                  "packed_T128", "noncausal_T128"])
def test_autograd_matches_dense(name):
    c, q, k, v, _, segq, segkv = make_case(name)
    sw = lambda a: torch.from_numpy(a).transpose(1, 2)  # noqa: E731
    q, k, v = sw(q), sw(k), sw(v)                        # (B, T, H, D)
    kw = {}
    if segq is not None:
        s = torch.from_numpy(segq)
        kw = dict(segment_ids_q=s, segment_ids_kv=s)
    flash = _grads(lambda a, b, d: fa.flash_attention(
        a, b, d, causal=c["causal"], **kw), q, k, v)
    dense = _grads(lambda a, b, d: dot_product_attention(
        a, b, d, causal=c["causal"], impl="dense", **kw), q, k, v)
    for f, d in zip(flash, dense):
        np.testing.assert_allclose(f.numpy(), d.numpy(), **TOL)


def _op_node(out):
    """The first autograd node under ``out`` that is not a layout view."""
    node = out.grad_fn
    while type(node).__name__ in ("TransposeBackward0", "ViewBackward0"):
        node = node.next_functions[0][0]
    return type(node).__name__


def test_grad_fn_is_the_ports_op():
    q = torch.randn(1, 64, 2, 16, requires_grad=True)
    out = fa.flash_attention(q, q, q)
    assert "kfrm_flash_attention" in _op_node(out)


def test_kernel_branch_wiring_gives_gradients(monkeypatch):
    """CPU tensors sent down the kernel branch: the launch functions are
    replaced by their plain versions run without autograd, exactly as
    opaque as a kernel's output. q, k and v must still get gradients,
    equal to the plain path's."""
    calls = {"fwd": 0, "bwd": 0}

    def fake_fwd(*a, **kw):
        calls["fwd"] += 1
        with torch.no_grad():
            return fa.flash_attention_reference_bh(*a, **kw)

    def fake_bwd(*a, **kw):
        calls["bwd"] += 1
        with torch.no_grad():
            return fa.flash_attention_bwd_reference(*a, **kw)

    c, q, k, v, _, segq, _ = make_case("packed_T128")
    sw = lambda a: torch.from_numpy(a).transpose(1, 2)  # noqa: E731
    q, k, v = sw(q), sw(k), sw(v)
    s = torch.from_numpy(segq)

    def run(a, b, d):
        return fa.flash_attention(a, b, d, segment_ids_q=s,
                                  segment_ids_kv=s)

    plain = _grads(run, q, k, v)
    monkeypatch.setattr(fa, "_launches_kernel", lambda t: True)
    monkeypatch.setattr(fa, "flash_fwd", fake_fwd)
    monkeypatch.setattr(fa, "flash_bwd", fake_bwd)
    wired = _grads(run, q, k, v)
    assert calls == {"fwd": 1, "bwd": 1}
    for got, ref in zip(wired, plain):
        assert got is not None
        np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    assert "kfrm_flash_attention" in _op_node(run(
        *(t.requires_grad_(True) for t in (q.clone(), k.clone(),
                                           v.clone()))))


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback inside the backward wrappers either."""
    q = torch.zeros(2, 64, 64, dtype=torch.bfloat16)
    lse = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd(q, q, q, q, lse, q, heads=1, group=1, causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dq(q, q, q, q, lse, lse, heads=1, group=1,
                        causal=True)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_bwd_dkv(q, q, q, q, lse, lse, heads=1, group=1,
                         causal=True)
