"""Tile-schedule parity of the Hopper flash kernels, on the CPU.

The CUDA kernels ``flash_fwd_kernel`` (``kernels/csrc/flash_fwd.cu``),
``flash_bwd_dq_kernel`` and ``flash_bwd_dkv_kernel``
(``kernels/csrc/flash_bwd.cu``) run only on the card. Their arithmetic is held here by a float32 blockwise emulation in
plain PyTorch that walks the kernels' loops as they run them:

- tile sizes read from the sources' ``constexpr``s, so the emulation and
  the kernels cannot drift apart;
- forward: one CTA per (q row, pair of BQ-row q tiles nq - 1 - x and x),
  each tile split into WG_ROWS-row consumer warpgroups, looping over
  BK-row kv tiles up to the causal limit; the online softmax in the exp2
  domain (natural-log lse); masking only on the tiles the kernel masks
  (diagonal, ragged, segments), by selecting the score to -inf;
- dQ: one CTA per (q row, pair of DQ_BQ-row q tiles nq - 1 - x and x),
  each split into DQ_WG_ROWS-row warpgroups, looping over DQ_BK-row kv
  tiles up to the causal limit of the warpgroup's rows; P in the exp2
  domain from lse, masked as in the forward;
- dK/dV: one CTA per (kv row, pair of DKV_BKV-row kv tiles x and
  nkv - 1 - x), each split into DKV_WG_ROWS-row warpgroups, looping over
  the GQA group's q heads and their DKV_BQ-row q tiles from the causal
  start, skipping tiles wholly in a warpgroup's past; P in the exp2
  domain from lse, masked as in the forward; dK and dV summed over the
  group in float32.

It is held against JAX's Pallas kernels run by their interpreter at
T = 256 (blocks divide T) and against the port's plain versions at ragged
T with GQA groups 1, 2 and 4, segment ids and rows that match no key.
Tolerance atol = rtol = 3e-5, as in ``test_torch_flash_backward.py``:
float32 on both sides, summed in other orders.
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeflow_rm_tpu.ops.flash_attention import _flash_bwd_pallas, _flash_call
from kubeflow_rm_tpu_torch.ops import flash_attention as fa
from kubeflow_rm_tpu_torch.ops.attention import NEG_INF

TOL = dict(atol=3e-5, rtol=3e-5)
CSRC = Path(fa.__file__).resolve().parents[1] / "kernels" / "csrc"
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def constexprs(name: str) -> dict:
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


FWD = constexprs("flash_fwd.cu")
DKV = constexprs("flash_bwd.cu")
BQ, BK, WG_ROWS = FWD["BQ"], FWD["BK"], FWD["WG_ROWS"]
DQ_BQ, DQ_BK, DQ_WG_ROWS = DKV["DQ_BQ"], DKV["DQ_BK"], DKV["DQ_WG_ROWS"]
DKV_BKV, DKV_BQ, DKV_WG_ROWS = (DKV["DKV_BKV"], DKV["DKV_BQ"],
                                DKV["DKV_WG_ROWS"])


def rows_of(t, first, n):
    """Rows [first, first + n) of a (T, ...) tensor, zero past T — what a
    TMA box reads at the ragged edge of its own head."""
    out = t.new_zeros((n, *t.shape[1:]))
    last = min(first + n, t.shape[0])
    if last > first:
        out[:last - first] = t[first:last]
    return out


def paired_tiles(n, late_heavy):
    """The tiles in the order the kernels' CTAs take them: CTA x runs
    tiles n - 1 - x and x (the heavy one first; under the causal mask the
    late q tiles and the early kv tiles are heavy), the middle tile of an
    odd n once."""
    order = []
    for x in range((n + 1) // 2):
        pair = (n - 1 - x, x) if late_heavy else (x, n - 1 - x)
        order += dict.fromkeys(pair)
    assert sorted(order) == list(range(n))
    return order


def keep_mask(rows, cols, T, causal, seg_rows, seg_cols, bound_rows):
    """keep[r, c]: row r (a q row) attends column c (a kv row). The
    forward leaves rows past T unbounded (they are never stored); the
    dK/dV kernel bounds both, since those rows would add to dK/dV."""
    keep = (cols[None, :] < T).expand(len(rows), len(cols))
    if bound_rows:
        keep = keep & (rows[:, None] < T)
    if causal:
        keep = keep & (rows[:, None] >= cols[None, :])
    if seg_rows is not None:
        keep = keep & (seg_rows[:, None] == seg_cols[None, :])
    return keep


def emulate_fwd(q, k, v, segq, segkv, *, heads, group, causal):
    """``flash_fwd_kernel``'s loops in float32: returns (O, lse)."""
    BH, T, D = q.shape
    scale_log2 = D ** -0.5 * LOG2E
    out = torch.zeros(BH, T, D)
    lse = torch.zeros(BH, T)
    nq, nk = math.ceil(T / BQ), math.ceil(T / BK)
    seg = segq is not None
    for bh in range(BH):
        b, kvh = bh // heads, bh // group
        for i in paired_tiles(nq, late_heavy=True):
            q0 = i * BQ
            n_tiles = min(nk, (q0 + BQ - 1) // BK + 1) if causal else nk
            for first in range(q0, q0 + BQ, WG_ROWS):   # consumer warpgroups
                rows = torch.arange(first, first + WG_ROWS)
                qw = rows_of(q[bh], first, WG_ROWS)
                sq = rows_of(segq[b], first, WG_ROWS) if seg else None
                m = torch.full((WG_ROWS,), NEG_INF)
                l = torch.zeros(WG_ROWS)
                acc = torch.zeros(WG_ROWS, D)
                for j in range(n_tiles):
                    k0 = j * BK
                    cols = torch.arange(k0, k0 + BK)
                    s = qw @ rows_of(k[kvh], k0, BK).T * scale_log2
                    if seg or k0 + BK > T or (causal and k0 + BK - 1 > first):
                        sk = rows_of(segkv[b], k0, BK) if seg else None
                        keep = keep_mask(rows, cols, T, causal, sq, sk, False)
                    else:
                        keep = torch.ones(WG_ROWS, BK, dtype=torch.bool)
                    # a masked score is selected to -inf: p = exp2(-inf)
                    # is 0 exactly, since m is finite (NEG_INF at least)
                    s = torch.where(keep, s, -math.inf)
                    mx = torch.maximum(m, s.amax(1))
                    corr = torch.exp2(m - mx)
                    p = torch.exp2(s - mx[:, None])
                    l = l * corr + p.sum(1)
                    acc = acc * corr[:, None] + p @ rows_of(v[kvh], k0, BK)
                    m = mx
                n = max(0, min(WG_ROWS, T - first))
                out[bh, first:first + n] = (
                    acc / torch.where(l == 0, 1.0, l)[:, None])[:n]
                lse[bh, first:first + n] = torch.where(
                    l == 0, NEG_INF, m * LN2 + torch.log(l))[:n]
    return out, lse


def emulate_dq(q, k, v, do, lse, delta, segq, segkv, *, heads, group,
               causal):
    """``flash_bwd_dq_kernel``'s loops in float32: returns dQ."""
    BH, T, D = q.shape
    scale = D ** -0.5
    scale_log2 = scale * LOG2E
    dq = torch.zeros(BH, T, D)
    nq, nk = math.ceil(T / DQ_BQ), math.ceil(T / DQ_BK)
    seg = segq is not None
    for bh in range(BH):
        b, kvh = bh // heads, bh // group
        for i in paired_tiles(nq, late_heavy=True):
            q0 = i * DQ_BQ
            for first in range(q0, q0 + DQ_BQ, DQ_WG_ROWS):
                rows = torch.arange(first, first + DQ_WG_ROWS)
                # causal: kv tiles up to the diagonal of the warpgroup's
                # last row (the q tile's last one can lie wholly past it)
                n_tiles = (min(nk, (first + DQ_WG_ROWS - 1) // DQ_BK + 1)
                           if causal else nk)
                qw = rows_of(q[bh], first, DQ_WG_ROWS)
                dow = rows_of(do[bh], first, DQ_WG_ROWS)
                l2 = rows_of(lse[bh], first, DQ_WG_ROWS) * LOG2E
                dl = rows_of(delta[bh], first, DQ_WG_ROWS)
                sq = rows_of(segq[b], first, DQ_WG_ROWS) if seg else None
                acc = torch.zeros(DQ_WG_ROWS, D)
                for j in range(n_tiles):
                    k0 = j * DQ_BK
                    cols = torch.arange(k0, k0 + DQ_BK)
                    kt = rows_of(k[kvh], k0, DQ_BK)
                    s = qw @ kt.T
                    dp = dow @ rows_of(v[kvh], k0, DQ_BK).T
                    if (seg or k0 + DQ_BK > T
                            or (causal and k0 + DQ_BK - 1 > first)):
                        sk = rows_of(segkv[b], k0, DQ_BK) if seg else None
                        keep = keep_mask(rows, cols, T, causal, sq, sk, False)
                        # selected to -inf: p = exp2(-inf) is 0 exactly,
                        # even where lse is NEG_INF (a row with no key)
                        s = torch.where(keep, s, -math.inf)
                    p = torch.exp2(s * scale_log2 - l2[:, None])
                    ds = p * (dp - dl[:, None]) * scale
                    acc += ds @ kt
                n = max(0, min(DQ_WG_ROWS, T - first))
                dq[bh, first:first + n] = acc[:n]
    return dq


def emulate_dkv(q, k, v, do, lse, delta, segq, segkv, *, heads, group,
                causal):
    """``flash_bwd_dkv_kernel``'s loops in float32: returns (dK, dV)."""
    BH, T, D = q.shape
    BKV = k.shape[0]
    KVH = heads // group
    scale = D ** -0.5
    scale_log2 = scale * LOG2E
    dk = torch.zeros(BKV, T, D)
    dv = torch.zeros(BKV, T, D)
    nq = math.ceil(T / DKV_BQ)
    seg = segq is not None
    for kvr in range(BKV):
        b = kvr // KVH
        for j in paired_tiles(math.ceil(T / DKV_BKV), late_heavy=False):
            k0 = j * DKV_BKV
            i0 = k0 // DKV_BQ if causal else 0
            for first in range(k0, k0 + DKV_BKV, DKV_WG_ROWS):
                kvrows = torch.arange(first, first + DKV_WG_ROWS)
                kw = rows_of(k[kvr], first, DKV_WG_ROWS)
                vw = rows_of(v[kvr], first, DKV_WG_ROWS)
                sk = rows_of(segkv[b], first, DKV_WG_ROWS) if seg else None
                dk_acc = torch.zeros(DKV_WG_ROWS, D)
                dv_acc = torch.zeros(DKV_WG_ROWS, D)
                for g in range(group):
                    bh = kvr * group + g
                    for i in range(i0, nq):
                        q0 = i * DKV_BQ
                        if causal and q0 + DKV_BQ - 1 < first:
                            continue          # wholly in the past: skipped
                        qrows = torch.arange(q0, q0 + DKV_BQ)
                        qt = rows_of(q[bh], q0, DKV_BQ)
                        dot = rows_of(do[bh], q0, DKV_BQ)
                        l2 = rows_of(lse[bh], q0, DKV_BQ) * LOG2E
                        dl = rows_of(delta[bh], q0, DKV_BQ)
                        st = kw @ qt.T                     # Sᵀ (kv x q)
                        dpt = vw @ dot.T
                        if (seg or q0 + DKV_BQ > T
                                or first + DKV_WG_ROWS > T
                                or (causal
                                    and q0 < first + DKV_WG_ROWS - 1)):
                            sq = rows_of(segq[b], q0, DKV_BQ) if seg else None
                            # keep[kv, q] <=> q attends kv
                            keep = keep_mask(qrows, kvrows, T, causal, sq,
                                             sk, True).T
                        else:
                            keep = torch.ones(DKV_WG_ROWS, DKV_BQ,
                                              dtype=torch.bool)
                        st = torch.where(keep, st, -math.inf)
                        p = torch.exp2(st * scale_log2 - l2[None])
                        ds = p * (dpt - dl[None]) * scale
                        dv_acc += p @ dot
                        dk_acc += ds @ qt
                n = max(0, min(DKV_WG_ROWS, T - first))
                dk[kvr, first:first + n] = dk_acc[:n]
                dv[kvr, first:first + n] = dv_acc[:n]
    return dk, dv


def packed_segments(lengths, T):
    seg = np.zeros(T, np.int32)
    at = 0
    for i, n in enumerate(lengths, start=1):
        seg[at:at + n] = i
        at += n
    return seg


def make_inputs(seed, B, H, KVH, T, D, seg_lengths=None, orphans=None):
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((B, H, T, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, KVH, T, D)).astype(np.float32)
            for _ in range(2))
    segq = segkv = None
    if seg_lengths is not None:
        segkv = np.stack([packed_segments(s, T) for s in seg_lengths])
        segq = segkv.copy()
        if orphans is not None:
            segq[0, orphans[0]:orphans[1]] = 99    # rows that match no key
    return q, k, v, do, segq, segkv


def bh(a):
    """(B, H, T, D) numpy -> the kernels' (B·H, T, D) float32 tensor."""
    B, H, T, D = a.shape
    return torch.from_numpy(np.array(a)).reshape(B * H, T, D)


def tseg(s):
    return None if s is None else torch.from_numpy(s)


# ---------------------------------------------------------------------
# against JAX's Pallas kernels (interpreted), T = 256
# ---------------------------------------------------------------------

JAX_CASES = {
    "causal_mha": dict(H=2, KVH=2, causal=True),
    "noncausal_gqa2": dict(H=4, KVH=2, causal=False),
    "causal_gqa4_segments_orphans": dict(
        H=4, KVH=1, causal=True, seg=[(100, 90, 66), (256,)],
        orphans=(130, 140)),
}


def jax_case(name, T=256, D=32, block=128):
    c = JAX_CASES[name]
    q, k, v, do, segq, segkv = make_inputs(
        20 + list(JAX_CASES).index(name), 2, c["H"], c["KVH"], T, D,
        c.get("seg"), c.get("orphans"))
    group = c["H"] // c["KVH"]
    jseg = [None if s is None else jnp.array(s) for s in (segq, segkv)]
    jq, jk, jv, jdo = (jnp.array(a) for a in (q, k, v, do))
    out, lse = _flash_call(jq, jk, jv, *jseg, c["causal"], block, block,
                           group, True)
    out, lse = np.array(out), np.array(lse)
    return c, group, (q, k, v, do, segq, segkv), (jq, jk, jv, jdo, jseg), \
        out, lse


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_fwd_schedule_matches_pallas(name):
    c, group, (q, k, v, _, segq, segkv), _, out, lse = jax_case(name)
    B, H, T, D = q.shape
    got_o, got_lse = emulate_fwd(bh(q), bh(k), bh(v), tseg(segq),
                                 tseg(segkv), heads=H, group=group,
                                 causal=c["causal"])
    np.testing.assert_allclose(got_o.numpy(), out.reshape(B * H, T, D),
                               **TOL)
    np.testing.assert_allclose(got_lse.numpy(), lse.reshape(B * H, T),
                               **TOL)
    if "orphans" in c:
        lo, hi = c["orphans"]
        assert np.all(got_o.view(B, H, T, D)[0, :, lo:hi].numpy() == 0.0)
        assert np.all(got_lse.view(B, H, T)[0, :, lo:hi].numpy() == NEG_INF)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_dq_schedule_matches_pallas(name):
    c, group, (q, k, v, do, segq, segkv), jx, out, lse = jax_case(name)
    jq, jk, jv, jdo, jseg = jx
    B, H, T, D = q.shape
    res = (jq, jk, jv, *jseg, jnp.array(out), jnp.array(lse))
    pq = _flash_bwd_pallas(c["causal"], 128, 128, group, True, res, jdo)[0]
    delta = (bh(do) * bh(out)).sum(-1)
    got = emulate_dq(
        bh(q), bh(k), bh(v), bh(do), torch.from_numpy(lse.copy()).reshape(
            B * H, T), delta, tseg(segq), tseg(segkv), heads=H,
        group=group, causal=c["causal"])
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(pq).reshape(
        got.shape), **TOL)
    if "orphans" in c:
        lo, hi = c["orphans"]
        assert np.all(got.view(B, H, T, D)[0, :, lo:hi].numpy() == 0.0)


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_dkv_schedule_matches_pallas(name):
    c, group, (q, k, v, do, segq, segkv), jx, out, lse = jax_case(name)
    jq, jk, jv, jdo, jseg = jx
    B, H, T, D = q.shape
    res = (jq, jk, jv, *jseg, jnp.array(out), jnp.array(lse))
    _, pk, pv = _flash_bwd_pallas(c["causal"], 128, 128, group, True, res,
                                  jdo)[:3]
    delta = (bh(do) * bh(out)).sum(-1)
    got_k, got_v = emulate_dkv(
        bh(q), bh(k), bh(v), bh(do), torch.from_numpy(lse.copy()).reshape(
            B * H, T), delta, tseg(segq), tseg(segkv), heads=H,
        group=group, causal=c["causal"])
    np.testing.assert_allclose(got_k.numpy(), np.asarray(pk).reshape(
        got_k.shape), **TOL)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(pv).reshape(
        got_v.shape), **TOL)


# ---------------------------------------------------------------------
# against the port's plain versions, ragged T
# ---------------------------------------------------------------------

SEGMENTS = {40: [(15, 25), (40,)], 130: [(40, 50, 40), (70, 60)],
            200: [(70, 60, 70), (120, 80)]}
RAGGED = [(T, g, True) for T in (40, 130, 200) for g in (1, 2, 4)] + [
    (130, 2, False), (200, 4, False)]


def ragged_case(T, group, causal, D=64, B=2, KVH=1):
    H = KVH * group
    seg = SEGMENTS[T] if causal else None
    q, k, v, do, segq, segkv = make_inputs(
        1000 + 10 * T + group, B, H, KVH, T, D, seg,
        (5, 9) if causal else None)
    return H, bh(q), bh(k), bh(v), bh(do), tseg(segq), tseg(segkv)


@pytest.mark.parametrize("T,group,causal", RAGGED)
def test_fwd_schedule_matches_plain_ragged(T, group, causal):
    H, q, k, v, _, segq, segkv = ragged_case(T, group, causal)
    kw = dict(heads=H, group=group, causal=causal)
    got_o, got_lse = emulate_fwd(q, k, v, segq, segkv, **kw)
    ref_o, ref_lse = fa.flash_attention_reference_bh(q, k, v, segq, segkv,
                                                     **kw)
    np.testing.assert_allclose(got_o.numpy(), ref_o.numpy(), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), ref_lse.numpy(), **TOL)
    if segq is not None:
        assert np.all(got_o[:H, 5:9].numpy() == 0.0)
        assert np.all(got_lse[:H, 5:9].numpy() == NEG_INF)


@pytest.mark.parametrize("T,group,causal", RAGGED)
def test_dq_schedule_matches_plain_ragged(T, group, causal):
    H, q, k, v, do, segq, segkv = ragged_case(T, group, causal)
    kw = dict(heads=H, group=group, causal=causal)
    out, lse = fa.flash_attention_reference_bh(q, k, v, segq, segkv, **kw)
    delta = (do * out).sum(-1)
    got = emulate_dq(q, k, v, do, lse, delta, segq, segkv, **kw)
    ref, _, _ = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, segq, segkv, **kw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL)
    if segq is not None:            # rows that match no key: dQ = 0
        assert np.all(got[:H, 5:9].numpy() == 0.0)


@pytest.mark.parametrize("T,group,causal", RAGGED)
def test_dkv_schedule_matches_plain_ragged(T, group, causal):
    H, q, k, v, do, segq, segkv = ragged_case(T, group, causal)
    kw = dict(heads=H, group=group, causal=causal)
    out, lse = fa.flash_attention_reference_bh(q, k, v, segq, segkv, **kw)
    delta = (do * out).sum(-1)
    got_k, got_v = emulate_dkv(q, k, v, do, lse, delta, segq, segkv, **kw)
    _, ref_k, ref_v = fa.flash_attention_bwd_reference(
        q, k, v, out, lse, do, segq, segkv, **kw)
    assert torch.isfinite(got_k).all() and torch.isfinite(got_v).all()
    np.testing.assert_allclose(got_k.numpy(), ref_k.numpy(), **TOL)
    np.testing.assert_allclose(got_v.numpy(), ref_v.numpy(), **TOL)


def test_tile_sizes_are_the_kernels():
    """The constants the emulation walks with are the sources' own, fit
    the kernels' warpgroup split, and keep dq within its budgets."""
    assert (BQ, BK, WG_ROWS) == (128, 128, 64)
    assert (DQ_BQ, DQ_BK, DQ_WG_ROWS) == (128, 64, 64)
    assert (DKV_BKV, DKV_BQ, DKV_WG_ROWS) == (128, 64, 64)
    assert BQ % WG_ROWS == 0 and DKV_BKV % DKV_WG_ROWS == 0
    assert DQ_BQ == 2 * DQ_WG_ROWS and DQ_WG_ROWS % DQ_BK == 0
    assert FWD["STAGES"] >= 2 and DKV["DKV_STAGES"] >= 2
    # dq holds K over two sections (S_j, then dQ += dS_j·K_j), so its
    # ring is one deeper than the forward's
    assert DKV["DQ_STAGES"] >= 3
    assert DKV["DQ_THREADS"] == 3 * 128
    # dq at D = 128: registers a consumer thread (S, dP, dQ fp32 and the
    # bf16 dS operand) under setmaxnreg's 240; shared memory (both q
    # tiles' Q and dO, the K/V stages, segment ids, 14 barriers, 1024
    # bytes of alignment slack) under the 232,448 bytes a block may use
    D = 128
    regs = DQ_BK // 2 + DQ_BK // 2 + D // 2 + DQ_BK // 16 * 4
    assert regs == 144 and regs <= DKV["CONSUMER_REGS"] == 240
    smem = (2 * 2 * DQ_BQ * D * 2
            + DKV["DQ_STAGES"] * (2 * DQ_BK * D * 2 + DQ_BK * 4)
            + 8 * (2 + 4 * DKV["DQ_STAGES"]) + 1024)
    assert smem <= 232448


# ---------------------------------------------------------------------
# rows above the kernels' grid bound: the wrappers' chunk plan
# ---------------------------------------------------------------------

def test_row_bound_is_the_kernels():
    """``GRID_ROWS_MAX`` is the bound every C entry point enforces (the
    kernels put B·H, or B·KVH for dK/dV, on grid y)."""
    fwd = re.findall(r"BH > (\d+)", (CSRC / "flash_fwd.cu").read_text())
    bwd = re.findall(r"rows > (\d+)", (CSRC / "flash_bwd.cu").read_text())
    assert fwd == bwd == [str(fa.GRID_ROWS_MAX)]


@pytest.mark.parametrize("heads,group", [(32, 1), (32, 4), (32, 8),
                                         (40, 1), (8, 8), (1, 1)])
@pytest.mark.parametrize("B", [1, 2047, 2048, 2100, 6000])
def test_row_chunk_plan_covers_every_row_once(B, heads, group):
    """Every q row exactly once, in order; each launch whole batch rows
    (a multiple of ``heads``, so segment rows and the kv row
    ``bh // group`` stay whole) and within the bound for its q rows and
    its kv rows; as few launches as the bound allows."""
    limit, BH = fa.GRID_ROWS_MAX, B * heads
    chunks = fa.row_chunks(BH, heads)
    starts = [a for a, _ in chunks]
    stops = [b for _, b in chunks]
    assert starts[0] == 0 and stops[-1] == BH and starts[1:] == stops[:-1]
    for a, b in chunks:
        assert a % heads == 0 and b % heads == 0 and a % group == 0
        assert 0 < b - a <= limit and (b - a) // group <= limit
    per = limit // heads * heads
    assert len(chunks) == -(-BH // per)
    assert (len(chunks) == 1) == (BH <= limit)
    with pytest.raises(ValueError, match="heads"):
        fa.row_chunks(10, 5, limit=4)


@pytest.mark.parametrize("group", [1, 2, 4])
def test_chunked_launches_compose_to_the_whole(monkeypatch, group):
    """The views each launch gets (q, kv, δ/lse rows and segment rows)
    give, launch by launch through the plain versions, the whole call's
    result: forward, dQ and dK/dV, at a bound of three batch rows."""
    B, H, T, D = 7, 4, 40, 16
    KVH = H // group
    q, k, v, do, segq, segkv = make_inputs(
        11, B, H, KVH, T, D, seg_lengths=[(15, 25)] * B, orphans=(5, 9))
    q, k, v, do = bh(q), bh(k), bh(v), bh(do)
    segq, segkv = tseg(segq), tseg(segkv)
    kw = dict(heads=H, group=group, causal=True)
    out, lse = fa.flash_attention_reference_bh(q, k, v, segq, segkv, **kw)
    grads = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, segq,
                                             segkv, **kw)
    monkeypatch.setattr(fa, "GRID_ROWS_MAX", 3 * H)
    parts = list(fa._chunks(B * H, H, group, segq, segkv))
    assert len(parts) == 3
    got_o, got_l = torch.empty_like(out), torch.empty_like(lse)
    got = [torch.empty_like(g) for g in grads]
    for qs, ks, sq, skv in parts:
        o, l = fa.flash_attention_reference_bh(q[qs], k[ks], v[ks], sq, skv,
                                               **kw)
        got_o[qs], got_l[qs] = o, l
        dq, dk, dv = fa.flash_attention_bwd_reference(
            q[qs], k[ks], v[ks], o, l, do[qs], sq, skv, **kw)
        got[0][qs], got[1][ks], got[2][ks] = dq, dk, dv
    assert torch.equal(got_o, out) and torch.equal(got_l, lse)
    for g, r in zip(got, grads):
        assert torch.equal(g, r)
