"""Zigzag ring attention: causal sequence parallelism without waste
(counterpart of ``kubeflow_rm_tpu/parallel/zigzag_ring.py``).

The plain ring (``ring_attention``) masks fully-future blocks: with
contiguous chunks rank 0 needs 1 of the n visiting chunks and rank n−1
all n. The zigzag layout splits the global sequence into 2n chunks;
rank i holds the PAIR ``(chunk i, chunk 2n−1−i)``. At ring step s the
K/V pair of rank j = (i−s) mod n arrives, and causality decides per
sub-block:

  q-early(i)  × k-early(j): needed iff s ≤ i       (diagonal at s=0)
  q-early(i)  × k-late(j):  never (always future)
  q-late(i)   × k-early(j): always, fully visible
  q-late(i)   × k-late(j):  needed iff s = 0 or s > i  (diag at s=0)

Every rank folds exactly 2 sub-blocks a step. Skipping is real control
flow (Python branches on the static step and rank), not masking. Like
the plain ring it is an einsum online softmax in plain PyTorch: no
kernel runs here.

Layout contract: callers put the sequence in zigzag order
(``zigzag_permutation``) and run the model with explicit positions
(``zigzag_positions``) so RoPE stays correct; causality is then implied
by chunk ids. Packed segments are not supported (use the
position-aware plain ring).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from kubeflow_rm_tpu_torch.parallel.collectives import (
    all_gather, ppermute,
)
from kubeflow_rm_tpu_torch.parallel.mesh import axis_group, axis_index
from kubeflow_rm_tpu_torch.parallel.ring_attention import (
    finish, ring_attention,
)

NEG_INF = -2.0**30


# ---------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------

def zigzag_permutation(T: int, n: int) -> np.ndarray:
    """Natural → zigzag gather indices: result[t] = natural index held
    at zigzag position t. Rank i's shard is chunks (i, 2n−1−i)."""
    assert T % (2 * n) == 0, f"T={T} must split into 2n={2 * n} chunks"
    c = T // (2 * n)
    order = []
    for i in range(n):
        order.extend(range(i * c, (i + 1) * c))
        order.extend(range((2 * n - 1 - i) * c, (2 * n - i) * c))
    return np.asarray(order, dtype=np.int32)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size, dtype=perm.dtype)
    return inv


def zigzag_positions(T: int, n: int) -> np.ndarray:
    """Global positions of a zigzag-ordered sequence (feed to RoPE)."""
    return zigzag_permutation(T, n)


# ---------------------------------------------------------------------
# the local schedule
# ---------------------------------------------------------------------

def _block(qc, kc, vc, o, m, l, diag: bool):
    """Fold one (Tc × Tc) K/V block into a q-chunk's accumulators."""
    s = torch.einsum("bqkgd,bskd->bkgqs", qc, kc.float())
    if diag:
        Tc = qc.shape[1]
        tri = torch.ones((Tc, Tc), dtype=torch.bool,
                         device=qc.device).tril()
        s = torch.where(tri, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if diag:
        p = torch.where(tri, p, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p, vc.float())
    return o * corr[..., None] + pv, m_new, l_new


def _step(qe, ql, kc, vc, oe, me, le, ol, ml, ll, s: int, i: int):
    """One ring step's live sub-blocks (the schedule table above)."""
    ke, kl = kc[:, 0], kc[:, 1]
    ve, vl = vc[:, 0], vc[:, 1]
    if s == 0:
        oe, me, le = _block(qe, ke, ve, oe, me, le, diag=True)
    elif s <= i:
        oe, me, le = _block(qe, ke, ve, oe, me, le, diag=False)
    ol, ml, ll = _block(ql, ke, ve, ol, ml, ll, diag=False)
    if s == 0:
        ol, ml, ll = _block(ql, kl, vl, ol, ml, ll, diag=True)
    elif s > i:
        ol, ml, ll = _block(ql, kl, vl, ol, ml, ll, diag=False)
    return oe, me, le, ol, ml, ll


def zigzag_ring_attention(q, k, v, *, group, causal: bool = True):
    """Local shard attention; shards are zigzag pairs (early‖late).

    q: (B, Tloc, H, D), k/v: (B, Tloc, KVH, D) with Tloc = 2·chunk.
    Returns (B, Tloc, H, D): the exact attention output for this
    shard's tokens over the full global sequence.
    """
    if not causal:
        # no masked blocks to skip: the plain ring
        return ring_attention(q, k, v, group=group, causal=False)
    n = dist.get_world_size(group)
    i = dist.get_rank(group)
    B, Tloc, H, D = q.shape
    KVH = k.shape[2]
    if H % KVH:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads {KVH}")
    G = H // KVH
    Tc = Tloc // 2

    qf = (q.float() * D ** -0.5).reshape(B, 2, Tc, KVH, G, D)
    qe, ql = qf[:, 0], qf[:, 1]
    kc = k.reshape(B, 2, Tc, KVH, D)
    vc = v.reshape(B, 2, Tc, KVH, D)

    def zeros():
        return (q.new_zeros((B, KVH, G, Tc, D), dtype=torch.float32),
                torch.full((B, KVH, G, Tc), NEG_INF, dtype=torch.float32,
                           device=q.device),
                q.new_zeros((B, KVH, G, Tc), dtype=torch.float32))

    acc = (*zeros(), *zeros())
    for s in range(n):
        acc = checkpoint(_step, qe, ql, kc, vc, *acc, s, i,
                         use_reentrant=False, preserve_rng_state=False)
        if s + 1 < n:
            kc, vc = ppermute(kc, group), ppermute(vc, group)
    oe, _, le, ol, _, ll = acc
    return torch.cat([finish(oe, le, q.dtype), finish(ol, ll, q.dtype)],
                     dim=1)


# ---------------------------------------------------------------------
# the mesh wrapper
# ---------------------------------------------------------------------

def zigzag_ring_self_attention(q, k, v, mesh, *, causal: bool = True,
                               inputs_zigzag: bool = False):
    """``zigzag_ring_attention`` over ``mesh``'s ``sp`` axis, on local
    chunks.

    With ``inputs_zigzag=False`` the chunks are contiguous (natural
    order): the sequence is gathered, permuted into zigzag layout,
    attended, and each rank keeps its natural chunk of the result (two
    gathers, as JAX's two sharded gathers — fine for tests and one-off
    calls; put the whole model in zigzag order for training). With
    ``inputs_zigzag=True`` the caller already owns the layout.
    """
    group = axis_group(mesh, "sp")
    if inputs_zigzag:
        return zigzag_ring_attention(q, k, v, group=group, causal=causal)
    n, r = dist.get_world_size(group), axis_index(mesh, "sp")
    T_loc = q.shape[1]
    T = n * T_loc
    perm = torch.as_tensor(zigzag_permutation(T, n), device=q.device,
                           dtype=torch.long)
    inv = torch.as_tensor(inverse_permutation(zigzag_permutation(T, n)),
                          device=q.device, dtype=torch.long)
    mine = slice(r * T_loc, (r + 1) * T_loc)

    def to_zigzag(x):
        return all_gather(x, group, 1)[:, perm][:, mine]

    out = zigzag_ring_attention(to_zigzag(q), to_zigzag(k), to_zigzag(v),
                                group=group, causal=causal)
    return all_gather(out, group, 1)[:, inv][:, mine]
