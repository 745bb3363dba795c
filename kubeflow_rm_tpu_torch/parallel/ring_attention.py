"""Ring attention: sequence-parallel exact attention over the ``sp`` axis
(counterpart of ``kubeflow_rm_tpu/parallel/ring_attention.py``).

Each rank holds a contiguous sequence chunk of Q, K and V. K/V chunks
rotate around the ring with ``collectives.ppermute`` while every rank
folds the visiting chunk into a running flash-style online softmax (m,
l, o accumulators in float32). After ``sp`` folds every query has
attended to every key exactly once; memory stays O(T/sp) per rank.

Causality is enforced with global positions, so the math is exact for
any contiguous sharding; fully-future chunks still visit (the schedule
is uniform) but their scores are masked. Each fold runs under
non-reentrant ``torch.utils.checkpoint`` (JAX's ``jax.checkpoint(step)``),
so the backward recomputes block scores instead of saving ``sp`` score
tensors. It is plain PyTorch, an einsum online softmax like JAX's XLA
one: no kernel runs here.

The rotation skips the last hop of JAX's scan (whose result nothing
reads): ``sp - 1`` sends, the same outputs and gradients.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from kubeflow_rm_tpu_torch.ops.attention import NEG_INF, attention_mask
from kubeflow_rm_tpu_torch.parallel.collectives import ppermute
from kubeflow_rm_tpu_torch.parallel.mesh import axis_group, axis_index


def _fold(qf, kc, vc, o, m, l, pos_q, pos_kc, seg_q, seg_kc, causal):
    """Fold one visiting K/V chunk into the accumulators."""
    Tq, Tk = qf.shape[1], kc.shape[1]
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, kc.float())
    mask = attention_mask(Tq, Tk, causal=causal, positions_q=pos_q,
                          positions_kv=pos_kc, segment_ids_q=seg_q,
                          segment_ids_kv=seg_kc)
    if mask is not None:
        s = torch.where(mask[:, None, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if mask is not None:
        # a row whose visible keys so far are none has m = NEG_INF, and
        # exp(s - m) = 1 would attend to masked keys: zero them
        p = torch.where(mask[:, None, None], p, 0.0)
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    pv = torch.einsum("bkgqs,bskd->bkgqd", p, vc.float())
    return o * corr[..., None] + pv, m_new, l_new


def finish(o: torch.Tensor, l: torch.Tensor, dtype) -> torch.Tensor:
    """(B, KVH, G, Tq, D) accumulators -> (B, Tq, H, D); a query with no
    visible key anywhere (l == 0) gives zeros."""
    B, KVH, G, Tq, D = o.shape
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, KVH * G, D).to(dtype)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    group,
    causal: bool = True,
    positions_q: torch.Tensor | None = None,
    positions_kv: torch.Tensor | None = None,
    segment_ids_q: torch.Tensor | None = None,
    segment_ids_kv: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention over sequence shards, on this rank's local chunks.

    Args:
      q: (B, Tloc, H, D) local query chunk.
      k, v: (B, Tloc, KVH, D) local key/value chunks.
      group: the ``sp`` process group (rank i holds chunk i).
      positions_q / positions_kv: (B, Tloc) global positions of the local
        chunk; default: contiguous equal chunks in ring order.
      segment_ids_q / segment_ids_kv: optional (B, Tloc) segment ids;
        attention is restricted to equal segments (one given: both).

    Returns:
      (B, Tloc, H, D) local attention output in q.dtype.
    """
    n = dist.get_world_size(group)
    my = dist.get_rank(group)
    B, Tq, H, D = q.shape
    _, Tk, KVH, _ = k.shape
    if H % KVH:
        raise ValueError(f"n_heads {H} not divisible by n_kv_heads {KVH}")
    G = H // KVH
    dev = q.device
    if positions_q is None:
        positions_q = (my * Tq + torch.arange(
            Tq, dtype=torch.int32, device=dev)).expand(B, Tq)
    if positions_kv is None:
        positions_kv = (my * Tk + torch.arange(
            Tk, dtype=torch.int32, device=dev)).expand(B, Tk)
    if segment_ids_q is not None or segment_ids_kv is not None:
        if segment_ids_q is None:
            segment_ids_q = segment_ids_kv
        if segment_ids_kv is None:
            segment_ids_kv = segment_ids_q

    qf = (q.float() * D ** -0.5).reshape(B, Tq, KVH, G, D)
    o = q.new_zeros((B, KVH, G, Tq, D), dtype=torch.float32)
    m = torch.full((B, KVH, G, Tq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, KVH, G, Tq), dtype=torch.float32, device=dev)
    kc, vc, pos_kc, seg_kc = k, v, positions_kv, segment_ids_kv
    for step in range(n):
        o, m, l = checkpoint(_fold, qf, kc, vc, o, m, l, positions_q,
                             pos_kc, segment_ids_q, seg_kc, causal,
                             use_reentrant=False, preserve_rng_state=False)
        if step + 1 < n:
            kc, vc = ppermute(kc, group), ppermute(vc, group)
            pos_kc = ppermute(pos_kc, group)
            if seg_kc is not None:
                seg_kc = ppermute(seg_kc, group)
    return finish(o, l, q.dtype)


def local_positions(mesh, B: int, T_loc: int, device) -> torch.Tensor:
    """Global positions (B, T_loc) of this rank's contiguous ``sp``
    chunk: JAX's ``arange(T)`` sharded over ``sp``."""
    start = axis_index(mesh, "sp") * T_loc
    return (start + torch.arange(T_loc, dtype=torch.int32,
                                 device=device)).expand(B, T_loc)


def ring_self_attention(q, k, v, mesh, *, causal: bool = True,
                        positions: torch.Tensor | None = None,
                        segments: torch.Tensor | None = None):
    """``ring_attention`` over ``mesh``'s ``sp`` axis, on local chunks
    (q (B, T/sp, H, D), k/v (B, T/sp, KVH, D), optional positions and
    segments (B, T/sp)). With segments and no positions the positions
    are the global ``arange``, as JAX's wrapper makes them."""
    group = axis_group(mesh, "sp")
    if positions is None and segments is not None:
        positions = local_positions(mesh, q.shape[0], q.shape[1], q.device)
    return ring_attention(q, k, v, group=group, causal=causal,
                          positions_q=positions, positions_kv=positions,
                          segment_ids_q=segments, segment_ids_kv=segments)
