"""Ulysses-style sequence parallelism: all-to-all over the ``sp`` axis
(counterpart of ``kubeflow_rm_tpu/parallel/ulysses.py``).

Where the ring rotates K/V chunks and keeps heads whole, Ulysses
re-shards with two all-to-alls: heads scatter across ``sp`` while the
sequence gathers, so each rank runs ordinary full-sequence attention on
H/sp heads — the port's flash op, so ``flash_fwd`` (and in training
``flash_bwd_dq``/``flash_bwd_dkv``) runs unmodified on (B, T, H/sp, D)
— then the inverse all-to-all restores the sequence layout.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from kubeflow_rm_tpu_torch.ops.attention import dot_product_attention
from kubeflow_rm_tpu_torch.parallel.collectives import (
    all_gather, all_to_all,
)
from kubeflow_rm_tpu_torch.parallel.mesh import axis_group
from kubeflow_rm_tpu_torch.parallel.ring_attention import local_positions


def ulysses_attention(
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
    impl: str = "auto",
) -> torch.Tensor:
    """Sequence-parallel attention via head/sequence all-to-all, on this
    rank's local chunks: q (B, Tloc, H, D), k/v (B, Tloc, KVH, D),
    optional positions/segments (B, Tloc). Requires ``H % sp == 0``; KV
    heads that do not divide ``sp`` are repeated up to H first (GQA
    loses its K/V memory saving across the scatter, never correctness).

    Returns the local (B, Tloc, H, D) output chunk.
    """
    n = dist.get_world_size(group)
    H, KVH = q.shape[2], k.shape[2]
    if H % n:
        raise ValueError(
            f"ulysses needs sp ({n}) to divide n_heads ({H})")
    if KVH % n:
        reps = H // KVH
        k = torch.repeat_interleave(k, reps, dim=2)
        v = torch.repeat_interleave(v, reps, dim=2)

    # scatter heads, gather sequence: (B, Tloc, H, D) -> (B, T, H/sp, D)
    qg = all_to_all(q, group, split_dim=2, concat_dim=1)
    kg = all_to_all(k, group, split_dim=2, concat_dim=1)
    vg = all_to_all(v, group, split_dim=2, concat_dim=1)

    def gather_seq(x):
        return None if x is None else all_gather(x, group, 1)

    out = dot_product_attention(
        qg, kg, vg, causal=causal,
        positions_q=gather_seq(positions_q),
        positions_kv=gather_seq(positions_kv),
        segment_ids_q=gather_seq(segment_ids_q),
        segment_ids_kv=gather_seq(segment_ids_kv),
        impl=impl,
    )
    # inverse: scatter sequence, gather heads
    return all_to_all(out, group, split_dim=1, concat_dim=2)


def ulysses_self_attention(q, k, v, mesh, *, causal: bool = True,
                           positions: torch.Tensor | None = None,
                           segments: torch.Tensor | None = None,
                           impl: str = "auto"):
    """``ulysses_attention`` over ``mesh``'s ``sp`` axis, on local chunks
    (mirror of ``ring_self_attention``). With segments and no positions
    the positions are the global ``arange``, as JAX's wrapper makes
    them."""
    if positions is None and segments is not None:
        positions = local_positions(mesh, q.shape[0], q.shape[1], q.device)
    return ulysses_attention(q, k, v, group=axis_group(mesh, "sp"),
                             causal=causal, positions_q=positions,
                             positions_kv=positions, segment_ids_q=segments,
                             segment_ids_kv=segments, impl=impl)
