"""Pipeline parallelism: the GPipe microbatch schedule over the ``pp``
axis (counterpart of ``kubeflow_rm_tpu/parallel/pipeline.py``).

The layer stack is split into ``pp`` contiguous stages: each rank holds
its stage's ``L/pp`` layers of every stacked leaf (``sharding``'s rules
put the layer axis on ``pp``). Microbatches flow stage to stage over
M + pp - 1 ticks; at each tick every stage runs its layers on the
microbatch it holds and hands the activation to the next stage with one
``collectives.ppermute``. The bubble is GPipe's (pp-1)/(M+pp-1).

The schedule is JAX's, predicated, not branched: every rank builds the
same autograd graph. Stage 0's input is ``where(stage == 0, microbatch,
received)``, bubble ticks compute on a clamped microbatch whose result
nothing keeps, and the last stage's outputs are written through a mask.
So every rank runs every ``ppermute``'s backward, in the same order,
and the point-to-point ring cannot hang (a stage that skipped its bubble
work, or left what it received unused, would drop those nodes from its
backward while its neighbours wait for them).

Inside a stage the rank computes with the fsdp gathers, tp heads and ep
experts of ``sharded.MeshView``, each block under the family's remat
wrapper. The pp-replicated leaves need two things: the embedding's
output enters the schedule through ``copy_to_group`` over ``pp``, whose
backward sums stage 0's gradient to every stage, and the epilogue (final
norm, head) runs on every rank on the broadcast outputs, so its
gradients are alike on every pp rank and are not summed over pp.
"""

from __future__ import annotations

from functools import partial

import torch

from kubeflow_rm_tpu_torch.parallel.collectives import (
    all_reduce, copy_to_group, ppermute,
)
from kubeflow_rm_tpu_torch.parallel.mesh import axis_size


def pipeline_forward(params: dict, tokens: torch.Tensor, cfg, mesh, **kw):
    """Causal LM forward pipelined over ``pp``; logits only (dense
    families). See ``pipeline_forward_with_aux`` for the contract."""
    return pipeline_forward_with_aux(params, tokens, cfg, mesh, **kw)[0]


def pipeline_forward_with_aux(
    params: dict,
    tokens: torch.Tensor,
    cfg,
    mesh,
    *,
    n_microbatches: int | None = None,
    positions: torch.Tensor | None = None,
    segments: torch.Tensor | None = None,
    packed: bool = False,
    impl: str = "auto",
    local_vocab: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Causal LM forward with the layer stack pipelined over ``pp``.

    ``params`` are this rank's shards and ``tokens`` (and ``positions``,
    ``segments``) its rows, as for ``forward(..., mesh=)``. Returns
    ``(logits, router_aux)``: the logits of this rank's rows (its tp
    share of the vocabulary with ``local_vocab``), alike on every pp
    rank, and for Mixtral the router aux loss as the mean over (layer,
    microbatch) pairs (None for dense families). The math is the
    family's ``forward``; MoE's aux equals the forward's only at
    ``n_microbatches=1`` (the load-balance statistic is nonlinear in
    the batch). Requires ``cfg.n_layers % pp == 0`` and the rank's rows
    divisible by ``n_microbatches`` (default pp). At pp == 1 it is the
    family's ``forward``.
    """
    from kubeflow_rm_tpu_torch.models.llama import (
        _block, _epilogue, _prologue, layer_slices, remat_block,
    )
    from kubeflow_rm_tpu_torch.models.mixtral import (
        MixtralConfig, _moe_block,
    )
    from kubeflow_rm_tpu_torch.parallel.sharded import MeshView

    is_moe = isinstance(cfg, MixtralConfig)
    pp = axis_size(mesh, "pp")
    kw = dict(positions=positions, segments=segments, packed=packed,
              impl=impl, mesh=mesh, local_vocab=local_vocab)
    if pp == 1:
        from kubeflow_rm_tpu_torch.models import forward_with_aux

        return forward_with_aux(params, tokens, cfg, **kw)
    if cfg.n_layers % pp:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pp={pp}")
    B, T = tokens.shape
    # None -> one microbatch per stage, the least that keeps every stage
    # busy (make_train_step's default too)
    M = pp if n_microbatches is None else n_microbatches
    if B % M:
        raise ValueError(f"batch {B} not divisible by microbatches {M}")
    mb = B // M

    view = MeshView(mesh, cfg, params)
    x, cos, sin, attn_positions = _prologue(params, tokens, cfg, positions,
                                            packed, view)
    # only stage 0 reads the embedding: the backward's sum over pp gives
    # every stage the embedding's gradient
    x = copy_to_group(x, view.g_pp)

    # Interleaved fold, JAX's: microbatch m takes rows m, M+m, 2M+m, ...
    # of this rank's rows, which are the rank's share of JAX's global
    # microbatch m (the router's statistics see the same tokens)
    def fold(a):
        if a is None:
            return None
        return a.reshape(mb, M, *a.shape[1:]).transpose(0, 1)

    x_mb, cos_mb, sin_mb = fold(x), fold(cos), fold(sin)
    pos_mb, seg_mb = fold(attn_positions), fold(segments)

    # the (h, aux) contract: one schedule serves both families
    if is_moe:
        block_aux = remat_block(partial(_moe_block, cfg, view=view), cfg)
    else:
        dense = remat_block(partial(_block, cfg, view=view), cfg)

        def block_aux(h, *a):
            return dense(h, *a), None

    # this stage's layers, sliced once for every microbatch: a layer's
    # gradient sums over the microbatches in its slice, then enters the
    # stacked leaf's (llama.layer_slices)
    layers = layer_slices(params["blocks"])
    stage = view.stage

    def stage_apply(h, idx):
        def pick(a_mb):
            return None if a_mb is None else a_mb[idx]

        aux = None
        for layer in layers:
            h, a = block_aux(h, layer, cos_mb[idx], sin_mb[idx],
                             pick(pos_mb), pick(seg_mb), impl)
            aux = a if aux is None else aux + a
        return h, aux

    dev = x.device
    flags = {b: torch.tensor(b, device=dev) for b in (False, True)}
    recv = torch.zeros_like(x_mb[0])
    outs = [torch.zeros_like(x_mb[0]) for _ in range(M)]
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    n_ticks = M + pp - 1
    for t in range(n_ticks):
        # stage s holds microbatch t - s; the clamp keeps bubble ticks
        # on a valid (discarded) microbatch instead of branching
        idx = min(max(t - stage, 0), M - 1)
        inp = torch.where(flags[stage == 0], x_mb[idx], recv)
        out, aux = stage_apply(inp, idx)
        if t + 1 < n_ticks:
            recv = ppermute(out, view.g_pp, 1)
        if aux is not None:
            # bubble ticks' aux must not pollute the router loss
            valid = flags[0 <= t - stage <= M - 1]
            aux_total = aux_total + torch.where(valid, aux, 0.0)
        # the last stage finishes microbatch t - (pp - 1) at tick t
        w = min(max(t - (pp - 1), 0), M - 1)
        keep = flags[stage == pp - 1 and t >= pp - 1]
        outs[w] = torch.where(keep, out, outs[w])
    # every stage but the last kept zeros: the sum over pp is the last
    # stage's outputs on every rank (backward: the identity)
    h = all_reduce(torch.stack(outs), view.g_pp)
    h = h.transpose(0, 1).reshape(B, *h.shape[2:])  # inverse of the fold
    logits = _epilogue(params, h, cfg, view, local_vocab=local_vocab)
    if not is_moe:
        return logits, None
    # each (layer, microbatch) pair is counted once over the stages
    return logits, all_reduce(aux_total, view.g_pp) / (cfg.n_layers * M)
