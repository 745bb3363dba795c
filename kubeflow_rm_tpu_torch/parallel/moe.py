"""Mixture-of-experts layer, dense dispatch (counterpart of
``kubeflow_rm_tpu/parallel/moe.py``), on one device.

Routing builds static-shaped ``(tokens, E, C)`` dispatch and combine
tensors and the expert FFN runs as batched products over the expert
axis (the GShard/Switch formulation): no ragged shapes and no
data-dependent control flow. Capacity-dropped tokens fall through on the
residual path; the auxiliary load-balancing loss keeps routing uniform.
The expert products are batched matmuls (``torch.einsum``, and
``models.remat.project`` for the two whose outputs the remat policies
name), as the JAX package computes them in XLA outside any Pallas
kernel. On a mesh (``moe_ffn(..., view=)``) the experts are split
over ``ep`` and routing runs over the global token axis. ``moe_ffn``
names its four parts as spans (``utils.profiling.annotate``):
``moe.route``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from kubeflow_rm_tpu_torch.parallel.collectives import (
    all_reduce, copy_to_group,
)
from kubeflow_rm_tpu_torch.utils.profiling import annotate


@dataclass(frozen=True)
class MoeConfig:
    n_experts: int = 8
    top_k: int = 2
    # per-expert slots = ceil(top_k * tokens * capacity_factor / E)
    capacity_factor: float = 1.25
    # weight of the load-balancing aux loss in the training objective
    router_aux_weight: float = 0.01


def expert_capacity(cfg: MoeConfig, n_tokens: int) -> int:
    cap = math.ceil(cfg.top_k * n_tokens * cfg.capacity_factor
                    / cfg.n_experts)
    return max(cap, 1)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values in
    descending order, the lower index first among equal values (a
    stable descending sort; ``torch.topk`` makes no promise on ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(router_logits: torch.Tensor, cfg: MoeConfig, capacity: int, *,
          offsets=None, n_global: int | None = None, reduce=None):
    """Top-k routing with per-expert capacity.

    ``router_logits`` (N, E). Returns ``dispatch`` (N, E, C) 0/1 (token
    n holds slot c of expert e), ``combine`` (N, E, C) float32 (dispatch
    weighted by the renormalised top-k gate) and the Switch aux loss
    ``E · Σ_e frac_routed_e · mean_prob_e``. Priority is (slot, token):
    slot 0 (the argmax choice) of every token claims capacity before any
    token's slot 1, then token order breaks ties.

    On a mesh the token axis is global (``sharded.MeshView.moe_route``):
    ``offsets(onehot)`` maps the local (N, k, E) choices to each choice's
    position within its expert in the global (slot, token) order,
    ``reduce`` sums a per-rank statistic over the ranks and ``n_global``
    is the global token count. Without them the N tokens are all.
    """
    N, E = router_logits.shape
    k = cfg.top_k
    probs = torch.softmax(router_logits.float(), dim=-1)
    gate_vals, expert_idx = top_k(probs, k)                   # (N, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    onehot = F.one_hot(expert_idx, E).to(torch.int32)         # (N, k, E)
    if offsets is None:
        slot_major = onehot.transpose(0, 1).reshape(k * N, E)
        pos = torch.cumsum(slot_major, dim=0) - 1             # within expert
        pos = pos.reshape(k, N, E).transpose(0, 1)
    else:
        pos = offsets(onehot)
    pos = (pos * onehot).sum(-1)                              # (N, k)
    # one_hot of an index past the capacity is all zeros (jax.nn.one_hot)
    slots = torch.arange(capacity, device=pos.device)
    slot_onehot = (pos[..., None] == slots).float()           # (N, k, C)
    dispatch_k = onehot[..., None].float() * slot_onehot[:, :, None, :]
    dispatch = dispatch_k.sum(1)                              # (N, E, C)
    combine = (dispatch_k * gate_vals[..., None, None]).sum(1)

    # load balance: the fraction of tokens whose top choice is e times
    # the mean router probability of e (differentiable through probs)
    top = onehot[:, 0, :].float()
    if reduce is None:
        frac_routed, mean_prob = top.mean(0), probs.mean(0)
    else:
        frac_routed = reduce(top.sum(0)) / n_global
        mean_prob = reduce(probs.sum(0)) / n_global
    aux_loss = E * (frac_routed * mean_prob).sum()
    return dispatch, combine, aux_loss


def moe_param_shapes(cfg: MoeConfig, dim: int, hidden: int) -> dict:
    E = cfg.n_experts
    return {
        "router": (dim, E),
        "moe_gate": (E, dim, hidden),
        "moe_up": (E, dim, hidden),
        "moe_down": (E, hidden, dim),
    }


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoeConfig,
            dtype: torch.dtype = torch.bfloat16, *, view=None):
    """SwiGLU expert FFN: x (B, T, D) -> ((B, T, D), aux loss).

    The router runs in float32 (routing decisions should not flip with
    bf16 rounding); the experts run in ``dtype``. Capacity is per call:
    N = B·T tokens share ``expert_capacity(cfg, N)`` slots an expert.

    ``view`` (a ``sharded.MeshView``): ``params`` and the routing are
    this rank's on a mesh. The view gathers the weights and the router's
    expert columns, routes over the global token axis, keeps this rank's
    experts (ep) and ends the tp-split expert product and the ep combine
    in their all-reduces; x is replicated over ep and tp.
    """
    # imported here: models.remat lives in the models package, which
    # imports this module through models.mixtral
    from kubeflow_rm_tpu_torch.models.remat import checkpoint_name, project

    B, T, D = x.shape
    N = B * T
    xf = x.reshape(N, D)
    if view is None:
        def weight(name):
            return params[name].to(dtype)

        router, over = params["router"], {}
    else:
        def weight(name):
            return view.weight(f"blocks/{name}", params[name], dtype)

        router, over = view.moe_router(params), view.moe_route(B, T)
    with annotate("moe.route"):
        logits = xf.float() @ router.float()
        dispatch, combine, aux = route(
            logits, cfg, expert_capacity(cfg, over.get("n_global", N)),
            **over)
        if view is not None:
            dispatch, combine, xf = view.moe_local(dispatch, combine, xf)

    with annotate("moe.dispatch"):
        expert_in = torch.einsum("nec,nd->ecd", dispatch.to(dtype),
                                 xf.to(dtype))
        if view is not None:
            expert_in = copy_to_group(expert_in, view.g_tp)
    with annotate("moe.experts"):
        # the dense MLP's names, so the named remat policies ("mlp",
        # "attn+mlp") save the expert activations as they save the
        # MLP's; ``project`` lets their replay skip the products that
        # made them
        gate = checkpoint_name(project(
            expert_in, weight("moe_gate"), "moe_gate"), "mlp_gate")
        up = checkpoint_name(project(
            expert_in, weight("moe_up"), "moe_up"), "mlp_up")
        h = F.silu(gate) * up
        expert_out = torch.einsum("ecf,efd->ecd", h, weight("moe_down"))
        if view is not None:
            expert_out = all_reduce(expert_out, view.g_tp)
    with annotate("moe.combine"):
        out = torch.einsum("nec,ecd->nd", combine.to(dtype), expert_out)
        if view is not None:
            out = all_reduce(out, view.g_ep)
    return out.reshape(B, T, D), aux
