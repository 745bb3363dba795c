"""Rematerialization policies (counterpart of ``_remat_policy`` and
``checkpoint_name`` in ``kubeflow_rm_tpu/models/llama.py``).

A block runs under ``torch.utils.checkpoint(use_reentrant=False)``; the
policy decides what its forward keeps for the backward:

- ``full``: only the block's inputs; the backward reruns the block.
- ``dots``: every projection output (``aten.mm``, no batch dims), as
  ``checkpoint_dots_with_no_batch_dims`` saves; attention's batched
  products and all elementwise work are recomputed.
- ``attn`` / ``mlp`` / ``attn+mlp``: the activations tagged with
  ``checkpoint_name`` (``_NAME_POLICIES``).

JAX prunes the recomputation to what the backward needs. Torch replays
the block in order (and stops once the last needed tensor is back), so
a projection whose output the backward never reads would run again for
nothing: one whose only consumer is a saved name, and ``w_down``, whose
only consumer is the residual add. The replay therefore runs such a
projection (``project``) without its product: it returns an
uninitialized tensor (for a saved name, the policy then hands back the
saved value). Its backward, which needs only ``h`` and ``w``, is exact.
(A plain ``aten.mm`` packs its saved inputs before it runs, so torch's
early stop would skip ``w_down`` by itself; ``project`` saves after its
forward, like any ``autograd.Function``, hence the explicit skip.) What
the replay recomputes is then JAX's set:
``full`` wq, wk, wv, wo, gate, up; ``dots`` none; ``attn`` wo, gate,
up; ``mlp`` wq, wk, wv, wo; ``attn+mlp`` wo (wo because the MLP's norm
needs ``x + wo(attn)``). In a MoE block (``parallel.moe``) the expert
gate and up products are ``project``s of batched weights too, named
``mlp_gate``/``mlp_up`` as the dense MLP's. The expert down product's
output is read by the combine's backward and no policy saves it, so
every policy recomputes it; ``dots``, which saves only unbatched
products (``aten.mm``), recomputes all three expert products, as JAX's
``checkpoint_dots_with_no_batch_dims`` does. The flash forward reruns
under every policy, because its lse is never a saved name, as in JAX.

Every policy's recompute of a block runs inside the ``remat.replay``
span (``utils.profiling.annotate``): a range in a profiler's trace that
dispatches no op, so the policy never sees it.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager, nullcontext
from functools import partial

import torch
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.checkpoint import (
    CheckpointPolicy, create_selective_checkpoint_contexts,
)

from kubeflow_rm_tpu_torch.utils.profiling import annotate

#: named-tensor remat presets (JAX's): save the listed activations,
#: recompute the rest in the backward
_NAME_POLICIES = {
    "attn": ("q_rope", "k_rope", "v_proj", "attn_out"),
    "attn+mlp": ("q_rope", "k_rope", "v_proj", "attn_out",
                 "mlp_gate", "mlp_up"),
    "mlp": ("mlp_gate", "mlp_up"),
}
REMAT_POLICIES = ("full", "dots", *_NAME_POLICIES)

#: the projections whose output alone makes each name (the dense MLP's
#: or the expert FFN's)
_NAME_SOURCE = {"q_rope": ("wq",), "k_rope": ("wk",), "v_proj": ("wv",),
                "mlp_gate": ("w_gate", "moe_gate"),
                "mlp_up": ("w_up", "moe_up")}

#: projections whose output the backward never reads
_UNREAD = frozenset({"w_down"})

#: projections the running replay may skip (empty outside a replay)
_SKIP: contextvars.ContextVar[frozenset] = contextvars.ContextVar(
    "kfrm_remat_skip", default=frozenset())


@torch.library.custom_op("kfrm::checkpoint_name", mutates_args=())
def _checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    return x.clone()


@_checkpoint_name.register_fake
def _(x, name):
    return torch.empty_like(x)


_checkpoint_name.register_autograd(lambda ctx, g: (g, None))


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """Tag ``x`` for the named policies (``jax.ad_checkpoint.
    checkpoint_name``): one op, ``kfrm::checkpoint_name``, that the
    policy recognises by its ``name``. A custom op may not return its
    input, so the tag is a copy; it is made only where autograd records
    (training), never in inference."""
    if not torch.is_grad_enabled():
        return x
    return _checkpoint_name(x, name)


class _Projection(torch.autograd.Function):
    """``h @ w`` whose forward may skip the product (``skip``) while its
    backward stays exact: it needs only ``h`` and ``w``. ``w`` is one
    (in, out) weight, or a batch (E, in, out) against ``h`` (E, C, in)."""

    @staticmethod
    def forward(ctx, h, w, skip):
        ctx.save_for_backward(h, w)
        if skip:
            # outside the checkpoint's dispatch modes: selective
            # checkpointing expects the replay to dispatch only ops the
            # forward did
            with _disable_current_modes():
                return h.new_empty((*h.shape[:-1], w.shape[-1]))
        return h @ w

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        gh = gw = None
        if ctx.needs_input_grad[0]:
            gh = g @ w.transpose(-2, -1)
        if ctx.needs_input_grad[1]:
            if w.dim() == 2:
                gw = (h.reshape(-1, h.shape[-1]).t()
                      @ g.reshape(-1, g.shape[-1]))
            else:
                gw = h.transpose(-2, -1) @ g
        return gh, gw, None


def project(h: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """The projection ``h @ w`` of weight ``name``: a plain product where
    autograd does not record, else ``_Projection``, skipped while a
    named-policy replay recomputes a name it alone produces."""
    if not torch.is_grad_enabled():
        return h @ w
    return _Projection.apply(h, w, name in _SKIP.get())


def _save_dots(ctx, func, *args, **kwargs):
    if func is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _save_names(names, ctx, func, *args, **kwargs):
    if func is torch.ops.kfrm.checkpoint_name.default and args[1] in names:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


@contextmanager
def _replay(sac_ctx, skip: frozenset):
    """The recompute context of every policy: the ``remat.replay`` span
    over the whole recompute of a block, the projections it may skip,
    and the policy's own context."""
    token = _SKIP.set(skip)
    try:
        with annotate("remat.replay"), sac_ctx:
            yield
    finally:
        _SKIP.reset(token)


def _full_contexts():
    return nullcontext(), _replay(nullcontext(), _UNREAD)


def _dots_contexts():
    fwd, rec = create_selective_checkpoint_contexts(_save_dots)
    return fwd, _replay(rec, frozenset())


def _named_contexts(names: frozenset):
    fwd, rec = create_selective_checkpoint_contexts(
        partial(_save_names, names))
    skip = _UNREAD | {w for n in names for w in _NAME_SOURCE.get(n, ())}
    return fwd, _replay(rec, skip)


def remat_context_fn(policy: str):
    """``context_fn`` for ``torch.utils.checkpoint`` under ``policy``."""
    if policy == "full":
        return _full_contexts
    if policy == "dots":
        return _dots_contexts
    if policy in _NAME_POLICIES:
        return partial(_named_contexts, frozenset(_NAME_POLICIES[policy]))
    raise ValueError(f"remat_policy must be one of "
                     f"{sorted(REMAT_POLICIES)}, got {policy!r}")
