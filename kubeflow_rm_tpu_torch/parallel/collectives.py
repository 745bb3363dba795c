"""Autograd-aware collectives over a process group (the port's
counterparts of ``lax.all_gather``, ``psum``, ``ppermute`` and
``all_to_all`` inside JAX's ``shard_map``).

JAX runs one controller over global arrays and GSPMD inserts the
collectives; the port runs one process per card on its local shards, so
the model calls these explicitly. Each is a ``torch.autograd.Function``
whose backward is the collective that carries the gradient back:

- ``all_gather``: gather ``dim`` / backward reduce-scatter (summing);
  for a parameter whose ranks each use the whole gathered weight on
  different data (fsdp);
- ``reduce_scatter``: reduce-scatter / backward all-gather;
- ``all_reduce``: sum / backward identity (Megatron's *g*: the end of a
  row-parallel product, whose output every rank then uses alike);
- ``copy_to_group``: identity / backward sum (Megatron's *f*: the input
  of a column-parallel product, whose ranks each pass back a part of
  the input's gradient);
- ``gather_from_group``: gather / backward this rank's slice (the
  gathered tensor is used alike on every rank, so each already holds
  the whole gradient);
- ``split_to_group``: this rank's slice / backward gather;
- ``ppermute``: send to rank ``(r + shift) % n``, receive from
  ``(r - shift) % n`` / backward the same shift the other way;
- ``all_to_all``: split ``split_dim`` across the ranks and concatenate
  what arrives along ``concat_dim`` in rank order (JAX's tiled
  ``all_to_all``) / backward the inverse exchange.

``all_reduce_max`` (``pmax``) and ``broadcast`` take no gradient: the
vocabulary-parallel cross-entropy shifts by a detached maximum, and a
decode step on a ``pp`` mesh hands its activation from stage to stage.

Over a group of one rank each returns its input and makes no call and
no autograd node, as XLA emits no collective for an axis of size 1: a
one-rank NCCL call costs the host a fraction of a millisecond, and a
mesh with a one-rank axis meets hundreds a step (``chip_smoke.py``'s
``mesh1`` phase measures one). The names are the ones every torch since 2.1 has
(``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``batch_isend_irecv``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _alone(group) -> bool:
    """A one-rank group: every collective over it is the identity."""
    return group.size() == 1


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    x = x.contiguous()
    # the collective concatenates along dim 0: gather (n·d0, ...) and
    # view it as (n, ...)
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    # (n, ..., d, ...) -> (..., n·d, ...)
    dim = dim % x.dim()
    out = out.view(n, *x.shape).movedim(0, dim)
    return out.reshape(*x.shape[:dim], n * x.shape[dim],
                       *x.shape[dim + 1:])


def _reduce_scatter(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    chunk = x.shape[dim] // n
    parts = x.reshape(*x.shape[:dim], n, chunk, *x.shape[dim + 1:])
    parts = parts.movedim(dim, 0).contiguous()
    out = parts.new_empty(parts.shape[1:])
    dist.reduce_scatter_tensor(out, parts.view(-1, *parts.shape[2:]),
                               group=group)
    return out


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"split: dim {dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    c = x.shape[dim] // n
    return x.narrow(dim, r * c, c).contiguous()


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def _ppermute(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if shift % n == 0:
        return x
    r = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    dst = dist.get_global_rank(group, (r + shift) % n)
    src = dist.get_global_rank(group, (r - shift) % n)
    ops = [dist.P2POp(dist.isend, x, dst, group),
           dist.P2POp(dist.irecv, out, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def _all_to_all(x: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    split_dim, concat_dim = split_dim % x.dim(), concat_dim % x.dim()
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    c = x.shape[split_dim] // n
    parts = x.reshape(*x.shape[:split_dim], n, c, *x.shape[split_dim + 1:])
    parts = parts.movedim(split_dim, 0).contiguous()   # (n, ...) by dest
    out = torch.empty_like(parts)
    dist.all_to_all_single(out, parts, group=group)    # (n, ...) by source
    # the sources, in rank order, go in front of concat_dim's elements
    out = out.movedim(0, concat_dim)
    shape = list(parts.shape[1:])
    shape[concat_dim] *= n
    return out.reshape(shape)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.group, ctx.dim), None, None


class _SplitToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _ppermute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, -ctx.shift), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.group, ctx.split_dim, ctx.concat_dim = group, split_dim, concat_dim
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.group, ctx.concat_dim, ctx.split_dim),
                None, None, None)


def _call(node, x: torch.Tensor, group, *args) -> torch.Tensor:
    """``node`` (an autograd ``Function``) on ``x``; ``x`` itself over
    a one-rank group."""
    if _alone(group):
        return x
    return node.apply(x, group, *args)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` (rank order);
    backward reduce-scatters (sums) the gradient."""
    return _call(_AllGather, x, group, dim)


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Sum over the ranks, this rank keeping its ``1/n`` of ``dim``;
    backward all-gathers."""
    return _call(_ReduceScatter, x, group, dim)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the ranks; backward passes the gradient through."""
    return _call(_AllReduce, x, group)


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; backward sums the gradient over the ranks."""
    return _call(_CopyToGroup, x, group)


def gather_from_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim``; backward keeps this
    rank's slice of the (alike on every rank) gradient."""
    return _call(_GatherFromGroup, x, group, dim)


def split_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's ``1/n`` of ``dim``; backward all-gathers."""
    return _call(_SplitToGroup, x, group, dim)


def ppermute(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """Rotate ``x`` ``shift`` ranks forward around the group."""
    return _call(_PPermute, x, group, shift)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Scatter ``split_dim`` over the ranks, gather ``concat_dim``."""
    return _call(_AllToAll, x, group, split_dim, concat_dim)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum over the ranks (no gradient)."""
    if _alone(group):
        return x
    x = x.detach().contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def broadcast(x: torch.Tensor, group, src: int) -> torch.Tensor:
    """The ``x`` of the group's rank ``src`` on every rank (no
    gradient)."""
    if _alone(group):
        return x
    x = x.detach().contiguous()
    if dist.get_rank(group) != src:
        x = torch.empty_like(x)
    dist.broadcast(x, src=dist.get_global_rank(group, src), group=group)
    return x
