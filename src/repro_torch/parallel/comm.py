"""The port's explicit collectives, counted by kind.

DTensor issues the collectives that a redistribution needs by itself;
these are the ones the port's code calls by hand: the tensor-parallel
products' reductions and gathers over "model" (``copy_to``, ``psum``,
``reduce_scatter``, ``gather``), the expert-parallel sum of the MoE layer,
the sums of sharded digests and squared gradient norms, the max of an
int8 row scale over a sharded row, and the pipeline's sends and
broadcast.

The tensor-parallel four keep one rule, Megatron's: a tensor that every
rank of the group holds whole carries its whole gradient on every rank.
So ``copy_to`` (the input of a column-cut product) sums the ranks'
partial gradients in its backward, ``psum`` (after a row-cut product)
passes its gradient through, and ``gather`` and ``reduce_scatter`` take
each other's place in the backward (a gather's backward keeps this rank's
slice).  ``collectives`` counts each call by its
kind, so that a caller can reset the counts, run a path and see which of
them it issued.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch
import torch.distributed as dist

collectives: Dict[str, int] = {}


def reset_collectives() -> None:
    collectives.clear()


def count(kind: str) -> None:
    collectives[kind] = collectives.get(kind, 0) + 1


def all_reduce(t: torch.Tensor, groups: Iterable, kind: str,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over each process group of ``groups`` in
    turn (over all of a mesh's dimensions, the whole mesh)."""
    for group in groups:
        count(kind)
        dist.all_reduce(t, op=op, group=group)
    return t


class _SumOverRanks(torch.autograd.Function):
    """The sum of each rank's ``x`` over ``group``, as ``jax.lax.psum``
    inside ``shard_map``: the result is replicated, and the gradient of
    each rank's ``x`` is the result's gradient as it is."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, kind: str) -> torch.Tensor:
        out = x.clone()
        count(kind)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None, None


def psum(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    return _SumOverRanks.apply(x, group, kind)


def _slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * n, n)


def _all_gather(x: torch.Tensor, group, dim: int, kind: str) -> torch.Tensor:
    """``x`` gathered along ``dim`` over ``group``, contiguous (as a
    kernel reads it)."""
    size = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((size * x.shape[0],) + tuple(x.shape[1:]))
    count(kind)
    dist.all_gather_into_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter(x: torch.Tensor, group, dim: int,
                    kind: str) -> torch.Tensor:
    size = dist.get_world_size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // size,) + tuple(x.shape[1:]))
    count(kind)
    dist.reduce_scatter_tensor(out, x, group=group)
    return out.movedim(0, dim).contiguous()


class _CopyTo(torch.autograd.Function):
    """The input of a column-cut product: the same tensor forward; the
    ranks' partial gradients summed backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, kind: str) -> torch.Tensor:
        ctx.group, ctx.kind = group, kind
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        count(ctx.kind)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None, None


class _ReduceScatter(torch.autograd.Function):
    """The ranks' partial sums summed and cut along ``dim``; the gradient
    gathered back."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, dim: int,
                kind: str) -> torch.Tensor:
        ctx.group, ctx.dim, ctx.kind = group, dim, kind
        return _reduce_scatter(x, group, dim, kind)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _all_gather(grad, ctx.group, ctx.dim, ctx.kind), None, None, \
            None


class _Gather(torch.autograd.Function):
    """Each rank's piece gathered along ``dim`` into the whole tensor; the
    gradient (whole on every rank) cut back to this rank's piece."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group, dim: int,
                kind: str) -> torch.Tensor:
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim, kind)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _slice(grad, ctx.group, ctx.dim).contiguous(), None, None, None


def copy_to(x: torch.Tensor, group, kind: str) -> torch.Tensor:
    return _CopyTo.apply(x, group, kind)


def reduce_scatter(x: torch.Tensor, group, dim: int,
                   kind: str) -> torch.Tensor:
    return _ReduceScatter.apply(x, group, dim % x.ndim, kind)


def gather(x: torch.Tensor, group, dim: int, kind: str) -> torch.Tensor:
    return _Gather.apply(x, group, dim % x.ndim, kind)
