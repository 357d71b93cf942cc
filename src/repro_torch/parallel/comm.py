"""The port's explicit collectives, counted by kind.

DTensor issues the collectives that a redistribution needs by itself;
these are the ones the port's code calls by hand: the expert-parallel
sum of the MoE layer, the sums of sharded digests and squared gradient
norms, the max of an int8 row scale over a sharded row, and the
pipeline's sends and broadcast.  ``collectives`` counts each call by its
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
