"""GPipe-style pipeline parallelism over a "stage" mesh dimension, ported
from ``repro.parallel.pipeline``.

The layer stack is split into S stages, one per rank of the stage
dimension; microbatches flow through the classic (n_micro + S − 1)-tick
schedule.  Each tick every stage applies its layers to its input (stage
0 to microbatch t, the others to what the previous stage sent), the last
stage keeps its output for microbatch t − (S − 1), and each stage hands
its output to the next one around the ring (JAX's ``ppermute``, here
``dist.batch_isend_irecv``).  At the end the last stage's outputs are
broadcast to every stage (JAX's ``psum`` of them).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.parallel import comm


def _stage_slice(params: Any, stage: int) -> Any:
    """This stage's slice of a tree of leaves stacked over the stages: a
    DTensor cut over the stage dimension holds exactly it; a plain tensor
    holds all of them."""
    if isinstance(params, dict):
        return {k: _stage_slice(v, stage) for k, v in params.items()}
    if isinstance(params, (tuple, list)):
        return type(params)(_stage_slice(v, stage) for v in params)
    if isinstance(params, DTensor):
        return params.to_local()[0]
    return params[stage]


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x: torch.Tensor, mesh,
                   stage_axis: str = "stage") -> torch.Tensor:
    """Run ``x`` through the S stages of ``mesh``'s ``stage_axis``.

    stage_params: a tree of leaves with leading dim S (one slice per
    stage), whole on every rank or DTensors cut over ``stage_axis``; x:
    (n_micro, mb, ...) microbatched input, the same on every rank.
    Returns (n_micro, mb, ...) outputs, the same on every rank."""
    S = mesh.size(mesh.mesh_dim_names.index(stage_axis))
    n_micro = x.shape[0]
    if n_micro < S:
        raise ValueError("need at least one microbatch per stage")
    stage = mesh.get_local_rank(stage_axis)
    group = mesh.get_group(stage_axis)
    ranks = dist.get_process_group_ranks(group)
    params = _stage_slice(stage_params, stage)

    buf = torch.zeros_like(x[0])                 # inter-stage register
    outs = torch.zeros_like(x)
    for t in range(n_micro + S - 1):
        # stage 0 feeds microbatch t (when in range); the others take buf
        inp = x[min(t, n_micro - 1)] if stage == 0 else buf
        out = stage_fn(params, inp)
        # the last stage commits microbatch t - (S - 1) (when in range)
        if stage == S - 1 and t >= S - 1:
            outs[t - (S - 1)] = out
        if S == 1:
            buf = out
            continue
        buf = torch.empty_like(out)
        comm.count("pipeline_send")
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, out.contiguous(), ranks[(stage + 1) % S],
                       group),
            dist.P2POp(dist.irecv, buf, ranks[(stage - 1) % S], group)])
        for req in reqs:
            req.wait()
    # only the last stage holds real outputs; broadcast them
    comm.count("pipeline_broadcast")
    dist.broadcast(outs, src=ranks[S - 1], group=group)
    return outs
