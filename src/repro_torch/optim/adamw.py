"""AdamW with mixed-precision state and optional gradient compression,
ported from ``repro.optim.adamw``.

The state keeps bf16 first and second moments and an fp32 master copy of
every parameter; gradients are clipped by their global norm in fp32, and
``compress="int8"`` quantizes them blockwise over the last axis first.
The arithmetic is the JAX package's, operation for operation: Python
floats enter as fp32 constants (JAX's weak types), the clip scale is cast
to the gradient's dtype before it multiplies, the bias corrections raise
b1 and b2 to the step count in fp32, and weight decay applies to every
trained leaf.

Unlike the functional original, the update writes in place: the new
weights into the parameters, the new moments and master into the state's
tensors.  It walks each leaf in slices of ``SLICE`` elements, so the fp32
temporaries stay small beside a 622 M-element embedding; every operation
is elementwise, so slicing changes no bit.

Sharded parameters (DTensors) are updated on their local shards, with the
gradients laid out as the parameters: the update is elementwise, so it
gives the unsharded bits.  What reaches across shards is reduced over the
mesh: the clip's sum of squares (each distinct shard counted once, then
summed over ranks) and int8 compression's row max where the row is cut.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Sequence

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels.ops import traced
from repro_torch.parallel import comm, sharding

#: elements of a leaf updated at a time
SLICE = 1 << 26

State = Dict[str, Any]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    moment_dtype: str = "bfloat16"
    master_dtype: str = "float32"
    grad_clip: float = 1.0
    compress: Optional[str] = None   # None | "int8"


def adamw_init(params: Iterable[torch.Tensor], cfg: AdamWConfig) -> State:
    """State for ``params`` (e.g. ``model.param_leaves()``): lists in the
    parameters' order, and the step count as an int32 scalar."""
    params = [p.detach() for p in params]
    mdt = getattr(torch, cfg.moment_dtype)
    return {
        "mu": [torch.zeros_like(p, dtype=mdt) for p in params],
        "nu": [torch.zeros_like(p, dtype=mdt) for p in params],
        "master": [p.to(getattr(torch, cfg.master_dtype), copy=True)
                   for p in params],
        "count": torch.zeros((), dtype=torch.int32, device=params[0].device),
    }


def _compress_int8(g: torch.Tensor, numel: Optional[int] = None,
                   row_groups: Sequence = ()) -> torch.Tensor:
    """Blockwise int8 quantize→dequantize (simulates int8 all-reduce).  For
    a local shard: ``numel`` is the whole tensor's, and ``row_groups`` the
    process groups of the mesh dimensions that cut its last axis, over
    which the row max is taken."""
    if g.ndim == 0 or (g.numel() if numel is None else numel) < 256:
        return g
    amax = torch.amax(torch.abs(g), dim=-1, keepdim=True)
    if row_groups:
        comm.all_reduce(amax, row_groups, "amax",
                        op=torch.distributed.ReduceOp.MAX)
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(g.dtype) * scale


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """fp32 square root, correctly rounded as XLA's and CUDA's are.
    torch's vectorised CPU sqrt misses the last bit on some inputs, so on
    the CPU it goes through fp64, whose second rounding is exact for a
    square root.  A traced call takes the card's path (``ops.traced``)."""
    if x.is_cuda or traced(x):
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def _slices(n: int):
    return (slice(i, min(i + SLICE, n)) for i in range(0, n, SLICE))


@torch.no_grad()
def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], state: State,
                 cfg: AdamWConfig) -> State:
    """One AdamW step.  Writes the new weights into ``params`` and the new
    moments and master into ``state``'s tensors; returns the state with the
    count advanced.  A leaf whose gradient is None is not trained: its
    value, moments and master stay as they are."""
    live = [i for i, g in enumerate(grads) if g is not None]
    if len(live) < len(grads):
        sub = {k: [state[k][i] for i in live] for k in ("mu", "nu", "master")}
        out = adamw_update([params[i] for i in live],
                           [grads[i] for i in live], dict(state, **sub), cfg)
        return dict(state, count=out["count"])
    count = state["count"] + 1
    kept = {k: state[k] for k in ("mu", "nu", "master")}
    mesh, layouts = None, None
    if isinstance(params[0], DTensor):
        mesh = params[0].device_mesh
        layouts = [(p.numel(), p.placements) for p in params]
        grads = [g.redistribute(mesh, p.placements).to_local()
                 for p, g in zip(params, grads)]
        params = [p.to_local() for p in params]
        state = dict(state, **{k: [t.to_local() for t in state[k]]
                               for k in ("mu", "nu", "master")})
    if cfg.compress == "int8" and mesh is None:
        grads = [_compress_int8(g) for g in grads]
    elif cfg.compress == "int8":
        grads = [_compress_int8(g, n, [mesh.get_group(i) for i, pl in
                                       enumerate(pls)
                                       if pl.is_shard(g.ndim - 1)])
                 for g, (n, pls) in zip(grads, layouts)]
    scale = None
    if cfg.grad_clip > 0 and mesh is None:
        # global-norm clip (fp32), summed in leaf order
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                               for g in grads))
    elif cfg.grad_clip > 0:
        # each distinct shard once, in leaf order, then over the mesh
        sq = [torch.sum(torch.square(g.float())) for g in grads]
        total = sum(s if sharding.owns_shard(mesh, pls) else torch.zeros_like(s)
                    for s, (_, pls) in zip(sq, layouts))
        gnorm = torch.sqrt(comm.all_reduce(total, sharding.mesh_groups(mesh),
                                           "clip"))
    if cfg.grad_clip > 0:
        scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                            / (gnorm + 1e-12), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(b1, count.float())
    c2 = 1.0 - torch.pow(b2, count.float())

    def upd(p, g, mu, nu, master):
        if scale is not None:
            g = g * scale.to(g.dtype)
        g32 = g.float()
        mu32 = mu.float() * b1 + g32 * (1 - b1)
        nu32 = nu.float() * b2 + g32 * g32 * (1 - b2)
        step = (mu32 / c1) / (_sqrt(nu32 / c2) + cfg.eps)
        m32 = master.float()
        m32 = m32 - cfg.lr * (step + cfg.weight_decay * m32)
        p.copy_(m32)
        mu.copy_(mu32)
        nu.copy_(nu32)
        master.copy_(m32)

    for p, g, mu, nu, master in zip(params, grads, state["mu"], state["nu"],
                                    state["master"]):
        g = g.reshape(-1)
        # the tensors written in place: view() raises unless it can
        p, mu, nu, master = (t.view(-1) for t in (p, mu, nu, master))
        for sl in _slices(g.numel()):
            upd(p[sl], g[sl], mu[sl], nu[sl], master[sl])
    return dict(kept, count=count)
