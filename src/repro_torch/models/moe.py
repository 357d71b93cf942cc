"""Feed-forward layers, ported from ``repro.models.moe``: the dense SwiGLU
FFN and the routed Mixture-of-Experts FFN on one device, and a shared
expert.

The routed FFN keeps the reference's semantics to the bit where the
arithmetic allows: top-k routing on fp32 logits with ties broken toward the
lower expert index, as ``jax.lax.top_k`` breaks them; a fixed capacity of
C = max(min(T, 32), ceil(T·k/E · capacity_factor)) tokens an expert, filled
in sorted (expert, token) order, the rest dropped; the expert products over
the (E, C, D) buffer; each token's k weighted contributions added one at a
time in the order the reference's sorted scatter-add meets them, ascending
expert index, in the activation dtype.  Every step is a gather, a sort or
a scatter with unique targets, so the result has the same bits on every
run on the card under ``torch.use_deterministic_algorithms(True)``, and no
step has a shape that depends on the data.  A device that holds a share
of the experts (``moe.held``) routes over all of them and computes its
own experts' part: routes to the others are dropped as a sharded rank's
are, and their part is left out.

A few tokens with no gradient asked for (T·k at most the experts held and
T within the capacity, so that no route can be dropped) take a shorter
path of the same semantics: ``kernels.ops.routed_experts`` computes only
the routed, held experts' products, reading their weights in place (on the
card a hand-written kernel, ``kernels/csrc/routed.cu``), and adds each
token's weighted rows in the same order, rounded at the same places.
Every batch-1 decode step takes it; prefill and training keep the buffer.

On a mesh (a ``ShardCtx``), ``moe_ffn`` runs the reference's
expert-parallel branch: the experts are cut over "model", each rank runs
``moe_ffn_local`` on its slice of experts and the tokens of its data
shard, and the slices' contributions are summed over "model".  The
capacity is then that of the data shard's T, as inside the reference's
``shard_map``: a sharded run drops other tokens than an unsharded one.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Partial

from repro_torch.kernels import ops
from repro_torch.models.common import ModelConfig
from repro_torch.parallel import comm, sharding
from repro_torch.runtime import spans

_EXPERTS = ("router", "w_gate", "w_up", "w_down")


def _capacity(T: int, k: int, E: int, cf: float) -> int:
    return max(min(T, 32), int(math.ceil(T * k / E * cf)))


def route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor,
          bias: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, D) -> (weights (T, k) fp32, experts (T, k) int64).

    The logits are an fp32 product (TF32 would move near-ties; PyTorch's
    default fp32 matmul precision, "highest", keeps it off).  A stable
    descending sort puts the lower index first on equal scores, as
    ``jax.lax.top_k`` does (``torch.topk`` does not).  With softmax scoring
    the weights are the top k logits' softmax; with sigmoid scoring (the
    ``glm4_moe`` router with one group) the experts are the top k of
    ``sigmoid(logits) + bias`` and their weights the sigmoid scores without
    the bias, divided by their sum and times ``routed_scale``."""
    m = cfg.moe
    k = m.top_k
    logits = x.float() @ router_w                      # (T, E)
    if m.scoring == "sigmoid":
        scores = torch.sigmoid(logits)
        top_e = torch.sort(scores + bias, dim=-1, descending=True,
                           stable=True)[1][:, :k]
        w = scores.gather(1, top_e)
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return w * m.routed_scale, top_e
    top_w, top_e = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(top_w[:, :k], dim=-1), top_e[:, :k]


def moe_ffn_local(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                  x: torch.Tensor, e0: int, e_local: int) -> torch.Tensor:
    """MoE FFN over the expert slice [e0, e0 + e_local).

    x: (T, D); the expert weights in ``p`` are that slice's,
    (e_local, D, F) and (e_local, F, D).  Returns the slice's contribution
    (T, D); with experts spread over devices the caller sums the slices.
    With T·k <= e_local, T <= C (each expert takes at most T routes, so
    none is dropped) and no gradient asked for, only the routed, held
    experts' products run (``ops.routed_experts``)."""
    m = cfg.moe
    T, D = x.shape
    k = m.top_k
    C = _capacity(T, k, m.n_experts, m.capacity_factor)

    # the selection bias where the router has one (sigmoid scoring)
    bias = (p["router_bias"],) if "router_bias" in p else ()
    top_w, top_e = route(cfg, p["router"], x, *bias)
    wants_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, *(p[n] for n in _EXPERTS)))
    if T * k <= e_local and T <= C and not wants_grad:
        return ops.routed_experts(x, top_e, top_w, p["w_gate"], p["w_up"],
                                  p["w_down"], e0, e_local)
    flat_e = top_e.reshape(-1)                          # (T·k,)
    flat_w = top_w.reshape(-1).to(x.dtype)
    flat_tok = torch.arange(T, device=x.device).repeat_interleave(k)

    le = flat_e - e0
    mine = (le >= 0) & (le < e_local)
    key = torch.where(mine, le, e_local)                # sentinel: not mine
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    tok_s = flat_tok[order]
    # position within each expert's segment (sorted: first-occurrence math)
    first = torch.searchsorted(key_s, key_s, side="left")
    seg_pos = torch.arange(T * k, device=x.device) - first
    keep = (key_s < e_local) & (seg_pos < C)
    overflow = e_local * C
    dest = torch.where(keep, key_s * C + seg_pos, overflow)

    # scatter with mode="drop": every dropped row lands on one extra row,
    # sliced off; kept rows have unique targets
    buf = x.new_zeros(overflow + 1, D).index_put((dest,), x[tok_s])
    buf = buf[:overflow].reshape(e_local, C, D)
    h = torch.bmm(buf, p["w_gate"])
    u = torch.bmm(buf, p["w_up"])
    y = torch.bmm(F.silu(h) * u, p["w_down"]).reshape(overflow, D)

    # gather with mode="fill": the overflow row reads zeros
    rows = torch.cat([y, y.new_zeros(1, D)])[dest]      # (T·k, D), sorted
    contrib = rows * (flat_w[order] * keep.to(x.dtype))[:, None]
    # back to token-major order, each token's k rows by ascending expert:
    # the order in which the reference's sorted scatter-add meets them
    by_expert = torch.argsort(top_e, dim=-1)            # experts distinct
    flat_pos = (torch.arange(T, device=x.device)[:, None] * k
                + by_expert).reshape(-1)
    contrib = contrib[torch.argsort(order)[flat_pos]].reshape(T, k, D)
    out = x.new_zeros(T, D)
    for j in range(k):
        out = out + contrib[:, j]
    return out


def dense_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor,
              ctx=None) -> torch.Tensor:
    """SwiGLU FFN. x: (..., D); with a context, the gate and up products
    column-cut over "model" and the down product row-cut, reduced once."""
    g, u = sharding.columns(ctx, x, p, ("w_gate", "w_up"))
    return sharding.rows(ctx, F.silu(g) * u, p, "w_down")


def shared_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor,
               ctx=None) -> torch.Tensor:
    """The shared expert: a SwiGLU over every token, the ``shared_*``
    leaves, cut on a mesh as the dense FFN is."""
    return dense_ffn({"w_gate": p["shared_gate"], "w_up": p["shared_up"],
                      "w_down": p["shared_down"]}, x, ctx)


def moe_ffn(cfg: ModelConfig, p: Dict[str, torch.Tensor],
            x: torch.Tensor, ctx=None) -> torch.Tensor:
    """The routed experts of an MoE FFN over (B, S, D) activations: the
    experts this device holds, [0, ``moe.n_held``), routed over all of
    them, or with a context expert-parallel over its "model" axis.  A
    ``moe.routed`` span while spans are on."""
    if ctx is not None:
        return _moe_ffn_sharded(cfg, p, x, ctx)
    B, S, D = x.shape
    with spans.span("moe.routed"):
        out = moe_ffn_local(cfg, p, x.reshape(B * S, D), 0, cfg.moe.n_held)
    return out.reshape(B, S, D)


def _moe_ffn_sharded(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor, ctx) -> torch.Tensor:
    """The reference's ``shard_map`` of ``moe_ffn``: x (B, S, D) by batch
    over the data axes, the router whole, the experts cut over "model"
    (E divisible by its size); out like x, summed over "model"."""
    m = cfg.moe
    if m.n_held != m.n_experts or m.scoring != "softmax":
        raise NotImplementedError(
            f"{cfg.name}: the expert-parallel layer takes every expert and "
            f"softmax scoring, not {m.n_held} of {m.n_experts} held and "
            f"{m.scoring} scoring")
    mesh, tp = ctx.mesh, ctx.tp_axis
    e_local = cfg.moe.n_experts // ctx.tp_size
    e0 = mesh.get_local_rank(tp) * e_local
    group = mesh.get_group(tp)
    x_spec = sharding._divisible((ctx.dp_axes, None, None), tuple(x.shape),
                                 mesh)
    specs = {"router": (None, None), "w_gate": (tp, None, None),
             "w_up": (tp, None, None), "w_down": (tp, None, None)}
    # gradients: a rank sees the tokens of its data shard and the routes to
    # its experts only, so each input's gradient is a partial sum over the
    # axes that cut what it feeds
    grads = [sharding.weight_grad(specs[k], x_spec, mesh) for k in _EXPERTS]
    grads[0] = tuple(Partial() if a == tp else pl
                     for a, pl in zip(mesh.mesh_dim_names, grads[0]))
    grads.append(tuple(Partial() if a == tp else pl for a, pl in zip(
        mesh.mesh_dim_names, sharding.placements(x_spec, mesh))))

    def local(router, w_gate, w_up, w_down, xl):
        B, S, D = xl.shape
        lp = {"router": router, "w_gate": w_gate, "w_up": w_up,
              "w_down": w_down}
        out = moe_ffn_local(cfg, lp, xl.reshape(B * S, D), e0, e_local)
        return comm.psum(out, group, "moe").reshape(B, S, D)

    return sharding.on_shards(local, mesh,
                              [specs[k] for k in _EXPERTS] + [x_spec], x_spec,
                              grads)(*(p[k] for k in _EXPERTS), x)
