"""Model assembly for stacks of attention and recurrent layers, ported from
``repro.models.transformer``: embedding, logits, caches, prefill and greedy
decode steps, with the per-kind dispatch of ``apply_layer_prefill``,
``apply_layer_decode`` and ``init_layer_state``; and the training forward
and loss (``forward_train``, ``lm_loss``) through every kind, with the
config's activation checkpointing (``remat``).  A layer's FFN is dense or,
with ``cfg.moe``, routed (``models.moe.moe_ffn``) with a shared expert
where the config has one, unless its ``LayerSpec`` asks for a dense one;
layers are pre-norm, or post-norm with ``cfg.post_norm``.  Prefill and
training take (B, S) token ids or, for a modality frontend, (B, S, D)
embeddings.
JAX's ``lax.scan`` over a group's ``reps`` becomes a Python loop; the
caches keep JAX's nesting (per group, per pattern position, a dict of
tensors stacked over ``reps``): attention KV caches, or the state of a
recurrent layer.

``ShardCtx`` carries a device mesh.  Given one, the entry points take a
model placed by ``parallel.sharding`` (DTensor parameters) and run on
DTensors, and each layer does the work a device does in the reference's
compiled program: its products run on local shards
(``sharding.columns`` and ``sharding.rows``), each weight gathered over
the data axes, every row-cut product's partial sums reduced over "model"
at once, so that no product runs whole on a "model" rank; attention is
cut by heads, or by query positions where the heads do not divide
"model"; MoE layers run expert-parallel; the loss takes its max, sum and
target over the vocab's cut; the kernels run on local shards.  Without
one, every function runs the single-device code.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import recurrent as rec
from repro_torch.models.attention import (attention_train,
                                          banded_window_attention,
                                          decode_attention, init_cache,
                                          prefill_attention, qkv_project,
                                          sharded_attention)
from repro_torch.models.common import (LayerSpec, ModelConfig, Transformer,
                                       rms_norm, weak_scalar)
from repro_torch.models.moe import dense_ffn, moe_ffn, shared_ffn
from repro_torch.parallel import comm, sharding

Caches = Tuple[Tuple[Dict[str, torch.Tensor], ...], ...]


@dataclass(frozen=True)
class ShardCtx:
    """A device mesh and the roles of its axes (``sharding.
    shard_ctx_for_mesh`` makes one)."""
    mesh: Any                                # a DeviceMesh
    dp_axes: Tuple[str, ...] = ("data",)     # batch axes (may include "pod")
    tp_axis: str = "model"

    @property
    def tp_size(self) -> int:
        return sharding.axis_sizes(self.mesh)[self.tp_axis]


def _constrain(x: torch.Tensor, ctx: Optional[ShardCtx], spec) -> torch.Tensor:
    """``x`` laid out by ``spec`` (as far as its shape divides) on the
    context's mesh; without a context, ``x``."""
    if ctx is None:
        return x
    return sharding.place(x, ctx.mesh,
                          sharding._divisible(spec, tuple(x.shape), ctx.mesh))


def _positions(B: int, S: int, device, ctx: Optional[ShardCtx]
               ) -> torch.Tensor:
    """(B, S) positions 0..S-1; with a context, cut by batch over the data
    axes as the activations are, so that RoPE's tables are made for this
    rank's rows only."""
    return _constrain(torch.arange(S, device=device).expand(B, S), ctx,
                      (ctx.dp_axes, None) if ctx else None)


def _layer(stacked, r: int) -> Dict[str, torch.Tensor]:
    return {k: t[r] for k, t in stacked.items()}


#: while a decode step is captured (``routed_ffn_cut``), where the
#: unsharded path's routed-FFN calls go instead of ``moe_ffn``
_routed_cut: Optional[Callable[..., torch.Tensor]] = None


@contextlib.contextmanager
def routed_ffn_cut(fn: Callable[..., torch.Tensor]) -> Iterator[None]:
    """Inside, each routed-FFN call of the unsharded path is
    ``fn(cfg, p, h)`` instead of ``moe_ffn(cfg, p, h)``: a decoder that
    captures its step as graphs (``launch.serve``) closes one graph there
    and leaves the call to run eagerly between replays."""
    global _routed_cut
    before, _routed_cut = _routed_cut, fn
    try:
        yield
    finally:
        _routed_cut = before


def _attn_input(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """What attention reads: ``ln1(x)``, or with ``cfg.post_norm`` x."""
    return x if cfg.post_norm else rms_norm(x, p["ln1"], cfg.norm_eps)


def _residual(cfg: ModelConfig, norm: torch.Tensor, x: torch.Tensor,
              out: torch.Tensor) -> torch.Tensor:
    """x plus a sublayer's output, normed first with ``cfg.post_norm``."""
    if cfg.post_norm:
        out = rms_norm(out, norm, cfg.norm_eps)
    return x + out


def _ffn_part(cfg: ModelConfig, spec: LayerSpec, p: Dict[str, torch.Tensor],
              x: torch.Tensor, ctx: Optional[ShardCtx] = None
              ) -> torch.Tensor:
    """x plus the layer's FFN (normed before, or after with post-norm):
    dense, or routed (``moe_ffn`` as this module names it, or while a
    step is captured ``_routed_cut``) plus the shared expert where the
    config has one."""
    h = x if cfg.post_norm else rms_norm(x, p["ln2"], cfg.norm_eps)
    routed = cfg.routed(spec)
    if not routed:
        f = dense_ffn(p, h, ctx)
    elif _routed_cut is not None and ctx is None:
        f = _routed_cut(cfg, p, h)
    else:
        f = moe_ffn(cfg, p, h, ctx)
    if routed and cfg.moe.d_shared:
        f = f + shared_ffn(p, h, ctx)
    return _residual(cfg, p["ln2"], x, f)


def _embed_rows(table: torch.Tensor, tokens: torch.Tensor,
                ctx: ShardCtx) -> torch.Tensor:
    """``table[tokens]`` with the table's vocab cut over "model" (a
    vocab-parallel lookup): each rank gathers the rows it holds for its
    batch shard, zeros the rest, and the ranks' rows are summed over
    "model"."""
    mesh, tp = ctx.mesh, ctx.tp_axis
    t_spec = sharding._divisible((tp, None), tuple(table.shape), mesh)
    tok_spec = sharding._divisible((ctx.dp_axes, None), tuple(tokens.shape),
                                   mesh)
    cut = t_spec[0] is not None
    group = mesh.get_group(tp)
    tok_pl = sharding.placements(tok_spec, mesh)
    t_grad = sharding.weight_grad(t_spec, tok_spec, mesh)

    def local(tab, tok):
        n = tab.shape[0]
        idx = tok - mesh.get_local_rank(tp) * n if cut else tok
        mine = (idx >= 0) & (idx < n)
        rows = torch.where(mine[..., None], tab[torch.where(mine, idx, 0)], 0)
        return comm.psum(rows, group, "embed") if cut else rows

    return sharding.on_shards(local, mesh, (t_spec, tok_spec),
                              tok_spec + (None,), (t_grad, tok_pl))(table,
                                                                    tokens)


def embed(model: Transformer, inputs: torch.Tensor,
          ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """inputs: (B, S) integer tokens -> (B, S, D) rows of the table scaled
    by sqrt(d_model); or (B, S, D) frontend embeddings, cast to the model's
    dtype and not scaled.  With a context, a plain ``inputs`` (every rank
    holds it whole) is first cut by batch over the data axes."""
    cfg = model.cfg
    if ctx is not None:
        inputs = _constrain(inputs, ctx, (ctx.dp_axes,))
    if inputs.is_floating_point():
        x = inputs.to(cfg.tdtype())
    else:
        table = model.embed
        rows = table[inputs] if ctx is None else _embed_rows(table, inputs,
                                                             ctx)
        x = (rows * weak_scalar(cfg.d_model ** 0.5, table)).to(cfg.tdtype())
    return _constrain(x, ctx, (ctx.dp_axes, None, None)) if ctx else x


def logits_fn(model: Transformer, x: torch.Tensor,
              ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """(B, S, D) -> (B, S, V) logits against ``lm_head``, or ``embed.T``
    where the head is tied; in fp32 with ``cfg.logits_fp32``.  With a
    context, cut by vocab over "model" (a column-cut product)."""
    x = rms_norm(x, model.out_norm, model.cfg.norm_eps)
    head = model.embed.T if model.lm_head is None else model.lm_head
    logits, = sharding.columns(ctx, x, {"lm_head": head.to(x.dtype)},
                               ("lm_head",))
    return logits.float() if model.cfg.logits_fp32 else logits


def init_layer_state(cfg: ModelConfig, spec: LayerSpec, batch: int,
                     max_seq: int, device=None) -> Dict[str, torch.Tensor]:
    if spec.kind == "attn":
        return init_cache(cfg, spec.window, batch, max_seq, cfg.tdtype(),
                          device)
    if spec.kind == "mlstm":
        return rec.mlstm_init_state(cfg, batch, device)
    if spec.kind == "slstm":
        return rec.slstm_init_state(cfg, batch, device)
    if spec.kind == "rglru":
        return rec.rglru_init_state(cfg, batch, device)
    raise ValueError(spec.kind)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                device=None) -> Caches:
    """Nested (per group, per pattern position) stacked empty caches."""
    groups = []
    for pattern, reps in cfg.blocks:
        per_pos = []
        for spec in pattern:
            one = init_layer_state(cfg, spec, batch, max_seq, device)
            per_pos.append({k: torch.stack([t] * reps) for k, t in one.items()})
        groups.append(tuple(per_pos))
    return tuple(groups)


def _apply_layer_prefill(cfg: ModelConfig, spec: LayerSpec, p, x, positions,
                         max_seq: int, ctx: Optional[ShardCtx] = None):
    if spec.kind == "attn":
        h = _attn_input(cfg, p, x)
        # on a mesh only the cache's length and positions are read: each
        # rank fills its own shards (``prefill_attention``)
        cache = init_cache(cfg, spec.window, x.shape[0] if ctx is None else 1,
                           max_seq, cfg.tdtype(), x.device)
        attn_out, new_cache = prefill_attention(cfg, p, h, spec.window,
                                                positions, cache, ctx=ctx,
                                                use_rope=spec.rope)
        x = _residual(cfg, p["ln1"], x, attn_out)
        return _ffn_part(cfg, spec, p, x, ctx), new_cache
    if spec.kind == "mlstm":
        return rec.mlstm_block(cfg, p, x, ctx=ctx)
    if spec.kind == "slstm":
        return rec.slstm_block(cfg, p, x, ctx=ctx)
    if spec.kind == "rglru":
        x, st = rec.rglru_block(cfg, p, x, ctx=ctx)
        if spec.has_ffn:
            x = _ffn_part(cfg, spec, p, x, ctx)
        return x, st
    raise ValueError(spec.kind)


def _apply_layer_decode(cfg: ModelConfig, spec: LayerSpec, p, x,
                        cache: Dict[str, torch.Tensor],
                        position: Union[int, torch.Tensor],
                        ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """One layer of a decode step.  ``cache`` holds this layer's views into
    the stacked caches; they are updated in place."""
    if spec.kind == "attn":
        attn_out, _ = decode_attention(cfg, p, _attn_input(cfg, p, x), cache,
                                       position, ctx=ctx, use_rope=spec.rope)
        return _ffn_part(cfg, spec, p, _residual(cfg, p["ln1"], x, attn_out),
                         ctx)
    step = {"mlstm": rec.mlstm_step, "slstm": rec.slstm_step,
            "rglru": rec.rglru_step}.get(spec.kind)
    if step is None:
        raise ValueError(spec.kind)
    x, new_state = step(cfg, p, x, cache, ctx)
    for k, t in new_state.items():
        cache[k].copy_(t)
    if spec.kind == "rglru" and spec.has_ffn:
        x = _ffn_part(cfg, spec, p, x, ctx)
    return x


@torch.no_grad()
def prefill(model: Transformer, inputs: torch.Tensor,
            max_seq: Optional[int] = None, ctx: Optional[ShardCtx] = None
            ) -> Tuple[torch.Tensor, Caches]:
    """Run the whole prompt, building caches.  inputs: (B, S) tokens or
    (B, S, D) embeddings.  Returns (last position's logits (B, V), caches);
    with a context, DTensors (lay the caches out by
    ``sharding.cache_pspecs`` for decode)."""
    cfg = model.cfg
    B, S = inputs.shape[:2]
    max_seq = max_seq or S
    with sharding.mesh_mode(ctx):
        x = embed(model, inputs, ctx)
        positions = _positions(B, S, inputs.device, ctx)
        new_groups = []
        for (pattern, reps), stacked_g in zip(cfg.blocks, model.groups):
            per_rep = []
            for r in range(reps):
                states = []
                for spec, stacked in zip(pattern, stacked_g):
                    x, st = _apply_layer_prefill(cfg, spec, _layer(stacked, r),
                                                 x, positions, max_seq, ctx)
                    states.append(st)
                per_rep.append(states)
            new_groups.append(tuple(
                {k: torch.stack([rep[i][k] for rep in per_rep])
                 for k in per_rep[0][i]}
                for i in range(len(pattern))))
        logits = logits_fn(model, x[:, -1:], ctx)
    return logits[:, 0], tuple(new_groups)


@torch.no_grad()
def decode_step(model: Transformer, caches: Caches, tokens: torch.Tensor,
                position: Union[int, torch.Tensor],
                ctx: Optional[ShardCtx] = None
                ) -> Tuple[torch.Tensor, Caches]:
    """tokens: (B,) integer at global ``position``.  Returns (logits (B, V),
    caches); the caches are updated in place.  Without a context
    ``position`` may be a 0-d integer tensor on the model's device (an int
    becomes one by a fill): the step then reads nothing back to the host
    and copies nothing from it, so that it can be captured as a graph and
    replayed with the position advanced on the device.  With a context it
    is an int."""
    cfg = model.cfg
    if ctx is None and not isinstance(position, torch.Tensor):
        position = torch.full((), position, dtype=torch.int64,
                              device=tokens.device)
    with sharding.mesh_mode(ctx):
        x = embed(model, tokens[:, None], ctx)
        for (pattern, reps), stacked_g, caches_g in zip(cfg.blocks,
                                                        model.groups, caches):
            for r in range(reps):
                for spec, stacked, cache in zip(pattern, stacked_g, caches_g):
                    x = _apply_layer_decode(cfg, spec, _layer(stacked, r), x,
                                            _layer(cache, r), position, ctx)
        logits = logits_fn(model, x, ctx)
    return logits[:, 0], caches


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------
def apply_layer_train(cfg: ModelConfig, spec: LayerSpec,
                      p: Dict[str, torch.Tensor], x: torch.Tensor,
                      positions: torch.Tensor,
                      ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """One layer of the training forward.  Attention takes the plain banded
    or chunked path, as JAX's does; the recurrent kinds take their training
    forms, which call no forward-only kernel."""
    if spec.kind == "attn":
        B, S = x.shape[:2]
        q, k, v = qkv_project(cfg, p, _attn_input(cfg, p, x), positions,
                              ctx, spec.rope)
        if ctx is None:
            out = attention_train(cfg, q, k, v, spec.window)
        else:
            w = spec.window
            out = sharded_attention(cfg, ctx, q, k, v, w,
                                    banded_window_attention
                                    if w is not None and S > w else None)
        x = _residual(cfg, p["ln1"], x,
                      sharding.rows(ctx, sharding.flatten(out, 2), p, "wo"))
        return _ffn_part(cfg, spec, p, x, ctx)
    if spec.kind == "mlstm":
        return rec.mlstm_block(cfg, p, x, train=True, ctx=ctx)[0]
    if spec.kind == "slstm":
        return rec.slstm_block(cfg, p, x, ctx=ctx)[0]
    if spec.kind == "rglru":
        x = rec.rglru_block(cfg, p, x, train=True, ctx=ctx)[0]
        return _ffn_part(cfg, spec, p, x, ctx) if spec.has_ffn else x
    raise ValueError(spec.kind)


#: the products whose outputs ``remat="dots"`` keeps: those without batch
#: dimensions (``x @ W`` reaches these), as JAX's
#: ``checkpoint_dots_with_no_batch_dims``; batched products (attention's
#: ``bmm``) and everything else are recomputed
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(cfg: ModelConfig, fn):
    """``fn`` under the config's activation checkpointing, as JAX's
    ``_remat``: "none" keeps every activation, "full" keeps only ``fn``'s
    inputs and recomputes the rest in the backward, "dots" also keeps the
    outputs of ``_DOTS``.  Non-reentrant checkpointing runs the first
    forward with autograd on, so the forward and the recompute take the
    same path and give the same bits."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("dots", "full"):
        raise ValueError(f"remat must be none, dots or full, not "
                         f"{cfg.remat!r}")
    policy = {}
    if cfg.remat == "dots":
        policy["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    # the model draws no random numbers: no RNG state to carry
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             preserve_rng_state=False, **policy)


def apply_groups_train(model: Transformer, x: torch.Tensor,
                       positions: torch.Tensor,
                       ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """Every layer in order, one repetition of a group's pattern at a time
    under ``_remat`` (JAX's granularity).  Each stacked leaf is unbound
    once, so that its gradient is assembled by one stack and not by a
    zero-filled copy of the whole stack for every layer, as indexing it per
    layer would give."""
    cfg = model.cfg
    for (pattern, reps), stacked_g in zip(cfg.blocks, model.groups):
        per_pos = [{k: t.unbind(0) for k, t in stacked.items()}
                   for stacked in stacked_g]

        def body(xc, layer_params, pattern=pattern):
            for spec, p in zip(pattern, layer_params):
                xc = apply_layer_train(cfg, spec, p, xc, positions, ctx)
            return xc

        body = _remat(cfg, body)
        for r in range(reps):
            x = body(x, [{k: t[r] for k, t in layers.items()}
                         for layers in per_pos])
    return x


def forward_train(model: Transformer, inputs: torch.Tensor,
                  ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """inputs: (B, S) integer tokens or (B, S, D) frontend embeddings ->
    (B, S, V) logits."""
    B, S = inputs.shape[:2]
    x = embed(model, inputs, ctx)
    positions = _positions(B, S, inputs.device, ctx)
    return logits_fn(model, apply_groups_train(model, x, positions, ctx), ctx)


def lm_loss(model: Transformer, inputs: torch.Tensor, targets: torch.Tensor,
            ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """Mean next-token cross-entropy, the JAX package's fused stable form:
    the max is taken without gradient and subtracted in the logits' dtype,
    then the rest runs in fp32.  With a context the loss is a replicated
    DTensor, and its backward must run under ``sharding.mesh_mode(ctx)``
    (``runtime.steps`` does so)."""
    with sharding.mesh_mode(ctx):
        logits = forward_train(model, inputs, ctx)
        if ctx is not None:
            targets = _constrain(targets, ctx, (ctx.dp_axes,))
            return torch.mean(_token_losses(logits, targets, ctx))
        lmax = torch.amax(logits, dim=-1, keepdim=True).detach()
        shifted = (logits - lmax).float()
        lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
        tgt = torch.gather(shifted, -1, targets[..., None].long())[..., 0]
        return torch.mean(lse - tgt)


def _token_losses(logits: torch.Tensor, targets: torch.Tensor,
                  ctx: ShardCtx) -> torch.Tensor:
    """Each token's cross-entropy, ``lse - shifted[target]``, with the
    vocab cut over "model" (the logits as ``logits_fn`` leaves them): on
    local shards, the max, the sum of exponentials and the target's logit
    each taken over "model" by one collective, so that no rank holds the
    whole vocab.  Bit for bit the unsharded arithmetic where "model" has
    one rank."""
    mesh, tp = ctx.mesh, ctx.tp_axis
    spec = sharding._divisible((ctx.dp_axes, None, tp), tuple(logits.shape),
                               mesh)
    cut = spec[2] is not None
    group = mesh.get_group(tp)

    def local(lg, tg):
        lmax = torch.amax(lg, dim=-1, keepdim=True).detach()
        if cut:
            comm.all_reduce(lmax, [group], "loss_max",
                            op=torch.distributed.ReduceOp.MAX)
        shifted = (lg - lmax).float()
        se = torch.sum(torch.exp(shifted), dim=-1)
        lse = torch.log(comm.psum(se, group, "loss_sum") if cut else se)
        n = shifted.shape[-1]
        idx = tg.long() - mesh.get_local_rank(tp) * n if cut else tg.long()
        mine = (idx >= 0) & (idx < n)
        got = torch.gather(shifted, -1, torch.where(mine, idx, 0)[..., None])
        got = torch.where(mine, got[..., 0], 0.0)
        return lse - (comm.psum(got, group, "target") if cut else got)

    return sharding.on_shards(local, mesh, (spec, spec[:2]), spec[:2])(
        logits, targets)
