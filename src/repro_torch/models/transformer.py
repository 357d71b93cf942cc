"""Model assembly for stacks of attention and recurrent layers, ported from
``repro.models.transformer``: embedding, logits, caches, prefill and greedy
decode steps, with the per-kind dispatch of ``apply_layer_prefill``,
``apply_layer_decode`` and ``init_layer_state``; and the training forward
and loss (``forward_train``, ``lm_loss``) through every kind, with the
config's activation checkpointing (``remat``).  A layer's FFN is dense or,
with ``cfg.moe``, routed (``models.moe.moe_ffn``).  Prefill and training
take (B, S) token ids or, for a modality frontend, (B, S, D) embeddings.
JAX's ``lax.scan`` over a group's ``reps`` becomes a Python loop; the
caches keep JAX's nesting (per group, per pattern position, a dict of
tensors stacked over ``reps``): attention KV caches, or the state of a
recurrent layer.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import recurrent as rec
from repro_torch.models.attention import (attention_train, decode_attention,
                                          init_cache, prefill_attention,
                                          qkv_project)
from repro_torch.models.common import (LayerSpec, ModelConfig, Transformer,
                                       rms_norm, weak_scalar)
from repro_torch.models.moe import dense_ffn, moe_ffn

Caches = Tuple[Tuple[Dict[str, torch.Tensor], ...], ...]


def _layer(stacked, r: int) -> Dict[str, torch.Tensor]:
    return {k: t[r] for k, t in stacked.items()}


def _ffn_part(cfg: ModelConfig, p: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    return x + (moe_ffn(cfg, p, h) if cfg.moe is not None
                else dense_ffn(p, h))


def embed(model: Transformer, inputs: torch.Tensor) -> torch.Tensor:
    """inputs: (B, S) integer tokens -> (B, S, D) rows of the table scaled
    by sqrt(d_model); or (B, S, D) frontend embeddings, cast to the model's
    dtype and not scaled."""
    cfg = model.cfg
    if inputs.is_floating_point():
        return inputs.to(cfg.tdtype())
    table = model.embed
    return (table[inputs] * weak_scalar(cfg.d_model ** 0.5, table)
            ).to(cfg.tdtype())


def logits_fn(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    """Tied head: (B, S, D) -> (B, S, V) logits against ``embed.T``."""
    x = rms_norm(x, model.out_norm, model.cfg.norm_eps)
    return x @ model.embed.T


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
                         max_seq: int):
    if spec.kind == "attn":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        cache = init_cache(cfg, spec.window, x.shape[0], max_seq, cfg.tdtype(),
                           x.device)
        attn_out, new_cache = prefill_attention(cfg, p, h, spec.window,
                                                positions, cache)
        return _ffn_part(cfg, p, x + attn_out), new_cache
    if spec.kind == "mlstm":
        return rec.mlstm_block(cfg, p, x)
    if spec.kind == "slstm":
        return rec.slstm_block(cfg, p, x)
    if spec.kind == "rglru":
        x, st = rec.rglru_block(cfg, p, x)
        if spec.has_ffn:
            x = _ffn_part(cfg, p, x)
        return x, st
    raise ValueError(spec.kind)


def _apply_layer_decode(cfg: ModelConfig, spec: LayerSpec, p, x,
                        cache: Dict[str, torch.Tensor], position: int
                        ) -> torch.Tensor:
    """One layer of a decode step.  ``cache`` holds this layer's views into
    the stacked caches; they are updated in place."""
    if spec.kind == "attn":
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        attn_out, _ = decode_attention(cfg, p, h, cache, position)
        return _ffn_part(cfg, p, x + attn_out)
    step = {"mlstm": rec.mlstm_step, "slstm": rec.slstm_step,
            "rglru": rec.rglru_step}.get(spec.kind)
    if step is None:
        raise ValueError(spec.kind)
    x, new_state = step(cfg, p, x, cache)
    for k, t in new_state.items():
        cache[k].copy_(t)
    if spec.kind == "rglru" and spec.has_ffn:
        x = _ffn_part(cfg, p, x)
    return x


@torch.no_grad()
def prefill(model: Transformer, inputs: torch.Tensor,
            max_seq: Optional[int] = None) -> Tuple[torch.Tensor, Caches]:
    """Run the whole prompt, building caches.  inputs: (B, S) tokens or
    (B, S, D) embeddings.  Returns (last position's logits (B, V), caches)."""
    cfg = model.cfg
    B, S = inputs.shape[:2]
    max_seq = max_seq or S
    x = embed(model, inputs)
    positions = torch.arange(S, device=inputs.device).expand(B, S)
    new_groups = []
    for (pattern, reps), stacked_g in zip(cfg.blocks, model.groups):
        per_rep = []
        for r in range(reps):
            states = []
            for spec, stacked in zip(pattern, stacked_g):
                x, st = _apply_layer_prefill(cfg, spec, _layer(stacked, r), x,
                                             positions, max_seq)
                states.append(st)
            per_rep.append(states)
        new_groups.append(tuple(
            {k: torch.stack([rep[i][k] for rep in per_rep])
             for k in per_rep[0][i]}
            for i in range(len(pattern))))
    logits = logits_fn(model, x[:, -1:])
    return logits[:, 0], tuple(new_groups)


@torch.no_grad()
def decode_step(model: Transformer, caches: Caches, tokens: torch.Tensor,
                position: int) -> Tuple[torch.Tensor, Caches]:
    """tokens: (B,) integer at global ``position``.  Returns (logits (B, V),
    caches); the caches are updated in place."""
    cfg = model.cfg
    x = embed(model, tokens[:, None])
    for (pattern, reps), stacked_g, caches_g in zip(cfg.blocks, model.groups,
                                                    caches):
        for r in range(reps):
            for spec, stacked, cache in zip(pattern, stacked_g, caches_g):
                x = _apply_layer_decode(cfg, spec, _layer(stacked, r), x,
                                        _layer(cache, r), position)
    logits = logits_fn(model, x)
    return logits[:, 0], caches


# ---------------------------------------------------------------------------
# Training forward and loss
# ---------------------------------------------------------------------------
def apply_layer_train(cfg: ModelConfig, spec: LayerSpec,
                      p: Dict[str, torch.Tensor], x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """One layer of the training forward.  Attention takes the plain banded
    or chunked path, as JAX's does; the recurrent kinds take their training
    forms, which call no forward-only kernel."""
    if spec.kind == "attn":
        B, S = x.shape[:2]
        q, k, v = qkv_project(cfg, p, rms_norm(x, p["ln1"], cfg.norm_eps),
                              positions)
        out = attention_train(cfg, q, k, v, spec.window)
        x = x + out.reshape(B, S, cfg.n_heads * cfg.dh) @ p["wo"]
        return _ffn_part(cfg, p, x)
    if spec.kind == "mlstm":
        return rec.mlstm_block(cfg, p, x, train=True)[0]
    if spec.kind == "slstm":
        return rec.slstm_block(cfg, p, x)[0]
    if spec.kind == "rglru":
        x = rec.rglru_block(cfg, p, x, train=True)[0]
        return _ffn_part(cfg, p, x) if spec.has_ffn else x
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
                       positions: torch.Tensor) -> torch.Tensor:
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
                xc = apply_layer_train(cfg, spec, p, xc, positions)
            return xc

        body = _remat(cfg, body)
        for r in range(reps):
            x = body(x, [{k: t[r] for k, t in layers.items()}
                         for layers in per_pos])
    return x


def forward_train(model: Transformer, inputs: torch.Tensor) -> torch.Tensor:
    """inputs: (B, S) integer tokens or (B, S, D) frontend embeddings ->
    (B, S, V) logits."""
    B, S = inputs.shape[:2]
    x = embed(model, inputs)
    positions = torch.arange(S, device=inputs.device).expand(B, S)
    return logits_fn(model, apply_groups_train(model, x, positions))


def lm_loss(model: Transformer, inputs: torch.Tensor,
            targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy, the JAX package's fused stable form:
    the max is taken without gradient and subtracted in the logits' dtype,
    then the rest runs in fp32."""
    logits = forward_train(model, inputs)
    lmax = torch.amax(logits, dim=-1, keepdim=True).detach()
    shifted = (logits - lmax).float()
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1))
    tgt = torch.gather(shifted, -1, targets[..., None].long())[..., 0]
    return torch.mean(lse - tgt)
