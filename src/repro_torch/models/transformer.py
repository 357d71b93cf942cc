"""Model assembly for attention-only stacks, ported from
``repro.models.transformer``: embedding, logits, caches, prefill and greedy
decode steps.  JAX's ``lax.scan`` over a group's ``reps`` becomes a Python
loop; the caches keep JAX's nesting (per group, per pattern position, a
dict of tensors stacked over ``reps``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.attention import (decode_attention, init_cache,
                                          prefill_attention)
from repro_torch.models.common import LayerSpec, ModelConfig, Transformer, rms_norm
from repro_torch.models.moe import dense_ffn

Caches = Tuple[Tuple[Dict[str, torch.Tensor], ...], ...]


def _layer(stacked, r: int) -> Dict[str, torch.Tensor]:
    return {k: t[r] for k, t in stacked.items()}


def _ffn_part(cfg: ModelConfig, p: Dict[str, torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    return x + dense_ffn(p, rms_norm(x, p["ln2"], cfg.norm_eps))


def embed(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) integer -> (B, S, D) scaled by sqrt(d_model)."""
    cfg = model.cfg
    table = model.embed
    # JAX multiplies by the scale as a weakly typed scalar, i.e. rounded to
    # the table's dtype first
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=table.dtype,
                         device=table.device)
    return (table[tokens] * scale).to(cfg.tdtype())


def logits_fn(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    """Tied head: (B, S, D) -> (B, S, V) logits against ``embed.T``."""
    x = rms_norm(x, model.out_norm, model.cfg.norm_eps)
    return x @ model.embed.T


def init_caches(cfg: ModelConfig, batch: int, max_seq: int,
                device=None) -> Caches:
    """Nested (per group, per pattern position) stacked empty caches."""
    groups = []
    for pattern, reps in cfg.blocks:
        per_pos = []
        for spec in pattern:
            one = init_cache(cfg, spec.window, batch, max_seq, cfg.tdtype(),
                             device)
            per_pos.append({k: torch.stack([t] * reps) for k, t in one.items()})
        groups.append(tuple(per_pos))
    return tuple(groups)


def _apply_layer_prefill(cfg: ModelConfig, spec: LayerSpec, p, x, positions,
                         max_seq: int):
    B = x.shape[0]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    cache = init_cache(cfg, spec.window, B, max_seq, cfg.tdtype(), x.device)
    attn_out, new_cache = prefill_attention(cfg, p, h, spec.window, positions,
                                            cache)
    return _ffn_part(cfg, p, x + attn_out), new_cache


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor,
            max_seq: Optional[int] = None) -> Tuple[torch.Tensor, Caches]:
    """Run the whole prompt, building caches.  tokens: (B, S).
    Returns (last position's logits (B, V), caches)."""
    cfg = model.cfg
    B, S = tokens.shape
    max_seq = max_seq or S
    x = embed(model, tokens)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
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
    for (_, reps), stacked_g, caches_g in zip(cfg.blocks, model.groups,
                                              caches):
        for r in range(reps):
            for stacked, cache in zip(stacked_g, caches_g):
                p = _layer(stacked, r)
                h = rms_norm(x, p["ln1"], cfg.norm_eps)
                attn_out, _ = decode_attention(cfg, p, h, _layer(cache, r),
                                               position)
                x = _ffn_part(cfg, p, x + attn_out)
    logits = logits_fn(model, x)
    return logits[:, 0], caches
