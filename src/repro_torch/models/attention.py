"""Attention substrate: GQA, RoPE, qk-norm, sliding-window / global layers,
ported from ``repro.models.attention``.

* **window layers (prefill)** call ``ops.sliding_window_attention`` at every
  prompt length: the SWA kernel on the card, and on the CPU its plain
  version, which is the JAX package's ``banded_window_attention`` with P·V
  in fp32.  For S <= w the band is the whole causal triangle, so this also
  covers the JAX path's full-attention branch for short prompts.
* **global layers (prefill)** loop over query chunks, each attending to all
  keys with a causal mask.
* **training** (``attention_train``) keeps JAX's choice: the plain banded
  form for window layers longer than their window, chunked causal
  attention otherwise.  It never reaches a kernel: the kernels are forward
  only, and autograd differentiates the plain versions.
* **decode**: one query token against a KV cache; window layers keep a ring
  buffer of w slots (global position p in slot p % w), global layers the
  full sequence.  Decode writes the new key and value into the cache in
  place.
* **on a mesh** (a ``ShardCtx``): attention runs on each rank's local
  shards (``sharded_attention``), a batch slice and, where the head counts
  divide, a slice of the heads; with ``cfg.attn_head_shard`` K/V are first
  repeated to H heads, as the reference does.  Attention is exact per head
  and batch row, so the kernel and the plain versions run unchanged there.
  Decode writes the new slot into the local shard that owns it (the
  caches of ``sharding.cache_pspecs`` cut the sequence over "model").
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import Replicate

from repro_torch.kernels import ops
from repro_torch.kernels.swa import swa_plain as banded_window_attention
from repro_torch.models.common import ModelConfig, rms_norm, rope
from repro_torch.parallel import sharding

__all__ = ["NEG_INF", "attention_train", "banded_window_attention",
           "decode_attention", "full_attention_chunked", "init_cache",
           "prefill_attention", "qkv_project", "sharded_attention"]

NEG_INF = -1e30
Cache = Dict[str, torch.Tensor]


def _split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    return sharding.unflatten(x, -1, (n, dh))


def qkv_project(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                positions: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,S,H,dh), k/v (B,S,KV,dh) with RoPE + qk-norm."""
    q = _split_heads(x @ p["wq"], cfg.n_heads, cfg.dh)
    k = _split_heads(x @ p["wk"], cfg.n_kv_heads, cfg.dh)
    v = _split_heads(x @ p["wv"], cfg.n_kv_heads, cfg.dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, v


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (..., Sq, KV, G, dh), k: (..., Sk, KV, dh) -> fp32 (..., KV, G, Sq, Sk).
    Upcasting first gives the fp32 accumulation of JAX's
    ``preferred_element_type=float32`` (products of bf16 values are exact
    in fp32)."""
    return torch.einsum("...qkgd,...skd->...kgqs", q.float(), k.float())


def _gqa_context(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (..., KV, G, Sq, Sk), v: (..., Sk, KV, dh) -> (..., Sq, KV, G, dh)."""
    return torch.einsum("...kgqs,...skd->...qkgd", probs.to(v.dtype), v)


def full_attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           q_chunk: int) -> torch.Tensor:
    """Causal full attention over query chunks (O(S·c) score memory)."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    kpos = torch.arange(S, device=q.device)
    c = min(q_chunk, S)
    outs = []
    for i0 in range(0, S, c):
        qi = q[:, i0:i0 + c]
        n = qi.shape[1]                                # the last may be short
        s = _gqa_scores(qi.reshape(B, n, KV, G, dh), k) * scale
        qpos = i0 + torch.arange(n, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]          # causal
        s = torch.where(mask, s, NEG_INF)
        outs.append(_gqa_context(torch.softmax(s, dim=-1), v))
    return torch.cat(outs, dim=1).reshape(B, S, H, dh)


def attention_train(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    """Attention of the training forward, with the JAX package's choice of
    path; q: (B, S, H, dh), k/v: (B, S, KV, dh) -> (B, S, H, dh)."""
    if window is not None and q.shape[1] > window:
        return banded_window_attention(q, k, v, window)
    return full_attention_chunked(q, k, v, cfg.q_chunk)


def _repeat_heads(k: torch.Tensor, G: int) -> torch.Tensor:
    """(B, S, KV, dh) -> (B, S, KV·G, dh), each head G times in a row
    (``jnp.repeat(k, G, axis=2)``)."""
    B, S, KV, dh = k.shape
    return k[:, :, :, None].expand(B, S, KV, G, dh).reshape(B, S, KV * G, dh)


def _heads_spec(cfg: ModelConfig, ctx, shape, kv_heads: int):
    """(B, S, heads, dh) on the mesh: batch over the data axes, heads over
    "model" where both head counts divide by its size."""
    tp = ctx.tp_size
    heads = (ctx.tp_axis if cfg.n_heads % tp == 0 and kv_heads % tp == 0
             else None)
    return sharding._divisible((ctx.dp_axes, None, heads, None), shape,
                               ctx.mesh)


def sharded_attention(cfg: ModelConfig, ctx, attend, q: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``attend(q, k, v)`` of DTensors q (B, S, H, dh), k/v (B, S, KV, dh),
    run on each rank's local batch rows and heads.  With
    ``cfg.attn_head_shard`` and H divisible by the "model" size, K/V are
    repeated to H heads first and every head count is sharded."""
    G = cfg.n_heads // cfg.n_kv_heads
    if cfg.attn_head_shard and cfg.n_heads % ctx.tp_size == 0 and G > 1:
        k, v = _repeat_heads(k, G), _repeat_heads(v, G)
    spec = _heads_spec(cfg, ctx, tuple(q.shape), k.shape[2])
    kv_spec = _heads_spec(cfg, ctx, tuple(k.shape), k.shape[2])
    return sharding.on_shards(attend, ctx.mesh, (spec, kv_spec, kv_spec),
                              spec)(q, k, v)


def init_cache(cfg: ModelConfig, window: Optional[int], batch: int,
               max_seq: int, dtype: torch.dtype, device=None) -> Cache:
    """KV cache for one attention layer (unstacked).

    Window layers use a ring buffer of size ``window`` with per-slot global
    positions; global layers use the full sequence buffer.
    """
    size = min(window, max_seq) if window else max_seq
    shape = (batch, size, cfg.n_kv_heads, cfg.dh)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.full((size,), -1, dtype=torch.int32, device=device),
    }


def _write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """cache[:, slot] = new[:, 0] for a DTensor cache (B, S, ...) whose
    sequence axis may be cut over the mesh: the write lands in the local
    shard that owns the slot, the new row laid out as the cache but for the
    sequence axis (``new`` (B, 1, ...))."""
    mesh = cache.device_mesh
    row_pl = [Replicate() if pl.is_shard(1) else pl
              for pl in cache.placements]
    row = new.redistribute(mesh, row_pl).to_local()
    offset = sharding.global_offset(cache)
    local = cache.to_local()
    i = slot - offset[1]
    if 0 <= i < local.shape[1]:
        local[:, i] = row[:, 0]


def _write_pos(pos: torch.Tensor, slot: int, position: int) -> None:
    """pos[slot] = position for a DTensor (S,) cut or not over the mesh."""
    offset = sharding.global_offset(pos)
    local = pos.to_local()
    i = slot - offset[0]
    if 0 <= i < local.shape[0]:
        local[i] = position


def decode_attention(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                     x: torch.Tensor, cache: Cache, position: int, ctx=None
                     ) -> Tuple[torch.Tensor, Cache]:
    """x: (B, 1, D); returns (attention output (B, 1, D), the cache, updated
    in place).  With a context the cache holds DTensors laid out by
    ``sharding.cache_pspecs``."""
    B = x.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    G = H // KV
    pos1 = torch.full((B, 1), position, dtype=torch.int32, device=x.device)
    q, k_new, v_new = qkv_project(cfg, p, x, pos1)
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    slot = position % k.shape[1]
    if ctx is None:
        k[:, slot] = k_new[:, 0]
        v[:, slot] = v_new[:, 0]
        pos[slot] = position
    else:
        _write_slot(k, k_new, slot)
        _write_slot(v, v_new, slot)
        _write_pos(pos, slot, position)
    s = torch.einsum("bqkgd,bskd->bkgqs",
                     sharding.unflatten(q, 2, (KV, G)).float(),
                     k.float()) * (dh ** -0.5)
    valid = (pos >= 0) & (pos <= position)
    s = torch.where(valid, s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    ctx_ = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return ctx_.reshape(B, 1, H * dh) @ p["wo"], cache


def _fill_cache(cache: Cache, k: torch.Tensor, v: torch.Tensor) -> Cache:
    """The prefill's keys and values into a fresh cache: the whole prompt,
    or the last ``size`` positions of a ring buffer smaller than it."""
    S = k.shape[1]
    size = cache["k"].shape[1]
    if size >= S:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        cache["pos"][:S] = torch.arange(S, dtype=torch.int32, device=k.device)
        return cache
    # ring buffer smaller than the prefill: keep the tail
    tail_p = torch.arange(S - size, S, dtype=torch.int32, device=k.device)
    # ring alignment: global position p lives in slot p % size
    roll = (S - size) % size
    return {"k": torch.roll(k[:, -size:], shifts=roll, dims=1),
            "v": torch.roll(v[:, -size:], shifts=roll, dims=1),
            "pos": torch.roll(tail_p, shifts=roll, dims=0)}


def prefill_attention(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                      x: torch.Tensor, window: Optional[int],
                      positions: torch.Tensor, cache: Optional[Cache] = None,
                      ctx=None) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Prefill attention; fills ``cache`` (fresh, from ``init_cache``) if
    given.  With a context the new cache is made of DTensors, batch over
    the data axes (and kv heads over "model" where they divide)."""
    q, k, v = qkv_project(cfg, p, x, positions)

    def attend(q, k, v):
        if window is not None:
            return ops.sliding_window_attention(q, k, v, window)
        return full_attention_chunked(q, k, v, cfg.q_chunk)

    out = (attend(q, k, v) if ctx is None
           else sharded_attention(cfg, ctx, attend, q, k, v))
    B, S = x.shape[:2]
    new_cache = None
    if cache is not None and ctx is None:
        new_cache = _fill_cache(cache, k, v)
    elif cache is not None:
        shape = cache["k"].shape

        def fill(k, v):
            local = {"k": k.new_zeros((k.shape[0], shape[1]) + k.shape[2:]),
                     "v": v.new_zeros((v.shape[0], shape[1]) + v.shape[2:]),
                     "pos": cache["pos"].clone()}
            local = _fill_cache(local, k, v)
            return local["k"], local["v"], local["pos"]

        kv_spec = _heads_spec(cfg, ctx, tuple(k.shape), k.shape[2])
        ck, cv, cpos = sharding.on_shards(
            fill, ctx.mesh, (kv_spec, kv_spec),
            [kv_spec, kv_spec, (None,)])(k, v)
        new_cache = {"k": ck, "v": cv, "pos": cpos}
    out = out.reshape(B, S, cfg.n_heads * cfg.dh)
    return out @ p["wo"], new_cache
