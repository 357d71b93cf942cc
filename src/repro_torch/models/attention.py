"""Attention substrate: GQA, RoPE, qk-norm, sliding-window / global layers,
ported from ``repro.models.attention``; a layer may take no position
encoding (NoPE: ``use_rope=False``).

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
* **on a mesh** (a ``ShardCtx``): the q/k/v products are column-cut and
  the output product row-cut over "model" (``sharding.columns``,
  ``sharding.rows``), and attention runs on each rank's local shards
  (``sharded_attention``): a batch slice and a slice of the heads where H
  divides the "model" size (K/V repeated to H heads where KV does not, or
  with ``cfg.attn_head_shard``, as the reference does), else a slice of
  the query positions.  Attention is exact per head, batch row and query,
  so the kernel and the plain versions run unchanged there.  Decode
  writes the new slot into the local shard that owns it (the caches of
  ``sharding.cache_pspecs`` cut the sequence over "model").
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
from torch.distributed.tensor import Partial, Replicate

from repro_torch.kernels import ops
from repro_torch.kernels.swa import swa_plain as banded_window_attention
from repro_torch.models.common import ModelConfig, rms_norm, rope
from repro_torch.parallel import comm, sharding

__all__ = ["NEG_INF", "attention_train", "banded_window_attention",
           "decode_attention", "full_attention_chunked", "init_cache",
           "prefill_attention", "qkv_project", "sharded_attention"]

NEG_INF = -1e30
Cache = Dict[str, torch.Tensor]


def _split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    return sharding.unflatten(x, -1, (n, dh))


def qkv_project(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                positions: torch.Tensor, ctx=None, use_rope: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> q (B,S,H,dh), k/v (B,S,KV,dh) with RoPE + qk-norm
    (with a context, the products column-cut over "model"); without
    ``use_rope`` (a NoPE layer) no position enters q or k."""
    q, k, v = sharding.columns(ctx, x, p, ("wq", "wk", "wv"))
    q = _split_heads(q, cfg.n_heads, cfg.dh)
    k = _split_heads(k, cfg.n_kv_heads, cfg.dh)
    v = _split_heads(v, cfg.n_kv_heads, cfg.dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if use_rope:
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
                           q_chunk: int, q_offset: int = 0) -> torch.Tensor:
    """Causal full attention over query chunks (O(S·c) score memory).
    With ``q_offset``, q holds the queries of positions ``q_offset`` on
    and k/v the keys from position 0 (a block of a sharded sequence)."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    kpos = torch.arange(k.shape[1], device=q.device)
    c = min(q_chunk, S)
    outs = []
    for i0 in range(0, S, c):
        qi = q[:, i0:i0 + c]
        n = qi.shape[1]                                # the last may be short
        s = _gqa_scores(qi.reshape(B, n, KV, G, dh), k) * scale
        qpos = q_offset + i0 + torch.arange(n, device=q.device)
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


def sharded_attention(cfg: ModelConfig, ctx, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, window: Optional[int],
                      band) -> torch.Tensor:
    """Causal attention of DTensors q (B, S, H, dh), k/v (B, S, KV, dh) on
    each rank's local shards, every batch row on its data shard and the
    work of each cut over "model" as the reference's program cuts it:

    * H divisible by the "model" size: by heads.  Where KV is not (or with
      ``cfg.attn_head_shard``), K/V are first repeated to H heads.
    * else by query positions (``_attention_by_rows``).

    ``band(q, k, v, window)`` is the window layers' attention (the kernel
    in prefill, the plain banded form in training); with ``band`` None,
    the chunked full attention."""
    B, S, H, dh = q.shape
    G = H // cfg.n_kv_heads
    tp = ctx.tp_size
    if H % tp:
        return _attention_by_rows(cfg, ctx, q, k, v, window, band)
    if (cfg.attn_head_shard or cfg.n_kv_heads % tp) and G > 1:
        k, v = _repeat_heads(k, G), _repeat_heads(v, G)
    spec = _heads_spec(cfg, ctx, tuple(q.shape), k.shape[2])
    kv_spec = _heads_spec(cfg, ctx, tuple(k.shape), k.shape[2])

    def attend(q, k, v):
        if band is not None:
            return band(q, k, v, window)
        return full_attention_chunked(q, k, v, cfg.q_chunk)

    return sharding.on_shards(attend, ctx.mesh, (spec, kv_spec, kv_spec),
                              spec)(q, k, v)


def _row_blocks(S: int, tp: int, rank: int, zigzag: bool):
    """The query blocks [b0, b1) that ``rank`` of ``tp`` attends for, in
    the order the ranks' outputs are gathered: one contiguous block each,
    or with ``zigzag`` blocks r and 2·tp - 1 - r of 2·tp, so that every
    rank meets as many causal keys.  None where S does not divide."""
    n = 2 * tp if zigzag else tp
    if S % n:
        return None
    blk = S // n
    idx = [rank, n - 1 - rank] if zigzag else [rank]
    return [(i * blk, (i + 1) * blk) for i in idx]


def _attention_by_rows(cfg: ModelConfig, ctx, q, k, v, window, band):
    """Attention whose heads do not divide the "model" size, cut over it
    by query positions: each rank holds q, k and v whole (gathered) and
    attends for its blocks of queries, the banded window layers over one
    contiguous block with its window of earlier keys, the others over two
    blocks taken zig-zag, each against the keys up to its end (every key
    it may see and no later one); the blocks' outputs are gathered whole
    over "model".  q, k and v get partial gradients (a rank's queries
    see only part of them)."""
    mesh, tp_axis = ctx.mesh, ctx.tp_axis
    B, S, H, dh = q.shape
    tp = ctx.tp_size
    use_band = band is not None
    group = mesh.get_group(tp_axis)
    rank = mesh.get_local_rank(tp_axis)
    blocks = _row_blocks(S, tp, rank, zigzag=not use_band)
    if blocks is None:
        sharding.note_whole("attention")
    spec = sharding._divisible((ctx.dp_axes, None, None, None),
                               tuple(q.shape), mesh)
    pls = sharding.placements(spec, mesh)
    t = tuple(mesh.mesh_dim_names).index(tp_axis)
    grad = tuple(Partial() if i == t and blocks else pl
                 for i, pl in enumerate(pls))

    def block(ql, kl, vl, b0, b1):
        if use_band:
            k0 = max(0, b0 - window + 1)
            return band(ql[:, k0:b1], kl[:, k0:b1], vl[:, k0:b1],
                        window)[:, b0 - k0:]
        return full_attention_chunked(ql[:, b0:b1], kl[:, :b1], vl[:, :b1],
                                      cfg.q_chunk, q_offset=b0)

    def local(ql, kl, vl):
        if blocks is None:      # S does not divide: every rank attends whole
            return block(ql, kl, vl, 0, S)
        mine = torch.cat([block(ql, kl, vl, b0, b1) for b0, b1 in blocks], 1)
        out = comm.gather(mine, group, 1, "attn_rows")
        if use_band:
            return out
        n = 2 * tp              # gathered as blocks 0, n-1, 1, n-2, ...
        order = [i for r in range(tp) for i in (r, n - 1 - r)]
        inv = torch.tensor([order.index(i) for i in range(n)],
                           device=out.device)
        return out.reshape(out.shape[0], n, S // n, H, dh)[:, inv].reshape(
            out.shape)

    return sharding.on_shards(local, mesh, (spec, spec, spec), spec,
                              (grad, grad, grad))(q, k, v)


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
                     x: torch.Tensor, cache: Cache,
                     position: Union[int, torch.Tensor], ctx=None,
                     use_rope: bool = True) -> Tuple[torch.Tensor, Cache]:
    """x: (B, 1, D); returns (attention output (B, 1, D), the cache, updated
    in place).  Without a context ``position`` is a 0-d integer tensor on
    x's device, and the slot, the writes and the mask are worked out from
    it there: the host reads nothing, so a captured step holds them.  With
    one it is an int and the cache holds DTensors laid out by
    ``sharding.cache_pspecs``."""
    B = x.shape[0]
    H, KV, dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    G = H // KV
    if ctx is None:
        pos1 = position.to(torch.int32).expand(B, 1)
    else:
        pos1 = torch.full((B, 1), position, dtype=torch.int32,
                          device=x.device)
    q, k_new, v_new = qkv_project(cfg, p, x, pos1, ctx, use_rope)
    k, v, pos = cache["k"], cache["v"], cache["pos"]
    slot = position % k.shape[1]
    if ctx is None:
        slot = slot.reshape(1)
        k.index_copy_(1, slot, k_new)
        v.index_copy_(1, slot, v_new)
        pos.index_copy_(0, slot, pos1[0])
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
    return sharding.rows(ctx, ctx_.reshape(B, 1, H * dh), p, "wo"), cache


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
                      ctx=None, use_rope: bool = True
                      ) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Prefill attention; fills ``cache`` (fresh, from ``init_cache``) if
    given.  With a context the new cache is made of DTensors, batch over
    the data axes (and kv heads over "model" where they divide)."""
    q, k, v = qkv_project(cfg, p, x, positions, ctx, use_rope)
    if ctx is not None:
        out = sharded_attention(cfg, ctx, q, k, v, window,
                                window and ops.sliding_window_attention)
    elif window is not None:
        out = ops.sliding_window_attention(q, k, v, window)
    else:
        out = full_attention_chunked(q, k, v, cfg.q_chunk)
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
    return sharding.rows(ctx, out, p, "wo"), new_cache
