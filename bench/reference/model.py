"""Plain fp32 reference of the benchmark's configurations: a Qwen3 decoder
(GQA with qk-norm, RoPE, SwiGLU or routed experts) written from the
published description, in plain PyTorch, with TF32 off.  It imports
nothing of the program.

Where the configuration as run departs from the published model, the
reference computes the configuration as run (``configs/*.json`` lists
each departure): the embedding rows are scaled by sqrt(d_model), a norm
applies its scale as (1 + w), and a routed FFN keeps at most C = max(min(T, 32), ceil(T k / E cf)) tokens an
expert in each call over T tokens, filled in (expert, token) order, the
rest dropped.  ``segments`` name the calls: the token server prefills a
prompt in one call and decodes one token a call.

With ``quant="fp8"`` every product of a bf16 weight takes both operands
rounded to float8 e4m3 with a scale a tensor (an expert's matrix is a
tensor), and its backward the incoming gradient rounded to e5m2: the
control, one precision below the configuration's bf16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def exact_fp32() -> None:
    """fp32 products in fp32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(t: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``t`` rounded to a float8 type under one scale, back in fp32."""
    scale = t.abs().amax().clamp(min=1e-30) / FP8[dtype]
    return (t / scale).to(dtype).to(torch.float32) * scale


class _Fp8Product(torch.autograd.Function):
    """x @ w on e4m3 operands; the backward's products on the same
    operands and the e5m2 gradient."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fp8(x), fp8(w)
        ctx.save_for_backward(xq, wq)
        return xq @ wq

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = fp8(g, torch.float8_e5m2)
        gx = gq @ wq.T
        gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return gx, gw


def linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]
           ) -> torch.Tensor:
    if quant == "fp8":
        return _Fp8Product.apply(x, w)
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + w)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate the two halves of each head, x: (B, S, heads, dh)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float32,
                                  device=x.device) / half)
    ang = (pos.float()[:, None] * inv)[None, :, None, :]
    c, s = torch.cos(ang), torch.sin(ang)
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              chunk: int = 512) -> torch.Tensor:
    """Causal attention, q (B, S, H, dh), k and v (B, S, KV, dh); query
    head h reads key head h // (H / KV)."""
    B, S, H, dh = q.shape
    G = H // k.shape[2]
    k = k.repeat_interleave(G, dim=2)
    v = v.repeat_interleave(G, dim=2)
    outs = []
    for i0 in range(0, S, chunk):
        i1 = min(S, i0 + chunk)
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, i0:i1], k[:, :i1]) \
            * dh ** -0.5
        qp = torch.arange(i0, i1, device=q.device)[:, None]
        kp = torch.arange(i1, device=q.device)[None, :]
        s = s.masked_fill(kp > qp, float("-inf"))
        outs.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1),
                                 v[:, :i1]))
    return torch.cat(outs, dim=1)


def capacity(T: int, k: int, E: int, cf: float) -> int:
    return max(min(T, 32), int(math.ceil(T * k / E * cf)))


def route(model: Dict, h: torch.Tensor, router: torch.Tensor,
          segments: Sequence[Tuple[int, int]]
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h: (T, D).  (weights (T, k), experts (T, k), kept (T, k)): the top
    k experts by router logit (the lower index first on a tie), their
    softmax weights, and which routes the capacity of each call keeps."""
    moe = model["moe"]
    E, k = moe["n_experts"], moe["top_k"]
    logits = h @ router
    top, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    w = torch.softmax(top[:, :k], dim=-1)
    e = idx[:, :k]
    kept = torch.ones_like(e, dtype=torch.bool)
    for a, b in segments:
        C = capacity(b - a, k, E, moe["capacity_factor"])
        seg = e[a:b]
        if int(torch.bincount(seg.reshape(-1), minlength=E).max()) <= C:
            continue
        flat = seg.reshape(-1)                # token-major: token order
        keep = torch.zeros_like(flat, dtype=torch.bool)
        for x in torch.unique(flat).tolist():
            where = (flat == x).nonzero()[:, 0]
            keep[where[:C]] = True
        kept[a:b] = keep.reshape(seg.shape)
    return w, e, kept


def moe_ffn(model: Dict, p: Dict[str, torch.Tensor], h: torch.Tensor,
            segments: Sequence[Tuple[int, int]], quant: Optional[str]
            ) -> torch.Tensor:
    T, D = h.shape
    w, e, kept = route(model, h, p["router"], segments)
    out = torch.zeros_like(h)
    for x in torch.unique(e[kept]).tolist():
        tok, slot = ((e == x) & kept).nonzero(as_tuple=True)
        hx = h[tok]
        y = linear(F.silu(linear(hx, p["w_gate"][x], quant))
                   * linear(hx, p["w_up"][x], quant), p["w_down"][x], quant)
        out = out.index_add(0, tok, y * w[tok, slot][:, None])
    return out


def layer(model: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
          segments: Optional[Sequence[Tuple[int, int]]] = None,
          quant: Optional[str] = None) -> torch.Tensor:
    """One decoder layer over x (B, S, D), positions 0 .. S-1.
    ``segments`` (routed layers, B = 1): the calls that the tokens were
    run in; by default the whole sequence in one call a row."""
    B, S, D = x.shape
    H, KV, dh = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    eps = model["norm_eps"]
    pos = torch.arange(S, device=x.device)
    h = rms_norm(x, p["ln1"], eps)
    q = linear(h, p["wq"], quant).reshape(B, S, H, dh)
    k = linear(h, p["wk"], quant).reshape(B, S, KV, dh)
    v = linear(h, p["wv"], quant).reshape(B, S, KV, dh)
    if model["qk_norm"]:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    q = rope(q, pos, model["rope_theta"])
    k = rope(k, pos, model["rope_theta"])
    a = attention(q, k, v, model.get("q_chunk", 512)).reshape(B, S, H * dh)
    x = x + linear(a, p["wo"], quant)
    h = rms_norm(x, p["ln2"], eps)
    if model.get("moe"):
        segs = segments or [(0, S)]
        f = torch.stack([moe_ffn(model, p, h[b], segs, quant)
                         for b in range(B)])
    else:
        f = linear(F.silu(linear(h, p["w_gate"], quant))
                   * linear(h, p["w_up"], quant), p["w_down"], quant)
    return x + f


def embed(model: Dict, table: torch.Tensor, tokens: torch.Tensor
          ) -> torch.Tensor:
    return table[tokens] * model["d_model"] ** 0.5


def head(model: Dict, leaves: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The output head, (D, V): ``lm_head``, or the embedding table where
    the configuration ties them."""
    return (leaves["embed"].T if model["tie_embeddings"]
            else leaves["lm_head"])


def logits(model: Dict, w_head: torch.Tensor, out_norm: torch.Tensor,
           x: torch.Tensor, quant: Optional[str] = None) -> torch.Tensor:
    """Logits of the head ``w_head`` (D, V), x (..., D) -> (..., V)."""
    h = rms_norm(x, out_norm, model["norm_eps"])
    return linear(h, w_head, quant)


def forward_train(model: Dict, leaves: Dict[str, torch.Tensor],
                  layers: List[Dict[str, torch.Tensor]],
                  tokens: torch.Tensor, quant: Optional[str] = None
                  ) -> torch.Tensor:
    x = embed(model, leaves["embed"], tokens)
    for p in layers:
        x = layer(model, p, x, quant=quant)
    return logits(model, head(model, leaves), leaves["out_norm"], x, quant)


def lm_loss(model: Dict, leaves: Dict[str, torch.Tensor],
            layers: List[Dict[str, torch.Tensor]], inputs: torch.Tensor,
            targets: torch.Tensor, quant: Optional[str] = None
            ) -> torch.Tensor:
    """Mean next-token cross-entropy over every token of the batch."""
    lg = forward_train(model, leaves, layers, inputs, quant)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           targets.reshape(-1).long())
