"""Plain fp32 reference of the benchmark's configurations: a Qwen3 decoder
(GQA with qk-norm, RoPE, SwiGLU or routed experts) written from the
published description, in plain PyTorch, with TF32 off.  It imports
nothing of the program.

It is the default reference module (``bench/arch.py``): a configuration
that names none is checked by it.  A module of another architecture,
``bench/reference/<name>.py``, supplies the same functions and may take
these for whatever it does not change:

* ``global_specs(model)``, ``layer_specs(model, layer)``: the leaves
  outside the layers and of layer ``layer``, as ``weights.Spec``;
* ``layer(model, p, x, segments, quant, index=layer)``, ``embed``,
  ``logits``, ``head``, ``lm_loss``;
* the work counts: ``layer_matmul_params(model, layer)``, the
  parameters a token multiplies through in a layer; ``keys(model,
  layer, pos)``, the keys a query at ``pos`` reads there;
  ``moe_decode_bytes(model, layer)``, the bytes of a routed FFN call on
  one token (None where the layer is not routed).

Every layer here is full causal attention: a layer's ``LayerSpec``
fields (``model["layers"]``) are not read.  A module whose layers have
windows builds on ``attention_block(..., window)``, ``ffn_block`` and
``window_keys``, the port's window rule.

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
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench import arch
from bench.weights import GAIN_WO, NORM, QK_NORM, Spec
from bench.work import BF16_BYTES

FP8 = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def global_specs(model: Dict) -> Dict[str, Spec]:
    D, V = model["d_model"], model["vocab"]
    dt = getattr(torch, model["dtype"])
    out = {"embed": ((V, D), dt, D ** -0.5, 0.0),
           "out_norm": ((D,), dt, NORM[1], NORM[0])}
    if not model["tie_embeddings"]:
        out["lm_head"] = ((D, V), dt, D ** -0.5, 0.0)
    return out


def layer_specs(model: Dict, layer: int) -> Dict[str, Spec]:
    """One attention layer's leaves, as the port lays them out (x @ W,
    W shaped (in, out); experts stacked on a leading axis)."""
    D, H, KV, dh = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                    model["head_dim"])
    dt = getattr(torch, model["dtype"])
    s = D ** -0.5
    out = {"ln1": ((D,), dt, NORM[1], NORM[0]),
           "wq": ((D, H * dh), dt, s, 0.0), "wk": ((D, KV * dh), dt, s, 0.0),
           "wv": ((D, KV * dh), dt, s, 0.0),
           "wo": ((H * dh, D), dt, GAIN_WO * (H * dh) ** -0.5, 0.0),
           "ln2": ((D,), dt, NORM[1], NORM[0])}
    if model["qk_norm"]:
        out["q_norm"] = ((dh,), dt, QK_NORM[1], QK_NORM[0])
        out["k_norm"] = ((dh,), dt, QK_NORM[1], QK_NORM[0])
    moe = model.get("moe")
    if moe:
        E, F = moe["n_experts"], moe["d_expert"]
        out.update(
            router=((D, E), getattr(torch, moe["router_dtype"]), s, 0.0),
            w_gate=((E, D, F), dt, s, 0.0), w_up=((E, D, F), dt, s, 0.0),
            w_down=((E, F, D), dt, F ** -0.5, 0.0))
    else:
        F = model["d_ff"]
        out.update(w_gate=((D, F), dt, s, 0.0), w_up=((D, F), dt, s, 0.0),
                   w_down=((F, D), dt, F ** -0.5, 0.0))
    return out


def layer_matmul_params(model: Dict, layer: int) -> int:
    """Parameters one token multiplies through in one layer: the four
    attention projections and the FFN it is routed to (the router and
    ``top_k`` experts where the layer is routed).  Norm scales do no
    products and are left out."""
    D, H, KV, dh = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                    model["head_dim"])
    attn = D * H * dh + 2 * D * KV * dh + H * dh * D
    moe = model.get("moe")
    if moe:
        ffn = D * moe["n_experts"] + moe["top_k"] * 3 * D * moe["d_expert"]
    else:
        ffn = 3 * D * model["d_ff"]
    return attn + ffn


def keys(model: Dict, layer: int, pos: int) -> int:
    """Keys a query at position ``pos`` reads in ``layer``: all up to its
    own (causal)."""
    return pos + 1


def window_keys(model: Dict, layer: int, pos: int) -> int:
    """``keys`` under the port's window rule, for a module whose layers
    have windows: in a layer whose ``LayerSpec`` has window w, a query at
    ``pos`` reads the keys pos - w + 1 .. pos."""
    w = arch.layers(model)[layer].get("window")
    return min(pos + 1, w) if w else pos + 1


def moe_decode_bytes(model: Dict, layer: int) -> Optional[float]:
    """Bytes one routed FFN call on a single token needs: the ``top_k``
    experts' three bf16 matrices, the fp32 router, and the bf16
    activation in and out."""
    moe = model.get("moe")
    if not moe:
        return None
    D = model["d_model"]
    experts = moe["top_k"] * 3 * D * moe["d_expert"] * BF16_BYTES
    return float(experts + D * moe["n_experts"] * 4 + 2 * D * BF16_BYTES)


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
              chunk: int = 512, window: Optional[int] = None
              ) -> torch.Tensor:
    """Causal attention, q (B, S, H, dh), k and v (B, S, KV, dh); query
    head h reads key head h // (H / KV).  With ``window`` w, a query at
    position p reads the keys p - w + 1 .. p only."""
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
        masked = kp > qp
        if window:
            masked = masked | (kp <= qp - window)
        s = s.masked_fill(masked, float("-inf"))
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


def attention_block(model: Dict, p: Dict[str, torch.Tensor],
                    x: torch.Tensor, quant: Optional[str] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """x (B, S, D) plus its self-attention over positions 0 .. S-1 (with
    ``window``, each query over the window before it)."""
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
    a = attention(q, k, v, model.get("q_chunk", 512),
                  window).reshape(B, S, H * dh)
    return x + linear(a, p["wo"], quant)


def ffn_block(model: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
              segments: Optional[Sequence[Tuple[int, int]]] = None,
              quant: Optional[str] = None) -> torch.Tensor:
    """x (B, S, D) plus its FFN: SwiGLU, or routed experts where the model
    has ``moe``."""
    B, S, D = x.shape
    h = rms_norm(x, p["ln2"], model["norm_eps"])
    if model.get("moe"):
        segs = segments or [(0, S)]
        f = torch.stack([moe_ffn(model, p, h[b], segs, quant)
                         for b in range(B)])
    else:
        f = linear(F.silu(linear(h, p["w_gate"], quant))
                   * linear(h, p["w_up"], quant), p["w_down"], quant)
    return x + f


def layer(model: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
          segments: Optional[Sequence[Tuple[int, int]]] = None,
          quant: Optional[str] = None, index: int = 0) -> torch.Tensor:
    """Decoder layer ``index`` over x (B, S, D), positions 0 .. S-1.
    ``segments`` (routed layers, B = 1): the calls that the tokens were
    run in; by default the whole sequence in one call a row."""
    return ffn_block(model, p, attention_block(model, p, x, quant),
                     segments, quant)


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
                  tokens: torch.Tensor, quant: Optional[str] = None,
                  layer_fn: Callable = layer) -> torch.Tensor:
    x = embed(model, leaves["embed"], tokens)
    for i, p in enumerate(layers):
        x = layer_fn(model, p, x, quant=quant, index=i)
    return logits(model, head(model, leaves), leaves["out_norm"], x, quant)


def lm_loss(model: Dict, leaves: Dict[str, torch.Tensor],
            layers: List[Dict[str, torch.Tensor]], inputs: torch.Tensor,
            targets: torch.Tensor, quant: Optional[str] = None,
            layer_fn: Callable = layer) -> torch.Tensor:
    """Mean next-token cross-entropy over every token of the batch, through
    ``layer_fn`` (a module of another architecture passes its own
    ``layer``)."""
    lg = forward_train(model, leaves, layers, inputs, quant, layer_fn)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           targets.reshape(-1).long())
