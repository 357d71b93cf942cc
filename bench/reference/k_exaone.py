"""Plain fp32 reference of K-EXAONE-236B-A23B's decoder layers, written from
the family's published modeling code (``transformers``: ``exaone4`` for
the attention and the norms, ``glm4_moe`` for the router), in plain
PyTorch, with TF32 off (``model.exact_fp32``).  It imports nothing of the
program.

A layer (``model["layers"][index]`` gives its ``LayerSpec`` fields):

* attention over the layer's input, with no norm in front: GQA with each
  head's q and k RMS-normed, RoPE in window layers (``window`` w: a query
  at p reads the keys p - w + 1 .. p) and none in the global ones (NoPE,
  ``rope`` false), which read every earlier key;
* post-norm: ``x = x + ln1(attn(x))``, then ``x = x + ln2(ffn(x))``;
* the FFN: a SwiGLU of ``d_ff`` where ``ffn`` is "dense" (layer 0), else
  the routed experts plus the shared expert, both over x.  The router
  takes the top ``top_k`` of ``sigmoid(x @ router) + router_bias`` (the
  selection bias; with one group the group limit does nothing), weights
  the chosen experts by their sigmoid scores without the bias, divided by
  their sum and times ``routed_scale``.

The configuration as run departs from the published model as
``configs/k-exaone-236b-a23b.ep8.l24.json`` lists: embedding rows scaled by
sqrt(d_model), norm scales applied as (1 + w), a routed FFN that keeps at
most C = max(min(T, 32), ceil(T k / E cf)) tokens an expert in each call
over T tokens, filled in (expert, token) order (``segments`` name the
calls), and one card's share of the experts: only the experts
[0, ``moe.held``) add their part; the router still chooses among all E.
The rest (embedding, head, loss, the fp8 control) is ``model.py``'s.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from bench import arch
from bench.reference import model as base
from bench.reference.model import (  # noqa: F401  as Qwen3's
    embed, global_specs, head, logits)
from bench.weights import NORM, Spec
from bench.work import BF16_BYTES

#: (mean, scale) of the router's selection bias (``e_score_correction_bias``):
#: a DeepSeek-V3-style bias, learned in the published model and given
#: neither in its config nor in a public source (assumed); drawn as the
#: published modeling code initialises it, zero
BIAS = (0.0, 0.0)

keys = base.window_keys


def _spec(model: Dict, layer: int) -> Dict:
    return arch.layers(model)[layer]


def _routed(model: Dict, layer: int) -> bool:
    return bool(model.get("moe")) and _spec(model, layer).get("ffn") != "dense"


def layer_specs(model: Dict, layer: int) -> Dict[str, Spec]:
    """Layer ``layer``'s leaves, named and shaped as the program's:
    ``ln1`` and ``ln2`` are the norms after attention and after the FFN;
    a routed layer's experts are the ``held`` ones, stacked.  Every norm
    scale, q's and k's included, is drawn about 1 (``weights.NORM``), as
    the published modeling code initialises its norms (ones).  ``wo``
    takes no gain: the norm after attention undoes any scale."""
    D, H, KV, dh = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                    model["head_dim"])
    dt = getattr(torch, model["dtype"])
    s = D ** -0.5
    out = {"ln1": ((D,), dt, NORM[1], NORM[0]),
           "wq": ((D, H * dh), dt, s, 0.0), "wk": ((D, KV * dh), dt, s, 0.0),
           "wv": ((D, KV * dh), dt, s, 0.0),
           "wo": ((H * dh, D), dt, (H * dh) ** -0.5, 0.0),
           "q_norm": ((dh,), dt, NORM[1], NORM[0]),
           "k_norm": ((dh,), dt, NORM[1], NORM[0]),
           "ln2": ((D,), dt, NORM[1], NORM[0])}
    if not _routed(model, layer):
        Fd = model["d_ff"]
        out.update(w_gate=((D, Fd), dt, s, 0.0), w_up=((D, Fd), dt, s, 0.0),
                   w_down=((Fd, D), dt, Fd ** -0.5, 0.0))
        return out
    moe = model["moe"]
    E, Fe, Fs = moe["n_experts"], moe["d_expert"], moe["d_shared"]
    held = moe.get("held") or E
    f32 = torch.float32
    out.update(
        router=((D, E), getattr(torch, moe["router_dtype"]), s, 0.0),
        router_bias=((E,), f32, BIAS[1], BIAS[0]),
        w_gate=((held, D, Fe), dt, s, 0.0), w_up=((held, D, Fe), dt, s, 0.0),
        w_down=((held, Fe, D), dt, Fe ** -0.5, 0.0),
        shared_gate=((D, Fs), dt, s, 0.0), shared_up=((D, Fs), dt, s, 0.0),
        shared_down=((Fs, D), dt, Fs ** -0.5, 0.0))
    return out


def _expected_experts_params(model: Dict) -> int:
    """Parameters of the held experts that one token is routed to, on
    average: k · held / E experts' three matrices (exact where E divides
    k · held, as it does in every configuration here)."""
    moe = model["moe"]
    E = moe["n_experts"]
    held = moe.get("held") or E
    return moe["top_k"] * held * 3 * model["d_model"] * moe["d_expert"] // E


def layer_matmul_params(model: Dict, layer: int) -> int:
    """Parameters one token multiplies through in layer ``layer`` on this
    card: the four attention projections, and the dense FFN, or the
    router, the expected held experts and the shared expert."""
    D, H, KV, dh = (model["d_model"], model["n_heads"], model["n_kv_heads"],
                    model["head_dim"])
    attn = D * H * dh + 2 * D * KV * dh + H * dh * D
    if not _routed(model, layer):
        return attn + 3 * D * model["d_ff"]
    moe = model["moe"]
    return (attn + D * moe["n_experts"] + _expected_experts_params(model)
            + 3 * D * moe["d_shared"])


def moe_decode_bytes(model: Dict, layer: int) -> Optional[float]:
    """Bytes a routed call on a single token needs (the program's
    ``moe_ffn``, which the shared expert is not part of): the fp32 router
    and selection bias, the expected held experts' bf16 matrices, and the
    bf16 activation in and out.  None on the dense layer."""
    if not _routed(model, layer):
        return None
    D, E = model["d_model"], model["moe"]["n_experts"]
    return float(_expected_experts_params(model) * BF16_BYTES + D * E * 4
                 + E * 4 + 2 * D * BF16_BYTES)


def route(model: Dict, h: torch.Tensor, router: torch.Tensor,
          bias: torch.Tensor, segments: Sequence[Tuple[int, int]]
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h: (T, D).  (weights (T, k), experts (T, k), kept (T, k)): the top k
    of the biased sigmoid scores (the lower index first on a tie), their
    weights, and the routes that this card's experts take under the
    capacity of each call."""
    moe = model["moe"]
    E, k = moe["n_experts"], moe["top_k"]
    held = moe.get("held") or E
    scores = torch.sigmoid(h @ router)
    e = torch.sort(scores + bias, dim=-1, descending=True,
                   stable=True)[1][:, :k]
    w = scores.gather(1, e)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * moe["routed_scale"]
    kept = e < held
    for a, b in segments:
        C = base.capacity(b - a, k, E, moe["capacity_factor"])
        flat = e[a:b].reshape(-1)                 # token-major: token order
        keep = flat < held
        if int(torch.bincount(flat[keep], minlength=E).max()) <= C:
            continue
        for x in torch.unique(flat[keep]).tolist():
            where = (flat == x).nonzero()[:, 0]
            keep[where[C:]] = False
        kept[a:b] = keep.reshape(b - a, k)
    return w, e, kept


def swiglu(h: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    return base.linear(F.silu(base.linear(h, w_gate, quant))
                       * base.linear(h, w_up, quant), w_down, quant)


def routed_ffn(model: Dict, p: Dict[str, torch.Tensor], h: torch.Tensor,
               segments: Sequence[Tuple[int, int]], quant: Optional[str]
               ) -> torch.Tensor:
    """The held experts' part of the routed FFN over h (T, D)."""
    w, e, kept = route(model, h, p["router"], p["router_bias"], segments)
    out = torch.zeros_like(h)
    for x in torch.unique(e[kept]).tolist():
        tok, slot = ((e == x) & kept).nonzero(as_tuple=True)
        y = swiglu(h[tok], p["w_gate"][x], p["w_up"][x], p["w_down"][x],
                   quant)
        out = out.index_add(0, tok, y * w[tok, slot][:, None])
    return out


def attention_out(model: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
                  quant: Optional[str], window: Optional[int],
                  use_rope: bool) -> torch.Tensor:
    """Self-attention's output (before the residual) over x (B, S, D),
    positions 0 .. S-1."""
    B, S, D = x.shape
    H, KV, dh = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    eps = model["norm_eps"]
    q = base.rms_norm(base.linear(x, p["wq"], quant).reshape(B, S, H, dh),
                      p["q_norm"], eps)
    k = base.rms_norm(base.linear(x, p["wk"], quant).reshape(B, S, KV, dh),
                      p["k_norm"], eps)
    v = base.linear(x, p["wv"], quant).reshape(B, S, KV, dh)
    if use_rope:
        pos = torch.arange(S, device=x.device)
        q = base.rope(q, pos, model["rope_theta"])
        k = base.rope(k, pos, model["rope_theta"])
    a = base.attention(q, k, v, model.get("q_chunk", 512), window)
    return base.linear(a.reshape(B, S, H * dh), p["wo"], quant)


def ffn_out(model: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
            segments: Optional[Sequence[Tuple[int, int]]],
            quant: Optional[str], index: int) -> torch.Tensor:
    """The FFN's output (before the residual) over x (B, S, D)."""
    if not _routed(model, index):
        return swiglu(x, p["w_gate"], p["w_up"], p["w_down"], quant)
    segs = segments or [(0, x.shape[1])]
    routed = torch.stack([routed_ffn(model, p, x[b], segs, quant)
                          for b in range(x.shape[0])])
    return routed + swiglu(x, p["shared_gate"], p["shared_up"],
                           p["shared_down"], quant)


def layer(model: Dict, p: Dict[str, torch.Tensor], x: torch.Tensor,
          segments: Optional[Sequence[Tuple[int, int]]] = None,
          quant: Optional[str] = None, index: int = 0) -> torch.Tensor:
    """Decoder layer ``index`` over x (B, S, D), positions 0 .. S-1.
    ``segments`` (routed layers, B = 1): the calls that the tokens were
    run in; by default the whole sequence in one call a row."""
    spec = _spec(model, index)
    eps = model["norm_eps"]
    a = attention_out(model, p, x, quant, spec.get("window"),
                      spec.get("rope", True))
    x = x + base.rms_norm(a, p["ln1"], eps)
    f = ffn_out(model, p, x, segments, quant, index)
    return x + base.rms_norm(f, p["ln2"], eps)


def lm_loss(model: Dict, leaves: Dict[str, torch.Tensor], layers,
            inputs: torch.Tensor, targets: torch.Tensor,
            quant: Optional[str] = None) -> torch.Tensor:
    return base.lm_loss(model, leaves, layers, inputs, targets, quant, layer)
