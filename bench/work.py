"""The benchmark's yardstick: the work that the traffic needs, counted from
the configuration and the traffic alone, and the card's published peaks.

Nothing here reads what the program happens to run.  A history that the
server prefills again, the experts that a token is not routed to, and the
forward that activation checkpointing recomputes are not needed work, so
a change to the program cannot move these numbers.

Peaks: NVIDIA's H100 SXM data sheet, dense rates (bf16 tensor cores and
HBM3).  ``fingerprint_work`` is a frozen copy of the word-mix kernel's
formula (``repro_torch/kernels/work.py``): a multiply, shift, xor and add
a word; the words in, one uint32 out.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
CORE_OPS = 67e12
BF16_BYTES = 2


def fingerprint_work(n: int, elem: int) -> Tuple[float, float]:
    """(integer operations, bytes) of one digest over ``n`` words of
    ``elem`` bytes."""
    return 4.0 * n, float(n * elem + 4)


def layer_matmul_params(model: Dict) -> int:
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


def head_params(model: Dict) -> int:
    return model["d_model"] * model["vocab"]


def attention_flops(model: Dict, keys: int) -> float:
    """One query against ``keys`` keys in every layer: q.k and p.v, two
    FLOPs a multiply-add."""
    return 4.0 * model["n_heads"] * model["head_dim"] * keys * model["n_layers"]


def serve_request_flops(model: Dict, context: int, n_prompt: int,
                        n_out: int) -> float:
    """FLOPs one replica needs for a request: the ``n_prompt`` new tokens
    at positions ``context`` on and each generated token but the last run
    through every layer, each attending to the keys up to its own
    position, and the head at the ``n_out`` positions whose logits pick a
    token."""
    per_token = 2.0 * model["n_layers"] * layer_matmul_params(model)
    flops = 0.0
    for p in range(context, context + n_prompt + n_out - 1):
        flops += per_token + attention_flops(model, p + 1)
    return flops + n_out * 2.0 * head_params(model)


def train_step_flops(model: Dict, batch: int, seq: int) -> float:
    """One replica's step: 6 FLOPs a parameter a token (forward and
    backward) over the layers and the head, plus three times the causal
    attention of the forward."""
    params = model["n_layers"] * layer_matmul_params(model) + head_params(model)
    pairs = seq * (seq + 1) // 2
    attn = 4.0 * model["n_heads"] * model["head_dim"] * pairs \
        * model["n_layers"] * batch
    return 6.0 * params * batch * seq + 3.0 * attn


def moe_decode_bytes(model: Dict) -> float:
    """Bytes one routed FFN call on a single token needs: the ``top_k``
    experts' three bf16 matrices, the fp32 router, and the bf16
    activation in and out."""
    moe = model["moe"]
    D = model["d_model"]
    experts = moe["top_k"] * 3 * D * moe["d_expert"] * BF16_BYTES
    return float(experts + D * moe["n_experts"] * 4 + 2 * D * BF16_BYTES)


def digest_bytes(leaf_sizes: Iterable[int], elem: int = BF16_BYTES) -> float:
    """Bytes of one digest of every leaf (a tree of ``leaf_sizes``
    words)."""
    return sum(fingerprint_work(n, elem)[1] for n in leaf_sizes)
