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

from bench import arch

BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
CORE_OPS = 67e12
BF16_BYTES = 2


def fingerprint_work(n: int, elem: int) -> Tuple[float, float]:
    """(integer operations, bytes) of one digest over ``n`` words of
    ``elem`` bytes."""
    return 4.0 * n, float(n * elem + 4)


def layer_matmul_params(model: Dict, layer: int = 0) -> int:
    """Parameters one token multiplies through in layer ``layer``: the
    attention projections and the FFN it is routed to, as the
    configuration's reference module counts them (``arch.py``)."""
    return arch.module(model).layer_matmul_params(model, layer)


def matmul_params(model: Dict) -> int:
    """Parameters one token multiplies through in all the layers."""
    mod = arch.module(model)
    return sum(mod.layer_matmul_params(model, l)
               for l in range(model["n_layers"]))


def head_params(model: Dict) -> int:
    return model["d_model"] * model["vocab"]


def query_keys(model: Dict, pos: int) -> int:
    """Keys a query at position ``pos`` reads, summed over the layers (a
    window layer reads at most its window)."""
    mod = arch.module(model)
    return sum(mod.keys(model, l, pos) for l in range(model["n_layers"]))


def attention_flops(model: Dict, keys: int) -> float:
    """A query's q.k and p.v against ``keys`` keys (summed over the
    layers), two FLOPs a multiply-add."""
    return 4.0 * model["n_heads"] * model["head_dim"] * keys


def serve_request_flops(model: Dict, context: int, n_prompt: int,
                        n_out: int) -> float:
    """FLOPs one replica needs for a request: the ``n_prompt`` new tokens
    at positions ``context`` on and each generated token but the last run
    through every layer, each attending to the keys its position reads,
    and the head at the ``n_out`` positions whose logits pick a token."""
    per_token = 2.0 * matmul_params(model)
    flops = 0.0
    for p in range(context, context + n_prompt + n_out - 1):
        flops += per_token + attention_flops(model, query_keys(model, p))
    return flops + n_out * 2.0 * head_params(model)


def train_step_flops(model: Dict, batch: int, seq: int) -> float:
    """One replica's step: 6 FLOPs a parameter a token (forward and
    backward) over the layers and the head, plus three times the causal
    attention of the forward, each query over the keys it reads."""
    params = matmul_params(model) + head_params(model)
    pairs = sum(query_keys(model, q) for q in range(seq))
    return 6.0 * params * batch * seq \
        + 3.0 * (attention_flops(model, pairs) * batch)


def moe_decode_bytes(model: Dict) -> float:
    """Bytes one routed FFN call on a single token needs, the mean over
    the routed layers (the reference module's ``moe_decode_bytes``: for
    Qwen3 the ``top_k`` experts' three bf16 matrices, the fp32 router, and
    the bf16 activation in and out)."""
    mod = arch.module(model)
    per = [b for b in (mod.moe_decode_bytes(model, l)
                       for l in range(model["n_layers"])) if b is not None]
    return sum(per) / len(per)


def digest_bytes(leaf_sizes: Iterable[int], elem: int = BF16_BYTES) -> float:
    """Bytes of one digest of every leaf (a tree of ``leaf_sizes``
    words)."""
    return sum(fingerprint_work(n, elem)[1] for n in leaf_sizes)
