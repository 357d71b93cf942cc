"""The work of one kernel call, from its shapes alone: the operations it
does and the bytes it must move, and the least time the card could take
for them (its roofline bound).

These are the formulas that ``chip_smoke.py`` holds each kernel's time
against and that the costing (``launch.costing``) counts for each call of
a kernel op (``kernels.ops``), so a bound on the card and a count of the
dry-run read one number.  Bytes: each input read once and each output
written once.  Operations: two a multiply-add.  The rates are the H100
SXM data sheet's (dense): the HBM rate, the bf16 tensor cores' rate, and
the CUDA cores' fp32 rate, which the fp32 and integer word kernels run
at.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
CORE_OPS = 67e12


@dataclass(frozen=True)
class Work:
    flops: float      # floating-point operations (FlopCounterMode's count)
    ops: float        # the operations the bound counts, at ``rate``
    rate: float       # BF16_FLOPS (tensor cores) or CORE_OPS (CUDA cores)
    bytes: float

    def bound(self) -> Tuple[float, str]:
        """(ms, "bytes" or "operations"): the larger of the bytes over the
        HBM rate and the operations over their rate."""
        bytes_ms = self.bytes / HBM_BYTES_S * 1e3
        ops_ms = self.ops / self.rate * 1e3
        return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                       else "operations")


def band_pairs(S: int, w: int) -> int:
    """(query, key) pairs of a causal window of ``w`` over ``S`` positions:
    the sum over p < S of min(p + 1, w)."""
    if S <= w:
        return S * (S + 1) // 2
    return w * (w + 1) // 2 + (S - w) * w


def _rate(elem: int) -> float:
    """bf16 and fp16 run on the tensor cores, fp32 on the CUDA cores."""
    return CORE_OPS if elem == 4 else BF16_FLOPS


def swa_work(B: int, S: int, H: int, KV: int, dh: int, w: int,
             elem: int) -> Work:
    """QK^T and P.V over the pairs in the band (two products of dh
    multiply-adds a pair and head); q and the output, k and v."""
    flops = 4 * dh * band_pairs(S, w) * H * B
    n_bytes = elem * dh * S * (2 * H + 2 * KV) * B
    return Work(flops, flops, _rate(elem), n_bytes)


def rglru_work(B: int, S: int, W: int) -> Work:
    """An fp32 multiply and add an element; a and x in, y out."""
    n = B * S * W
    return Work(2 * n, 2 * n, CORE_OPS, 12 * n)


def mlstm_work(B: int, S: int, H: int, dh: int, c: int, elem: int) -> Work:
    """Per chunk and plane: q.k^T and W.V over the c(c+1)/2 causal pairs,
    q.C and the C update over c x dh x dh; bytes of q, k, v and h in
    ``elem`` bytes, the fp32 gates, C, n and m."""
    pairs = c * (c + 1) // 2
    flops = B * (S // c) * H * (4 * pairs * dh + 4 * c * dh * dh)
    n_bytes = B * (4 * S * H * dh * elem + 2 * S * H * 4
                   + H * (dh * dh + dh + 1) * 4)
    return Work(flops, flops, _rate(elem), n_bytes)


def fingerprint_work(n: int, elem: int) -> Work:
    """A multiply, shift, xor and add a word: integer operations, no
    FLOPs; the words in, one uint32 out."""
    return Work(0, 4 * n, CORE_OPS, n * elem + 4)


def routed_work(T: int, k: int, D: int, F: int, elem: int) -> Work:
    """Every slot's three D x F products, two flops a weight, on the
    tensor cores' rate; bytes of the slots' three matrices, x and the
    output in ``elem`` bytes and the routes.  From shapes alone every
    slot counts as routed to a held expert: the most the call can read."""
    flops = 6 * T * k * D * F
    n_bytes = T * k * 3 * D * F * elem + 2 * T * D * elem + T * k * 12
    return Work(flops, flops, _rate(elem), n_bytes)
