"""A frozen plain copy of the attestation digest (the paper's section 6.1
checksum as the port computes it): a leaf's digest is the sum over its
raw words w (16 bits for bf16, 32 for fp32) of ((w * 0x9E3779B9) ^
(w >> 16)) mod 2**32; a tree's digest folds its leaf digests in order,
acc = acc * 31 + h + i mod 2**32.  The sum takes no order, so a stacked
leaf's digest is the sum of its slices' digests."""

from __future__ import annotations

from typing import Iterable

import torch

MIX = 0x9E3779B9
M32 = 0xFFFFFFFF
CHUNK = 1 << 24


def digest(x: torch.Tensor) -> int:
    flat = x.detach().reshape(-1)
    if x.dtype in (torch.bfloat16, torch.float16):
        view, mask = flat.view(torch.int16), 0xFFFF
    elif x.dtype == torch.float32:
        view, mask = flat.view(torch.int32), M32
    else:
        raise TypeError(f"no words defined for {x.dtype}")
    total = 0
    for i in range(0, view.numel(), CHUNK):
        w = view[i:i + CHUNK].to(torch.int64) & mask
        total += int((((w * MIX) & M32) ^ (w >> 16)).sum())
    return total & M32


def fold(leaf_digests: Iterable[int]) -> int:
    acc = 0
    for i, h in enumerate(leaf_digests):
        acc = (acc * 31 + h + i) & M32
    return acc


def tree_digest(leaves: Iterable[torch.Tensor]) -> int:
    return fold(digest(x) for x in leaves)
