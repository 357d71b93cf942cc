"""Plain PyTorch oracles, ported from ``repro.kernels.ref``."""

from __future__ import annotations

import torch

from repro_torch.kernels.fingerprint import MIX

NEG_INF = -1e30


def swa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            window: int) -> torch.Tensor:
    """Sliding-window causal attention over whole rows. q/k/v: (P, S, dh)."""
    P, S, dh = q.shape
    s = torch.einsum("pqd,pkd->pqk", q.float(), k.float()) * (dh ** -0.5)
    pos = torch.arange(S, device=q.device)
    delta = pos[:, None] - pos[None, :]
    valid = (delta >= 0) & (delta < window)
    s = torch.where(valid[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("pqk,pkd->pqd", p, v.float()).to(q.dtype)


def fingerprint_ref(words: torch.Tensor) -> int:
    """Order-independent digest of uint32 words held in an integer tensor
    (matches ``repro_torch.runtime.attest``)."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    w = ((w * MIX) & 0xFFFFFFFF) ^ (w >> 16)
    return int(w.sum()) & 0xFFFFFFFF
