"""Plain PyTorch oracles, ported from ``repro.kernels.ref``."""

from __future__ import annotations

import torch

import torch.nn.functional as F

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


def mlstm_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              it: torch.Tensor, ft: torch.Tensor) -> torch.Tensor:
    """Sequential (step-by-step) mLSTM, the ground truth of the chunkwise
    form.  q/k/v: (P, S, dh); it/ft: (P, S, 1)."""
    P, S, dh = q.shape
    q32, k32, v32 = q.float(), k.float(), v.float()
    it32, ft32 = it[..., 0].float(), ft[..., 0].float()
    C = torch.zeros((P, dh, dh), dtype=torch.float32, device=q.device)
    n = torch.zeros((P, dh), dtype=torch.float32, device=q.device)
    m = torch.full((P,), NEG_INF, dtype=torch.float32, device=q.device)
    hs = []
    for t in range(S):
        lf = F.logsigmoid(ft32[:, t])
        m_new = torch.maximum(lf + m, it32[:, t])
        fd = torch.exp(lf + m - m_new)[:, None]
        iw = torch.exp(it32[:, t] - m_new)[:, None]
        kt, vt = k32[:, t], v32[:, t]
        C = C * fd[..., None] + iw[..., None] * kt[..., :, None] * vt[..., None, :]
        n = n * fd + iw * kt
        num = torch.einsum("pd,pde->pe", q32[:, t], C)
        den = torch.clamp(torch.einsum("pd,pd->p", q32[:, t], n).abs(), min=1.0)
        hs.append(num / den[:, None])
        m = m_new
    return torch.stack(hs, dim=1).to(q.dtype)


def rglru_ref(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y_t = a_t · y_{t-1} + x_t by doubling (Hillis–Steele), the
    log-depth scan that ``jax.lax.associative_scan`` also computes.
    a/x: (B, S, W)."""
    a, y = a.float(), x.float()
    step = 1
    while step < a.shape[1]:
        # combine(c1, c2) = (a1·a2, b1·a2 + b2) with c1 the element `step`
        # positions earlier (the identity (1, 0) before the start)
        a_prev = torch.ones_like(a)
        y_prev = torch.zeros_like(y)
        a_prev[:, step:] = a[:, :-step]
        y_prev[:, step:] = y[:, :-step]
        y = y_prev * a + y
        a = a_prev * a
        step *= 2
    return y


def fingerprint_ref(words: torch.Tensor) -> int:
    """Order-independent digest of uint32 words held in an integer tensor
    (matches ``repro_torch.runtime.attest``)."""
    w = words.to(torch.int64) & 0xFFFFFFFF
    w = ((w * MIX) & 0xFFFFFFFF) ^ (w >> 16)
    return int(w.sum()) & 0xFFFFFFFF
