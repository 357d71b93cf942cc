"""Public wrappers around the CUDA kernels.

A wrapper launches its kernel for a CUDA tensor and runs the kernel's plain
version for a CPU tensor; there is no fallback from one to the other.
``launches`` counts kernel launches by name (see ``kernels.cuda``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.cuda import launches, reset_launches
from repro_torch.kernels.fingerprint import fingerprint_cuda, fingerprint_plain
from repro_torch.kernels.swa import swa_cuda, swa_plain

__all__ = ["fingerprint", "launches", "reset_launches",
           "sliding_window_attention"]


def _on_cuda(*xs: torch.Tensor) -> bool:
    devices = {x.device.type for x in xs}
    if devices == {"cuda"}:
        return True
    if devices == {"cpu"}:
        return False
    raise ValueError(f"tensors on {sorted(devices)}: the kernels take CUDA "
                     f"tensors, the plain versions CPU tensors")


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, window: int) -> torch.Tensor:
    """GQA sliding-window attention.
    q: (B, S, H, dh); k/v: (B, S, KV, dh) -> (B, S, H, dh)."""
    if _on_cuda(q, k, v):
        return swa_cuda(q, k, v, window)
    return swa_plain(q, k, v, window)


def fingerprint(x: torch.Tensor) -> int:
    """uint32 digest of a tensor's words (see ``kernels.fingerprint``)."""
    if _on_cuda(x):
        return int(fingerprint_cuda(x).item()) & 0xFFFFFFFF
    return fingerprint_plain(x)
