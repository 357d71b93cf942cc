"""Public wrappers around the CUDA kernels.

A wrapper launches its kernel for a CUDA tensor and runs the kernel's plain
version for a CPU tensor; there is no fallback from one to the other.  A
kernel takes raw pointers, which a DTensor does not have: the wrappers
raise on one, and the model calls them on local shards (``local_map``).
The SWA, RG-LRU and mLSTM kernels are forward only: their wrappers raise for
CUDA inputs that autograd would differentiate, rather than return a result
that silently drops the gradient.
``launches`` counts kernel launches by name (see ``kernels.cuda``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels.cuda import launches, reset_launches
from repro_torch.kernels.fingerprint import fingerprint_cuda, fingerprint_plain
from repro_torch.kernels.mlstm import State, mlstm_cuda, mlstm_plain
from repro_torch.kernels.rglru import rglru_cuda, rglru_plain
from repro_torch.kernels.swa import swa_cuda, swa_plain

__all__ = ["fingerprint", "launches", "mlstm_chunkwise",
           "mlstm_chunkwise_state", "reset_launches", "rglru_scan",
           "sliding_window_attention"]


def _on_cuda(*xs: torch.Tensor) -> bool:
    if any(isinstance(x, DTensor) for x in xs):
        raise TypeError("the kernels take local tensors, not DTensors: call "
                        "them on local shards (local_map)")
    devices = {x.device.type for x in xs}
    if devices == {"cuda"}:
        return True
    if devices == {"cpu"}:
        return False
    raise ValueError(f"tensors on {sorted(devices)}: the kernels take CUDA "
                     f"tensors, the plain versions CPU tensors")


def _forward_only(name: str, *xs: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(f"the {name} kernel is forward only: it cannot "
                           f"take inputs that require grad")


def sliding_window_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, window: int) -> torch.Tensor:
    """GQA sliding-window attention.
    q: (B, S, H, dh); k/v: (B, S, KV, dh) -> (B, S, H, dh)."""
    if _on_cuda(q, k, v):
        _forward_only("swa", q, k, v)
        return swa_cuda(q, k, v, window)
    return swa_plain(q, k, v, window)


def mlstm_chunkwise_state(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          it: torch.Tensor, ft: torch.Tensor, chunk: int
                          ) -> Tuple[torch.Tensor, State]:
    """Chunkwise mLSTM with its final state, for a sequence the caller has
    padded to a multiple of ``chunk`` (the model pads as ``mlstm_train``
    does).  q/k/v: (B, S, H, dh); it/ft: (B, S, H) fp32 -> h (B, S, H, dh)
    and (C, n, m) in fp32."""
    if _on_cuda(q, k, v, it, ft):
        _forward_only("mlstm", q, k, v, it, ft)
        return mlstm_cuda(q, k, v, it, ft, chunk)
    return mlstm_plain(q, k, v, it, ft, chunk)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    it: torch.Tensor, ft: torch.Tensor,
                    chunk: int = 256) -> torch.Tensor:
    """Chunkwise mLSTM as ``repro.kernels.ops.mlstm_chunkwise``: pads S to a
    multiple of min(chunk, S) with zero q/k/v and input gates and forget
    gates of 30 (forget ≈ 1 on padding).  q/k/v: (B, S, H, dh);
    it/ft: (B, S, H) -> h (B, S, H, dh)."""
    S = q.shape[1]
    c = min(chunk, S)
    pad = (-S) % c
    it, ft = it.float().contiguous(), ft.float().contiguous()
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
        it = F.pad(it, (0, 0, 0, pad))
        ft = F.pad(ft, (0, 0, 0, pad), value=30.0)
    h, _ = mlstm_chunkwise_state(q, k, v, it, ft, c)
    return h[:, :S]


def rglru_scan(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Gated linear recurrence y_t = a_t·y_{t-1} + x_t from y = 0, in fp32.
    a/x: (B, S, W) fp32 -> y (B, S, W) fp32."""
    if _on_cuda(a, x):
        _forward_only("rglru", a, x)
        return rglru_cuda(a, x)
    return rglru_plain(a, x)


def fingerprint(x: torch.Tensor) -> int:
    """uint32 digest of a tensor's words (see ``kernels.fingerprint``)."""
    if _on_cuda(x):
        return int(fingerprint_cuda(x).item()) & 0xFFFFFFFF
    return fingerprint_plain(x)
