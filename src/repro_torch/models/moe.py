"""Feed-forward layers, ported from ``repro.models.moe`` (dense SwiGLU only;
the routed MoE is not ported yet)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F


def dense_ffn(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """SwiGLU FFN. x: (..., D)."""
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
