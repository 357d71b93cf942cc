"""Replicated inference serving plane (DESIGN_SERVING.md).

The paper's §8 applications (Memcached, Redis, Liquibook) become
Byzantine-tolerant for ~10 µs of consensus; this package does the same
for the repo's own JAX serving stack.  Session/KV-cache metadata rides
uBFT consensus slots (:class:`repro.runtime.server.TokenServerApp`),
per-token decode cost comes from the roofline model over the registered
architectures (:mod:`repro.serve.costmodel`), and per-app SLOs size
leader-side admission control with agreed deterministic BUSY shedding
(:class:`repro.core.consensus.AdmissionConfig`).
"""

from repro_torch.serve.costmodel import HBM_BW, PEAK_FLOPS, ServingCostModel
from repro_torch.serve.plane import (InferencePlane, SLOSpec, admission_for,
                               greedy_decode_fn)

__all__ = [
    "ServingCostModel",
    "PEAK_FLOPS",
    "HBM_BW",
    "SLOSpec",
    "admission_for",
    "greedy_decode_fn",
    "InferencePlane",
]
