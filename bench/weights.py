"""The benchmark's weights, drawn on the device from ``--seed``.

Every leaf of every layer is drawn by a generator of its own, seeded from
(seed, leaf name, layer), straight in the dtype it is served in, as normal
noise of a leaf's mean and scale.  So the program and the plain reference
get the same numbers, and the reference can draw one layer again after the
program's state is gone, without keeping a copy.

The products are drawn at the port's init scales (fan-in ** -0.5, the
embedding and the untied head d_model ** -0.5), with two changes that
make the served tokens depend on every layer:

* attention's output product ``wo`` is drawn ``GAIN_WO`` times larger,
  and the query and key norms' scales about 1.5, so that attention picks
  out keys rather than averaging the context and its output counts
  beside the FFN's;
* the norm scales, applied as (1 + w), are drawn about 1 (w ~ N(0, 0.1)).

At these scales a bf16 forward agrees with the fp32 reference on most
served tokens and an fp8 one on clearly fewer (checked on the CPU at
d_model 1024 and on the card; ``PERF.md``).
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterator, Tuple

import torch

from bench import arch

NORM = (0.0, 0.1)           # (mean, scale) of a norm's w
QK_NORM = (0.5, 0.1)
GAIN_WO = 4.0
Spec = Tuple[Tuple[int, ...], torch.dtype, float, float]   # shape, dtype,
#                                                          scale, mean


def global_specs(model: Dict) -> Dict[str, Spec]:
    """The leaves outside the layers, as the configuration's reference
    module (``arch.py``) lays them out."""
    return arch.module(model).global_specs(model)


def layer_specs(model: Dict, layer: int = 0) -> Dict[str, Spec]:
    """The leaves of layer ``layer``, as the configuration's reference
    module lays them out (x @ W, W shaped (in, out); experts stacked on a
    leading axis)."""
    return arch.module(model).layer_specs(model, layer)


def _seed(seed: int, name: str, layer: int) -> int:
    h = hashlib.sha256(f"{int(seed)}/{name}/{layer}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def fill(out: torch.Tensor, seed: int, name: str, layer: int,
         scale: float, mean: float) -> torch.Tensor:
    """Draw leaf ``name`` of ``layer`` (-1: a leaf outside the layers)
    into ``out``, in place."""
    gen = torch.Generator(device=out.device)
    gen.manual_seed(_seed(seed, name, layer))
    return out.normal_(mean, scale, generator=gen)


def draw(model: Dict, seed: int, name: str, layer: int, device,
         dtype=None) -> torch.Tensor:
    """One leaf, drawn anew; with ``dtype``, cast after the draw."""
    specs = global_specs(model) if layer < 0 else layer_specs(model, layer)
    shape, dt, scale, mean = specs[name]
    t = fill(torch.empty(shape, dtype=dt, device=device), seed, name, layer,
             scale, mean)
    return t if dtype is None else t.to(dtype)


def stacked(model: Dict, seed: int, name: str, layers: Iterator[int],
            device) -> torch.Tensor:
    """Leaf ``name`` of the given layers (one pattern position's, which
    share their leaves), stacked on a leading axis."""
    layers = list(layers)
    shape, dt, scale, mean = layer_specs(model, layers[0])[name]
    t = torch.empty((len(layers),) + shape, dtype=dt, device=device)
    for i, layer in enumerate(layers):
        fill(t[i], seed, name, layer, scale, mean)
    return t
