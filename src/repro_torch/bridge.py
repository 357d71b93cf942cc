"""Crossing from the JAX package's parameters to the port's model.

The port keeps JAX's layout (weights ``(in, out)``, the pytree's names,
per-group stacking) and each leaf's dtype (the RG-LRU's ``lam`` stays fp32
in a bf16 model), so conversion is a plain copy.  numpy has no bf16 of
its own: a bf16 array (ml_dtypes' ``bfloat16``) crosses as an int16 view and
is viewed back as ``torch.bfloat16``, which keeps every bit.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.models.common import ModelConfig, Transformer


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    a = np.array(a, order="C")   # a writable copy: torch shares its memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_jax(np_tree: Mapping[str, Any], cfg: ModelConfig,
                    device=None) -> Transformer:
    """Build the port's model from the JAX parameter tree given as numpy
    arrays (e.g. ``jax.tree.map(np.asarray, init_params(cfg, key))``)."""
    model = Transformer(cfg, device=device)

    def put(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
        t = tensor_from_numpy(src, device)
        if t.shape != dst.shape or t.dtype != dst.dtype:
            raise ValueError(f"{name}: JAX has {t.dtype}{tuple(t.shape)}, the "
                             f"port expects {dst.dtype}{tuple(dst.shape)}")
        dst.copy_(t)

    with torch.no_grad():
        if set(np_tree) != {"embed", "groups", "out_norm"}:
            raise ValueError(f"expected a tied-head tree, got {sorted(np_tree)}")
        put(model.embed, np_tree["embed"], "embed")
        put(model.out_norm, np_tree["out_norm"], "out_norm")
        for g, group in enumerate(model.groups):
            for i, pos in enumerate(group):
                src = np_tree["groups"][g][i]
                if set(src) != set(pos.keys()):
                    raise ValueError(f"groups[{g}][{i}]: JAX has {sorted(src)}"
                                     f", the port {sorted(pos.keys())}")
                for k, dst in pos.items():
                    put(dst, src[k], f"groups[{g}][{i}][{k}]")
    return model
