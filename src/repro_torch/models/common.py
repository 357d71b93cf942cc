"""Model substrate: configs, parameter initialization, shared layers.

A :class:`ModelConfig`'s ``blocks`` field is a *pattern program*: a list of
(pattern, repeats) groups, where a pattern is a tuple of :class:`LayerSpec`
(gemma3: five sliding-window layers to one global).  Parameters keep the
JAX package's layout so that converting them is a plain copy: weights are
``(in, out)`` and used as ``x @ W``, and each pattern position holds its
``reps`` layers stacked on a leading axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import torch
from torch import nn


# ---------------------------------------------------------------------------
# Layer / model configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LayerSpec:
    """One layer in the pattern program."""
    kind: str                      # "attn" (the only kind this port runs)
    window: Optional[int] = None   # attention window (None = full/causal)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    blocks: Tuple[Tuple[Tuple[LayerSpec, ...], int], ...] = ()
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0
    qk_norm: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    q_chunk: int = 512

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def layer_list(self) -> List[LayerSpec]:
        out: List[LayerSpec] = []
        for pattern, reps in self.blocks:
            out.extend(list(pattern) * reps)
        return out

    def validate(self) -> None:
        if len(self.layer_list()) != self.n_layers:
            raise ValueError(
                f"{self.name}: pattern program has {len(self.layer_list())} "
                f"layers, config says {self.n_layers}")
        for spec in self.layer_list():
            if spec.kind != "attn":
                raise NotImplementedError(
                    f"{self.name}: the port runs attention layers only, "
                    f"not {spec}")


# ---------------------------------------------------------------------------
# Shared primitives
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding over the leading ``fraction`` of the head dim.

    x: (..., S, H, dh); positions: (..., S) integer.
    """
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    if rot == 0:
        return x
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].float() * freqs       # (..., S, half)
    ang = ang[..., None, :]                          # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([out.to(x.dtype), x_pass], dim=-1)


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------
def _layer_shapes(cfg: ModelConfig) -> dict:
    """Per-layer (unstacked) shape and init scale of every attention-layer
    parameter; a scale of None means zeros (the RMSNorm offsets)."""
    D, dh, H, KV, F = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    s_in = D ** -0.5
    shapes = {
        "ln1": ((D,), None),
        "wq": ((D, H * dh), s_in),
        "wk": ((D, KV * dh), s_in),
        "wv": ((D, KV * dh), s_in),
        "wo": ((H * dh, D), (H * dh) ** -0.5),
        "ln2": ((D,), None),
        "w_gate": ((D, F), s_in),
        "w_up": ((D, F), s_in),
        "w_down": ((F, D), F ** -0.5),
    }
    if cfg.qk_norm:
        shapes["q_norm"] = ((dh,), None)
        shapes["k_norm"] = ((dh,), None)
    return shapes


class Transformer(nn.Module):
    """Parameters of an attention-only stack with a tied head, named as
    the JAX pytree: ``embed``, ``out_norm`` and ``groups[g][pos][name]``
    with a leading ``reps`` axis.  The forward passes are the plain
    functions of ``repro_torch.models.transformer``.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        dt = cfg.tdtype()

        def param(*shape):
            return nn.Parameter(torch.zeros(shape, dtype=dt, device=device),
                                requires_grad=False)

        self.embed = param(cfg.vocab, cfg.d_model)
        self.out_norm = param(cfg.d_model)
        shapes = _layer_shapes(cfg)
        self.groups = nn.ModuleList(
            nn.ModuleList(
                nn.ParameterDict({k: param(reps, *shape)
                                  for k, (shape, _) in shapes.items()})
                for _ in pattern)
            for pattern, reps in cfg.blocks)

    def param_leaves(self) -> Iterator[torch.Tensor]:
        """Parameters in ``jax.tree.leaves`` order of the JAX pytree (dict
        keys sorted at every level), which ``fingerprint_tree`` hashes in."""
        yield self.embed
        for group in self.groups:
            for pos in group:
                for k in sorted(pos.keys()):
                    yield pos[k]
        yield self.out_norm


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """Random parameters with the JAX package's scales (normal · scale,
    drawn in fp32 and cast; norms zero).  The numbers differ from
    ``jax.random``'s: tests that compare the two convert the JAX init with
    ``repro_torch.bridge.params_from_jax`` instead."""
    model = Transformer(cfg, device=device)
    scales = {k: s for k, (_, s) in _layer_shapes(cfg).items()}
    scales["embed"] = cfg.d_model ** -0.5
    for name, p in model.named_parameters():
        scale = scales.get(name.rsplit(".", 1)[-1])
        if scale is None:
            continue
        noise = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                            device=p.device)
        p.copy_(noise * scale)
    return model
