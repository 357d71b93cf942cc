"""Model substrate: configs, parameter initialization, shared layers.

A :class:`ModelConfig`'s ``blocks`` field is a *pattern program*: a list of
(pattern, repeats) groups, where a pattern is a tuple of :class:`LayerSpec`
(gemma3: five sliding-window layers to one global; recurrentgemma: two
RG-LRU layers to one local attention; xLSTM: three mLSTM blocks to one
sLSTM).  Parameters keep the JAX package's layout so that converting them
is a plain copy: weights are ``(in, out)`` and used as ``x @ W``, and each
pattern position holds its ``reps`` layers stacked on a leading axis.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn


# ---------------------------------------------------------------------------
# Layer / model configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LayerSpec:
    """One layer in the pattern program."""
    kind: str                      # "attn" | "mlstm" | "slstm" | "rglru"
    window: Optional[int] = None   # attention window (None = full/causal)
    has_ffn: bool = True           # xLSTM blocks carry their own projections
    # the layer's FFN: None, the model's (routed with ``cfg.moe``);
    # "dense", a SwiGLU of ``d_ff`` in a routed model (leading dense layers)
    ffn: Optional[str] = None
    rope: bool = True              # False: no position encoding (NoPE)


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    # "softmax": the top-k logits' softmax; "sigmoid": experts chosen by
    # sigmoid(logit) + a selection bias (the ``router_bias`` leaf), weighted
    # by their sigmoid scores normalised to sum 1, times ``routed_scale``
    scoring: str = "softmax"
    routed_scale: float = 1.0
    d_shared: int = 0              # a shared expert's width (0: none)
    # the experts held on this device, [0, held): the router keeps all
    # ``n_experts`` outputs, and routes to the others add nothing here
    # (one device's share of an expert-parallel layer); None: all
    held: Optional[int] = None

    @property
    def n_held(self) -> int:
        return self.n_experts if self.held is None else self.held


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
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0
    qk_norm: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = True  # False: an untied (d_model, vocab) lm_head
    # post-norm layers: ``x + ln1(attn(x))``, then ``x + ln2(ffn(x))``, no
    # norm in front of attention or the FFN; False: pre-norm
    post_norm: bool = False
    dtype: str = "bfloat16"
    # modality frontend stub: prefill and training take (B, S, D)
    # precomputed embeddings in place of token ids
    frontend: Optional[str] = None   # None | "audio" | "vlm"
    # the reference's sequence limit and KV chunk: fields that its model
    # code does not read, nor does the port's
    max_seq: int = 131_072
    remat: str = "full"          # "none" | "dots" | "full" (training only)
    q_chunk: int = 512
    kv_chunk: int = 1024
    mlstm_chunk: int = 256
    logits_fp32: bool = False    # logits cast to fp32 before the loss
    attest: bool = True          # fingerprint grads/params each step (uBFT)
    # multi-device layout (with a ``ShardCtx`` only; no effect without one)
    # the reference's per-layer gather of the FSDP-cut weights; the port's
    # sharded products gather each weight over "data" whatever its value
    # (``sharding.columns``, ``sharding.rows``)
    fsdp_gather: bool = False
    attn_head_shard: bool = False  # expand KV to H heads, shard the heads

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def routed(self, spec: LayerSpec) -> bool:
        """Whether ``spec``'s FFN is the routed one."""
        return self.moe is not None and spec.ffn != "dense"

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


def default_blocks(n_layers: int) -> Tuple:
    """Uniform full-attention stack."""
    return (((LayerSpec("attn"),), n_layers),)


# ---------------------------------------------------------------------------
# Shared primitives
# ---------------------------------------------------------------------------
def weak_scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as JAX applies it to an array: a weakly typed scalar,
    rounded to the array's dtype first (torch would keep it in fp32 for a
    bf16 array).  Made by a fill on the array's device, which rounds as
    ``torch.tensor`` does and copies nothing from the host, so that a
    captured step can hold it."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


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
@dataclass(frozen=True)
class Leaf:
    """One parameter of a layer (unstacked): its shape, its init (normal
    noise times ``scale``, or the constant ``fill`` where ``scale`` is None),
    its dtype (None: the model's) and whether the train step trains it."""
    shape: Tuple[int, ...]
    scale: Optional[float] = None
    fill: float = 0.0
    dtype: Optional[torch.dtype] = None
    trained: bool = True


def layer_leaves(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, Leaf]:
    """The parameters of one layer of ``spec``'s kind, as
    ``repro.models.common.init_layer_params`` makes them: a dense FFN, or
    with ``cfg.moe`` an fp32 router and the held experts stacked on a
    leading axis, with the sigmoid router's selection bias (fp32, zero at
    init) and a shared expert where the config has them.  With
    ``cfg.post_norm``, ``ln1`` and ``ln2`` are the norms after attention
    and after the FFN."""
    D, dh, H, KV, F = cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads, cfg.d_ff
    s_in = D ** -0.5
    leaves = {"ln1": Leaf((D,))}
    if spec.kind == "attn":
        leaves.update(
            wq=Leaf((D, H * dh), s_in), wk=Leaf((D, KV * dh), s_in),
            wv=Leaf((D, KV * dh), s_in),
            wo=Leaf((H * dh, D), (H * dh) ** -0.5))
        if cfg.qk_norm:
            leaves.update(q_norm=Leaf((dh,)), k_norm=Leaf((dh,)))
    elif spec.kind == "mlstm":
        leaves.update(
            wq=Leaf((D, H * dh), s_in), wk=Leaf((D, H * dh), s_in),
            wv=Leaf((D, H * dh), s_in), wi=Leaf((D, H), s_in),
            wf=Leaf((D, H), s_in),
            bf=Leaf((H,), fill=3.0),          # forget bias: remember by default
            wo=Leaf((H * dh, D), (H * dh) ** -0.5),
            up=Leaf((D, 2 * D), s_in), down=Leaf((D, D), D ** -0.5))
    elif spec.kind == "slstm":
        hd = D // H
        leaves.update(
            wz=Leaf((D, D), s_in), wi=Leaf((D, D), s_in),
            wf=Leaf((D, D), s_in), wo_gate=Leaf((D, D), s_in),
            rz=Leaf((H, hd, hd), s_in), wo=Leaf((D, D), D ** -0.5),
            up=Leaf((D, 2 * D), s_in), down=Leaf((D, D), D ** -0.5))
    elif spec.kind == "rglru":
        W = D                                 # lru width = d_model
        leaves.update(
            w_in=Leaf((D, 2 * W), s_in), conv=Leaf((4, W), 0.1),
            wa=Leaf((W, W), W ** -0.5), wx=Leaf((W, W), W ** -0.5),
            lam=Leaf((W,), 1.0, dtype=torch.float32),
            w_out=Leaf((W, D), W ** -0.5))
    else:
        raise ValueError(spec.kind)
    if spec.has_ffn and spec.kind in ("attn", "rglru"):
        leaves["ln2"] = Leaf((D,))
        m = cfg.moe
        if cfg.routed(spec):
            E, Eh, Fe = m.n_experts, m.n_held, m.d_expert
            leaves.update(
                router=Leaf((D, E), s_in, dtype=torch.float32),
                w_gate=Leaf((Eh, D, Fe), s_in), w_up=Leaf((Eh, D, Fe), s_in),
                w_down=Leaf((Eh, Fe, D), Fe ** -0.5))
            if m.scoring == "sigmoid":
                # set outside the gradient (DeepSeek-V3's load balancing)
                leaves["router_bias"] = Leaf((E,), dtype=torch.float32,
                                             trained=False)
            if m.d_shared:
                Fs = m.d_shared
                leaves.update(shared_gate=Leaf((D, Fs), s_in),
                              shared_up=Leaf((D, Fs), s_in),
                              shared_down=Leaf((Fs, D), Fs ** -0.5))
        else:
            leaves.update(w_gate=Leaf((D, F), s_in), w_up=Leaf((D, F), s_in),
                          w_down=Leaf((F, D), F ** -0.5))
    return leaves


class Transformer(nn.Module):
    """Parameters of a stack of attention and recurrent layers, named as
    the JAX pytree: ``embed``, ``out_norm``, ``groups[g][pos][name]`` with a
    leading ``reps`` axis, and with ``tie_embeddings=False`` an
    ``lm_head`` (d_model, vocab); a tied head reads ``embed.T``.  The forward
    passes are the plain functions of ``repro_torch.models.transformer``.
    Parameters start frozen, as serving wants them; ``requires_grad_()``
    makes them trainable (the train step of ``runtime.steps`` does), all
    but the leaves that are not trained (``Leaf.trained``).
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        cfg.validate()
        self.cfg = cfg
        dt = cfg.tdtype()

        def param(*shape, dtype=None):
            return nn.Parameter(torch.zeros(shape, dtype=dtype or dt,
                                            device=device),
                                requires_grad=False)

        self.embed = param(cfg.vocab, cfg.d_model)
        self.out_norm = param(cfg.d_model)
        self.lm_head = (None if cfg.tie_embeddings
                        else param(cfg.d_model, cfg.vocab))
        self.groups = nn.ModuleList(
            nn.ModuleList(
                nn.ParameterDict({
                    k: param(reps, *leaf.shape, dtype=leaf.dtype)
                    for k, leaf in layer_leaves(cfg, spec).items()})
                for spec in pattern)
            for pattern, reps in cfg.blocks)
        self._untrained = [
            (g, i, k)
            for g, (pattern, _) in enumerate(cfg.blocks)
            for i, spec in enumerate(pattern)
            for k, leaf in layer_leaves(cfg, spec).items() if not leaf.trained]

    def requires_grad_(self, requires_grad: bool = True) -> "Transformer":
        super().requires_grad_(requires_grad)
        for g, i, k in self._untrained:
            self.groups[g][i][k].requires_grad_(False)
        return self

    def leaf_items(self) -> Iterator[Tuple[Tuple, torch.Tensor]]:
        """(path, parameter) in ``jax.tree.leaves`` order of the JAX pytree
        (dict keys sorted at every level), the path as JAX's:
        ``("embed",)``, ``("groups", g, pos, name)``, ``("lm_head",)`` where
        the head is untied, ``("out_norm",)``."""
        yield ("embed",), self.embed
        for g, group in enumerate(self.groups):
            for i, pos in enumerate(group):
                for k in sorted(pos.keys()):
                    yield ("groups", g, i, k), pos[k]
        if self.lm_head is not None:
            yield ("lm_head",), self.lm_head
        yield ("out_norm",), self.out_norm

    def param_leaves(self) -> Iterator[torch.Tensor]:
        """Parameters in ``leaf_items`` order, which ``fingerprint_tree``
        hashes in."""
        return (t for _, t in self.leaf_items())

    def set_leaf(self, path: Tuple, value: nn.Parameter) -> None:
        """Replace the parameter at ``path`` (a path of ``leaf_items``)."""
        if path[0] == "groups":
            self.groups[path[1]][path[2]][path[3]] = value
        else:
            setattr(self, path[0], value)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Transformer:
    """Random parameters with the JAX package's inits (normal · scale,
    drawn in fp32 and cast to the leaf's dtype; norms zero; the mLSTM
    forget bias 3.0).  The numbers differ from ``jax.random``'s: tests that
    compare the two convert the JAX init with
    ``repro_torch.bridge.params_from_jax`` instead."""
    model = Transformer(cfg, device=device)

    def draw(p: torch.Tensor, scale: float) -> None:
        noise = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                            device=p.device)
        # scaled in place: one fp32 temporary the size of the leaf, not two
        # (a full-width stack of experts is tens of GB in fp32)
        p.copy_(noise.mul_(scale))

    draw(model.embed, cfg.d_model ** -0.5)
    if model.lm_head is not None:         # the reference's key order
        draw(model.lm_head, cfg.d_model ** -0.5)
    for (pattern, _), group in zip(cfg.blocks, model.groups):
        for spec, pos in zip(pattern, group):
            for name, leaf in layer_leaves(cfg, spec).items():
                if leaf.scale is not None:
                    draw(pos[name], leaf.scale)
                elif leaf.fill:
                    pos[name].fill_(leaf.fill)
    return model
