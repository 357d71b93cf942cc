"""Recurrent blocks: xLSTM (mLSTM + sLSTM) and RG-LRU (RecurrentGemma),
ported from ``repro.models.recurrent``.

Prefill and training forms (one function each, so that the two cannot
drift apart; ``train=True`` selects the training form):
* **mLSTM** — the chunkwise-parallel form; in prefill the chunk loop is the
  mLSTM kernel (``ops.mlstm_chunkwise_state``), which also returns the
  state that decode starts from.
* **sLSTM** — inherently sequential (recurrent gate connections): a Python
  loop over time with the input projections hoisted out of it.  It has no
  kernel.
* **RG-LRU** — gated linear recurrence after a short causal conv1d: in
  prefill the RG-LRU kernel (``ops.rglru_scan``) in place of JAX's
  ``associative_scan``.

The mLSTM and RG-LRU kernels are forward only, so the training forms call
their plain versions by name (``mlstm_plain``, ``rglru_plain``), which
autograd differentiates.  They do not leave the choice to the wrappers'
autograd guard: under activation checkpointing the guard could pass in
one forward and refuse in the recompute.

Decode forms: single-step state updates that return new state tensors; the
state replaces the KV cache.

On a mesh (a ``ShardCtx``), the products are column-cut or row-cut over
"model" as the rules cut their weights (``sharding.columns``,
``sharding.rows``; the RG-LRU's row-cut gates reduce-scattered onto its
lanes), and the kernels and their plain versions run on each rank's
local shards: the mLSTM and the sLSTM's loop on its batch rows and, where
the head count divides, its heads; the RG-LRU's causal conv and scan on
its batch rows and lanes, which ``lam``, ``wa`` and ``wx`` put on
"model".  All are exact per head or lane.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.mlstm import mlstm_plain
from repro_torch.kernels.rglru import rglru_plain
from repro_torch.models.common import ModelConfig, rms_norm, weak_scalar
from repro_torch.parallel import sharding

State = Dict[str, torch.Tensor]
NEG_INF = -1e30


def _out_and_mlp(p: Dict[str, torch.Tensor], inner: torch.Tensor,
                 h: torch.Tensor, ctx=None) -> torch.Tensor:
    """A block's output product ``inner @ wo`` plus its gated MLP on ``h``,
    ``(silu(g) * u) @ down``: both row-cut, so on a mesh their partial
    sums are added and reduced over "model" once."""
    u, g = sharding.columns(ctx, h, p, ("up",), split=2)
    return sharding.rows_sum(ctx, p, [(inner, "wo"), (F.silu(g) * u, "down")])


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def _mlstm_gates(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                 ctx=None):
    """Returns (q, k, v, i_tilde, f_tilde) for x: (B, S, D)."""
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.dh
    y, yk, yv, yi, yf = sharding.columns(
        ctx, x, p, ("wq", "wk", "wv", "wi", "wf"))
    scale = weak_scalar(dh ** -0.5, y)
    q = sharding.unflatten(y, -1, (H, dh)) * scale
    k = sharding.unflatten(yk, -1, (H, dh)) * scale
    v = sharding.unflatten(yv, -1, (H, dh))
    it = yi.float()                                          # (B, S, H)
    ft = yf.float() + p["bf"].float()
    return q, k, v, it, ft


def mlstm_train(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                chunk: int = 256, train: bool = False, ctx=None
                ) -> Tuple[torch.Tensor, State]:
    """Chunkwise-parallel mLSTM. x: (B, S, D) -> ((B, S, H·dh), state);
    through the kernel, or with ``train`` through its plain version.

    As in the JAX package, the *input* is zero-padded to a multiple of
    min(chunk, S) before the gate projections, so a padded step has
    q = k = v = 0, input gate 0 and forget gate ``bf``; the final state
    includes those steps (training reads only ``h[:, :S]``)."""
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.dh
    c = min(chunk, S)
    pad = (-S) % c
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    q, k, v, it, ft = _mlstm_gates(cfg, p, x, ctx)
    chunkwise = mlstm_plain if train else ops.mlstm_chunkwise_state
    if ctx is None:
        h, (C, n, m) = chunkwise(q, k, v, it, ft, c)
    else:
        h, C, n, m = _mlstm_on_shards(cfg, ctx, chunkwise, q, k, v, it, ft, c)
    h = sharding.flatten(h, 2)[:, :S]
    return h, {"C": C, "n": n, "m": m}


def _mlstm_on_shards(cfg: ModelConfig, ctx, chunkwise, q, k, v, it, ft,
                     c: int):
    """``chunkwise`` on each rank's batch rows and heads: q/k/v (B, S, H,
    dh), it/ft (B, S, H) -> h and the final (C, n, m), cut alike."""
    shape = tuple(q.shape)
    heads = ctx.tp_axis if cfg.n_heads % ctx.tp_size == 0 else None
    if heads is None:
        sharding.note_whole("mlstm")
    qs = sharding._divisible((ctx.dp_axes, None, heads, None), shape,
                             ctx.mesh)
    gs = qs[:3]

    def run(q, k, v, it, ft):
        h, (C, n, m) = chunkwise(q, k, v, it, ft, c)
        return h, C, n, m

    return sharding.on_shards(
        run, ctx.mesh, (qs, qs, qs, gs, gs),
        [qs, (qs[0], qs[2], None, None), (qs[0], qs[2], None),
         (qs[0], qs[2])])(q, k, v, it, ft)


def mlstm_block(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                train: bool = False, ctx=None) -> Tuple[torch.Tensor, State]:
    """Full mLSTM residual block: norm → mLSTM → out-proj → gated MLP.
    Returns (output, state)."""
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    inner, state = mlstm_train(cfg, p, h, chunk=cfg.mlstm_chunk, train=train,
                               ctx=ctx)
    y = _out_and_mlp(p, inner, h, ctx)
    return x + y, state


def mlstm_init_state(cfg: ModelConfig, batch: int, device=None) -> State:
    H, dh = cfg.n_heads, cfg.dh
    f32 = torch.float32
    return {"C": torch.zeros((batch, H, dh, dh), dtype=f32, device=device),
            "n": torch.zeros((batch, H, dh), dtype=f32, device=device),
            "m": torch.full((batch, H), NEG_INF, dtype=f32, device=device)}


def mlstm_step(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               state: State, ctx=None) -> Tuple[torch.Tensor, State]:
    """Single decode step. x: (B, 1, D)."""
    B = x.shape[0]
    H, dh = cfg.n_heads, cfg.dh
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v, it, ft = _mlstm_gates(cfg, p, h, ctx)
    q, k, v = q[:, 0].float(), k[:, 0].float(), v[:, 0].float()  # (B, H, dh)
    it, ft = it[:, 0], ft[:, 0]                                  # (B, H)
    lf = sharding.elementwise(F.logsigmoid, ft)
    m_new = torch.maximum(lf + state["m"], it)
    fd = torch.exp(lf + state["m"] - m_new)[..., None]
    iw = torch.exp(it - m_new)[..., None]
    C = state["C"] * fd[..., None] + (iw[..., None] * k[..., :, None]
                                      * v[..., None, :])
    n = state["n"] * fd + iw * k
    num = torch.einsum("bhd,bhde->bhe", q, C)
    den = torch.clamp(torch.einsum("bhd,bhd->bh", q, n).abs()[..., None],
                      min=1.0)
    y = _out_and_mlp(p, (num / den).to(x.dtype).reshape(B, 1, H * dh), h,
                     ctx)
    return x + y, {"C": C, "n": n, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def _slstm_cell(rz, zt, it, ft, ot, c_prev, h_prev, m_prev):
    """One step of the sLSTM cell (per-head recurrent z connection)."""
    zr = torch.einsum("bhd,hde->bhe", h_prev, rz)
    z = torch.tanh(zt + zr)
    m_t = torch.maximum(ft + m_prev, it)
    ig = torch.exp(it - m_t)
    fg = torch.exp(ft + m_prev - m_t)
    c_t = fg * c_prev + ig * z.float()
    h_t = (torch.sigmoid(ot.float()) * torch.tanh(c_t)).to(h_prev.dtype)
    return c_t, h_t, m_t


def _slstm_inputs(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                  hin: torch.Tensor, ctx=None):
    D = hin.shape[-1]
    H = cfg.n_heads

    def heads(y):
        return sharding.unflatten(y, -1, (H, D // H))

    z, i, f, o = sharding.columns(
        ctx, hin, p, ("wz", "wi", "wf", "wo_gate"))
    return heads(z), heads(i.float()), heads(f.float()), heads(o)


def slstm_block(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                ctx=None) -> Tuple[torch.Tensor, State]:
    """sLSTM residual block, a loop over time (sequential recurrence).
    Returns (output, state)."""
    hin = rms_norm(x, p["ln1"], cfg.norm_eps)
    z, i, f, o = _slstm_inputs(cfg, p, hin, ctx)
    if ctx is None:
        hs, c, h, m = _slstm_loop(p["rz"], z, i, f, o)
    else:
        hs, c, h, m = _slstm_on_shards(cfg, ctx, p["rz"], z, i, f, o)
    y = _out_and_mlp(p, sharding.flatten(hs, 2), hin, ctx)
    return x + y, {"c": c, "h": h, "m": m}


def _slstm_loop(rz, z, i, f, o):
    """The sLSTM cell over time from a zero state: z, i, f, o (B, S, H, dh)
    -> (h of every step (B, S, H, dh), the final c, h and m).  The inputs
    are unbound over time once, so that autograd assembles their gradients
    with one stack each, not with a zero-filled copy of the whole input for
    every step."""
    B, _, H, dh = z.shape
    c = torch.zeros(B, H, dh, dtype=torch.float32, device=z.device)
    m = torch.zeros_like(c)
    h = torch.zeros(B, H, dh, dtype=z.dtype, device=z.device)
    hs = []
    for zt, it, ft, ot in zip(*(t.unbind(1) for t in (z, i, f, o))):
        c, h, m = _slstm_cell(rz, zt, it, ft, ot, c, h, m)
        hs.append(h)
    return torch.stack(hs, dim=1), c, h, m


def _slstm_on_shards(cfg: ModelConfig, ctx, rz, z, i, f, o):
    """``_slstm_loop`` on each rank's batch rows and, where the head count
    divides, its heads (``rz`` cut alike): every step's operators run on
    local tensors, in a layout that does not change with the length."""
    heads = ctx.tp_axis if cfg.n_heads % ctx.tp_size == 0 else None
    if heads is None:
        sharding.note_whole("slstm")
    xs = sharding._divisible((ctx.dp_axes, None, heads, None),
                             tuple(z.shape), ctx.mesh)
    ss = (xs[0], xs[2], None)
    rs = (xs[2], None, None)
    return sharding.on_shards(
        _slstm_loop, ctx.mesh, (rs, xs, xs, xs, xs), [xs, ss, ss, ss],
        (sharding.weight_grad(rs, (xs[0], xs[2]), ctx.mesh),) + tuple(
            sharding.placements(xs, ctx.mesh) for _ in range(4)))(
        rz, z, i, f, o)


def slstm_init_state(cfg: ModelConfig, batch: int, device=None) -> State:
    H = cfg.n_heads
    shape = (batch, H, cfg.d_model // H)
    f32 = torch.float32
    return {"c": torch.zeros(shape, dtype=f32, device=device),
            "h": torch.zeros(shape, dtype=cfg.tdtype(), device=device),
            "m": torch.zeros(shape, dtype=f32, device=device)}


def slstm_step(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               state: State, ctx=None) -> Tuple[torch.Tensor, State]:
    B = x.shape[0]
    hin = rms_norm(x, p["ln1"], cfg.norm_eps)
    zt, it, ft, ot = (a[:, 0] for a in _slstm_inputs(cfg, p, hin, ctx))
    c, h, m = _slstm_cell(p["rz"], zt, it, ft, ot, state["c"], state["h"],
                          state["m"])
    y = _out_and_mlp(p, h.reshape(B, 1, cfg.d_model), hin, ctx)
    return x + y, {"c": c, "h": h, "m": m}


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma)
# ---------------------------------------------------------------------------
_RGLRU_C = 8.0


def _rglru_gates(p: Dict[str, torch.Tensor], uc: torch.Tensor, ctx=None):
    """Decay a and the gated, normalised input for conv outputs uc (with a
    context, the products row-cut and reduce-scattered, so that the gates
    come out cut over "model" by lanes, as uc is)."""
    r = torch.sigmoid(sharding.rows(ctx, uc, p, "wa", scatter=True)
                      .float())                              # recurrence gate
    i = torch.sigmoid(sharding.rows(ctx, uc, p, "wx", scatter=True)
                      .float())                              # input gate
    log_a = -_RGLRU_C * F.softplus(p["lam"].float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return a, uc.float() * i * beta


def rglru_block(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
                train: bool = False, ctx=None) -> Tuple[torch.Tensor, State]:
    """RG-LRU residual block: in-proj → conv1d(4) → gated linear recurrence
    (the RG-LRU kernel, or with ``train`` its plain version) → out-proj.
    Returns (output, state)."""
    S = x.shape[1]
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    u, gate = sharding.columns(ctx, h, p, ("w_in",), split=2)  # (B, S, F) ×2
    scan = rglru_plain if train else ops.rglru_scan
    if ctx is None:
        uc = _causal_conv4(u, p["conv"])
        a, xin = _rglru_gates(p, uc)
        y = scan(a, xin)
    else:
        lanes = sharding._divisible((ctx.dp_axes, None, ctx.tp_axis),
                                    tuple(u.shape), ctx.mesh)
        w_spec = (None, lanes[2])
        uc = sharding.on_shards(
            _causal_conv4, ctx.mesh, (lanes, w_spec), lanes,
            (sharding.placements(lanes, ctx.mesh),
             sharding.weight_grad(w_spec, lanes, ctx.mesh)))(u, p["conv"])
        a, xin = _rglru_gates(p, uc, ctx)
        y = sharding.on_shards(scan, ctx.mesh, (lanes, lanes), lanes)(a, xin)
    out_gated = (y * F.gelu(gate.float(), approximate="tanh")).to(x.dtype)
    out = x + sharding.rows(ctx, out_gated, p, "w_out")
    # decode state: last recurrence value + last 3 raw conv inputs
    hist = u[:, -3:] if S >= 3 else F.pad(u, (0, 0, 3 - S, 0))
    return out, {"y": y[:, -1], "conv": hist}


def _causal_conv4(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel 4. u: (B, S, F); w: (4, F)."""
    out = u * w[3]
    for i in range(1, 4):
        shifted = F.pad(u, (0, 0, i, 0))[:, :-i]
        out = out + shifted * w[3 - i]
    return out


def rglru_init_state(cfg: ModelConfig, batch: int, device=None) -> State:
    W = cfg.d_model
    return {"y": torch.zeros((batch, W), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, 3, W), dtype=cfg.tdtype(),
                                device=device)}


def rglru_step(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
               state: State, ctx=None) -> Tuple[torch.Tensor, State]:
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    u, gate = sharding.columns(ctx, h[:, 0], p, ("w_in",), split=2)  # (B, F)
    hist, w = state["conv"], p["conv"]                       # (B, 3, F)
    uc = u * w[3] + hist[:, 2] * w[2] + hist[:, 1] * w[1] + hist[:, 0] * w[0]
    new_hist = torch.cat([hist[:, 1:], u[:, None]], dim=1)
    a, xin = _rglru_gates(p, uc, ctx)
    y = state["y"] * a + xin
    out = (y * F.gelu(gate.float(), approximate="tanh")).to(x.dtype)
    return x + sharding.rows(ctx, out, p, "w_out")[:, None], {
        "y": y, "conv": new_hist}
