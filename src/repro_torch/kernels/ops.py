"""Public wrappers around the CUDA kernels, and the kernels as operators.

Each kernel is an operator of the ``repro_torch`` library
(``torch.ops.repro_torch.{swa,rglru,mlstm,fingerprint,routed}``): its CUDA
implementation launches the kernel and counts the launch, its fake
implementation gives the output's shapes and dtypes without running
anything, and its FLOP formula (``torch.utils.flop_counter``) and byte
count come from ``kernels.work``.  So a step traced on fake tensors (the
dry-run, ``launch.costing``) sees each kernel call as one operator with
the work the kernel does.

A wrapper calls the operator for a CUDA tensor (a launch) or a fake
tensor (a trace), and runs the kernel's plain version for a CPU tensor;
there is no fallback from one to the other.  The wrappers' own checks stay
outside the operators.  A kernel takes raw pointers, which a DTensor does not
have: the wrappers raise on one, and the model calls them on local shards
(``local_map``).  The SWA, RG-LRU, mLSTM and routed-experts kernels are
forward only: their wrappers raise for CUDA inputs that autograd would
differentiate, rather than return a result that silently drops the
gradient.
``launches`` counts kernel launches by name (see ``kernels.cuda``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake, unset_fake_temporarily
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import _disable_current_modes
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import work
from repro_torch.kernels.cuda import launches, reset_launches
from repro_torch.kernels.fingerprint import (fingerprint_cuda,
                                             fingerprint_fake,
                                             fingerprint_plain)
from repro_torch.kernels.mlstm import (State, mlstm_cuda, mlstm_fake,
                                       mlstm_plain)
from repro_torch.kernels.rglru import rglru_cuda, rglru_fake, rglru_plain
from repro_torch.kernels.routed import routed_cuda, routed_fake, routed_plain
from repro_torch.kernels.swa import swa_cuda, swa_fake, swa_plain

__all__ = ["KERNEL_OPS", "fingerprint", "host_ints", "host_side", "launches",
           "mlstm_chunkwise", "mlstm_chunkwise_state", "op_work",
           "reset_launches", "rglru_scan", "routed_experts",
           "sliding_window_attention", "traced"]

_M32 = 0xFFFFFFFF

# ---------------------------------------------------------------------------
# The kernels as operators
# ---------------------------------------------------------------------------
_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("swa(Tensor q, Tensor k, Tensor v, int window) -> Tensor")
_LIB.define("rglru(Tensor a, Tensor x) -> Tensor")
_LIB.define("mlstm(Tensor q, Tensor k, Tensor v, Tensor it, Tensor ft, "
            "int chunk) -> (Tensor, Tensor, Tensor, Tensor)")
_LIB.define("fingerprint(Tensor x) -> Tensor")
_LIB.define("routed(Tensor x, Tensor top_e, Tensor top_w, Tensor w_gate, "
            "Tensor w_up, Tensor w_down, int e0, int e_local) -> Tensor")


def _mlstm_flat(q, k, v, it, ft, chunk):
    h, (C, n, m) = mlstm_cuda(q, k, v, it, ft, chunk)
    return h, C, n, m


for _name, _cuda, _fake in (("swa", swa_cuda, swa_fake),
                            ("rglru", rglru_cuda, rglru_fake),
                            ("mlstm", _mlstm_flat, mlstm_fake),
                            ("fingerprint", fingerprint_cuda,
                             fingerprint_fake),
                            ("routed", routed_cuda, routed_fake)):
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"repro_torch::{_name}", _fake, lib=_LIB)


def _swa_work(q, k, v, window) -> work.Work:
    B, S, H, dh = q.shape
    return work.swa_work(B, S, H, k.shape[2], dh, window, q.element_size())


def _rglru_work(a, x) -> work.Work:
    return work.rglru_work(*a.shape)


def _mlstm_work(q, k, v, it, ft, chunk) -> work.Work:
    B, S, H, dh = q.shape
    return work.mlstm_work(B, S, H, dh, chunk, q.element_size())


def _fingerprint_work(x) -> work.Work:
    return work.fingerprint_work(x.numel(), x.element_size())


def _routed_work(x, top_e, top_w, w_gate, w_up, w_down, e0,
                 e_local) -> work.Work:
    return work.routed_work(*top_e.shape, x.shape[1], w_gate.shape[2],
                            x.element_size())


#: the operators the wrappers call
SWA = torch.ops.repro_torch.swa.default
RGLRU = torch.ops.repro_torch.rglru.default
MLSTM = torch.ops.repro_torch.mlstm.default
FINGERPRINT = torch.ops.repro_torch.fingerprint.default
ROUTED = torch.ops.repro_torch.routed.default

#: each kernel operator's work from its arguments (tensors, fake or real)
KERNEL_OPS: Dict[object, Callable[..., work.Work]] = {
    SWA: _swa_work, RGLRU: _rglru_work, MLSTM: _mlstm_work,
    FINGERPRINT: _fingerprint_work, ROUTED: _routed_work,
}


def op_work(func, args) -> work.Work:
    """The work of one call of a kernel operator (a key of ``KERNEL_OPS``)
    on ``args``."""
    return KERNEL_OPS[func](*args)


def _flop_formula(func):
    # the formula gets the tensors themselves (get_raw), whose element size
    # it needs; FlopCounterMode passes the output as ``out_val``
    @register_flop_formula(func.overloadpacket, get_raw=True)
    def flops(*args, out_val=None, **kwargs) -> int:
        return int(KERNEL_OPS[func](*args, **kwargs).flops)
    return flops


for _func in KERNEL_OPS:
    _flop_formula(_func)


# ---------------------------------------------------------------------------
# Traced calls: what the port does differently on fake tensors
# ---------------------------------------------------------------------------
def traced(*xs: torch.Tensor) -> bool:
    """True where one of ``xs`` is a fake tensor: the call is traced (the
    dry-run, ``launch.costing``), not run.  A traced call takes the card's
    path on either device, so that it counts the card's work: the kernels'
    operators here, AdamW's square root (``optim.adamw``)."""
    return any(is_fake(x) for x in xs)


@contextlib.contextmanager
def host_side() -> Iterator[None]:
    """Work on the host that no dispatch mode or fake mode sees: a read of
    a tensor's values, or arithmetic that DTensor does with tensors to
    place a shard (``parallel.sharding.global_offset``)."""
    with _disable_current_modes(), unset_fake_temporarily():
        yield


def host_ints(t: torch.Tensor) -> List[int]:
    """The values of an integer tensor, read on the host.  A traced tensor
    holds none and reads 0 for each.  This is the one place where a traced
    call differs from a run: the digests of a traced step are 0, while
    every launch and collective that makes them is traced.  The read is
    ``host_side``, so a run and a trace count alike."""
    if traced(t):
        return [0] * t.numel()
    with host_side():
        return t.tolist()


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------
def _on_cuda(*xs: torch.Tensor) -> bool:
    """True where the operator runs: CUDA tensors (a launch) or fake
    tensors (a trace); False for CPU tensors (the plain version)."""
    if any(isinstance(x, DTensor) for x in xs):
        raise TypeError("the kernels take local tensors, not DTensors: call "
                        "them on local shards (local_map)")
    devices = {x.device.type for x in xs}
    if devices == {"cuda"}:
        return True
    if devices == {"cpu"}:
        return traced(*xs)
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
        return SWA(q, k, v, window)
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
        h, C, n, m = MLSTM(q, k, v, it, ft, chunk)
        return h, (C, n, m)
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
        return RGLRU(a, x)
    return rglru_plain(a, x)


def routed_experts(x: torch.Tensor, top_e: torch.Tensor,
                   top_w: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor, w_down: torch.Tensor, e0: int,
                   e_local: int) -> torch.Tensor:
    """An MoE FFN's routed, held experts [e0, e0 + e_local) for a few
    tokens (see ``kernels.routed``).  x: (T, D); top_e, top_w: (T, k);
    w_gate, w_up: (e_local, D, F); w_down: (e_local, F, D) -> (T, D)."""
    if _on_cuda(x, top_e, top_w, w_gate, w_up, w_down):
        _forward_only("routed", x, w_gate, w_up, w_down)
        return ROUTED(x, top_e, top_w, w_gate, w_up, w_down, e0, e_local)
    return routed_plain(x, top_e, top_w, w_gate, w_up, w_down, e0, e_local)


def fingerprint(x: torch.Tensor) -> int:
    """uint32 digest of a tensor's words (see ``kernels.fingerprint``)."""
    if _on_cuda(x):
        return host_ints(FINGERPRINT(x))[0] & _M32
    return fingerprint_plain(x)
