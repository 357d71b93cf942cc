"""Routed experts of an MoE FFN for a few tokens: the CUDA kernel and its
plain version.

x: (T, D); the routes top_e (T, k) int64 and top_w (T, k) fp32, as
``models.moe.route`` gives them; the held experts' stacked weights w_gate,
w_up (E_held, D, F) and w_down (E_held, F, D), which hold experts
[e0, e0 + e_local).  For each (token, slot) routed to a held expert e the
slot's SwiGLU y = (silu(x W_gate[e]) * (x W_up[e])) W_down[e], and each
token's output (T, D) is the sum of y * w over its held slots, added one at
a time in ascending expert index, in x's dtype; a slot routed elsewhere
adds nothing.  That is the routed FFN of ``models.moe`` when no route is
dropped, rounded where its buffer path rounds.  The kernel
(``csrc/routed.cu``) replaces no TPU kernel: it reads only the routed, held
experts' weights, in place.  Forward only, bf16 or fp32.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda

#: the most slots a token the kernel takes (``KMAX`` in the source)
KMAX = 16
_ELEM = {torch.bfloat16: 2, torch.float32: 4}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda.load("routed")
    fn = lib.routed_launch
    fn.argtypes = ([ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.c_longlong] * 3
                   + [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] * 3
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(x, top_e, top_w, w_gate, w_up, w_down) -> None:
    """The checks of shapes and dtypes that the kernel needs."""
    T, D = x.shape
    E, F_ = w_gate.shape[0], w_gate.shape[2]
    if (top_e.shape != top_w.shape or top_e.dim() != 2
            or top_e.shape[0] != T):
        raise ValueError(f"bad routes: top_e{tuple(top_e.shape)} "
                         f"top_w{tuple(top_w.shape)} for x{tuple(x.shape)}")
    if (w_gate.shape != (E, D, F_) or w_up.shape != w_gate.shape
            or w_down.shape != (E, F_, D)):
        raise ValueError(f"bad expert weights w_gate{tuple(w_gate.shape)} "
                         f"w_up{tuple(w_up.shape)} "
                         f"w_down{tuple(w_down.shape)} for D = {D}")
    if top_e.dtype != torch.int64 or top_w.dtype != torch.float32:
        raise TypeError(f"routes are int64 experts and fp32 weights, not "
                        f"{top_e.dtype}/{top_w.dtype}")
    if x.dtype not in _ELEM or any(w.dtype != x.dtype
                                   for w in (w_gate, w_up, w_down)):
        raise TypeError(f"the routed kernel takes bf16 or fp32 x and weights "
                        f"of one dtype, not {x.dtype}/{w_gate.dtype}")
    if top_e.shape[1] > KMAX:
        raise ValueError(f"the routed kernel takes at most {KMAX} slots a "
                         f"token, not {top_e.shape[1]}")


def routed_fake(x: torch.Tensor, top_e: torch.Tensor, top_w: torch.Tensor,
                w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, e0: int, e_local: int) -> torch.Tensor:
    """The operator's fake implementation: the checks and the (T, D)
    output in x's dtype, without a launch."""
    _check(x, top_e, top_w, w_gate, w_up, w_down)
    return x.new_empty(x.shape)


def routed_cuda(x: torch.Tensor, top_e: torch.Tensor, top_w: torch.Tensor,
                w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, e0: int, e_local: int) -> torch.Tensor:
    """Launch the kernel's two passes on CUDA tensors; returns a new (T, D)
    tensor.  Nothing is read back to the host and nothing is allocated
    but the output and the (T·k, F) activation between the passes, so the
    call can be captured in a CUDA graph."""
    if not (x.is_cuda and all(t.device == x.device for t in (
            top_e, top_w, w_gate, w_up, w_down))):
        raise ValueError("routed_cuda takes CUDA tensors on one device")
    _check(x, top_e, top_w, w_gate, w_up, w_down)
    for name, t in (("x", x), ("top_e", top_e), ("top_w", top_w),
                    ("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down)):
        if t.stride(-1) != 1:
            raise ValueError(f"the routed kernel reads {name} with a unit "
                             f"last stride, not {tuple(t.stride())}")
    cuda.check_aligned("routed", w_gate, w_up, w_down)
    T, D = x.shape
    k = top_e.shape[1]
    F_ = w_gate.shape[2]
    p = torch.empty((T * k, F_), dtype=x.dtype, device=x.device)
    out = torch.empty((T, D), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = _lib().routed_launch(
        _ELEM[x.dtype], x.data_ptr(), x.stride(0), top_e.data_ptr(),
        top_e.stride(0), top_w.data_ptr(), top_w.stride(0),
        w_gate.data_ptr(), w_gate.stride(0), w_gate.stride(1),
        w_up.data_ptr(), w_up.stride(0), w_up.stride(1),
        w_down.data_ptr(), w_down.stride(0), w_down.stride(1),
        p.data_ptr(), out.data_ptr(), T, k, D, F_, e0, e_local, stream)
    cuda.check(status, "routed")
    cuda.launches["routed"] += 1
    return out


def routed_plain(x: torch.Tensor, top_e: torch.Tensor, top_w: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor,
                 w_down: torch.Tensor, e0: int, e_local: int) -> torch.Tensor:
    """The kernel's plain PyTorch version, on any device: every slot's
    products over its expert's gathered weights (a slot not held takes
    expert e0's and is zeroed), each token's slots weighed and then added
    in ascending expert order, as the buffer path adds them."""
    T, k = top_e.shape
    le = top_e.reshape(-1) - e0
    held = (le >= 0) & (le < e_local)
    idx = torch.where(held, le, 0)
    xs = x.repeat_interleave(k, dim=0)[:, None]             # (T·k, 1, D)
    h = torch.bmm(xs, w_gate[idx])
    u = torch.bmm(xs, w_up[idx])
    y = torch.bmm(F.silu(h) * u, w_down[idx])[:, 0]         # (T·k, D)
    rows = y * top_w.reshape(-1).to(x.dtype)[:, None]
    contrib = torch.where(held[:, None], rows, 0).reshape(T, k, -1)
    contrib = contrib[torch.arange(T, device=x.device)[:, None],
                      torch.argsort(top_e, dim=-1, stable=True)]
    out = x.new_zeros(T, x.shape[1])
    for j in range(k):
        out = out + contrib[:, j]
    return out
