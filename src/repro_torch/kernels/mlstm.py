"""Chunkwise mLSTM: the CUDA kernel and its plain version.

Both take q, k, v: (B, S, H, dh) of one dtype and the gate pre-activations
it, ft: (B, S, H) in fp32, with S a multiple of ``chunk``, and return
h: (B, S, H, dh) in q's dtype and the final state (C (B, H, dh, dh),
n (B, H, dh), m (B, H)) in fp32, carried from C = 0, n = 0, m = -1e30.
Neither pads: the callers do (``ops.mlstm_chunkwise`` as the JAX package's
``ops`` does, the model as ``mlstm_train`` does).  The kernel
(``csrc/mlstm.cu``) replaces the TPU kernel
``src/repro/kernels/mlstm.py:_mlstm_kernel``, which keeps the state in
VMEM and never writes it out; the model's decode needs it.  bf16 inputs
run two tensor-core passes (the state entering each chunk, then every
chunk's output at once) through scratch that the wrapper allocates; fp32
inputs run the CUDA-core kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda

NEG_INF = -1e30
MAX_DH = 512
MAX_CHUNK = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda.load("mlstm")
    fn = lib.mlstm_launch
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           it: torch.Tensor, ft: torch.Tensor, chunk: int) -> None:
    """The checks of shapes, dtypes and strides that the kernel needs."""
    B, S, H, dh = q.shape
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the mLSTM kernel takes f32 or bf16 q/k/v of one "
                        f"dtype, not {q.dtype}/{k.dtype}/{v.dtype}")
    if it.dtype != torch.float32 or ft.dtype != torch.float32:
        raise TypeError(f"the mLSTM kernel takes fp32 gates, not "
                        f"{it.dtype}/{ft.dtype}")
    if (k.shape != q.shape or v.shape != q.shape or it.shape != (B, S, H)
            or ft.shape != it.shape):
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} it{tuple(it.shape)} "
                         f"ft{tuple(ft.shape)}")
    if not (1 <= chunk <= MAX_CHUNK and S >= chunk and S % chunk == 0
            and dh <= MAX_DH):
        raise ValueError(f"the mLSTM kernel takes 1 <= chunk <= {MAX_CHUNK}, "
                         f"S a positive multiple of chunk and dh <= {MAX_DH}, "
                         f"not chunk={chunk}, S={S}, dh={dh}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the mLSTM kernel reads rows with unit head-dim stride")
    if not (it.is_contiguous() and ft.is_contiguous()):
        raise ValueError("the mLSTM kernel reads contiguous gates")
    if q.dtype == torch.bfloat16 and dh % 8:
        raise ValueError(f"the bf16 mLSTM kernel takes dh a multiple of "
                         f"8, not {dh}")


def mlstm_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               it: torch.Tensor, ft: torch.Tensor, chunk: int):
    """The operator's fake implementation: the checks and the outputs'
    shapes and dtypes (h, C, n, m), without a launch."""
    _check(q, k, v, it, ft, chunk)
    B, S, H, dh = q.shape
    f32 = dict(dtype=torch.float32)
    return (q.new_empty(q.shape), q.new_empty((B, H, dh, dh), **f32),
            q.new_empty((B, H, dh), **f32), q.new_empty((B, H), **f32))


def mlstm_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               it: torch.Tensor, ft: torch.Tensor, chunk: int
               ) -> Tuple[torch.Tensor, State]:
    """Launch the kernel on CUDA tensors (one launch for fp32, the state
    and output passes for bf16; one count either way).  q, k and v are read
    in place through their strides; h and the state are new tensors."""
    B, S, H, dh = q.shape
    if not all(x.is_cuda and x.device == q.device for x in (q, k, v, it, ft)):
        raise ValueError("mlstm_cuda takes CUDA tensors on one device")
    _check(q, k, v, it, ft, chunk)
    dev = q.device
    P, nc = B * H, S // chunk
    scratch = (None, None, None)
    if q.dtype == torch.bfloat16:     # the tensor-core passes
        cuda.check_aligned("mLSTM", q, k, v)
        # the state entering each chunk, in one allocation: C as a bf16
        # (hi, lo) pair (P, nc, 2, dh, dh), n (P, nc, dh) and m (P, nc) in
        # fp32, each part starting on a 16-byte boundary
        sizes = (P * nc * 2 * dh * dh * 2, P * nc * dh * 4, P * nc * 4)
        offsets = [0]
        for size in sizes[:-1]:
            offsets.append(offsets[-1] + (size + 15) // 16 * 16)
        buf = torch.empty(offsets[-1] + sizes[-1], dtype=torch.uint8,
                          device=dev)
        scratch = tuple(buf.data_ptr() + off for off in offsets)
    lib = _lib()
    h = torch.empty((B, S, H, dh), dtype=q.dtype, device=dev)
    # the final C, n and m as views of one fp32 allocation
    state = torch.empty(P * (dh * dh + dh + 1), dtype=torch.float32,
                        device=dev)
    C = state[:P * dh * dh].view(B, H, dh, dh)
    n = state[P * dh * dh:P * (dh * dh + dh)].view(B, H, dh)
    m = state[P * (dh * dh + dh):].view(B, H)
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = lib.mlstm_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), it.data_ptr(),
        ft.data_ptr(), h.data_ptr(), C.data_ptr(), n.data_ptr(),
        m.data_ptr(), *scratch, _DTYPES[q.dtype], B, S, H, dh, chunk,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), stream)
    cuda.check(status, "mlstm")
    cuda.launches["mlstm"] += 1
    return h, (C, n, m)


def mlstm_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                it: torch.Tensor, ft: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, State]:
    """The kernel's plain PyTorch version, on any device: the chunk body of
    the JAX package's ``mlstm_train`` for every plane at once, in fp32.
    The inputs are split into chunks once, so that autograd assembles their
    gradients with one concatenation each, not with a zero-filled copy of
    a whole input for every chunk."""
    B, S, H, dh = q.shape
    c = chunk
    if S % c:
        raise ValueError(f"S={S} is not a multiple of chunk={c}")
    dev = q.device
    C = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=dev)
    n = torch.zeros((B, H, dh), dtype=torch.float32, device=dev)
    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    causal = torch.ones((c, c), dtype=torch.bool, device=dev).tril()
    hs = []
    chunks = zip(*(x.float().split(c, dim=1) for x in (q, k, v, it, ft)))
    for qi, ki, vi, iti, fti in chunks:     # (B, c, H, dh); gates (B, c, H)
        csum = torch.cumsum(F.logsigmoid(fti), dim=1)
        tot = csum[:, -1]                                      # (B, H)
        # a[b, t, s, h] = csum_t - csum_s + i_s for s <= t
        a = csum[:, :, None, :] - csum[:, None, :, :] + iti[:, None, :, :]
        a = torch.where(causal[None, :, :, None], a, float("-inf"))
        b = csum + m[:, None, :]                               # (B, c, H)
        m_row = torch.maximum(a.amax(dim=2), b)
        D = torch.exp(a - m_row[:, :, None, :])
        sq = torch.exp(b - m_row)
        w = torch.einsum("bthd,bshd->btsh", qi, ki) * D
        num = (torch.einsum("btsh,bshd->bthd", w, vi)
               + torch.einsum("bthd,bhde->bthe", qi, C) * sq[..., None])
        n_intra = w.sum(dim=2)
        n_inter = torch.einsum("bthd,bhd->bth", qi, n) * sq
        denom = torch.clamp((n_intra + n_inter).abs(), min=1.0)
        hs.append((num / denom[..., None]).to(q.dtype))
        # carry the state to the chunk's end
        m_next = torch.maximum(tot + m, (tot[:, None] - csum + iti).amax(dim=1))
        dec = torch.exp(tot + m - m_next)
        w_s = torch.exp(tot[:, None] - csum + iti - m_next[:, None])
        C = C * dec[..., None, None] + torch.einsum(
            "bshd,bshe->bhde", ki * w_s[..., None], vi)
        n = n * dec[..., None] + torch.einsum("bsh,bshd->bhd", w_s, ki)
        m = m_next
    return torch.cat(hs, dim=1), (C, n, m)
