"""Sliding-window causal attention: the CUDA kernel and its plain version.

A query at position p attends to keys p-w+1 .. p.  q: (B, S, H, dh);
k, v: (B, S, KV, dh) with H a multiple of KV (GQA: query head h reads kv
head h // (H // KV)).  The softmax and P·V run in fp32 and the output has
q's dtype, as in the TPU kernel ``src/repro/kernels/swa.py:_swa_kernel``
that ``csrc/swa.cu`` replaces.  Forward only.  bf16 and fp16 inputs run
the tensor-core kernel (dh a multiple of 16, rows 16-byte aligned), fp32
inputs the CUDA-core one.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import cuda

NEG_INF = -1e30
MAX_DH = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda.load("swa")
    fn = lib.swa_launch
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int) -> None:
    """The checks of shapes, dtypes and strides that the kernel needs."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"the SWA kernel takes f32, bf16 or f16 q/k/v of one "
                        f"dtype, not {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, S, KV, dh) or v.shape != k.shape or H % KV:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    if dh > MAX_DH or window < 1:
        raise ValueError(f"the SWA kernel takes dh <= {MAX_DH} and window >= "
                         f"1, not dh={dh}, window={window}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the SWA kernel reads rows with unit head-dim stride")
    if q.dtype != torch.float32:      # the tensor-core kernel
        if dh % 16:
            raise ValueError(f"the {q.dtype} SWA kernel takes dh a multiple "
                             f"of 16, not {dh}")


def swa_fake(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             window: int) -> torch.Tensor:
    """The operator's fake implementation: the checks and the output's
    shape and dtype, without a launch."""
    _check(q, k, v, window)
    return q.new_empty(q.shape)


def swa_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             window: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns a new (B, S, H, dh)
    tensor.  K and V are read in place through their strides."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("swa_cuda takes CUDA tensors on one device")
    _check(q, k, v, window)
    if q.dtype != torch.float32:
        cuda.check_aligned("SWA", q, k, v)
    lib = _lib()
    out = torch.empty((B, S, H, dh), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.swa_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        _DTYPES[q.dtype], B, S, H, KV, dh, window,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        dh ** -0.5, stream)
    cuda.check(status, "swa")
    cuda.launches["swa"] += 1
    return out


def swa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              window: int) -> torch.Tensor:
    """The kernel's plain PyTorch version, on any device: the JAX package's
    ``banded_window_attention`` (chunk = window; each query chunk attends to
    [previous chunk ‖ own chunk] in one einsum) computed in fp32 throughout,
    so P·V is fp32 as in the kernel."""
    B, S, H, dh = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    c = window
    pad = (-S) % c
    out_dtype = q.dtype
    q, k, v = q.float(), k.float(), v.float()
    if pad:
        q, k, v = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v))
    Sp = S + pad
    nq = Sp // c
    qc = q.reshape(B, nq, c, KV, G, dh)
    # banded keys/values: [chunk i-1 ‖ chunk i] for each chunk i
    kprev = F.pad(k, (0, 0, 0, 0, c, 0))[:, :-c]
    kc = torch.cat([kprev.reshape(B, nq, c, KV, dh),
                    k.reshape(B, nq, c, KV, dh)], dim=2)
    vprev = F.pad(v, (0, 0, 0, 0, c, 0))[:, :-c]
    vc = torch.cat([vprev.reshape(B, nq, c, KV, dh),
                    v.reshape(B, nq, c, KV, dh)], dim=2)
    s = torch.einsum("bnqkgd,bnskd->bnkgqs", qc, kc) * scale
    dev = q.device
    qi = torch.arange(c, device=dev)[:, None]
    si = torch.arange(2 * c, device=dev)[None, :]
    delta = (c + qi) - si                      # q_pos - k_pos
    band = (delta >= 0) & (delta < window)
    # the first chunk's "previous" keys are padding
    nvalid = torch.arange(nq, device=dev)[:, None, None] > 0
    valid = band[None] & (nvalid | (si[None] >= c))
    s = torch.where(valid[:, None, None], s, NEG_INF)
    probs = torch.softmax(s, dim=-1)
    out = torch.einsum("bnkgqs,bnskd->bnqkgd", probs, vc)
    return out.reshape(B, Sp, H, dh)[:, :S].to(out_dtype)
