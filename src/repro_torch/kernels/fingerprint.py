"""State-attestation fingerprint: the CUDA kernel and its plain version.

digest(x) = sum over words w of ((w * 0x9E3779B9) ^ (w >> 16)) mod 2**32,
where the words are the raw bits of x: 16 bits for bf16/f16 and 32 bits for
f32/int32/uint32, widened to uint32.  Other dtypes are value-cast to uint32
words, as ``repro.kernels.ops.fingerprint`` does; the kernel does not take
them.  The kernel (``csrc/fingerprint.cu``) replaces the TPU kernel
``src/repro/kernels/fingerprint.py:_fp_kernel``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda

MIX = 0x9E3779B9
_M32 = 0xFFFFFFFF
_WORD_BYTES = {torch.bfloat16: 2, torch.float16: 2, torch.float32: 4,
               torch.int32: 4, torch.uint32: 4}
_PLAIN_CHUNK = 1 << 24


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda.load("fingerprint")
    fn = lib.fingerprint_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fingerprint_fake(x: torch.Tensor) -> torch.Tensor:
    """The operator's fake implementation: the dtype check and the (1,)
    int32 output, without a launch."""
    if x.dtype not in _WORD_BYTES:
        raise TypeError(f"the fingerprint kernel takes bf16, f16, f32, int32 "
                        f"or uint32 words, not {x.dtype}")
    return x.new_empty((1,), dtype=torch.int32)


def fingerprint_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor.  Returns a (1,) int32 tensor on
    the device holding the uint32 digest's bits; nothing is synchronised."""
    if not x.is_cuda:
        raise ValueError("fingerprint_cuda takes a CUDA tensor")
    word_bytes = _WORD_BYTES.get(x.dtype)
    if word_bytes is None:
        raise TypeError(f"the fingerprint kernel takes bf16, f16, f32, int32 "
                        f"or uint32 words, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the fingerprint kernel reads a contiguous tensor")
    lib = _lib()
    out = torch.zeros(1, dtype=torch.int32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.fingerprint_launch(x.data_ptr(), x.numel(), word_bytes,
                                    out.data_ptr(), stream)
    cuda.check(status, "fingerprint")
    cuda.launches["fingerprint"] += 1
    return out


def _words(x: torch.Tensor) -> torch.Tensor:
    """The uint32 words of ``x``, held in int64 (torch has little uint32
    arithmetic)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.view(torch.int16).to(torch.int64) & 0xFFFF
    if x.dtype in (torch.float32, torch.int32, torch.uint32):
        return x.view(torch.int32).to(torch.int64) & _M32
    return x.to(torch.int64) & _M32


def fingerprint_plain(x: torch.Tensor) -> int:
    """The kernel's plain PyTorch version, on any device.  Works through the
    flattened tensor in chunks, so the int64 temporaries stay small."""
    flat = x.reshape(-1)
    total = 0
    for i in range(0, flat.numel(), _PLAIN_CHUNK):
        w = _words(flat[i:i + _PLAIN_CHUNK])
        w = ((w * MIX) & _M32) ^ (w >> 16)
        total += int(w.sum())
    return total & _M32
