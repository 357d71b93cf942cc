"""RG-LRU gated linear recurrence: the CUDA kernel and its plain version.

y_t = a_t · y_{t-1} + x_t over a, x: (B, S, W), elementwise over the W
lanes, from y = 0, in fp32; the output is fp32.  The kernel
(``csrc/rglru.cu``) replaces the TPU kernel
``src/repro/kernels/rglru.py:_rglru_kernel``.  It is a segmented scan over
time: a block owns a strip of lanes and splits time into segments, each
thread first reduces its segment to (decay product, end value), combines
those of the segments before it into its carry-in, then reruns its segment
from that carry.  Each product and sum is rounded apart, as in the plain
version, so the first segment (``layout()[2]`` steps) equals the plain
version bit for bit; later steps differ by the rounding of the carries
only (within 1e-5 here), and a repeated call gives the same bits.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import Tuple

import torch

from repro_torch.kernels import cuda


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda.load("rglru")
    fn = lib.rglru_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(a: torch.Tensor, x: torch.Tensor) -> None:
    """The checks of shapes, dtypes and layout that the kernel needs."""
    if a.dtype != torch.float32 or x.dtype != torch.float32:
        raise TypeError(f"the RG-LRU kernel takes fp32 a and x, not "
                        f"{a.dtype}/{x.dtype}")
    if a.dim() != 3 or x.shape != a.shape:
        raise ValueError(f"bad shapes a{tuple(a.shape)} x{tuple(x.shape)}")
    if not (a.is_contiguous() and x.is_contiguous()):
        raise ValueError("the RG-LRU kernel reads contiguous a and x")


def rglru_fake(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The operator's fake implementation: the checks and the output's
    shape and dtype, without a launch."""
    _check(a, x)
    return a.new_empty(a.shape)


def rglru_cuda(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; returns a new (B, S, W) fp32
    tensor."""
    if not (a.is_cuda and x.device == a.device):
        raise ValueError("rglru_cuda takes CUDA tensors on one device")
    _check(a, x)
    B, S, W = a.shape
    lib = _lib()
    y = torch.empty((B, S, W), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    status = lib.rglru_launch(a.data_ptr(), x.data_ptr(), y.data_ptr(),
                              B, S, W, stream)
    cuda.check(status, "rglru")
    cuda.launches["rglru"] += 1
    return y


@functools.cache
def layout() -> Tuple[int, int, int]:
    """The kernel's layout: (lanes a block, segments a super-chunk, steps a
    segment), read from the constants ``LW``, ``T`` and ``L`` of
    ``csrc/rglru.cu``; needs no build."""
    src = (cuda.CSRC / "rglru.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
                 for name in ("LW", "T", "L"))


def rglru_plain(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version, on any device: the sequential
    recurrence in fp32, one step at a time.  The inputs are unbound over
    time once and the steps stacked, so that autograd differentiates it
    with one gather and one stack, not with a zero-filled copy of a whole
    input or output for every step."""
    a, x = a.float(), x.float()
    carry = torch.zeros_like(a[:, 0])
    ys = []
    for a_t, x_t in zip(a.unbind(1), x.unbind(1)):
        carry = a_t * carry + x_t
        ys.append(carry)
    return torch.stack(ys, dim=1)
