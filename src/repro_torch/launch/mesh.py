"""Device meshes, ported from ``repro.launch.mesh``.

A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of the
default process group, which the caller initialises first (NCCL on the
card, gloo on the CPU).  Single pod: 16×16 = 256 ranks (data × model).
Multi-pod: 2×16×16 = 512 ranks with a leading "pod" axis, pure data
parallelism whose gradient all-reduce crosses the slow inter-pod links.
Functions, not constants, so that importing this module touches no
process group.
"""

from __future__ import annotations

from typing import Sequence

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A mesh of ``shape`` named ``axes`` over the default process group,
    whose world size must be the product of ``shape``; ranks fill it in
    row-major order, as ``jax.make_mesh`` fills devices."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda") -> DeviceMesh:
    """The degenerate (1, 1) mesh of one rank."""
    return make_mesh((1, 1), ("data", "model"), device_type)
