"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Builds
happen at first use, never at import, into ``kernels/build/`` (ignored by
git); a library is named after a hash of its source and of the shared
headers ``csrc/*.cuh``, so an edited source or header builds anew.
:func:`build` starts one ``nvcc`` per missing library, all at once.

``launches`` counts kernel launches by name.  Each launcher adds one where
it launches its kernel and nowhere else, so a caller can reset the counts,
run a path, and see which kernels the path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
SOURCES = ("fingerprint", "swa", "rglru", "mlstm", "routed")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches: Dict[str, int] = {name: 0 for name in SOURCES}
#: ptxas report (registers, shared memory, spills) of each library built by
#: this process
build_log: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named after a hash of the source
    and the shared headers it may include."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> None:
    """Compile every library of ``names`` that is not built yet, with one
    ``nvcc`` process per source, all running together.  Raises if any
    fails."""
    pending = []
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        pending.append((name, proc, tmp, target))
    failed = []
    for name, proc, tmp, target in pending:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}{err}")
            continue
        os.replace(tmp, target)
        build_log[name] = out + err
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _libs[name] = lib
    return lib


def check(status: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (``cudaGetLastError``)."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status}")


def check_aligned(name: str, *xs) -> None:
    """Raise unless every tensor of ``xs`` starts on a 16-byte boundary and
    steps between rows in multiples of 16 bytes: the tensor-core kernels
    copy rows into shared memory 16 bytes at a time (``cp.async``)."""
    for x in xs:
        if x.data_ptr() % 16 or any(
                (st * x.element_size()) % 16 for st in x.stride()[:-1]):
            raise ValueError(
                f"the {name} kernel takes 16-byte aligned rows: pointer "
                f"{x.data_ptr():#x}, strides {tuple(x.stride())} of "
                f"{x.dtype}")
