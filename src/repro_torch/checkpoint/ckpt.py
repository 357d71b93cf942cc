"""Checkpointing: fingerprint-attested save and restore, ported from
``repro.checkpoint.ckpt``.

Checkpoint ids are *agreed through uBFT consensus* before being written
(``repro_torch.runtime.trainer``): a checkpoint is only trusted if f+1
replicas attest to the same state fingerprint — the distributed analog of
the paper's f+1 signed application checkpoints (§5.1).  The fingerprint of
the parameters is stored beside the data and computed again on load, on
the model's device (the fingerprint kernel on the card), before the model
is handed to a replica; a mismatch means corruption on disk.

The format is the reference's, so that a checkpoint crosses between the
two packages both ways: ``ckpt_{step}.pkl``, a protocol-4 pickle of
``{"step", "params", "opt_state"}`` nested as the JAX package's trees with
numpy arrays as leaves, published by an atomic ``os.replace``; and
``ckpt_{step}.json``, a manifest of the step, the fingerprint and ``meta``.
numpy pickles a bf16 array through ``ml_dtypes``, which ships with JAX and
is not installed beside the port, so this module writes and reads the
pickle itself: ``_Writer`` emits for each tensor what numpy emits for an
array (``_reconstruct``, then the shape, the dtype and the raw bytes),
naming ``ml_dtypes.bfloat16`` without importing it, and streams the bytes
into the file; ``_Unpickler`` accepts only those globals and makes each
array a tensor.

``reshard`` re-lays-out a checkpoint onto a mesh (elastic scaling: a job
restarted at a different size keeps training); a sharded model is saved
as whole tensors, which either package loads.
"""

from __future__ import annotations

import json
import os
import pickle
import struct
import warnings
from typing import Any, BinaryIO, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch import bridge
from repro_torch.models.common import ModelConfig, Transformer
from repro_torch.optim.adamw import State
from repro_torch.parallel.sharding import distribute_tree, whole
from repro_torch.runtime.attest import fingerprint_tree

#: where this numpy keeps ``_reconstruct`` (``numpy._core.multiarray`` from
#: numpy 2, ``numpy.core.multiarray`` before): the name numpy itself would
#: write, which the reader's numpy resolves
_MULTIARRAY = np.zeros(0).__reduce__()[0].__module__

#: numpy's name of each leaf dtype ("bfloat16": ml_dtypes' type) and the
#: state numpy pickles with it
_NUMPY_DTYPES = {torch.float32: "f4", torch.float16: "f2",
                 torch.int32: "i4", torch.bfloat16: "bfloat16"}
_TORCH_DTYPES = {name: dt for dt, name in _NUMPY_DTYPES.items()}
_BUILTIN_STATE = (3, "<", None, None, None, -1, -1, 0)
_BF16_STATE = (3, "<", None, None, None, 2, 2, 64)


class _Global(NamedTuple):
    module: str
    name: str


class _Writer:
    """A protocol-4 pickle of nested dicts, tuples, ints, strings, None and
    tensors, written opcode by opcode (no memo, no frames, which the format
    leaves optional)."""

    def __init__(self, f: BinaryIO):
        self.write = f.write

    def dump(self, obj: Any) -> None:
        self.write(pickle.PROTO + b"\x04")
        self.save(obj)
        self.write(pickle.STOP)

    def save(self, obj: Any) -> None:
        w = self.write
        if obj is None:
            w(pickle.NONE)
        elif isinstance(obj, bool):
            w(pickle.NEWTRUE if obj else pickle.NEWFALSE)
        elif isinstance(obj, int):
            if -2 ** 31 <= obj < 2 ** 31:
                w(pickle.BININT + struct.pack("<i", obj))
            else:
                data = pickle.encode_long(obj)
                w(pickle.LONG1 + bytes([len(data)]) + data)
        elif isinstance(obj, str):
            data = obj.encode("utf-8")
            w(pickle.BINUNICODE + struct.pack("<I", len(data)) + data)
        elif isinstance(obj, bytes):
            self._bytes(obj)
        elif isinstance(obj, _Global):
            self.save(obj.module)
            self.save(obj.name)
            w(pickle.STACK_GLOBAL)
        elif isinstance(obj, tuple):
            w(pickle.MARK)
            for x in obj:
                self.save(x)
            w(pickle.TUPLE)
        elif isinstance(obj, dict):
            w(pickle.EMPTY_DICT + pickle.MARK)
            for k, v in obj.items():
                self.save(k)
                self.save(v)
            w(pickle.SETITEMS)
        elif isinstance(obj, torch.Tensor):
            self._array(obj)
        else:
            raise TypeError(f"a checkpoint cannot hold {type(obj).__name__}")

    def _bytes(self, data) -> None:
        n = memoryview(data).nbytes
        if n < 256:
            self.write(pickle.SHORT_BINBYTES + bytes([n]))
        elif n < 2 ** 32:
            self.write(pickle.BINBYTES + struct.pack("<I", n))
        else:
            self.write(pickle.BINBYTES8 + struct.pack("<Q", n))
        self.write(data)

    def _array(self, t: torch.Tensor) -> None:
        """``t`` as numpy pickles an array of its dtype:
        ``_reconstruct(ndarray, (0,), b"b")``, then its state (1, shape,
        dtype, Fortran order, raw bytes)."""
        name = _NUMPY_DTYPES.get(t.dtype)
        if name is None:
            raise TypeError(f"a checkpoint cannot hold {t.dtype} leaves")
        w = self.write
        self.save(_Global(_MULTIARRAY, "_reconstruct"))
        self.save((_Global("numpy", "ndarray"), (0,), b"b"))
        w(pickle.REDUCE + pickle.MARK)
        self.save(1)
        self.save(tuple(t.shape))
        self.save(_Global("numpy", "dtype"))
        bf16 = t.dtype == torch.bfloat16
        self.save((_Global("ml_dtypes", "bfloat16") if bf16 else name,
                   False, True))
        w(pickle.REDUCE)
        self.save(_BF16_STATE if bf16 else _BUILTIN_STATE)
        w(pickle.BUILD)
        self.save(False)
        raw = t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        self._bytes(memoryview(raw.numpy()))
        w(pickle.TUPLE + pickle.BUILD)


class _Dtype:
    """``numpy.dtype(name, align, copy)`` as the reader meets it."""

    def __init__(self, name: str, align: bool = False, copy: bool = True):
        if name not in _TORCH_DTYPES:
            raise pickle.UnpicklingError(f"a checkpoint leaf of dtype {name}")
        self.torch = _TORCH_DTYPES[name]

    def __setstate__(self, state: tuple) -> None:
        if state[1] == ">":
            raise pickle.UnpicklingError("a big-endian checkpoint leaf")


class _Array:
    """An array as the pickle builds it; its state makes it a tensor."""

    def __setstate__(self, state: tuple) -> None:
        _, shape, dtype, fortran, raw = state
        if fortran or not isinstance(dtype, _Dtype):
            raise pickle.UnpicklingError("a checkpoint leaf in an unknown "
                                         "layout")
        if len(raw):
            # a tensor over the pickle's read-only bytes: the loader copies
            # it before anything writes
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", UserWarning)
                flat = torch.frombuffer(raw, dtype=torch.uint8)
        else:
            flat = torch.empty(0, dtype=torch.uint8)
        self.tensor = flat.view(dtype.torch).reshape(shape)


def _reconstruct(cls: str, shape: tuple, typecode: bytes) -> _Array:
    if cls != "ndarray":
        raise pickle.UnpicklingError(f"a checkpoint leaf of class {cls}")
    return _Array()


class _Unpickler(pickle.Unpickler):
    """Reads what ``_Writer`` and numpy (with or without ``ml_dtypes``)
    write, and refuses every other global."""

    GLOBALS = {("numpy._core.multiarray", "_reconstruct"): _reconstruct,
               ("numpy.core.multiarray", "_reconstruct"): _reconstruct,
               ("numpy", "ndarray"): "ndarray",
               ("numpy", "dtype"): _Dtype,
               ("ml_dtypes", "bfloat16"): "bfloat16"}

    def find_class(self, module: str, name: str) -> Any:
        try:
            return self.GLOBALS[module, name]
        except KeyError:
            raise pickle.UnpicklingError(
                f"a checkpoint may not name {module}.{name}") from None


def _tensors(obj: Any) -> Any:
    """The unpickled tree with each array as its tensor."""
    if isinstance(obj, _Array):
        return obj.tensor
    if isinstance(obj, dict):
        return {k: _tensors(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_tensors(x) for x in obj)
    return obj


def save_checkpoint(path: str, step: int, model: Transformer,
                    opt_state: Optional[State] = None,
                    meta: Optional[Dict] = None) -> int:
    """Writes the checkpoint and returns the fingerprint of the parameters
    (one fingerprint launch per leaf on the card).  A sharded model (and
    its state) is gathered into whole tensors, which rank 0 writes while
    the others wait: every rank of the mesh calls this."""
    params = list(model.param_leaves())
    fp = fingerprint_tree(params)
    sharded = isinstance(params[0], DTensor)
    params = [whole(p) for p in params]
    opt = None
    if opt_state is not None:
        opt = {key: bridge.jax_tree(model, [whole(t) for t in opt_state[key]])
               for key in ("mu", "nu", "master")}
        opt["count"] = opt_state["count"]
    if sharded and dist.get_rank() != 0:
        dist.barrier()
        return fp
    os.makedirs(path, exist_ok=True)
    state = {"step": step, "params": bridge.jax_tree(model, params),
             "opt_state": opt}
    tmp = os.path.join(path, f"ckpt_{step}.tmp")
    final = os.path.join(path, f"ckpt_{step}.pkl")
    with open(tmp, "wb") as f:
        _Writer(f).dump(state)
    os.replace(tmp, final)     # atomic publish
    manifest = {"step": step, "fingerprint": fp, "meta": meta or {}}
    with open(os.path.join(path, f"ckpt_{step}.json"), "w") as f:
        json.dump(manifest, f)
    if sharded:
        dist.barrier()
    return fp


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [int(f[5:-5]) for f in os.listdir(path)
             if f.startswith("ckpt_") and f.endswith(".json")]
    return max(steps) if steps else None


def load_checkpoint(path: str, cfg: ModelConfig, step: Optional[int] = None,
                    expect_fp: Optional[int] = None, device=None
                    ) -> Tuple[int, Transformer, Optional[State]]:
    """Returns (step, model, AdamW state or None) on ``device``, after the
    parameters' fingerprint, computed there (one launch per leaf on the
    card), matched the manifest's and ``expect_fp``."""
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    with open(os.path.join(path, f"ckpt_{step}.pkl"), "rb") as f:
        state = _tensors(_Unpickler(f).load())
    with open(os.path.join(path, f"ckpt_{step}.json")) as f:
        manifest = json.load(f)
    model = bridge.params_from_jax(state["params"], cfg, device)
    fp = fingerprint_tree(model.param_leaves())
    if fp != manifest["fingerprint"]:
        raise ValueError(f"checkpoint {step}: fingerprint mismatch "
                         f"(corrupted): {fp} != {manifest['fingerprint']}")
    if expect_fp is not None and fp != expect_fp:
        raise ValueError(f"checkpoint {step}: fingerprint {fp} does not match "
                         f"the consensus-agreed value {expect_fp}")
    opt = state["opt_state"]
    if opt is not None:
        opt = bridge.opt_state_from_jax(opt, model, device)
    return state["step"], model, opt


def reshard(tree: Any, mesh, specs: Any) -> Any:
    """Place a host tree (a model as ``load_checkpoint`` returns it, a list
    of leaves, or caches) onto ``mesh`` by ``specs``, e.g.
    ``parallel.param_pspecs(cfg, model, mesh)``."""
    return distribute_tree(mesh, tree, specs)
