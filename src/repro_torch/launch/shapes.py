"""Assigned input shapes and their fake tensors (no allocation), ported
from ``repro.launch.shapes``.

Four shapes per LM architecture (40 cells):
    train_4k     seq 4096,   global batch 256   -> train_step
    prefill_32k  seq 32768,  global batch 32    -> prefill
    decode_32k   KV 32768,   global batch 128   -> serve_step
    long_500k    KV 524288,  global batch 1     -> serve_step (sub-quadratic
                 archs only; pure full-attention archs are skipped)

The reference's ``ShapeDtypeStruct``s become fake tensors
(``FakeTensorMode``) on the caller's device: they have shapes, dtypes and
devices and hold no memory, so a step run on them is traced, not
computed.  Each function takes the fake mode to make them in (``mode``);
without one it uses the active fake mode, or a new one.  Tensors of two
fake modes do not mix, so a caller makes all of a step's tensors in one.
Modality frontends ([audio]/[vlm]) get (B, S, D) embeddings instead of
token ids.  The decode position is a Python int, as the port's
``decode_step`` takes it: the last slot of the cache.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
from torch._guards import detect_fake_mode
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import LONG_CONTEXT_OK
from repro_torch.models.common import ModelConfig, Transformer
from repro_torch.models.transformer import init_caches


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq: int
    batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def cell_runnable(arch: str, shape: str) -> Tuple[bool, str]:
    if shape == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, "pure full-attention arch: long_500k skipped (DESIGN §6)"
    return True, ""


def fake_mode() -> FakeTensorMode:
    """A fake mode for a step's tensors; plain tensors may meet its fake
    ones (a constant made inside the step)."""
    return FakeTensorMode(allow_non_fake_inputs=True)


@contextlib.contextmanager
def _in(mode: Optional[FakeTensorMode]) -> Iterator[None]:
    active = detect_fake_mode()
    if mode is None and active is not None:
        yield
        return
    with (mode or FakeTensorMode()):
        yield


def input_specs(cfg: ModelConfig, shape: ShapeSpec, device="cuda",
                mode: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    """Fake tensors for the step function's *data* arguments."""
    B, S = shape.batch, shape.seq
    with _in(mode):
        def tokens(*dims):
            return torch.empty(dims, dtype=torch.int32, device=device)

        def inputs():
            if cfg.frontend:
                return torch.empty((B, S, cfg.d_model), dtype=cfg.tdtype(),
                                   device=device)
            return tokens(B, S)

        if shape.kind == "train":
            return {"inputs": inputs(), "targets": tokens(B, S)}
        if shape.kind == "prefill":
            return {"inputs": inputs()}
        if shape.kind == "decode":
            return {"caches": init_caches(cfg, B, S, device),
                    "tokens": tokens(B), "position": S - 1}
    raise ValueError(shape.kind)


def params_spec(cfg: ModelConfig, device="cuda",
                mode: Optional[FakeTensorMode] = None) -> Transformer:
    """The model with fake parameters: exactly ``init_params``' leaves
    (names, shapes, dtypes, order: ``leaf_items``), drawn from nothing."""
    with _in(mode):
        return Transformer(cfg, device=device)


def opt_spec(cfg: ModelConfig, params: Transformer,
             mode: Optional[FakeTensorMode] = None) -> Dict[str, Any]:
    """The AdamW state of ``params`` (fake, or placed DTensors of fake
    shards), as ``optim.adamw.adamw_init`` makes it."""
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    with _in(mode):
        return adamw_init(params.param_leaves(), AdamWConfig())
