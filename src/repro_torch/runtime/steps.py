"""Step builders, ported from ``repro.runtime.steps``.

  make_train_step(cfg, opt_cfg, ctx)  — fwd + bwd + AdamW + attestation
                                        fingerprints
  make_prefill(cfg, ctx)              — prompt ingestion, returns last
                                        logits + caches
  make_serve_step(cfg, ctx)           — one decode token against
                                        caches/state

``ctx`` is a ``ShardCtx``: with one, the steps take a model placed on its
mesh (``parallel.sharding``) and run sharded.  ``opt_cfg`` stays the
train step's second argument, as the port's callers pass it, where the
reference puts ``ctx``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.common import ModelConfig, Transformer
from repro_torch.models.transformer import (ShardCtx, decode_step, lm_loss,
                                            prefill)
from repro_torch.optim.adamw import AdamWConfig, State, adamw_update
from repro_torch.parallel.sharding import mesh_mode
from repro_torch.runtime import spans
from repro_torch.runtime.attest import fingerprint_tree


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    ctx: Optional[ShardCtx] = None):
    """``train_step(model, opt_state, batch) -> (opt_state, metrics)``: the
    loss and its gradients (left in each parameter's ``.grad``), one AdamW
    step written into the model and the state, and with ``cfg.attest`` the
    digests ``grad_fp`` of the gradients and ``param_fp`` of the new
    parameters, both in ``param_leaves()`` order (a leaf that is not
    trained, ``Leaf.trained``, keeps its value and has no gradient).
    ``batch`` holds ``inputs``, (B, S) integer tokens or, for a frontend
    arch, (B, S, D) float embeddings, and integer ``targets`` (B, S), on
    the model's device.  With ``ctx`` the gradients are laid out as their parameters
    before the update, and the loss is the replicated value.

    With spans on (``runtime.spans``) a step is a ``train.step`` span
    holding ``train.forward`` (the loss), ``train.backward``,
    ``train.adamw`` and ``train.attest`` (both digests)."""
    opt_cfg = opt_cfg or AdamWConfig()

    def train_step(model: Transformer, opt_state: State,
                   batch: Dict[str, torch.Tensor]
                   ) -> Tuple[State, Dict[str, object]]:
        if model.cfg != cfg:
            raise ValueError(f"the step was built for {cfg.name}, the model "
                             f"is {model.cfg.name}")
        step = spans.begin("train.step")
        params = list(model.param_leaves())
        model.requires_grad_(True)
        model.zero_grad(set_to_none=True)
        with torch.enable_grad(), mesh_mode(ctx):
            with spans.span("train.forward"):
                loss = lm_loss(model, batch["inputs"], batch["targets"], ctx)
            with spans.span("train.backward"):
                loss.backward()
        # a leaf that is not trained (a router's selection bias) has None
        grads = [p.grad if p.requires_grad else None for p in params]
        if any(g is None for p, g in zip(params, grads) if p.requires_grad):
            raise RuntimeError(f"{cfg.name}: the loss reaches no gradient of "
                               f"a trained leaf")
        if ctx is not None:
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for p, g in zip(params, grads)]
            loss = loss.full_tensor()
        with spans.span("train.adamw"):
            opt_state = adamw_update(params, grads, opt_state, opt_cfg)
        metrics: Dict[str, object] = {"loss": loss.detach()}
        if cfg.attest:
            # uBFT attestation: replicas CTBcast these (see runtime.trainer)
            with spans.span("train.attest"):
                metrics["grad_fp"] = fingerprint_tree(
                    g for g in grads if g is not None)
                metrics["param_fp"] = fingerprint_tree(params)
        spans.end(step)
        return opt_state, metrics

    return train_step


def make_prefill(cfg: ModelConfig, ctx: Optional[ShardCtx] = None,
                 max_seq: Optional[int] = None):
    """``prefill_step(model, inputs)``: inputs are (B, S) tokens or (B, S,
    D) frontend embeddings."""

    def prefill_step(model: Transformer, inputs: torch.Tensor):
        return prefill(model, inputs, max_seq=max_seq, ctx=ctx)

    return prefill_step


def make_serve_step(cfg: ModelConfig, ctx: Optional[ShardCtx] = None):
    def serve_step(model: Transformer, caches, tokens: torch.Tensor,
                   position: int):
        return decode_step(model, caches, tokens, position, ctx=ctx)

    return serve_step
