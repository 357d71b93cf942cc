"""The replicated trainer's first steps, in the reference.

From the seed's weights and the mix's batches, ``steps`` steps of the
configuration's training: the mean next-token cross-entropy in fp32 (TF32
off), its gradients by autograd, and AdamW as the mix states it, written
from its description: the gradients clipped to a global norm, first and
second moments kept in the moment dtype (bf16) and an fp32 master copy,
bias corrections, decoupled weight decay on every leaf.  It reports what
the benchmark compares with the program: each step's loss, each leaf's
norm of the first clipped gradient and of the parameters' change after
the last step, and with ``keep_first`` the first clipped gradient
itself; with ``judge(key, gradient) -> float``, what it says of each
leaf's first clipped gradient (the norm of its difference from another
run's).  A leaf is one layer's matrix or vector, or a leaf
outside the layers, keyed (name, layer) with layer -1 outside.

The loss is the configuration's reference module's (``bench/arch.py``).
``quant="fp8"`` is the control (every product's operands in float8);
``half_batch`` a planted fault: the loss over the first half of the rows
only.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from bench import arch, weights
from bench.reference import model as base

Key = Tuple[str, int]


def leaves(model: Dict, seed: int, device) -> Dict[Key, torch.Tensor]:
    """The seed's weights in fp32, every leaf trainable."""
    f32 = torch.float32
    out = {(name, -1): weights.draw(model, seed, name, -1, device, f32)
           for name in weights.global_specs(model)}
    for l in range(model["n_layers"]):
        for name in weights.layer_specs(model, l):
            out[name, l] = weights.draw(model, seed, name, l, device, f32)
    for t in out.values():
        t.requires_grad_(True)
    return out


def _loss(model: Dict, p: Dict[Key, torch.Tensor], batch: Dict,
          quant: Optional[str]) -> torch.Tensor:
    g = {name: p[name, -1] for name in weights.global_specs(model)}
    layers = [{name: p[name, l] for name in weights.layer_specs(model, l)}
              for l in range(model["n_layers"])]
    return arch.module(model).lm_loss(model, g, layers, batch["inputs"],
                                      batch["targets"], quant)


def run(model: Dict, opt: Dict, seed: int, device,
        batch_fn: Callable[[int], Dict[str, torch.Tensor]], steps: int,
        quant: Optional[str] = None, half_batch: bool = False,
        keep_first: bool = False,
        judge: Optional[Callable[[Key, torch.Tensor], float]] = None
        ) -> Dict:
    base.exact_fp32()
    p = leaves(model, seed, device)
    p0 = {k: t.detach().clone() for k, t in p.items()}
    mdt = getattr(torch, opt["moment_dtype"])
    mu = {k: torch.zeros_like(t, dtype=mdt) for k, t in p.items()}
    nu = {k: torch.zeros_like(t, dtype=mdt) for k, t in p.items()}
    losses: List[float] = []
    first_grad: Dict[Key, float] = {}
    first: Dict[Key, torch.Tensor] = {}
    first_err: Dict[Key, float] = {}
    b1, b2 = opt["b1"], opt["b2"]
    for step in range(steps):
        batch = batch_fn(step)
        if half_batch:
            n = batch["inputs"].shape[0] // 2
            batch = {k: v[:n] for k, v in batch.items()}
        for t in p.values():
            t.grad = None
        loss = _loss(model, p, batch, quant)
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            grads = {k: t.grad for k, t in p.items()}
            norm = math.sqrt(sum(float(torch.sum(g * g))
                                 for g in grads.values()))
            clip = min(1.0, opt["grad_clip"] / (norm + 1e-12))
            t_ = step + 1
            c1, c2 = 1.0 - b1 ** t_, 1.0 - b2 ** t_
            for k, t in p.items():
                g = grads[k] * clip
                if step == 0:
                    first_grad[k] = float(torch.linalg.vector_norm(g))
                    if keep_first:
                        first[k] = g.clone()
                    if judge is not None:
                        first_err[k] = judge(k, g)
                m = mu[k].float() * b1 + g * (1.0 - b1)
                v = nu[k].float() * b2 + g * g * (1.0 - b2)
                upd = (m / c1) / (torch.sqrt(v / c2) + opt["eps"])
                t -= opt["lr"] * (upd + opt["weight_decay"] * t)
                mu[k] = m.to(mdt)
                nu[k] = v.to(mdt)
    change = {k: float(torch.linalg.vector_norm(t.detach() - p0[k]))
              for k, t in p.items()}
    return {"losses": losses, "first_grad": first_grad, "change": change,
            "first": first, "first_err": first_err}
