"""Crossing between the JAX package's parameters and the port's model.

The port keeps JAX's layout (weights ``(in, out)``, the pytree's names,
per-group stacking) and each leaf's dtype (the RG-LRU's ``lam`` stays fp32
in a bf16 model), so conversion is a plain copy.  numpy has no bf16 of
its own: a bf16 array (ml_dtypes' ``bfloat16``) crosses as an int16 view and
is viewed back as ``torch.bfloat16``, which keeps every bit; on the way
back (``numpy_from_tensor``) a bf16 tensor leaves as that int16 view.
The optimizer state crosses leaf by leaf in ``jax.tree.leaves`` order
(``tree_leaves``), which is ``Transformer.param_leaves()`` order.  The way
in takes numpy arrays or tensors as leaves (``as_tensor``); the way back
(``params_to_jax``, ``opt_state_to_jax``) rebuilds JAX's nesting around
``param_leaves()`` order (``jax_tree``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

from repro_torch.models.common import ModelConfig, Transformer
from repro_torch.optim.adamw import State


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    a = np.array(a, order="C")   # a writable copy: torch shares its memory
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def as_tensor(a: Any, device=None) -> torch.Tensor:
    """A leaf given as a numpy array or a tensor, as a new tensor on
    ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    return tensor_from_numpy(a, device)


def numpy_from_tensor(t: torch.Tensor) -> np.ndarray:
    """A tensor (a parameter, a gradient, a state leaf) as numpy, bf16 as
    its int16 view (the same bits), for comparisons with the JAX
    package's arrays."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a nest of dicts, tuples and lists in
    ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [tree]


def params_from_jax(np_tree: Mapping[str, Any], cfg: ModelConfig,
                    device=None) -> Transformer:
    """Build the port's model from the JAX parameter tree given as numpy
    arrays (e.g. ``jax.tree.map(np.asarray, init_params(cfg, key))``) or
    tensors."""
    model = Transformer(cfg, device=device)

    def put(dst: torch.Tensor, src: np.ndarray, name: str) -> None:
        t = as_tensor(src, device)
        if t.shape != dst.shape or t.dtype != dst.dtype:
            raise ValueError(f"{name}: JAX has {t.dtype}{tuple(t.shape)}, the "
                             f"port expects {dst.dtype}{tuple(dst.shape)}")
        dst.copy_(t)

    with torch.no_grad():
        want = {"embed", "groups", "out_norm"}
        if model.lm_head is not None:
            want.add("lm_head")
        if set(np_tree) != want:
            raise ValueError(f"expected the keys {sorted(want)} of a "
                             f"{'tied' if cfg.tie_embeddings else 'untied'}"
                             f"-head tree, got {sorted(np_tree)}")
        put(model.embed, np_tree["embed"], "embed")
        put(model.out_norm, np_tree["out_norm"], "out_norm")
        if model.lm_head is not None:
            put(model.lm_head, np_tree["lm_head"], "lm_head")
        for g, group in enumerate(model.groups):
            for i, pos in enumerate(group):
                src = np_tree["groups"][g][i]
                if set(src) != set(pos.keys()):
                    raise ValueError(f"groups[{g}][{i}]: JAX has {sorted(src)}"
                                     f", the port {sorted(pos.keys())}")
                for k, dst in pos.items():
                    put(dst, src[k], f"groups[{g}][{i}][{k}]")
    return model


def opt_state_from_jax(np_state: Mapping[str, Any], model: Transformer,
                       device=None) -> State:
    """The JAX package's AdamW state (``mu``, ``nu``, ``master`` trees and
    ``count``, given as numpy arrays or tensors) as the port's
    ``optim.adamw`` state for ``model``'s parameters."""
    params = list(model.param_leaves())
    state: Dict[str, Any] = {}
    for key in ("mu", "nu", "master"):
        leaves = tree_leaves(np_state[key])
        if len(leaves) != len(params):
            raise ValueError(f"{key}: JAX has {len(leaves)} leaves, the port "
                             f"{len(params)}")
        state[key] = [as_tensor(a, device) for a in leaves]
        for i, (t, p) in enumerate(zip(state[key], params)):
            if t.shape != p.shape:
                raise ValueError(f"{key}[{i}]: JAX has {tuple(t.shape)}, "
                                 f"the port {tuple(p.shape)}")
    count = np_state["count"]
    if not isinstance(count, torch.Tensor):
        count = np.asarray(count, np.int32)
    state["count"] = as_tensor(count, device)
    return state


def jax_tree(model: Transformer, leaves: Sequence[Any]) -> Dict[str, Any]:
    """``leaves`` (one per parameter, in ``param_leaves()`` order) nested as
    the JAX package's parameter tree: ``embed``, ``groups`` (a tuple per
    group of a tuple per pattern position of dicts), ``lm_head`` where the
    head is untied, and ``out_norm``."""
    leaves = list(leaves)
    n = sum(1 for _ in model.param_leaves())
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} leaves for a model of {n}")
    it = iter(leaves)
    tree: Dict[str, Any] = {"embed": next(it)}
    tree["groups"] = tuple(tuple({k: next(it) for k in sorted(pos.keys())}
                                 for pos in group)
                           for group in model.groups)
    if model.lm_head is not None:
        tree["lm_head"] = next(it)
    tree["out_norm"] = next(it)
    return tree


def params_to_jax(model: Transformer) -> Dict[str, Any]:
    """The model's parameters as the JAX parameter tree of numpy arrays
    (bf16 as int16 views), the inverse of :func:`params_from_jax`."""
    return jax_tree(model, [numpy_from_tensor(p)
                            for p in model.param_leaves()])


def opt_state_to_jax(state: State, model: Transformer) -> Dict[str, Any]:
    """The port's AdamW state as the JAX package's (``mu``, ``nu`` and
    ``master`` trees, ``count`` an int32 scalar array), the inverse of
    :func:`opt_state_from_jax`."""
    out: Dict[str, Any] = {key: jax_tree(model, [numpy_from_tensor(t)
                                                 for t in state[key]])
                           for key in ("mu", "nu", "master")}
    out["count"] = numpy_from_tensor(state["count"])
    return out
