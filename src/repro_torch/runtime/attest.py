"""State attestation: digests of parameter trees, ported from
``repro.runtime.attest``.

Each array's digest is an order-independent sum of mixed words (the
fingerprint kernel on the card, its plain version on the CPU); a tree's
digest mixes its leaf digests positionally, in ``jax.tree.leaves`` order of
the JAX pytree, so a model converted from JAX has the same digest on both.
"""

from __future__ import annotations

from typing import Iterable

import torch

from repro_torch.kernels import ops

_M32 = 0xFFFFFFFF


def fingerprint_array(x: torch.Tensor) -> int:
    """Order-independent uint32 digest of one array (sum-mix over words)."""
    return ops.fingerprint(x.contiguous())


def fingerprint_tree(leaves: Iterable[torch.Tensor]) -> int:
    """uint32 digest of a sequence of leaves, e.g. ``model.param_leaves()``
    or their gradients in that order: acc = acc·31 + h + i mod 2**32."""
    acc = 0
    for i, leaf in enumerate(leaves):
        acc = (acc * 31 + fingerprint_array(leaf) + i) & _M32
    return acc
