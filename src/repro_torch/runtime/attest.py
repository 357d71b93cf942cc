"""State attestation: digests of parameter trees, ported from
``repro.runtime.attest``.

Each array's digest is an order-independent sum of mixed words (the
fingerprint kernel on the card, its plain version on the CPU); a tree's
digest mixes its leaf digests positionally, in ``jax.tree.leaves`` order of
the JAX pytree, so a model converted from JAX has the same digest on both.

A sharded leaf (a DTensor) is digested shard by shard: a sum mod 2**32
over words is the sum of its shards' sums, so each rank digests its local
shard with the kernel, the one rank of each group of replicas of a shard
contributes it (``sharding.owns_shard``), and the contributions are summed
over the mesh as int64, since NCCL and gloo have no uint32 sum, and cut to
32 bits.  The result is the whole tensor's digest, bit for bit.
"""

from __future__ import annotations

from typing import Iterable, List

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.kernels import ops
from repro_torch.parallel import comm, sharding

_M32 = 0xFFFFFFFF


def _local_digest(x: DTensor) -> int:
    """This rank's contribution to the digest of ``x``: its local shard's
    digest where it owns the shard, else 0."""
    if any(pl.is_partial() for pl in x.placements):
        x = x.redistribute(x.device_mesh, [Replicate() if pl.is_partial()
                                           else pl for pl in x.placements])
    if not sharding.owns_shard(x.device_mesh, x.placements):
        return 0
    return ops.fingerprint(x.to_local().contiguous())


def _sum_over_mesh(mesh, values: List[int], like: torch.Tensor) -> List[int]:
    """``values`` summed over ``mesh`` in an int64 tensor on the device of
    ``like``'s local shard (fake where it is fake: a traced step traces the
    all-reduce and reads 0, ``ops.host_ints``)."""
    t = torch.tensor(values, dtype=torch.int64,
                     device=like.to_local().device)
    comm.all_reduce(t, sharding.mesh_groups(mesh), "digest")
    return [v & _M32 for v in ops.host_ints(t)]


def fingerprint_array(x: torch.Tensor) -> int:
    """Order-independent uint32 digest of one array (sum-mix over words);
    of a DTensor, the digest of the whole tensor (a collective: every rank
    of its mesh calls it)."""
    if isinstance(x, DTensor):
        return _sum_over_mesh(x.device_mesh, [_local_digest(x)], x)[0]
    return ops.fingerprint(x.contiguous())


def fingerprint_tree(leaves: Iterable[torch.Tensor]) -> int:
    """uint32 digest of a sequence of leaves, e.g. ``model.param_leaves()``
    or their gradients in that order: acc = acc·31 + h + i mod 2**32.  The
    DTensor leaves' shard digests are summed over their mesh in one
    all-reduce."""
    leaves = list(leaves)
    digests = [None if isinstance(x, DTensor) else fingerprint_array(x)
               for x in leaves]
    sharded = [i for i, d in enumerate(digests) if d is None]
    if sharded:
        first = leaves[sharded[0]]
        sums = _sum_over_mesh(first.device_mesh,
                              [_local_digest(leaves[i]) for i in sharded],
                              first)
        for i, d in zip(sharded, sums):
            digests[i] = d
    acc = 0
    for i, h in enumerate(digests):
        acc = (acc * 31 + h + i) & _M32
    return acc
