"""Sharded service plane: a fleet of uBFT groups over one substrate.

:class:`~repro.service.router.ShardRouter` hash-partitions the keyspace,
:class:`~repro.service.sharded.ShardedService` attaches K independent 2f+1
groups to a shared :class:`~repro.core.substrate.Substrate` and runs
cross-shard multi-key operations as two-phase commit where *each phase is
itself a BFT-committed slot* (DESIGN_SHARDING.md).
"""

from repro_torch.service.router import ShardRouter
from repro_torch.service.sharded import ServiceClient, ShardedService

__all__ = ["ShardRouter", "ServiceClient", "ShardedService"]
