"""Deterministic key→shard routing for the sharded service plane.

The routing function started as ``crc32(key) % K``; with live split/merge
(ISSUE 7) it is an **epoch-versioned routing table** whose entries form a
disjoint binary partition of the crc32 space:

    table[(modulus, residue)] = shard index

Initially ``{(K, r): r for r in range(K)}`` — exactly the old hash
partitioner.  A *split* refines one entry by doubling its modulus: the
entry ``(m, r) -> a`` becomes ``(2m, r) -> a`` and ``(2m, r+m) -> b``, so
exactly the keys with ``crc32(key) % 2m == r+m`` move to the new shard
``b`` and every other key keeps its old home.  A *merge* re-points all of
one shard's entries at another and coalesces sibling entries back to the
coarser modulus.  Both bump ``epoch``.

Shard **indices are append-only**: a split mints a fresh index and a merge
retires one, but indices are never renumbered — the coordinator-shard
index recorded inside an in-flight 2PC PREPARE stays valid across any
sequence of resharding operations (DESIGN_SHARDING.md).

The table itself is *not* the source of truth for data placement — the
shards' replicated state machines are (freeze/cut/adopt slots, committed
in each affected shard's log).  A client routing on a stale table is
answered deterministically with ``FROZEN``/``MOVED`` bounces and retries;
the table is advisory fast-path state, updated by the control plane once
the cut slot has committed.  Replica pids are still resolved live from
each shard's :attr:`~repro.core.smr.Cluster.replica_pids` at send time, so
membership epoch switches (PR 5) remain invisible here.
"""

from __future__ import annotations

import zlib
from typing import Dict, List, Tuple


class ShardRouter:
    """Epoch-versioned binary-refinement partitioner over uBFT groups."""

    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError("a service needs at least one shard")
        #: bumped by every committed split/merge; mirrors the router-epoch
        #: value the reshard slots record in the affected shards' logs
        self.epoch = 0
        #: (modulus, residue) -> shard index; disjoint cover of crc32 space
        self.table: Dict[Tuple[int, int], int] = {
            (n_shards, r): r for r in range(n_shards)}
        self._moduli: List[int] = [n_shards]

    # ------------------------------------------------------------- lookup
    @property
    def n_shards(self) -> int:
        """Number of *live* (routable) shard indices."""
        return len(set(self.table.values()))

    def shard_of(self, key: bytes) -> int:
        h = zlib.crc32(key)
        for m in self._moduli:
            idx = self.table.get((m, h % m))
            if idx is not None:
                return idx
        raise AssertionError("routing table does not cover the key space")

    def split(self, pairs: List[Tuple[bytes, bytes]]
              ) -> Dict[int, List[Tuple[bytes, bytes]]]:
        """Partition an MSET's pairs by destination shard (insertion order
        within each shard preserved — last write per key wins, as in the
        unsharded app)."""
        by_shard: Dict[int, List[Tuple[bytes, bytes]]] = {}
        for k, v in pairs:
            by_shard.setdefault(self.shard_of(k), []).append((k, v))
        return by_shard

    def ranges_of(self, idx: int) -> List[Tuple[int, int]]:
        """The (modulus, residue) entries currently routed to ``idx``,
        coarsest-first — deterministic across every observer."""
        return sorted((m, r) for (m, r), i in self.table.items() if i == idx)

    # ---------------------------------------------------------- resharding
    def peek_split(self, idx: int) -> Tuple[int, int]:
        """The range a split of ``idx`` would hand off, without mutating:
        the coarsest entry ``(m, r)`` of ``idx`` is refined and its upper
        child ``(2m, r+m)`` moves.  Pure, so the control plane can freeze
        and transfer exactly this range *before* committing the table."""
        owned = self.ranges_of(idx)
        if not owned:
            raise ValueError(f"shard {idx} owns no key range")
        m, r = owned[0]
        return (2 * m, r + m)

    def commit_split(self, idx: int, new_idx: int) -> Tuple[int, int]:
        """Refine ``idx``'s coarsest entry, routing the upper child to
        ``new_idx``.  Returns the moved range; bumps the epoch."""
        owned = self.ranges_of(idx)
        if not owned:
            raise ValueError(f"shard {idx} owns no key range")
        m, r = owned[0]
        del self.table[(m, r)]
        self.table[(2 * m, r)] = idx
        self.table[(2 * m, r + m)] = new_idx
        self._reindex()
        self.epoch += 1
        return (2 * m, r + m)

    def commit_merge(self, src_idx: int, dst_idx: int
                     ) -> List[Tuple[int, int]]:
        """Route every range of ``src_idx`` to ``dst_idx`` (retiring
        ``src_idx``), coalescing sibling entries back to the coarser
        modulus where possible.  Returns the moved ranges; bumps the
        epoch."""
        moved = self.ranges_of(src_idx)
        if not moved:
            raise ValueError(f"shard {src_idx} owns no key range")
        for rng in moved:
            self.table[rng] = dst_idx
        # coalesce: whenever both children (2m, r) and (2m, r+m) route to
        # the same shard, replace them with their parent (m, r)
        changed = True
        while changed:
            changed = False
            for (m, r), i in sorted(self.table.items()):
                if m % 2 != 0 or r >= m // 2:
                    continue
                sib = (m, r + m // 2)
                if self.table.get(sib) == i and self.table.get((m, r)) == i:
                    del self.table[(m, r)]
                    del self.table[sib]
                    self.table[(m // 2, r)] = i
                    changed = True
                    break
        self._reindex()
        self.epoch += 1
        return moved

    def _reindex(self) -> None:
        self._moduli = sorted({m for (m, _r) in self.table})
