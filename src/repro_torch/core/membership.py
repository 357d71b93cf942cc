"""First-class membership epochs for the replica group.

The paper's protocol text treats the replica set as a static parameter
(n = 2f+1 processes fixed at deployment).  That assumption silently
degrades the deployment story: one crashed replica permanently burns a
slot of the fault budget, and the Fig 11 reconfiguration narrative (and
the bounded-memory argument of Table 2) only stays meaningful if the
*group itself* can be repaired.  A :class:`MembershipEpoch` makes the
group explicit:

* ``epoch`` — a monotonically increasing configuration number.  Epoch 0
  is the deployment-time group; every replica replacement bumps it by
  one.  Protocol messages that are only meaningful relative to a
  configuration (SEAL_VIEW / NEW_VIEW) carry the epoch when it is
  non-zero, and stale-epoch messages are rejected exactly like stale
  views.  (Epoch-0 messages keep the historical wire shape so static
  deployments stay bit-identical on the recorded golden traces.)
* ``replicas`` — the ordered member tuple.  Order is load-bearing:
  leader selection is ``replicas[view % n]``, and a replacement takes
  the slot of the replica it replaces (:meth:`replace`) so the
  view→leader mapping is disturbed as little as possible.

Epoch switches are *agreed*, not broadcast: the control plane
(:meth:`repro.core.smr.Cluster.replace_replica`) routes the epoch bump
through a consensus slot (a MEMBERSHIP request), so every honest replica
applies the same switch at the same point of its execution order — see
``DESIGN_MEMBERSHIP.md`` for the safety argument.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MembershipEpoch:
    """One epoch of the replica group: (epoch number, ordered members)."""

    epoch: int
    replicas: Tuple[str, ...]

    def __post_init__(self):
        if len(set(self.replicas)) != len(self.replicas):
            raise ValueError(f"duplicate replica pid in {self.replicas!r}")

    # ------------------------------------------------------------- derived
    @property
    def n(self) -> int:
        return len(self.replicas)

    @property
    def f(self) -> int:
        """Byzantine budget implied by n = 2f+1."""
        return (len(self.replicas) - 1) // 2

    @property
    def quorum(self) -> int:
        return self.f + 1

    def leader(self, view: int) -> str:
        return self.replicas[view % len(self.replicas)]

    def __contains__(self, pid: str) -> bool:
        return pid in self.replicas

    # ------------------------------------------------------------- evolve
    def replace(self, old: str, new: str) -> "MembershipEpoch":
        """The next epoch with ``new`` in ``old``'s slot (index preserved,
        so the view→leader mapping only changes where it must)."""
        if old not in self.replicas:
            raise ValueError(f"{old!r} is not a member of epoch {self.epoch}")
        if new in self.replicas:
            raise ValueError(f"{new!r} is already a member of epoch "
                             f"{self.epoch}")
        members = tuple(new if r == old else r for r in self.replicas)
        return MembershipEpoch(self.epoch + 1, members)
