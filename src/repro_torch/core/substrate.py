"""The shared disaggregated-memory substrate (§8: "a small amount of
reliable disaggregated memory ... shared by many replicated applications").

A :class:`Substrate` owns everything that is *infrastructure* rather than
application: one :class:`~repro.sim.events.Simulator` (the event loop), one
:class:`~repro.sim.net.NetworkModel` (the calibrated fabric), one
:class:`~repro.core.crypto.KeyRegistry` (key material for every process),
and the :class:`~repro.core.registers.MemoryPool`\\ s that form the TCB.

Many independent 2f+1 replica groups then *attach* to the same substrate
(:meth:`repro.core.smr.Cluster.attach`): they co-run on the one event loop
and share the same pools.  Isolation between applications is provided by

* **pid namespacing** — an app named ``A`` gets replicas ``A/r0..A/r2`` and
  clients ``A/c0..``; register cells are keyed by owner pid, so two apps
  never collide in disaggregated memory;
* **app-namespaced register-key sharding** — a replica's
  :class:`~repro.core.registers.RegisterClient` routes register keys
  ``crc32(app:owner:reg) % n_pools``, so each app's registers spread over
  the shared pools independently (the legacy single-app layout hashes
  ``crc32(owner:reg)`` and is preserved bit-for-bit for the unnamed app);
* **per-app byte budgets** — Table 2 accounting is split per app
  (:meth:`memory_by_app`); an app that exceeds its budget in any pool is
  surfaced as a *per-app fault* in :attr:`budget_faults`
  (:meth:`audit_budgets`), never as a global assert that would take down
  its neighbours.

The substrate is deliberately application-oblivious, exactly like the
paper's memory nodes: it knows app *names* and the pids registered under
them only for accounting and fault attribution.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core import crypto
from repro_torch.core.registers import (POOL_MEMORY_BUDGET, MemoryNode, MemoryPool)
from repro_torch.sim.events import Simulator
from repro_torch.sim.net import NetParams, NetworkModel


@dataclass
class AppRecord:
    """One replicated application attached to the substrate."""
    name: str
    cluster: Any                 # repro.core.smr.Cluster (no import cycle)
    owner_pids: Tuple[str, ...]  # pids whose register cells belong to this app
    budget: int = POOL_MEMORY_BUDGET


class Substrate:
    """Simulator + network + key registry + shared memory pools.

    ``n_pools`` pools of ``2·f_m+1`` nodes each are created up front; pool 0
    keeps the historical ``m0/m1/...`` pids and extra shards are
    ``p<i>m<j>`` — identical to the layout ``build_cluster`` always
    produced, so single-app deployments through the shim stay bit-for-bit
    on the recorded golden traces.
    """

    def __init__(self, f_m: int = 1, n_pools: int = 1,
                 params: Optional[NetParams] = None, seed: int = 0,
                 auto_reconfigure: bool = False, lease_us: float = 200.0):
        self.sim = Simulator(seed=seed)
        self.net = NetworkModel(self.sim, params)
        self.registry = crypto.KeyRegistry()
        self.f_m = f_m
        self.pools: List[MemoryPool] = [
            MemoryPool(self.sim, self.net, self.registry, f_m=f_m,
                       name=f"pool{i}",
                       prefix=("m" if i == 0 else f"p{i}m"),
                       auto_reconfigure=auto_reconfigure, lease_us=lease_us)
            for i in range(n_pools)
        ]
        self.apps: Dict[str, AppRecord] = {}
        #: sharded services (``repro.service.ShardedService``) by name —
        #: each is a *set* of attached apps (``<name>/s<i>``) plus routing
        self.services: Dict[str, Any] = {}
        self._owner_app: Dict[str, str] = {}
        #: (sim time, app, pool name, occupied bytes, budget) per overrun —
        #: the per-app fault surface for Table 2 budget violations
        self.budget_faults: List[Tuple[float, str, str, int, int]] = []

    # ------------------------------------------------------------- attach
    def register_app(self, name: str, cluster: Any,
                     owner_pids: Tuple[str, ...],
                     budget: int = POOL_MEMORY_BUDGET) -> AppRecord:
        """Record an attached application (called by ``Cluster.attach``)."""
        if name in self.apps:
            raise ValueError(f"app {name!r} already attached to substrate")
        rec = AppRecord(name=name, cluster=cluster,
                        owner_pids=tuple(owner_pids), budget=budget)
        self.apps[name] = rec
        for pid in owner_pids:
            self._owner_app[pid] = name
        return rec

    def add_owner(self, name: str, pid: str) -> None:
        """Register a pid created after attach (replica replacement) under
        its app, so per-app accounting keeps attributing its cells."""
        rec = self.apps.get(name)
        if rec is None:
            raise KeyError(f"no app {name!r} on this substrate")
        if pid not in rec.owner_pids:
            rec.owner_pids = rec.owner_pids + (pid,)
        self._owner_app[pid] = name

    def select_pools(self, pools: Optional[Any]) -> List[MemoryPool]:
        """Resolve a pool-placement policy: ``None`` → every pool (the
        same list object, so legacy identity checks hold); otherwise a
        subset given as indices, names, or MemoryPool objects."""
        if pools is None:
            return self.pools
        by_name = {p.name: p for p in self.pools}
        out: List[MemoryPool] = []
        for ref in pools:
            if isinstance(ref, MemoryPool):
                if ref not in self.pools:
                    raise ValueError(f"pool {ref.name!r} is not on this "
                                     f"substrate")
                out.append(ref)
            elif isinstance(ref, int):
                if not 0 <= ref < len(self.pools):
                    raise ValueError(f"cannot resolve pool {ref!r} "
                                     f"(substrate has {len(self.pools)})")
                out.append(self.pools[ref])
            elif ref in by_name:
                out.append(by_name[ref])
            else:
                raise ValueError(f"cannot resolve pool {ref!r}")
        if not out:
            raise ValueError("pool placement must select at least one pool")
        if len(set(id(p) for p in out)) != len(out):
            raise ValueError("pool placement lists a pool twice — the "
                             "crc32 shard denominator would double-count")
        return out

    @property
    def clusters(self) -> Dict[str, Any]:
        return {name: rec.cluster for name, rec in self.apps.items()}

    @property
    def mem_nodes(self) -> List[MemoryNode]:
        """Current TCB membership across all pools (flat view)."""
        return [n for p in self.pools for n in p.member_nodes()]

    # --------------------------------------------- Table 2, split per app
    def memory_by_app(self) -> Dict[str, Dict[str, int]]:
        """Occupied disaggregated memory per app per pool:
        ``{app: {pool_name: bytes}}``.  Cells are attributed by their owner
        pid; owners not registered under any app (e.g. a bare
        ``RegisterClient`` used directly in a test) are attributed to their
        own pid so nothing is silently dropped."""
        out: Dict[str, Dict[str, int]] = {name: {} for name in self.apps}
        for pool in self.pools:
            per_owner = pool.memory_bytes_by_owner()
            for owner, nbytes in per_owner.items():
                app = self._owner_app.get(owner, owner)
                by_pool = out.setdefault(app, {})
                by_pool[pool.name] = by_pool.get(pool.name, 0) + nbytes
        return out

    def app_pool_bytes(self, name: str) -> Dict[str, int]:
        """Per-pool occupancy of one app (empty dict if it wrote nothing)."""
        return self.memory_by_app().get(name, {})

    def audit_budgets(self, usage: Optional[Dict[str, Dict[str, int]]] = None
                      ) -> List[Tuple[float, str, str, int, int]]:
        """Check every attached app against its per-pool byte budget.

        Overruns are appended to :attr:`budget_faults` and returned — a
        *per-app* fault record, not a global assert: one misbehaving (or
        merely oversubscribed) application must not take down the shared
        substrate or its neighbours.  ``usage`` lets a caller that already
        computed :meth:`memory_by_app` pass it in instead of re-walking
        every pool's cell map.
        """
        overruns: List[Tuple[float, str, str, int, int]] = []
        if usage is None:
            usage = self.memory_by_app()
        for name, rec in self.apps.items():
            for pool_name, nbytes in usage.get(name, {}).items():
                if nbytes >= rec.budget:
                    overruns.append((self.sim.now, name, pool_name,
                                     nbytes, rec.budget))
        self.budget_faults.extend(overruns)
        return overruns
