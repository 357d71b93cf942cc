"""Deterministic fault-schedule driver: seeded (time, action, target) events.

A :class:`FaultSchedule` is a sorted list of :class:`FaultEvent`\\ s; the
:class:`FaultInjector` installs them on a simulator and applies them at
virtual time, resolving targets against the live process table, the network
model, and the memory pools:

=================  =======================================  =====================
action             target                                   effect
=================  =======================================  =====================
``crash``          process pid                              ``Process.crash()``
``recover``        process pid                              ``Process.recover()``
``partition``      ``(src, dst)`` pid pair                  drop both directions
``heal``           ``(src, dst)`` pair or ``None`` (= all)  restore link(s)
``reconfigure``    pool name / index / ``(pool, dead_pid)``  ``MemoryPool.reconfigure``
``replace_replica`` replica pid (app resolved by prefix)    ``Cluster.replace_replica``
``stale_serve``    memory-node pid or ``(pid, False)``      ``MemoryNode.set_stale_serve``
``slow_replica``   pid / ``(pid, params)`` / ``(pid, False)``  ``NetworkModel.degrade_src``
=================  =======================================  =====================

``slow_replica`` is the *gray* failure mode: the target stays up (keeps
receiving, keeps its state) but every message it sends pays an extra delay
and/or a seeded fraction is silently lost — exactly the partial failure a
clean crash schedule cannot express, and the one the self-healing
suspicion layer (``core/health.py``) exists to catch.

Everything is driven by one seeded RNG, so a schedule is exactly
reproducible from ``(seed, horizon, targets)`` — the property the
fault-matrix tests and the ``benchmarks/fault_scenarios.py`` sweep rely on.
:meth:`FaultSchedule.seeded` generates *sensible* adversaries: it never
crashes more than the supplied fault budgets, recovers or reconfigures what
it crashed, and always heals what it partitions.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Iterable, List, Optional, Sequence, Tuple

import numpy as np

ACTIONS = ("crash", "recover", "partition", "heal", "reconfigure",
           "replace_replica", "stale_serve", "reshard", "slow_replica")


@dataclass(frozen=True)
class FaultEvent:
    time: float
    action: str
    target: Any = None

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")


def _ev_key(ev: FaultEvent) -> Tuple[float, str]:
    return (ev.time, ev.action)


class FaultSchedule:
    """An ordered, deterministic list of fault events."""

    def __init__(self, events: Iterable[FaultEvent] = (),
                 seed: Optional[int] = None):
        self.events: List[FaultEvent] = sorted(events, key=_ev_key)
        self.seed = seed

    def __iter__(self):
        return iter(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def add(self, time: float, action: str, target: Any = None
            ) -> "FaultSchedule":
        self.events.append(FaultEvent(time, action, target))
        self.events.sort(key=_ev_key)
        return self

    @classmethod
    def seeded(cls, seed: int, *, horizon_us: float,
               memory: Sequence[str] = (), pools: Sequence[Any] = (),
               replicas: Sequence[str] = (),
               partitions: Sequence[Tuple[str, str]] = (),
               n_memory_crashes: int = 1, n_replica_crashes: int = 0,
               n_partitions: int = 0, reconfigure: bool = False,
               recover: bool = True, replace_replicas: bool = False,
               stale_serve: Sequence[str] = (),
               n_slow_replicas: int = 0,
               slow_params: Optional[dict] = None,
               slow_recover: bool = False) -> "FaultSchedule":
        """Generate a deterministic schedule inside ``(0.1, 0.8)·horizon``.

        ``memory`` lists crash-eligible memory-node pids (pass at most f_m
        per pool to stay within the fault budget); ``replicas`` likewise
        (at most f).  ``reconfigure`` replaces each crashed memory node via
        its pool (resolved by pid prefix) instead of recovering it.
        ``replace_replicas`` follows each replica crash with a
        ``replace_replica`` event (membership-epoch repair under load).
        ``partitions`` lists candidate pid pairs for ``n_partitions``
        partition+heal episodes.  ``stale_serve`` lists memory-node pids
        that turn into stale-serving Byzantine memory (enabled at a seeded
        time, never disabled — keep it within f_m per pool).

        ``n_slow_replicas`` gray-degrades that many replicas (drawn from
        ``replicas``) at seeded times: delay and drop fraction are drawn
        per target unless pinned via ``slow_params`` (the degradation's
        own drop RNG is always seeded from this schedule's stream, so the
        whole gray episode is a pure function of the seed).
        ``slow_recover`` follows each degradation with a clearing event —
        leave it False when a self-healing control plane is expected to
        replace the sick replica instead.
        """
        rng = np.random.default_rng(seed)
        ev: List[FaultEvent] = []

        def t(lo: float = 0.1, hi: float = 0.8) -> float:
            return float(rng.uniform(lo * horizon_us, hi * horizon_us))

        mem = list(memory)
        for pid in list(rng.permutation(mem))[:n_memory_crashes]:
            t0 = t()
            ev.append(FaultEvent(t0, "crash", str(pid)))
            if reconfigure:
                pool = _pool_of(str(pid), pools)
                ev.append(FaultEvent(t0 + t(0.05, 0.15), "reconfigure",
                                     (pool, str(pid))))
            elif recover:
                ev.append(FaultEvent(t0 + t(0.05, 0.15), "recover", str(pid)))
        for pid in list(rng.permutation(list(replicas)))[:n_replica_crashes]:
            t0 = t()
            ev.append(FaultEvent(t0, "crash", str(pid)))
            if replace_replicas:
                ev.append(FaultEvent(t0 + t(0.05, 0.15), "replace_replica",
                                     str(pid)))
        pairs = list(partitions)
        for i in list(rng.permutation(len(pairs)))[:n_partitions]:
            a, b = pairs[int(i)]
            t0 = t()
            ev.append(FaultEvent(t0, "partition", (a, b)))
            ev.append(FaultEvent(t0 + t(0.05, 0.15), "heal", (a, b)))
        for pid in stale_serve:
            ev.append(FaultEvent(t(), "stale_serve", str(pid)))
        if n_slow_replicas:
            for pid in list(rng.permutation(list(replicas)))[:n_slow_replicas]:
                t0 = t()
                params = dict(slow_params) if slow_params else {
                    "delay_us": float(rng.uniform(300.0, 2000.0)),
                    "drop": float(rng.uniform(0.1, 0.6)),
                }
                params.setdefault("seed", int(rng.integers(2 ** 31)))
                ev.append(FaultEvent(t0, "slow_replica", (str(pid), params)))
                if slow_recover:
                    ev.append(FaultEvent(t0 + t(0.05, 0.15), "slow_replica",
                                         (str(pid), False)))
        return cls(ev, seed=seed)


def _pool_of(pid: str, pools: Sequence[Any]):
    """Pool name owning ``pid``, or None — the injector then resolves the
    pool by the dead pid at apply time (no silent pool-0 fallback)."""
    for p in pools:
        if pid in getattr(p, "members", ()) or pid in getattr(p, "nodes", ()):
            return getattr(p, "name", p)
    return None


class FaultInjector:
    """Applies a :class:`FaultSchedule` to a simulator.

    ``pools`` enables ``reconfigure`` targets and lets ``crash``/``recover``
    hit replacement nodes that only exist inside a pool.  Every applied
    event is recorded in ``log`` as ``(time, action, target)``; events that
    turn out to be no-ops (e.g. a ``reconfigure`` racing a lease-driven one)
    land in ``skipped`` instead, so tests asserting on ``log`` never count
    a fault that did not actually happen.
    """

    def __init__(self, sim, net, pools: Sequence[Any] = (),
                 clusters: Optional[dict] = None,
                 services: Optional[dict] = None):
        self.sim = sim
        self.net = net
        self.pools = list(pools)
        #: app name -> Cluster, for ``replace_replica`` targets (the pid's
        #: ``app/`` prefix selects the cluster; "" is the unnamed app)
        self.clusters = dict(clusters or {})
        #: service name -> ShardedService, for ``reshard`` targets
        self.services = dict(services or {})
        self.log: List[Tuple[float, str, Any]] = []
        self.skipped: List[Tuple[float, str, Any]] = []

    @classmethod
    def for_cluster(cls, cluster, schedule: Optional[FaultSchedule] = None
                    ) -> "FaultInjector":
        inj = cls(cluster.sim, cluster.net, getattr(cluster, "pools", ()),
                  clusters={getattr(cluster, "name", ""): cluster})
        if schedule is not None:
            inj.install(schedule)
        return inj

    def install(self, schedule: FaultSchedule) -> "FaultInjector":
        for ev in schedule:
            self.sim.at(ev.time, lambda ev=ev: self.apply(ev),
                        note=f"fault.{ev.action}")
        return self

    # ------------------------------------------------------------ applying
    def apply(self, ev: FaultEvent) -> None:
        applied = getattr(self, f"_do_{ev.action}")(ev.target)
        rec = (self.sim.now, ev.action, ev.target)
        (self.skipped if applied is False else self.log).append(rec)

    def _process(self, pid: str):
        proc = self.sim.processes.get(pid)
        if proc is None:
            raise KeyError(f"fault target {pid!r} is not a live process")
        return proc

    def _do_crash(self, pid: str) -> None:
        self._process(pid).crash()

    def _do_recover(self, pid: str) -> None:
        self._process(pid).recover()

    def _do_partition(self, target: Tuple[str, str]) -> None:
        a, b = target
        self.net.partition(a, b, forced=True)
        self.net.partition(b, a, forced=True)

    def _do_heal(self, target: Optional[Tuple[str, str]]) -> None:
        if target is None:
            self.net.heal()
            return
        a, b = target
        self.net.heal_link(a, b)
        self.net.heal_link(b, a)

    def _resolve_pool(self, ref: Any, dead: Optional[str]):
        if isinstance(ref, int):
            return self.pools[ref]
        for p in self.pools:
            if getattr(p, "name", None) == ref or p is ref:
                return p
        if ref is None and dead is not None:
            for p in self.pools:
                if dead in getattr(p, "members", ()):
                    return p
        if ref is None and len(self.pools) == 1:
            return self.pools[0]
        raise KeyError(f"cannot resolve pool {ref!r} (dead={dead!r})")

    def _do_reconfigure(self, target: Any) -> bool:
        dead = None
        if isinstance(target, tuple):
            target, dead = target
        pool = self._resolve_pool(target, dead)
        return pool.reconfigure(dead)

    def _do_replace_replica(self, target: Any) -> bool:
        """Replace a replica: target is its pid (``A/r0`` resolves app
        ``A``; bare ``r0`` the unnamed app), or ``(app, pid)``."""
        if isinstance(target, tuple):
            app, pid = target
        else:
            pid = target
            app = pid.rsplit("/", 1)[0] if "/" in pid else ""
        cluster = self.clusters.get(app)
        if cluster is None:
            raise KeyError(f"no cluster {app!r} for replace_replica target "
                           f"{target!r}")
        return cluster.replace_replica(pid) is not None

    def _do_stale_serve(self, target: Any) -> bool:
        """Byzantine memory-side adversary: the node starts serving stale
        (old-but-well-formed) blobs.  ``(pid, False)`` switches it back."""
        on = True
        if isinstance(target, tuple):
            target, on = target
        node = self.sim.processes.get(target)
        if node is None:
            for p in self.pools:
                node = getattr(p, "nodes", {}).get(target)
                if node is not None:
                    break
        if node is None or not hasattr(node, "set_stale_serve"):
            raise KeyError(f"stale_serve target {target!r} is not a "
                           f"memory node")
        if bool(node.stale_serve) == bool(on):
            return False
        node.set_stale_serve(on)
        return True

    def _do_slow_replica(self, target: Any) -> bool:
        """Gray failure: degrade every send *from* a replica that stays up.
        ``pid`` or ``(pid, {"delay_us":…, "drop":…, "seed":…})`` enables
        (dict keys optional); ``(pid, False)`` clears.  Re-degrading an
        already-degraded pid (or clearing a healthy one) is skipped."""
        params: Optional[dict] = None
        on = True
        if isinstance(target, tuple):
            pid, arg = target
            if arg is False:
                on = False
            elif isinstance(arg, dict):
                params = arg
            elif arg is not None and arg is not True:
                raise ValueError(f"bad slow_replica arg {arg!r} — expected "
                                 f"a params dict or False")
        else:
            pid = target
        if not on:
            if pid not in self.net.degraded:
                return False
            self.net.clear_degrade(pid)
            return True
        if pid in self.net.degraded:
            return False
        p = {"delay_us": 500.0, "drop": 0.3, "seed": 1}
        p.update(params or {})
        self.net.degrade_src(pid, **p)
        return True

    def _do_reshard(self, target: Any) -> bool:
        """Live shard split/merge on a sharded service (the shard count
        becomes a mid-run variable, like any other fault-schedule event):
        ``(service, "split", idx)`` or ``(service, "merge", src, dst)``.
        The operation is *initiated* here and completes asynchronously —
        watch ``service.reshards``.  Skipped (returns False) when another
        reshard is still in flight."""
        name, kind = target[0], target[1]
        svc = self.services.get(name)
        if svc is None:
            raise KeyError(f"no sharded service {name!r} for reshard "
                           f"target {target!r}")
        if svc.resharding:
            return False
        if kind == "split":
            svc.split_shard(target[2])
        elif kind == "merge":
            svc.merge_shards(target[2], target[3])
        else:
            raise ValueError(f"unknown reshard kind {kind!r}")
        return True
