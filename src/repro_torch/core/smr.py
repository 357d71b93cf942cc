"""SMR cluster wiring: replicas + memory nodes + clients (Figure 1).

A :class:`Cluster` is one replicated application: 2f+1
:class:`UbftReplica`s plus any number of :class:`Client`s.  Clusters no
longer own their infrastructure — they :meth:`Cluster.attach` to a
:class:`~repro.core.substrate.Substrate` (simulator + network + key
registry + shared memory pools), so N independent applications can co-run
on one event loop over the *same* disaggregated memory ("shared by many
replicated applications", §8).  Clients send unsigned requests to *all*
replicas (§5.4) and complete when f+1 matching responses arrive.

``build_cluster`` remains as a thin shim (private substrate + one unnamed
app) so existing call sites migrate incrementally; it reproduces the
historical construction order bit-for-bit (golden traces).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import crypto
from repro_torch.core.consensus import App, ConsensusConfig, UbftReplica
from repro_torch.core.health import (HealthConfig, HealthMonitor, ReconfigPlan,
                               ReplicaHealth, as_health_config)
from repro_torch.core.node import Node
from repro_torch.core.registers import POOL_MEMORY_BUDGET, MemoryNode, MemoryPool
from repro_torch.core.substrate import Substrate
from repro_torch.sim.events import Simulator
from repro_torch.sim.net import NetParams, NetworkModel


class ReplacementError(RuntimeError):
    """A replica replacement was rejected by a guard (unknown/retired
    target, one already in flight, a stale plan, …)."""


class Client(Node):
    """Closed-loop uBFT client."""

    def __init__(self, sim: Simulator, net: NetworkModel, registry, pid: str,
                 replicas: List[str], f: int):
        super().__init__(sim, net, registry, pid)
        self.replicas = replicas
        self.f = f
        self._next_rid = 0
        self._outstanding: Dict[tuple, dict] = {}
        self.latencies: List[float] = []
        self.handle("REP", self._on_reply)

    def request(self, payload: bytes,
                cb: Optional[Callable[[bytes, float], None]] = None) -> tuple:
        rid = (self.pid, self._next_rid)
        self._next_rid += 1
        self._outstanding[rid] = {
            "t0": self.sim.now, "replies": {}, "cb": cb, "done": False,
        }
        body = (rid, payload)
        size = crypto.wire_size_shallow(body) + 19  # len("REQ") + 16
        self.send_fanout(self.replicas, "REQ", body, size=size)
        return rid

    def _on_reply(self, src: str, body: Any) -> None:
        rid, result = body
        st = self._outstanding.get(rid)
        if st is None or st["done"]:
            return
        # replies are fresh bytes per replica: group raw bytes results by
        # value directly (domain-tagged so a crafted bytes result can never
        # collide with the *encoding* of a structured one), encode anything
        # else
        replies = st["replies"]
        if type(result) is bytes:
            enc = (0, result)
        else:
            enc = (1, crypto.encode(result))
        who = replies.get(enc)
        if who is None:
            who = replies[enc] = set()
        who.add(src)
        # only the reply group that just grew can newly reach the quorum
        if len(who) >= self.f + 1:  # f+1 matching responses
            st["done"] = True
            lat = self.sim.now - st["t0"]
            self.latencies.append(lat)
            if st["cb"] is not None:
                st["cb"](result, lat)
            del self._outstanding[rid]


@dataclass
class Cluster:
    """One replicated application over a (possibly shared) substrate."""
    sim: Simulator
    net: NetworkModel
    registry: crypto.KeyRegistry
    replicas: List[UbftReplica]
    pools: List[MemoryPool]
    clients: List[Client] = field(default_factory=list)
    #: application name on the substrate ("" = legacy unnamed single app)
    name: str = ""
    #: the substrate this cluster is attached to (None only for hand-built
    #: Cluster objects in old-style tests)
    substrate: Optional[Substrate] = None
    #: retained for live replica replacement (``replace_replica``)
    app_factory: Optional[Callable[[], App]] = None
    cfg: Optional[ConsensusConfig] = None
    replica_cls: Any = None
    #: replicas retired by an epoch switch (control-plane bookkeeping)
    retired_replicas: List[UbftReplica] = field(default_factory=list)
    #: set when a shard merge retires this whole group: it stays attached
    #: (recorded 2PC outcomes must remain probeable) but owns no key range
    #: and receives no fresh client traffic
    retired: bool = False
    #: (sim time, old_pid, new_pid) per initiated replacement
    replacements: List[Tuple[float, str, str]] = field(default_factory=list)
    #: (sim time, old_pid, reason) per *rejected* replacement request —
    #: the guard surface for idempotency (``replace_replica``)
    rejected_replacements: List[Tuple[float, str, str]] = \
        field(default_factory=list)
    #: self-healing control plane, set by ``enable_self_healing``
    health_monitor: Optional[HealthMonitor] = None
    #: called with ``(old_replica, joiner)`` at the end of every
    #: ``replace_replica`` — the service layer attaches its per-replica
    #: machinery (e.g. 2PC recovery timers) to the joiner here, so an
    #: epoch switch never silently shrinks the recovery fleet
    replace_hooks: List[Callable[[UbftReplica, UbftReplica], None]] = \
        field(default_factory=list)

    @classmethod
    def attach(cls, substrate: Substrate, app_factory: Callable[[], App],
               name: str = "", cfg: Optional[ConsensusConfig] = None,
               replica_cls=UbftReplica,
               budget: int = POOL_MEMORY_BUDGET,
               pools: Optional[Any] = None) -> "Cluster":
        """Attach one replicated application to a shared substrate.

        Builds 2f+1 replicas (f from ``cfg`` alone) named
        ``<name>/r<i>`` (bare ``r<i>`` for the unnamed app) on the
        substrate's event loop, sharing its network, key registry and
        memory pools.  Register keys are sharded ``crc32(name:owner:reg)``
        so this app's slice of the shared pools is independent of its
        neighbours'; ``budget`` is this app's per-pool Table 2 byte budget
        (overruns surface as per-app faults via
        ``substrate.audit_budgets()``, not as a global assert).

        ``pools`` pins this app's register sharding to a *subset* of the
        substrate's pools (a placement policy on top of the namespaced
        crc32 sharding): pass pool indices, names, or MemoryPool objects;
        ``None`` spreads over every pool (the default layout, preserved
        bit-for-bit).
        """
        if name in substrate.apps:
            raise ValueError(f"app {name!r} already attached to substrate")
        cfg = cfg or ConsensusConfig(f_m=substrate.f_m)
        if cfg.f_m != substrate.f_m:
            # the memory fault budget is a property of the shared TCB; an
            # app believing f_m is smaller would run f_m+1 register quorums
            # that need not intersect on the substrate's 2·f_m+1-node pools
            raise ValueError(
                f"cfg.f_m={cfg.f_m} disagrees with the substrate's "
                f"f_m={substrate.f_m} — the memory fault budget comes from "
                f"the shared pools, not per-app config")
        app_pools = substrate.select_pools(pools)
        prefix = f"{name}/" if name else ""
        replica_pids = [f"{prefix}r{i}" for i in range(2 * cfg.f + 1)]
        replicas = [
            replica_cls(substrate.sim, substrate.net, substrate.registry,
                        pid, replica_pids, app_pools, app_factory(),
                        cfg, namespace=name)
            for pid in replica_pids
        ]
        cluster = cls(sim=substrate.sim, net=substrate.net,
                      registry=substrate.registry, replicas=replicas,
                      pools=app_pools, name=name, substrate=substrate,
                      app_factory=app_factory, cfg=cfg,
                      replica_cls=replica_cls)
        substrate.register_app(name, cluster, tuple(replica_pids),
                               budget=budget)
        return cluster

    @property
    def mem_nodes(self) -> List[MemoryNode]:
        """Current TCB membership across all pools (legacy flat view)."""
        return [n for p in self.pools for n in p.member_nodes()]

    @property
    def replica_pids(self) -> List[str]:
        return [r.pid for r in self.replicas]

    def new_client(self, pid: Optional[str] = None) -> Client:
        if pid is None:
            prefix = f"{self.name}/" if self.name else ""
            pid = f"{prefix}c{len(self.clients)}"
        c = Client(self.sim, self.net, self.registry, pid,
                   self.replica_pids, self.replicas[0].f)
        self.clients.append(c)
        return c

    # ------------------------------------------------ replica replacement
    def current_epoch(self) -> int:
        """Highest membership epoch among live voting replicas."""
        return max((r.membership.epoch for r in self.replicas
                    if not r.joining), default=0)

    def current_members(self) -> Tuple[str, ...]:
        """Membership of the current epoch."""
        e = self.current_epoch()
        for r in self.replicas:
            if not r.joining and r.membership.epoch == e:
                return r.membership.replicas
        return tuple(self.replica_pids)

    def current_leader(self) -> str:
        """Leader pid of the current epoch's seated view (as observed by
        one live replica of that epoch)."""
        e = self.current_epoch()
        for r in self.replicas:
            if not r.joining and not r.crashed and r.membership.epoch == e:
                return r.leader()
        return self.current_members()[0]

    def next_replica_pid(self) -> str:
        """The deterministic pid the next joiner will get — fixed ahead of
        time so reconfiguration plans can be precomputed."""
        prefix = f"{self.name}/" if self.name else ""
        return f"{prefix}r{len(self.replicas) + len(self.retired_replicas)}"

    def replacement_in_flight(self) -> bool:
        """True while an epoch bump is pending or a joiner is still
        non-voting — the never-more-than-one-concurrent-replacement
        guard."""
        if any(r.joining for r in self.replicas):
            return True
        return any(ne > r.membership.epoch
                   for r in self.replicas if not r.crashed
                   for ne in r.pending_membership)

    def _reject_replacement(self, old_pid: str, reason: str,
                            strict: bool) -> None:
        self.rejected_replacements.append((self.sim.now, old_pid, reason))
        if strict:
            raise ReplacementError(
                f"cannot replace {old_pid!r} in app {self.name!r}: {reason}")
        return None

    def replace_replica(self, old_pid: str,
                        new_pid: Optional[str] = None,
                        plan: Optional[ReconfigPlan] = None,
                        strict: bool = False
                        ) -> Optional[UbftReplica]:
        """Replace a (typically crashed) replica with a fresh one — the
        control-plane operation behind the membership-epoch machinery.

        The sequence (DESIGN_MEMBERSHIP.md):

        1. install the joiner *non-voting* (``joining=True``) — it observes
           the group but cannot affect any quorum;
        2. survivors publish their latest signed checkpoint + boundary
           snapshot + prepared-slot state into their own ``xfer/<epoch>``
           registers, and the joiner pulls f+1 of them — the state
           transfer travels entirely through the disaggregated-memory
           pools (the PR 2 machinery);
        3. every pool re-keys the old pid's register permission to the new
           pid (``MemoryPool.rekey_owner`` — the reconfiguration
           pull/merge path, retried on timeout), so a Byzantine replaced
           replica cannot keep writing.  Rekey completion is *not* ordered
           before joiner activation: if the joiner writes an inherited
           register before ``adopt_wts`` lands, its entry is transiently
           shadowed by the inherited higher-timestamp blob — harmless for
           safety (the inherited CTBcast entries carry the old pid's
           signature and fail verification at every reader) and
           self-healing (``adopt_wts`` takes the max, so the next write
           supersedes);
        4. survivors route the epoch bump through a consensus slot
           (MEMBERSHIP); executing it switches every honest replica to the
           new epoch at the same point of its execution order, and f+1
           EPOCH confirmations activate the joiner.

        Guards (idempotency): a request naming a pid that is unknown,
        already retired, or mid-replacement — or arriving while another
        epoch bump is in flight — is rejected with a clear reason
        (recorded in :attr:`rejected_replacements`; raised as
        :class:`ReplacementError` with ``strict=True``) instead of racing
        the membership machinery.

        ``plan`` executes a precomputed :class:`~repro.core.health
        .ReconfigPlan` instead of deciding online: the joiner pid, the
        target epoch and the ``rekey_owner`` pool order come from the
        plan, which is validated against the live membership first (a
        stale plan is a rejection, never a partial execution).

        Returns the joiner (already on the event loop), or ``None`` when
        the replacement cannot start.  The switch itself completes
        asynchronously — drive the simulator and watch
        ``replica.membership.epoch``.
        """
        if self.app_factory is None:
            raise RuntimeError("replace_replica needs the app factory — "
                               "attach the cluster via Cluster.attach")
        by_pid = {r.pid: r for r in self.replicas}
        old = by_pid.get(old_pid)
        if old is None:
            if any(r.pid == old_pid for r in self.retired_replicas):
                return self._reject_replacement(
                    old_pid, "already retired by an earlier epoch switch",
                    strict)
            return self._reject_replacement(
                old_pid, "unknown pid (not in this cluster)", strict)
        if old.joining:
            return self._reject_replacement(
                old_pid, "target is itself a joiner still mid-replacement",
                strict)
        survivors = [r for r in self.replicas
                     if r.pid != old_pid and not r.crashed and not r.joining]
        if not survivors:
            return self._reject_replacement(
                old_pid, "no live survivors to transfer state from", strict)
        if self.replacement_in_flight():
            return self._reject_replacement(
                old_pid, "a replacement is already in flight", strict)
        cur_epoch = max(r.membership.epoch for r in survivors)
        members = next(r for r in survivors
                       if r.membership.epoch == cur_epoch).membership.replicas
        if old_pid not in members:
            return self._reject_replacement(
                old_pid, "not a member of the current epoch", strict)
        e = cur_epoch + 1
        pools = list(self.pools)
        if plan is not None:
            if new_pid is not None and new_pid != plan.new_pid:
                return self._reject_replacement(
                    old_pid, f"new_pid {new_pid!r} conflicts with the "
                    f"plan's {plan.new_pid!r}", strict)
            if (plan.old_pid != old_pid or plan.epoch != e or
                    plan.members != tuple(members)):
                return self._reject_replacement(
                    old_pid, f"stale plan (plan epoch {plan.epoch} / "
                    f"members {plan.members} vs live epoch {e} / "
                    f"{tuple(members)})", strict)
            by_name = {p.name: p for p in pools}
            if set(plan.rekey_order) != set(by_name):
                return self._reject_replacement(
                    old_pid, "plan's pool placement no longer matches the "
                    "cluster", strict)
            pools = [by_name[n] for n in plan.rekey_order]
            new_pid = plan.new_pid
        if new_pid is None:
            new_pid = self.next_replica_pid()
        if new_pid in self.sim.processes:
            return self._reject_replacement(
                old_pid, f"joiner pid {new_pid!r} is already a live "
                f"process", strict)
        cls = self.replica_cls or UbftReplica
        joiner = cls(self.sim, self.net, self.registry, new_pid,
                     list(members), self.pools, self.app_factory(),
                     self.cfg, namespace=self.name, joining=True,
                     epoch=cur_epoch)
        survivor_pids = [r.pid for r in survivors
                         if r.membership.epoch == cur_epoch]
        for r in survivors:
            r.publish_xfer(e)

        def _do_rekeys() -> None:
            for pool in pools:
                pool.rekey_owner(old_pid, new_pid,
                                 cb=joiner.regs.adopt_wts)
        if old.crashed:
            _do_rekeys()
        else:
            # A live target is still a voting member of the current epoch
            # (possibly its seated leader) until the agreed switch
            # executes.  Revoking its register permissions at fire time
            # would mute its slow-path broadcasts mid-epoch and wedge the
            # group; revoke at joiner activation instead — the switch
            # retires the old pid at the same point of the execution
            # order, so it cannot keep writing past its epoch either way.
            joiner.on_activate_hooks.append(_do_rekeys)
        joiner.begin_join(e, survivor_pids, (old_pid, new_pid))
        for r in survivors:
            r.propose_membership(e, old_pid, new_pid)
        if not old.crashed:
            # A live target proposes its own retirement: when the seated
            # leader is the one being rotated out, the survivors' ECHOs
            # alone would only reach it after a starvation-driven view
            # change (a full patience window).  An honest leader proposes
            # immediately; a Byzantine one still loses its view to the
            # progress timer as before.
            old.propose_membership(e, old_pid, new_pid)
        # control-plane bookkeeping: the cluster now routes around old_pid
        idx = self.replicas.index(old)
        self.replicas[idx] = joiner
        self.retired_replicas.append(old)
        # Clients fan REQs to every pid that is a member now or will be
        # next epoch: a live target stays a voting member — possibly the
        # seated leader — until the agreed switch executes, and cutting
        # it out of the fan-out at fire time would leave requests issued
        # during the switch without any copy at the one replica that can
        # propose them.  The retired pid is pruned once the joiner votes.
        fanout = self.replica_pids
        if not old.crashed:
            fanout = fanout + [old_pid]
        for c in self.clients:
            c.replicas = fanout

        def _prune_retired() -> None:
            if joiner.joining and not joiner.crashed:
                self.sim.after(50.0, _prune_retired)
                return
            for c in self.clients:
                c.replicas = self.replica_pids
        if not old.crashed:
            self.sim.after(50.0, _prune_retired)
        if self.substrate is not None:
            self.substrate.add_owner(self.name, new_pid)
        self.replacements.append((self.sim.now, old_pid, new_pid))
        for hook in self.replace_hooks:
            hook(old, joiner)
        return joiner

    def submit_internal(self, rid: tuple, payload: bytes) -> None:
        """Route a service-level request (``("svc", ...)`` rid, applied to
        the app, no reply) into this group's consensus from the control
        plane: every live replica proposes it, the deterministic rid
        dedupes the submissions into one slot.  This is the cluster-side
        hook behind ``repro.service``'s cross-shard 2PC recovery (a single
        replica uses ``UbftReplica.propose_internal`` directly)."""
        for r in self.replicas:
            if not r.crashed and not r.joining:
                r.propose_internal(rid, payload)

    # ------------------------------------------------ self-healing plane
    def enable_self_healing(self, cfg: Any = None) -> HealthMonitor:
        """Turn on the suspicion-driven control plane (core/health.py):
        one :class:`HealthMonitor` for the group, one
        :class:`ReplicaHealth` agent per replica (joiners included, via
        ``replace_hooks``).  ``cfg`` is a :class:`HealthConfig`, a dict of
        overrides, or None/True for defaults.  Idempotent — a second call
        returns the existing monitor."""
        if self.health_monitor is not None:
            return self.health_monitor
        hcfg = as_health_config(cfg)
        mon = HealthMonitor(self, hcfg)
        for r in self.replicas:
            r.gap_repair_us = hcfg.gap_repair_us
            ReplicaHealth(r, mon, hcfg)

        def _on_replace(old: UbftReplica, joiner: UbftReplica) -> None:
            agent = getattr(old, "health_agent", None)
            if agent is not None:
                agent.stop()
            joiner.gap_repair_us = hcfg.gap_repair_us
            ReplicaHealth(joiner, mon, hcfg)
            mon.forget(old.pid)

        self.replace_hooks.append(_on_replace)
        self.health_monitor = mon
        return mon

    # ------------------------------------------------------ telemetry
    def stats(self) -> Dict[str, Any]:
        """One telemetry surface for benchmarks and controllers:
        replacement history (accepted + rejected), per-pool rekey retry
        counts (``aborted_rekeys`` et al.), per-replica health/suspicion
        counters, and — when self-healing is enabled — the monitor's
        accusation, replacement and gating logs."""
        pools = {
            p.name: {
                "rekeys": len(p.rekeys),
                "aborted_rekeys": len(p.aborted_rekeys),
                "aborted_syncs": len(p.aborted_syncs),
                "reconfigurations": len(p.reconfigurations),
            }
            for p in self.pools
        }
        health: Dict[str, Any] = {}
        for r in self.replicas:
            hc = getattr(r, "health_counters", None) or {}
            entry = {
                "starvations": hc.get("starvations", 0),
                "view_changes": hc.get("view_changes", 0),
                "seated_past": dict(hc.get("seated_past", {})),
            }
            agent = getattr(r, "health_agent", None)
            if agent is not None:
                entry["hb_misses"] = dict(agent.misses)
                entry["suspects"] = sorted(agent.suspects)
            health[r.pid] = entry
        out: Dict[str, Any] = {
            "epoch": self.current_epoch(),
            "members": list(self.current_members()),
            "replacements": list(self.replacements),
            "rejected_replacements": list(self.rejected_replacements),
            "replacement_in_flight": self.replacement_in_flight(),
            "pools": pools,
            "health": health,
        }
        mon = self.health_monitor
        if mon is not None:
            out["suspicions"] = {t: sorted(acc)
                                 for t, acc in mon.accusations.items() if acc}
            out["auto_replacements"] = [dict(rec) for rec in mon.replacements]
            out["deferred"] = list(mon.deferred)
            out["rotation"] = [dict(rec) for rec in mon.rotation_log]
        admission: Dict[str, Any] = {}
        for r in self.replicas:
            cfg = getattr(r, "cfg", None)
            if cfg is None or cfg.admission is None:
                continue
            admission[r.pid] = dict(
                r.admission_stats,
                backlog=r._client_backlog,
                shed_queued=len(r.shed_queue),
                exec_lag=max(r.decided.keys(), default=-1) - r.exec_upto,
            )
        if admission:
            out["admission"] = admission
        # engine observability: wire-cache / digest-path counters (module
        # global — shared by every app on the substrate) plus this
        # fabric's fan-out accounting, so benchmarks can prove the batched
        # paths are actually taken on the hot path
        out["engine"] = {
            "digests": crypto.digest_stats(),
            "net": {
                "msgs_sent": self.net.msgs_sent,
                "bytes_sent": self.net.bytes_sent,
                "fanout_msgs": self.net.fanout_msgs,
                "coalesced_runs": self.net.coalesced_runs,
            },
            "events_processed": self.sim.events_processed,
        }
        return out

    def memory_by_pool(self) -> Dict[str, int]:
        """This app's occupied disaggregated memory per shared pool
        (Table 2, split per application)."""
        if self.substrate is None:
            return {p.name: p.memory_bytes() for p in self.pools}
        return self.substrate.app_pool_bytes(self.name)

    def run_request(self, client: Client, payload: bytes,
                    timeout: float = 1_000_000.0) -> Tuple[bytes, float]:
        """Issue one request and run the simulation until it completes."""
        box: dict = {}

        def done(result: bytes, lat: float) -> None:
            box["result"] = result
            box["lat"] = lat

        client.request(payload, done)
        ok = self.sim.run_until(lambda: "result" in box, timeout=timeout)
        if not ok:
            raise TimeoutError(
                f"request did not complete within {timeout} µs "
                f"(t={self.sim.now})")
        return box["result"], box["lat"]

    def run_requests(self, client: Client, payloads: List[bytes],
                     timeout: float = 10_000_000.0) -> List[Tuple[bytes, float]]:
        """Issue many requests concurrently (they ride the leader's batched
        slots) and run until every one completes.  Returns (result, latency)
        per payload, in submission order."""
        out: List[Optional[Tuple[bytes, float]]] = [None] * len(payloads)
        left = {"n": len(payloads)}

        def mk(i: int):
            def done(result: bytes, lat: float) -> None:
                out[i] = (result, lat)
                left["n"] -= 1
            return done

        for i, p in enumerate(payloads):
            client.request(p, mk(i))
        ok = self.sim.run_until(lambda: left["n"] == 0, timeout=timeout)
        if not ok:
            raise TimeoutError(
                f"{left['n']}/{len(payloads)} requests incomplete after "
                f"{timeout} µs (t={self.sim.now})")
        return out  # type: ignore[return-value]


def build_cluster(app_factory: Callable[[], App],
                  f: Optional[int] = None, f_m: Optional[int] = None,
                  cfg: Optional[ConsensusConfig] = None,
                  params: Optional[NetParams] = None,
                  seed: int = 0,
                  replica_cls=UbftReplica,
                  n_pools: int = 1,
                  auto_reconfigure: bool = False,
                  lease_us: float = 200.0) -> Cluster:
    """Legacy shim: a private :class:`Substrate` plus one unnamed app.

    Assembles a 2f+1-replica uBFT deployment over ``n_pools`` memory pools
    of 2f_m+1 nodes each, exactly as the pre-substrate builder did
    (identical pids, process-creation order, and draw order — the recorded
    golden traces hold bit-for-bit).

    In the substrate API the fault parameters come from ``cfg`` alone.
    When ``cfg`` is supplied together with explicit ``f``/``f_m`` keywords
    that *disagree* with it, this shim raises instead of silently
    clobbering the config (the historical footgun: ``cfg.f`` used to be
    overwritten by the defaulted keyword).
    """
    if cfg is not None:
        if f is not None and f != cfg.f:
            raise ValueError(
                f"conflicting fault budgets: build_cluster(f={f}) vs "
                f"cfg.f={cfg.f} — with cfg=..., f comes from cfg alone")
        if f_m is not None and f_m != cfg.f_m:
            raise ValueError(
                f"conflicting fault budgets: build_cluster(f_m={f_m}) vs "
                f"cfg.f_m={cfg.f_m} — with cfg=..., f_m comes from cfg alone")
    else:
        cfg = ConsensusConfig(f=1 if f is None else f,
                              f_m=1 if f_m is None else f_m)
    substrate = Substrate(f_m=cfg.f_m, n_pools=n_pools, params=params,
                          seed=seed, auto_reconfigure=auto_reconfigure,
                          lease_us=lease_us)
    return Cluster.attach(substrate, app_factory, name="", cfg=cfg,
                          replica_cls=replica_cls)
