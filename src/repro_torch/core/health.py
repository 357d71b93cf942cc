"""Self-healing control plane: suspicion → precomputed replacement plans.

Closes the loop left open by the membership machinery (DESIGN_MEMBERSHIP.md):
``Cluster.replace_replica`` used to fire only when a schedule or operator
invoked it, so a silently degraded replica cost view-change churn forever.
Three pieces close it:

:class:`ReplicaHealth` — a per-replica agent aggregating health signals
    already latent in the protocol into a phi-style suspicion score per
    peer: lease heartbeats (mirroring ``_PoolManager``'s LEASE_PING
    machinery in ``core/registers.py`` — a peer's freshest heartbeat ages
    past the period), progress-timer starvation episodes seated past a
    pid (``UbftReplica.health_counters`` / ``on_starvation_hooks``), and
    TBcast retransmission fires toward a peer that stopped acking
    (``TBcastService.retx_fires``).  When a peer's score crosses
    ``accuse_score`` the agent ACCUSEs it to the group's monitor and keeps
    refreshing the accusation every beat; when the score falls back under
    ``retract_score`` it RETRACTs.  The accuse/retract band plus the
    decaying accumulator is the per-accuser hysteresis: one missed beat or
    one starvation episode never reaches the accuse threshold.

:class:`HealthMonitor` — the per-cluster control-plane node (the analogue
    of the pools' manager: correct infrastructure, like the paper's
    disaggregated memory).  Replacement fires only when **f+1 distinct
    current members** accuse the same target *simultaneously* and the
    quorum has been **sustained for ``hold_us``** — so f Byzantine
    replicas spamming accusations can never evict an honest replica (at
    least one honest accuser is required, and honest accusers retract
    when the target shows life).  On top of the quorum: a global
    ``cooldown_us`` between automatic replacements, a replacement
    ``budget`` per ``budget_window_us``, and exponential back-off on
    repeat targets (per *slot*, since the replacement inherits the seat) —
    a flapping gray replica cannot convert suspicion into replacement
    churn.

:class:`ReconfigPlan` / :class:`PlanTable` — recovery is plan *lookup*,
    not online decision-making: for the group's current (f, f_m,
    pool-placement) neighborhood the table fixes, per possible target, the
    target epoch, the joiner pid, the state-transfer sources and the
    ``rekey_owner`` order ahead of time.  ``rotation()`` chains 2f+1 plans
    (consecutive epoch bumps, one per seat) into a rolling full-group
    rotation — the live-upgrade story — executed strictly one at a time
    (the in-flight guard in ``Cluster.replace_replica`` plus the
    monitor's sequential chaining: never more than one concurrent
    replacement per group).

Everything here is opt-in (``Cluster.enable_self_healing``): an
unenabled cluster sends not a single extra byte, so static/golden
deployments are bit-identical with or without this module.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.node import Node


@dataclass
class HealthConfig:
    """Suspicion + gating parameters (see DESIGN_MEMBERSHIP.md)."""
    #: heartbeat period; also the suspicion-evaluation beat
    hb_us: float = 400.0
    #: beats of heartbeat silence before a miss is scored
    miss_after: float = 1.5
    #: per-beat decay of the miss/retransmission accumulator
    decay: float = 0.5
    #: score added per starvation episode seated past the peer
    vc_weight: float = 2.0
    #: score added per TBcast RTO fire toward the peer
    retx_weight: float = 0.5
    #: sliding window for starvation episodes
    signal_window_us: float = 60_000.0
    #: accuse when score ≥ this …
    accuse_score: float = 3.0
    #: … retract only once it falls back under this (hysteresis band)
    retract_score: float = 0.75
    #: an unrefreshed accusation lapses after this long (dead accusers
    #: cannot pin a suspicion forever)
    accuse_ttl_us: float = 2_500.0
    #: the f+1 accuser quorum must be sustained this long before firing
    hold_us: float = 1_500.0
    #: global minimum gap between automatic replacements
    cooldown_us: float = 4_000.0
    #: automatic-replacement budget per ``budget_window_us``
    budget: int = 4
    budget_window_us: float = 200_000.0
    #: repeat replacements of the same *seat* back off exponentially:
    #: the k-th needs ``backoff_base_us · 2^(k-1)`` since the previous
    backoff_base_us: float = 10_000.0
    backoff_max_exp: int = 6
    #: poll period for replacement/rotation completion watches
    poll_us: float = 250.0
    #: consensus-level decision gap repair (cfg.gap_repair_us on every
    #: replica the healing layer manages): a replica stalled behind an
    #: undecided slot pulls the missing commit certificate from members
    #: after this grace.  Rolling rotation depends on it — each step
    #: retires one COMMIT voucher, so an ex-joiner can otherwise go deaf
    #: to a slot decided around its join window until the next summary
    #: boundary (unboundedly far away on a quiet stream).
    gap_repair_us: float = 600.0


def as_health_config(val: Any) -> HealthConfig:
    """Normalize the ``self_heal`` knob: True/None → defaults, a dict →
    overrides, a HealthConfig → itself."""
    if isinstance(val, HealthConfig):
        return val
    if val is None or val is True:
        return HealthConfig()
    if isinstance(val, dict):
        return HealthConfig(**val)
    raise TypeError(f"cannot build a HealthConfig from {val!r}")


# ==========================================================================
# Precomputed reconfiguration plans
# ==========================================================================
@dataclass(frozen=True)
class ReconfigPlan:
    """One precomputed replacement: everything ``replace_replica`` would
    otherwise decide online, fixed ahead of time."""
    #: the epoch this replacement creates (= pre-epoch + 1)
    epoch: int
    old_pid: str
    new_pid: str
    #: expected membership *before* the switch — staleness guard
    members: Tuple[str, ...]
    #: survivors expected to publish ``xfer/<epoch>`` state
    xfer_sources: Tuple[str, ...]
    #: pool names in ``rekey_owner`` order
    rekey_order: Tuple[str, ...]
    #: the (f, f_m, pool-placement) neighborhood the plan was built for
    neighborhood: Tuple[int, int, Tuple[str, ...]] = (0, 0, ())


class PlanTable:
    """Per-cluster table of :class:`ReconfigPlan`\\ s, one per possible
    target in the current membership, refreshed after every epoch switch.

    The table is keyed by the group's *neighborhood* — (f, f_m, pool
    placement) — which fixes everything a plan needs: the joiner pid
    follows the cluster's deterministic naming, the transfer sources are
    the surviving seats, and the rekey order is the placement's pool
    order.  At suspicion time the control plane looks a plan up and
    executes it; it decides nothing.
    """

    def __init__(self, cluster: Any):
        self.cluster = cluster
        self.plans: Dict[str, ReconfigPlan] = {}
        self.built_epoch: int = -1
        self.refresh()

    # ------------------------------------------------------------ building
    def _neighborhood(self) -> Tuple[int, int, Tuple[str, ...]]:
        c = self.cluster
        members = c.current_members()
        f = (len(members) - 1) // 2
        f_m = getattr(c.pools[0], "f_m", 0) if c.pools else 0
        return (f, f_m, tuple(p.name for p in c.pools))

    def _plan(self, epoch: int, members: Tuple[str, ...], old: str,
              new: str, hood: Tuple[int, int, Tuple[str, ...]]
              ) -> ReconfigPlan:
        return ReconfigPlan(
            epoch=epoch, old_pid=old, new_pid=new, members=tuple(members),
            xfer_sources=tuple(m for m in members if m != old),
            rekey_order=hood[2], neighborhood=hood)

    def refresh(self) -> None:
        """Recompute one plan per current member (all sharing the next
        free joiner pid — at most one of them ever executes)."""
        c = self.cluster
        e = c.current_epoch()
        members = tuple(c.current_members())
        hood = self._neighborhood()
        new = c.next_replica_pid()
        self.plans = {old: self._plan(e + 1, members, old, new, hood)
                      for old in members}
        self.built_epoch = e

    def plan_for(self, old_pid: str) -> Optional[ReconfigPlan]:
        return self.plans.get(old_pid)

    def current(self, plan: ReconfigPlan) -> bool:
        """Is the plan still executable against the live cluster state?"""
        c = self.cluster
        return (plan.epoch == c.current_epoch() + 1 and
                plan.members == tuple(c.current_members()))

    def rotation(self) -> List[ReconfigPlan]:
        """Chained plans replacing every current seat, leader last:
        2f+1 consecutive epoch bumps, each plan's expected membership
        being the previous plan's outcome — the rolling full-group
        rotation.  Strictly sequential by construction (plan k+1 is not
        executable until plan k's epoch committed).

        Seat order matters for tail latency: replacing a follower keeps
        the view (the leader seat is untouched, proposals never stop),
        while replacing the leader forces a full view change — seal,
        share collection, NEW_VIEW, repropose — underneath live traffic.
        Scheduling the current leader's seat last pays that cost once
        per rotation instead of at every step."""
        c = self.cluster
        e = c.current_epoch()
        members = list(c.current_members())
        lead = c.current_leader()
        order = [m for m in members if m != lead]
        if lead in members:
            order.append(lead)
        hood = self._neighborhood()
        base = c.next_replica_pid()
        prefix, start = base.rsplit("r", 1)
        plans: List[ReconfigPlan] = []
        for j, old in enumerate(order):
            new = f"{prefix}r{int(start) + j}"
            plans.append(self._plan(e + 1 + j, tuple(members), old, new,
                                    hood))
            members[members.index(old)] = new
        return plans


# ==========================================================================
# Per-replica suspicion agent
# ==========================================================================
class ReplicaHealth:
    """Heartbeats + phi-style per-peer suspicion for one replica.

    Every ``hb_us`` the agent broadcasts a HEALTH_HB to the current
    membership and scores each peer:

    * *heartbeat age* — the freshest HB from the peer older than
      ``miss_after`` beats scores ``age / hb_us`` (a constant-delay gray
      peer shows up here: its HBs arrive, but always stale);
    * *retransmission silence* — TBcast RTO fires toward the peer since
      the last beat, weighted by ``retx_weight``;
    * both feed a per-beat-decayed accumulator, plus ``vc_weight`` per
      starvation episode seated past the peer within ``signal_window_us``.

    Score ≥ ``accuse_score`` → ACCUSE the monitor (refreshed every beat
    while suspect); score back under ``retract_score`` → RETRACT.
    """

    def __init__(self, replica: Any, monitor: "HealthMonitor",
                 cfg: HealthConfig):
        self.replica = replica
        self.monitor = monitor
        self.cfg = cfg
        self.pid = replica.pid
        self.stopped = False
        self.suspects: Set[str] = set()
        self.misses: Dict[str, int] = {}       # per-peer missed-beat count
        self._acc: Dict[str, float] = {}       # decayed miss/retx score
        self._last_hb: Dict[str, float] = {}
        self._retx_seen: Dict[str, int] = {}
        self._starved: Dict[str, List[float]] = {}
        self._seq = 0
        self._last_beat = replica.sim.now
        replica.health_agent = self
        replica.handle("HEALTH_HB", self._on_hb)
        replica.on_starvation_hooks.append(self._on_starvation)
        self._handle = replica.sim.periodic(cfg.hb_us, self._beat)

    def stop(self) -> None:
        """Detach (replica retired by an epoch switch): stop beating and
        go deaf to signal hooks."""
        self.stopped = True
        self._handle.cancel()

    # ------------------------------------------------------------- signals
    def _on_hb(self, src: str, _body: Any) -> None:
        self._last_hb[src] = self.replica.sim.now

    def _on_starvation(self, stale_leader: str) -> None:
        if self.stopped or stale_leader == self.pid:
            return
        self._starved.setdefault(stale_leader, []).append(
            self.replica.sim.now)

    # ---------------------------------------------------------------- beat
    def _beat(self) -> None:
        r = self.replica
        if self.stopped or r.crashed:
            return
        cfg = self.cfg
        sim = r.sim
        now = sim.now
        if now - self._last_beat > 2.0 * cfg.hb_us:
            # first beat, or back from a crash window: grace-reset so
            # peers are not condemned for our own downtime
            for m in list(self._last_hb):
                self._last_hb[m] = now
            self._acc.clear()
        self._last_beat = now
        members = r.membership.replicas
        self._seq += 1
        for m in members:
            if m != self.pid:
                r.send(m, "HEALTH_HB", self._seq)
        # drop state for pids no longer in the membership
        mset = set(members)
        for d in (self._last_hb, self._acc, self._retx_seen, self._starved,
                  self.misses):
            for m in [m for m in d if m not in mset]:
                del d[m]
        self.suspects &= mset
        retx = getattr(getattr(r, "tb", None), "retx_fires", {})
        horizon = now - cfg.signal_window_us
        for m in members:
            if m == self.pid:
                continue
            last = self._last_hb.get(m)
            if last is None:
                last = self._last_hb[m] = now   # grace on first sight
            inst = 0.0
            age = now - last
            if age > cfg.miss_after * cfg.hb_us:
                inst = age / cfg.hb_us
                self.misses[m] = self.misses.get(m, 0) + 1
            seen = retx.get(m, 0)
            delta = seen - self._retx_seen.get(m, 0)
            self._retx_seen[m] = seen
            acc = (self._acc.get(m, 0.0) * cfg.decay + inst +
                   cfg.retx_weight * delta)
            self._acc[m] = acc
            starved = self._starved.get(m)
            if starved:
                starved[:] = [t for t in starved if t >= horizon]
            score = acc + cfg.vc_weight * (len(starved) if starved else 0)
            if score >= cfg.accuse_score:
                self.suspects.add(m)
                r.send(self.monitor.pid, "HEALTH_ACCUSE", (m, score))
            elif m in self.suspects and score <= cfg.retract_score:
                self.suspects.discard(m)
                r.send(self.monitor.pid, "HEALTH_RETRACT", (m,))


# ==========================================================================
# Per-cluster monitor
# ==========================================================================
class HealthMonitor(Node):
    """Control-plane node gating suspicion into plan execution.

    Fires ``cluster.replace_replica(target, plan=...)`` only when the
    accusation quorum, hysteresis hold, cooldown, budget and per-seat
    back-off all pass — see the module docstring.  Also drives rolling
    full-group rotation (:meth:`rotate`).
    """

    def __init__(self, cluster: Any, cfg: Optional[HealthConfig] = None):
        name = getattr(cluster, "name", "")
        pid = f"{name}/healthd" if name else "healthd"
        super().__init__(cluster.sim, cluster.net, cluster.registry, pid)
        self.cluster = cluster
        self.cfg = cfg or HealthConfig()
        self.plans = PlanTable(cluster)
        #: target -> {accuser: time of freshest accusation}
        self.accusations: Dict[str, Dict[str, float]] = {}
        #: target -> time the f+1 quorum was first (continuously) met
        self.quorum_since: Dict[str, float] = {}
        #: (time, accuser, target, score, "accuse" | "retract")
        self.suspicion_log: List[Tuple[float, str, str, float, str]] = []
        #: completed/in-flight automatic replacements (dicts with
        #: t_detect / t_fire / t_active, target, new, epoch)
        self.replacements: List[Dict[str, Any]] = []
        #: (time, target, reason) — gating decisions that deferred a fire
        self.deferred: List[Tuple[float, str, str]] = []
        self.rotation_log: List[Dict[str, Any]] = []
        self.rotating = False
        self._last_fire = float("-inf")
        self._fire_times: List[float] = []
        self._seat_backoff: Dict[int, Tuple[int, float]] = {}
        self.handle("HEALTH_ACCUSE", self._on_accuse)
        self.handle("HEALTH_RETRACT", self._on_retract)
        self._handle = self.sim.periodic(self.cfg.hold_us / 2.0,
                                         self._evaluate)

    # ------------------------------------------------------------ plumbing
    def _on_accuse(self, src: str, body: Any) -> None:
        target, score = body
        if src == target:
            return
        acc = self.accusations.setdefault(target, {})
        if src not in acc:
            self.suspicion_log.append(
                (self.sim.now, src, target, float(score), "accuse"))
        acc[src] = self.sim.now

    def _on_retract(self, src: str, body: Any) -> None:
        target = body[0]
        acc = self.accusations.get(target)
        if acc and src in acc:
            del acc[src]
            self.suspicion_log.append(
                (self.sim.now, src, target, 0.0, "retract"))

    def forget(self, pid: str) -> None:
        """Drop all suspicion state naming ``pid`` (it left the group)."""
        self.accusations.pop(pid, None)
        self.quorum_since.pop(pid, None)
        for acc in self.accusations.values():
            acc.pop(pid, None)

    # ---------------------------------------------------------- evaluation
    def _evaluate(self) -> None:
        now = self.sim.now
        cfg = self.cfg
        members = tuple(self.cluster.current_members())
        f = (len(members) - 1) // 2
        mset = set(members)
        for target in list(self.accusations):
            acc = self.accusations[target]
            for a in [a for a, t in acc.items()
                      if now - t > cfg.accuse_ttl_us]:
                del acc[a]
            if target not in mset:
                self.forget(target)
                continue
            live = [a for a in acc if a in mset and a != target]
            if len(live) >= f + 1:
                self.quorum_since.setdefault(target, now)
            else:
                self.quorum_since.pop(target, None)
                continue
            if now - self.quorum_since[target] >= cfg.hold_us:
                self._try_replace(target, now, members)

    def _defer(self, target: str, reason: str) -> None:
        self.deferred.append((self.sim.now, target, reason))

    def _try_replace(self, target: str, now: float,
                     members: Tuple[str, ...]) -> None:
        cfg = self.cfg
        c = self.cluster
        if self.rotating:
            return self._defer(target, "rotation in flight")
        if c.replacement_in_flight():
            return self._defer(target, "replacement in flight")
        if now - self._last_fire < cfg.cooldown_us:
            return self._defer(target, "cooldown")
        self._fire_times = [t for t in self._fire_times
                            if now - t <= cfg.budget_window_us]
        if len(self._fire_times) >= cfg.budget:
            return self._defer(target, "budget exhausted")
        seat = members.index(target)
        bo = self._seat_backoff.get(seat)
        if bo is not None and now < bo[1]:
            return self._defer(target, f"seat {seat} backoff")
        plan = self.plans.plan_for(target)
        if plan is None or not self.plans.current(plan):
            self.plans.refresh()
            plan = self.plans.plan_for(target)
        if plan is None:
            return self._defer(target, "no plan")
        # replace_replica runs the cluster's replace_hooks synchronously,
        # and one of those is our own forget() — grab t_detect first
        t_detect = self.quorum_since.get(target, now)
        joiner = c.replace_replica(target, plan=plan)
        if joiner is None:
            reason = (c.rejected_replacements[-1][2]
                      if c.rejected_replacements else "rejected")
            return self._defer(target, f"rejected: {reason}")
        rec = {"target": target, "new": plan.new_pid, "epoch": plan.epoch,
               "seat": seat, "t_detect": t_detect,
               "t_fire": now, "t_active": None}
        self.replacements.append(rec)
        self._last_fire = now
        self._fire_times.append(now)
        exp = min(bo[0] if bo else 0, cfg.backoff_max_exp)
        self._seat_backoff[seat] = (
            (bo[0] if bo else 0) + 1,
            now + cfg.backoff_base_us * (2 ** exp))
        self.forget(target)
        self._watch(rec, joiner)

    def _watch(self, rec: Dict[str, Any], joiner: Any) -> None:
        """Poll until the joiner is an active voting member, then stamp
        the recovery time and refresh the plan table for the new epoch."""
        def check() -> None:
            if (not joiner.joining and
                    joiner.membership.epoch >= rec["epoch"]):
                rec["t_active"] = self.sim.now
                self.plans.refresh()
                return
            self.sim.after(self.cfg.poll_us, check)
        self.sim.after(self.cfg.poll_us, check)

    # ------------------------------------------------------------ rotation
    def rotate(self, done_cb: Optional[Callable[[], None]] = None) -> None:
        """Rolling full-group rotation: replace every current seat in
        slot order through chained precomputed plans — 2f+1 consecutive
        epoch bumps, strictly one replacement in flight at a time.

        Aborts (recorded in ``rotation_log``) if a concurrent automatic
        replacement invalidates the chain; automatic replacement is
        suppressed while a rotation runs, so that only happens when an
        operator races the rotation by hand.
        """
        if self.rotating:
            raise RuntimeError("a rotation is already in flight")
        self.plans.refresh()
        chain = self.plans.rotation()
        self.rotating = True
        log = self.rotation_log = []
        c = self.cluster
        poll = self.cfg.poll_us

        def settled_at(e: int) -> bool:
            live = [r for r in c.replicas if not r.crashed and not r.joining]
            return (bool(live) and not c.replacement_in_flight() and
                    all(r.membership.epoch == e for r in live))

        def step(i: int) -> None:
            if i == len(chain):
                self.rotating = False
                self.plans.refresh()
                if done_cb is not None:
                    done_cb()
                return
            plan = chain[i]

            def try_fire() -> None:
                if not settled_at(plan.epoch - 1):
                    self.sim.after(poll, try_fire)
                    return
                joiner = c.replace_replica(plan.old_pid, plan=plan)
                if joiner is None:
                    reason = (c.rejected_replacements[-1][2]
                              if c.rejected_replacements else "rejected")
                    log.append({"step": i, "old": plan.old_pid,
                                "epoch": plan.epoch, "aborted": reason})
                    self.rotating = False
                    return
                rec = {"step": i, "old": plan.old_pid, "new": plan.new_pid,
                       "epoch": plan.epoch, "t_fire": self.sim.now,
                       "t_done": None}
                log.append(rec)

                def wait_done() -> None:
                    if settled_at(plan.epoch) and not joiner.joining:
                        rec["t_done"] = self.sim.now
                        step(i + 1)
                    else:
                        self.sim.after(poll, wait_done)
                self.sim.after(poll, wait_done)
            try_fire()
        step(0)
