"""Declarative scenarios: topology + apps + workloads + faults, executed.

A :class:`ScenarioSpec` describes a whole deployment the way the paper's
evaluation sections describe theirs: one shared disaggregated-memory
substrate (f_m, n_pools, network parameters, seed), any number of
replicated applications attached to it (:class:`AppSpec` — app factory,
consensus config, per-pool byte budget), a workload per app
(:class:`Workload` — closed-loop back-to-back clients or an open-loop
seeded Poisson arrival process), and an optional
:class:`~repro.sim.faults.FaultSchedule`.  :func:`run_scenario` builds it,
drives every workload concurrently on the one event loop, audits the
per-app Table 2 budgets, and returns per-app latencies / counters /
memory occupancy.

This replaces the hand-rolled setup previously copied across every
``benchmarks/fig*.py``, ``benchmarks/throughput.py``,
``benchmarks/fault_scenarios.py``, the test fixtures and the examples —
and it is the only way to express the paper's headline deployment: *many*
replicated applications sharing one substrate (§8), since a private
``build_cluster`` per app cannot put two apps on one event loop.

Workload semantics
------------------
* ``closed`` — ``n_clients`` clients re-fire back-to-back.  With
  ``n_requests`` set, the app completes after that many requests total
  (the classic figure workload); with ``duration_us`` set instead, clients
  re-fire until the window closes (the throughput workload).
* ``open`` — arrivals are a seeded Poisson process (``rate_rps`` per
  client over ``duration_us``); requests are injected at their arrival
  times *regardless of completions*, so interference sweeps do not
  self-throttle the way closed loops do.  Arrival draws come from a
  dedicated ``numpy`` RNG (``seed``), never from the simulator's RNG —
  adding an open-loop app cannot perturb the network jitter stream of its
  neighbours.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.consensus import App, ConsensusConfig
from repro_torch.core.registers import POOL_MEMORY_BUDGET
from repro_torch.core.smr import Cluster
from repro_torch.core.substrate import Substrate
from repro_torch.sim.faults import FaultInjector, FaultSchedule
from repro_torch.sim.net import NetParams


# --------------------------------------------------------------------------
# Specs
# --------------------------------------------------------------------------
@dataclass
class Workload:
    """One app's load: closed-loop (count- or duration-bounded) or
    open-loop Poisson arrivals.

    Key popularity: with ``keyspace > 0`` every request draws a key from a
    seeded sampler — uniform when ``zipf_theta == 0``, Zipf(θ) otherwise
    (rank-r key has weight 1/r^θ; the YCSB-style skew knob, θ≈0.99 being
    the classic "hot-key" setting).  ``payload_fn`` is then called as
    ``payload_fn(i, key)`` and turns the drawn key into the request — so
    skewed-traffic sweeps are declarative rather than hand-rolled per
    benchmark.  Key draws come from a dedicated RNG (``key_seed``), never
    the simulator's, and are indexed by request number: request ``i``
    always sees the same key regardless of interleaving.
    """
    kind: str = "closed"               # "closed" | "open" | "trace"
    n_requests: int = 0                # closed: total requests to complete
    duration_us: float = 0.0           # closed: window; open: arrival window
    rate_rps: float = 0.0              # open: Poisson rate per client (req/s)
    payload: bytes = b"x" * 32
    payload_fn: Optional[Callable[..., Any]] = None
    n_clients: int = 1
    seed: int = 0                      # open: arrival-process stream
    timeout_us: float = 60_000_000.0   # drain bound after the window closes
    keyspace: int = 0                  # >0: draw a key per request
    zipf_theta: float = 0.0            # 0 = uniform; >0 = Zipf skew
    key_seed: int = 0                  # key-popularity stream
    #: kind="trace": a precomputed ``[(t_us, payload), ...]`` schedule
    #: (the workload library's generators — repro.workloads — produce
    #: these); arrivals are replayed verbatim, round-robin over clients
    trace: Optional[List[Tuple[float, Any]]] = None

    def __post_init__(self):
        if self.kind not in ("closed", "open", "trace"):
            raise ValueError(f"unknown workload kind {self.kind!r}")
        if self.kind == "trace":
            if not self.trace:
                raise ValueError("trace workload needs a non-empty trace")
            if not self.duration_us:
                self.duration_us = max(t for t, _ in self.trace) + 1.0
        if self.kind == "closed":
            if not (self.n_requests or self.duration_us):
                raise ValueError(
                    "closed workload needs n_requests or duration_us")
            if self.n_requests and self.duration_us:
                raise ValueError(
                    "closed workload takes n_requests OR duration_us, not "
                    "both (a count target cannot be guaranteed inside a "
                    "fixed window)")
        if self.kind == "open" and not (self.rate_rps > 0 and
                                        self.duration_us > 0):
            raise ValueError("open workload needs rate_rps and duration_us")
        if self.keyspace and self.payload_fn is None:
            raise ValueError("a keyed workload (keyspace > 0) needs a "
                             "payload_fn(i, key) to build requests")
        self._keys: List[bytes] = []
        self._key_rng: Any = None
        self._key_cdf: Any = None

    def key_for(self, i: int) -> bytes:
        """The i-th request's key — lazily drawn, cached, index-stable."""
        if self._key_rng is None:
            self._key_rng = np.random.default_rng(self.key_seed)
            if self.zipf_theta > 0.0:
                w = 1.0 / np.arange(1, self.keyspace + 1) ** self.zipf_theta
                self._key_cdf = np.cumsum(w / w.sum())
        rng = self._key_rng
        while len(self._keys) <= i:
            if self._key_cdf is None:
                idx = int(rng.integers(self.keyspace))
            else:
                idx = int(np.searchsorted(self._key_cdf, rng.random()))
            self._keys.append(b"k%07d" % idx)
        return self._keys[i]

    def payload_for(self, i: int) -> Any:
        if self.keyspace:
            return self.payload_fn(i, self.key_for(i))
        return self.payload_fn(i) if self.payload_fn is not None \
            else self.payload


@dataclass
class AppSpec:
    """One replicated application on the shared substrate."""
    name: str
    app: Callable[[], App]
    cfg: Optional[ConsensusConfig] = None
    workload: Optional[Workload] = None
    budget: int = POOL_MEMORY_BUDGET   # per-pool Table 2 byte budget
    replica_cls: Any = None            # default: UbftReplica
    #: pool placement policy: pin this app's register sharding to a pool
    #: subset (indices / names / MemoryPool objects); None = every pool
    pools: Any = None
    #: self-healing membership (``Cluster.enable_self_healing``): True /
    #: a ``HealthConfig`` / a dict of overrides; None|False = off
    self_heal: Any = None


@dataclass
class ServiceSpec:
    """One sharded service on the substrate: K uBFT groups
    (``<name>/s<i>``, each an independent 2f+1 deployment of ``app``)
    behind a :class:`~repro.service.router.ShardRouter`, driven by one
    workload whose ``payload_fn`` returns service *ops* (``("get", k)`` /
    ``("set", k, v)`` / ``("mset", pairs)``) instead of wire bytes —
    typically a keyed workload (``keyspace``/``zipf_theta``) so the hot
    shard emerges from the key distribution, not from hand-routing."""
    name: str
    n_shards: int
    cfg: Optional[ConsensusConfig] = None
    workload: Optional[Workload] = None
    #: app factory per shard; None = repro.apps.kvstore.ShardKVApp
    app: Optional[Callable[[], App]] = None
    budget: int = POOL_MEMORY_BUDGET
    tx_timeout_us: float = 20_000.0
    pools: Any = None
    #: self-heal every shard group (split-born shards included)
    self_heal: Any = None


@dataclass
class ScenarioSpec:
    """Topology + apps + workloads + faults, declaratively."""
    apps: List[AppSpec]
    services: List[ServiceSpec] = field(default_factory=list)
    f_m: int = 1
    n_pools: int = 1
    seed: int = 0
    params: Optional[NetParams] = None
    auto_reconfigure: bool = False
    lease_us: float = 200.0
    #: a FaultSchedule, or a callable ``(substrate) -> FaultSchedule`` for
    #: schedules that need the live pools (FaultSchedule.seeded)
    faults: Any = None
    #: extra settle time after all workloads complete (lets view changes,
    #: reconfigurations and replica convergence finish before assertions)
    drain_us: float = 0.0


# --------------------------------------------------------------------------
# Results
# --------------------------------------------------------------------------
@dataclass
class AppResult:
    name: str
    latencies: List[float]
    issued: int
    completed: int
    #: this app's occupied disaggregated memory per pool (Table 2 per app)
    memory_by_pool: Dict[str, int]

    @property
    def stalled(self) -> int:
        return self.issued - self.completed


@dataclass
class ScenarioResult:
    substrate: Substrate
    clusters: Dict[str, Cluster]
    apps: Dict[str, AppResult]
    injector: Optional[FaultInjector]
    #: per-app budget overruns recorded by the substrate audit
    budget_overruns: List[Tuple[float, str, str, int, int]]
    msgs_sent: int
    bytes_sent: int
    events_processed: int

    def latencies(self, name: str = "") -> List[float]:
        return self.apps[name].latencies


# --------------------------------------------------------------------------
# Workload drivers
# --------------------------------------------------------------------------
class _WorkloadRun:
    """Live state of one app's workload on the event loop."""

    def __init__(self, cluster: Cluster, w: Workload):
        self.cluster = cluster
        self.w = w
        self.lats: List[float] = []
        self.issued = 0
        self.completed = 0
        self._open_seq = -1
        self.t_end = (cluster.sim.now + w.duration_us
                      if w.duration_us else None)
        self.clients = [cluster.new_client() for _ in range(w.n_clients)]
        if w.kind == "closed":
            self._start_closed()
        elif w.kind == "trace":
            self._start_trace()
        else:
            self._start_open()

    # ------------------------------------------------------------- closed
    def _start_closed(self) -> None:
        for cl in self.clients:
            self._fire_closed(cl)

    def _fire_closed(self, cl) -> None:
        w, sim = self.w, self.cluster.sim
        if w.n_requests and self.issued >= w.n_requests:
            return
        if self.t_end is not None and sim.now >= self.t_end:
            return
        i = self.issued
        self.issued += 1

        def done(_res, lat: float) -> None:
            self.completed += 1
            self.lats.append(lat)
            self._fire_closed(cl)

        cl.request(w.payload_for(i), done)

    # --------------------------------------------------------------- open
    def _start_open(self) -> None:
        """Schedule the whole seeded Poisson arrival process up front.

        Inter-arrival gaps are exponential with mean ``1e6 / rate_rps`` µs,
        drawn client-by-client from a dedicated RNG — the schedule is a
        pure function of (seed, rate, duration, n_clients) and is
        independent of everything else in the simulation.
        """
        w, sim = self.w, self.cluster.sim
        rng = np.random.default_rng(w.seed)
        mean_gap = 1e6 / w.rate_rps
        t0 = sim.now
        for cl in self.clients:
            t = t0 + float(rng.exponential(mean_gap))
            while t < t0 + w.duration_us:
                sim.at(t, (lambda cl=cl: self._fire_open(cl)),
                       note="workload.arrival")
                self.issued += 1
                t += float(rng.exponential(mean_gap))

    def _fire_open(self, cl) -> None:
        self._open_seq += 1
        i = self._open_seq

        def done(_res, lat: float) -> None:
            self.completed += 1
            self.lats.append(lat)

        cl.request(self.w.payload_for(i), done)

    # -------------------------------------------------------------- trace
    def _start_trace(self) -> None:
        """Replay a precomputed ``(t_us, payload)`` schedule verbatim
        (open-loop: arrivals fire regardless of completions), round-robin
        over the client pool.  Trace times are relative to now."""
        w, sim = self.w, self.cluster.sim
        t0 = sim.now
        n_cl = len(self.clients)
        for j, (t, payload) in enumerate(w.trace):
            if t >= w.duration_us:
                continue
            cl = self.clients[j % n_cl]
            sim.at(t0 + t, (lambda cl=cl, p=payload: self._fire_trace(cl, p)),
                   note="workload.arrival")
            self.issued += 1

    def _fire_trace(self, cl, payload) -> None:
        def done(_res, lat: float) -> None:
            self.completed += 1
            self.lats.append(lat)

        cl.request(payload, done)

    # ----------------------------------------------------------- progress
    def done(self) -> bool:
        w = self.w
        if w.kind == "closed":
            if w.n_requests:
                return self.completed >= w.n_requests
            # duration-bounded closed loop: the window IS the measurement —
            # in-flight stragglers are not drained (classic throughput
            # window; ``issued - completed`` shows up as ``stalled``)
            return (self.t_end is not None and
                    self.cluster.sim.now >= self.t_end)
        # open loop / trace replay: every arrival issued and completed
        if self.t_end is not None and self.cluster.sim.now < self.t_end:
            return False
        return self.completed >= self.issued


def open_loop(cluster: Cluster, payload_fn: Callable[[int], bytes],
              rate_rps: float, duration_us: float, n_clients: int = 1,
              seed: int = 0, timeout_us: float = 60_000_000.0) -> List[float]:
    """Standalone open-loop driver for one already-built cluster: seeded
    Poisson arrivals at ``rate_rps`` per client over ``duration_us``, then
    drain.  Returns completion latencies (see ``benchmarks/common.py``'s
    ``open_loop_cluster`` wrapper)."""
    run = _WorkloadRun(cluster, Workload(
        kind="open", rate_rps=rate_rps, duration_us=duration_us,
        payload_fn=payload_fn, n_clients=n_clients, seed=seed,
        timeout_us=timeout_us))
    cluster.sim.run(until=cluster.sim.now + duration_us)
    ok = cluster.sim.run_until(run.done, timeout=timeout_us)
    if not ok:
        raise TimeoutError(
            f"open loop stalled: {run.completed}/{run.issued} completed")
    return run.lats


# --------------------------------------------------------------------------
# Execution
# --------------------------------------------------------------------------
def build_deployment(spec: ScenarioSpec
                     ) -> Tuple[Substrate, Dict[str, Cluster]]:
    """Build the substrate and attach every app — no workload driving.
    For benchmarks that need manual control (tracing, warmup) over a
    declaratively-specified topology."""
    substrate = Substrate(f_m=spec.f_m, n_pools=spec.n_pools,
                          params=spec.params, seed=spec.seed,
                          auto_reconfigure=spec.auto_reconfigure,
                          lease_us=spec.lease_us)
    clusters: Dict[str, Cluster] = {}
    for a in spec.apps:
        kw: Dict[str, Any] = {}
        if a.replica_cls is not None:
            kw["replica_cls"] = a.replica_cls
        if a.pools is not None:
            kw["pools"] = a.pools
        clusters[a.name] = Cluster.attach(substrate, a.app, name=a.name,
                                          cfg=a.cfg, budget=a.budget, **kw)
        if a.self_heal:
            clusters[a.name].enable_self_healing(a.self_heal)
    for s in spec.services:
        from repro_torch.service import ShardedService  # avoid a static cycle
        app = s.app
        if app is None:
            from repro_torch.apps.kvstore import ShardKVApp
            app = ShardKVApp
        svc = ShardedService.attach(substrate, s.n_shards, name=s.name,
                                    cfg=s.cfg, app=app, budget=s.budget,
                                    tx_timeout_us=s.tx_timeout_us,
                                    pools=s.pools, self_heal=s.self_heal)
        # shard groups are ordinary attached apps: expose them under their
        # full names so FaultInjector events can target "<svc>/s<i>/r<j>"
        for i, shard in enumerate(svc.shards):
            clusters[shard.name] = shard
    return substrate, clusters


def run_scenario(spec: ScenarioSpec) -> ScenarioResult:
    """Execute a scenario end to end: build, inject faults, drive every
    app's workload concurrently on the shared event loop, drain, audit the
    per-app memory budgets."""
    substrate, clusters = build_deployment(spec)
    sim = substrate.sim

    injector: Optional[FaultInjector] = None
    if spec.faults is not None:
        sched = spec.faults(substrate) if callable(spec.faults) \
            else spec.faults
        if not isinstance(sched, FaultSchedule):
            sched = FaultSchedule(sched)
        injector = FaultInjector(sim, substrate.net, substrate.pools,
                                 clusters=clusters,
                                 services=substrate.services).install(sched)

    runs: Dict[str, _WorkloadRun] = {}
    for a in spec.apps:
        if a.workload is not None:
            runs[a.name] = _WorkloadRun(clusters[a.name], a.workload)
    for s in spec.services:
        if s.workload is not None:
            # a ShardedService quacks like a cluster to the driver (.sim,
            # .new_client, client.request) — ops route through the shards
            runs[s.name] = _WorkloadRun(substrate.services[s.name],
                                        s.workload)

    # Phase 1: run out the longest load window (duration-bounded apps keep
    # injecting/refiring until their own t_end inside this window).
    t_end = max((r.t_end for r in runs.values() if r.t_end is not None),
                default=None)
    if t_end is not None:
        sim.run(until=t_end)
    # Phase 2: drain — count-bounded closed loops finish their totals,
    # open loops complete their in-flight tail.
    if runs:
        timeout = max(r.w.timeout_us for r in runs.values())
        ok = sim.run_until(lambda: all(r.done() for r in runs.values()),
                           timeout=timeout)
        if not ok:
            detail = ", ".join(
                f"{name or '<default>'}: {r.completed}/"
                f"{r.issued if r.issued else r.w.n_requests}"
                for name, r in runs.items() if not r.done())
            raise TimeoutError(f"scenario stalled after {timeout} µs "
                               f"({detail})")
    if spec.drain_us:
        sim.run(until=sim.now + spec.drain_us)

    usage = substrate.memory_by_app()
    overruns = substrate.audit_budgets(usage)

    def mem_of(name: str) -> Dict[str, int]:
        # a service's occupancy is the sum of its shard apps' (each shard
        # is its own app "<svc>/s<i>" in the substrate's accounting)
        svc = substrate.services.get(name)
        if svc is None:
            return dict(usage.get(name, {}))
        agg: Dict[str, int] = {}
        for shard in svc.shards:
            for pool, nbytes in usage.get(shard.name, {}).items():
                agg[pool] = agg.get(pool, 0) + nbytes
        return agg

    apps = {
        name: AppResult(name=name, latencies=r.lats, issued=r.issued,
                        completed=r.completed, memory_by_pool=mem_of(name))
        for name, r in runs.items()
    }
    # apps/services without a workload still get their memory accounting
    for name in ([a.name for a in spec.apps] +
                 [s.name for s in spec.services]):
        if name not in apps:
            apps[name] = AppResult(name=name, latencies=[], issued=0,
                                   completed=0, memory_by_pool=mem_of(name))
    return ScenarioResult(substrate=substrate, clusters=clusters, apps=apps,
                          injector=injector, budget_overruns=overruns,
                          msgs_sent=substrate.net.msgs_sent,
                          bytes_sent=substrate.net.bytes_sent,
                          events_processed=sim.events_processed)
