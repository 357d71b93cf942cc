"""ShardedService: K independent uBFT groups as one partitioned kvstore.

Scale-out for the service plane: one 2f+1 group caps out around 1 Mops, so
the keyspace is hash-partitioned (:class:`~repro.service.router.ShardRouter`)
across K groups attached to *one* shared substrate (``<name>/s0..s<K-1>``) —
group count is a free variable on fixed infrastructure, exactly what the
PR 4 substrate was built for.

Cross-shard MSET runs as two-phase commit where **each phase is itself a
BFT-committed slot** (DESIGN_SHARDING.md):

* PREPARE — an ordinary consensus request per participant shard
  (:func:`~repro.apps.kvstore.tprep_req`): the shard's replicated state
  machine locks the keys, records the intent, and votes.  The vote is a
  product of the shard's log, so all 2f+1 replicas agree on it.
* DECIDE — one consensus request on the **coordinator shard** (the lowest
  participating shard index): the first DECIDE in its totally-ordered log
  fixes the outcome; every later DECIDE — including a recovery probe
  proposing abort — reads that record back.  The outcome is therefore
  unique and replicated *without any separate BFT coordinator group*.
  A *commit* outcome is additionally **owner-bound**: the txid embeds a
  collision-resistant tag of the submitting client's pid
  (:func:`~repro.apps.kvstore.make_txid`) and the state machine only
  records ``C`` when the authenticated caller of the DECIDE slot matches
  that tag — a Byzantine client can neither pre-commit nor (thanks to the
  txid's unguessable nonce) even name another client's transaction, so
  it cannot tear an honest MSET.  Abort stays open to anyone: recovery
  probes must be able to presume-abort, and an abort is always atomic.
* FINISH — a consensus request per participant shard applying or
  discarding the intent and releasing its locks.

The *client* driving the phases is untrusted for safety (a client lying
about the outcome could only tear its own transaction, which is
indistinguishable from it issuing legal single-key SETs) but is relied on
for progress — so every replica arms a **presumed-abort recovery timer**
when it executes a PREPARE (:class:`_TxRecovery`): if the intent is still
pending past its deadline, the replica itself probes the coordinator
shard, which records DECIDE(abort) if nothing was decided yet and answers
with *signed outcome statements*; f+1 matching signatures (so the answer
comes from the replicated record, not from any single — possibly
Byzantine — replica, and at least one signer is honest) form an outcome
certificate that rides the resulting recovery FINISH into this replica's
own shard as a deterministic ``("svc", ...)`` slot all replicas'
concurrent submissions dedupe into.  A transaction whose client vanished
after a committed DECIDE is thus *finished forward*; one abandoned before
DECIDE is aborted.

The recovery fleet survives membership epoch switches: every
``Cluster.replace_replica`` fires the cluster's ``replace_hooks``, which
attach a fresh :class:`_TxRecovery` to the joiner, and the joiner arms
probes for every pending intent it adopted via snapshot once it activates
(``on_activate_hooks``) — so locks are released even when every replica
that originally executed the PREPARE has been replaced.
"""

from __future__ import annotations

import hashlib
import random
import struct
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.apps.kvstore import (TXID_LEN, VOTE_OK, ShardKVApp, adopt_req,
                                capture_req, cut_req, freeze_req, get_req,
                                key_in_range, make_txid, mset_req,
                                parse_adopt, parse_cut, parse_rfinish,
                                parse_tprep, range_fp, rfinish_req, set_req,
                                tdecide_req, tfinish_req, tprep_req)
from repro_torch.core import crypto
from repro_torch.core.consensus import App, ConsensusConfig, UbftReplica
from repro_torch.core.registers import POOL_MEMORY_BUDGET
from repro_torch.core.smr import Cluster
from repro_torch.core.substrate import Substrate
from repro_torch.service.router import ShardRouter


class ServiceClient:
    """Routes operations to shards; runs cross-shard MSETs as 2PC.

    Operations are structured tuples (the router needs the key *before*
    the wire encoding picks a shard):

    * ``("get", key)`` / ``("set", key, value)`` — routed to one shard
    * ``("mset", pairs)`` — single-shard: one plain MSET slot;
      cross-shard: PREPARE / DECIDE / FINISH as described in the module
      docstring.  Completes ``cb(b"OK" | b"ABORTED", latency)``.

    One underlying uBFT :class:`~repro.core.smr.Client` per shard, created
    via ``Cluster.new_client`` — so a membership epoch switch on any shard
    (``replace_replica``) updates this client's destination pids in place
    and nothing here ever caches a replica address.
    """

    #: test knobs simulating a coordinator-client crash mid-2PC: drop the
    #: protocol on the floor after PREPARE (before DECIDE) / after DECIDE
    #: (before FINISH) — recovery must then abort / finish-forward
    drop_decide = False
    drop_finish = False
    #: routing-bounce handling (live split/merge): how many FROZEN/MOVED
    #: bounces one op survives before the bounce is surfaced to the
    #: caller, and how long to wait before re-routing.  FROZEN retries
    #: back off exponentially (capped): a freeze lasts as long as the
    #: range transfer, and every premature retry is a full consensus slot
    #: on the very shard the transfer is trying to drain — flat retries
    #: turn a hot-shard split into a self-inflicted retry storm
    max_route_retries = 64
    retry_delay_us = 150.0
    retry_backoff_max = 5          # cap the FROZEN delay at 150µs · 2^5

    def __init__(self, service: "ShardedService", pid: str):
        self.service = service
        self.pid = pid
        self.sim = service.sim
        self.router = service.router
        self.shard_clients = [c.new_client() for c in service.shards]
        self._txseq = 0
        # per-client nonce stream for txids.  Models a CSPRNG: the seed is
        # derived from the service-wide tx_secret + pid so runs stay
        # reproducible, while within the model no other client can predict
        # the draws (a real deployment would use os.urandom)
        self._tx_rng = random.Random(int.from_bytes(
            hashlib.sha256(
                f"{service.tx_secret}|{pid}".encode()).digest()[:8],
            "little"))
        self.latencies: List[float] = []

    # ------------------------------------------------------------ routing
    def _client_for(self, shard: int):
        """Per-shard uBFT client, grown lazily — a split minting shard
        index K+1 after this ServiceClient was created must still be
        reachable without re-creating the client."""
        while shard >= len(self.shard_clients):
            self.shard_clients.append(
                self.service.shards[len(self.shard_clients)].new_client())
        return self.shard_clients[shard]

    def request(self, op: tuple,
                cb: Optional[Callable[[bytes, float], None]] = None,
                _attempt: int = 0, _t0: Optional[float] = None) -> None:
        kind = op[0]
        if kind == "get":
            return self._one(self.router.shard_of(op[1]), get_req(op[1]), cb,
                             op=op, attempt=_attempt, t0=_t0)
        if kind == "set":
            return self._one(self.router.shard_of(op[1]),
                             set_req(op[1], op[2]), cb,
                             op=op, attempt=_attempt, t0=_t0)
        if kind == "mset":
            by_shard = self.router.split(list(op[1]))
            if len(by_shard) == 1:
                ((s, pairs),) = by_shard.items()
                return self._one(s, mset_req(pairs), cb,
                                 op=op, attempt=_attempt, t0=_t0)
            return self._mset_2pc(by_shard, cb)
        raise ValueError(f"unknown service op {kind!r}")

    def _one(self, shard: int, payload: bytes,
             cb: Optional[Callable[[bytes, float], None]],
             op: Optional[tuple] = None, attempt: int = 0,
             t0: Optional[float] = None) -> None:
        if t0 is None:
            t0 = self.sim.now

        def done(result: bytes, lat: float) -> None:
            # live split/merge bounces: a shard that froze or handed off
            # the key's range answers deterministically; re-route rather
            # than surface the bounce (until the retry budget runs out)
            if op is not None and attempt < self.max_route_retries:
                if result == b"FROZEN":
                    # The range still lives at this shard but is
                    # write-locked for transfer.  Do NOT poll: every
                    # premature retry costs the *source* shard a consensus
                    # slot, and on a hot shard that surge is what pushes
                    # the queue past the §5.4 direct-copy horizon (where
                    # every slot decays to the slow-path kick).  Wait for
                    # the router-epoch bump that ends the transfer, with a
                    # capped-exponential timer as the fallback for a
                    # crashed control plane.
                    fired: dict = {}

                    def go() -> None:
                        if fired:
                            return
                        fired["x"] = 1
                        self.request(op, cb, _attempt=attempt + 1, _t0=t0)

                    delay = self.retry_delay_us * (
                        2 ** min(attempt, self.retry_backoff_max))
                    self.service._epoch_waiters.append(go)
                    self.sim.after(delay, go)
                    return
                if result[:5] == b"MOVED" and len(result) == 7:
                    (tgt,) = struct.unpack("<H", result[5:])
                    if op[0] in ("get", "set"):
                        # the reply names the adopting shard: chase it
                        # directly — the shared routing table may not have
                        # committed the epoch bump yet
                        self._one(tgt, payload, cb, op=op,
                                  attempt=attempt + 1, t0=t0)
                    else:
                        # multi-key op: re-split via the routing table
                        self.sim.after(
                            self.retry_delay_us,
                            lambda: self.request(op, cb,
                                                 _attempt=attempt + 1,
                                                 _t0=t0))
                    return
            end_lat = lat if attempt == 0 else self.sim.now - t0
            self.latencies.append(end_lat)
            if cb is not None:
                cb(result, end_lat)
        self._client_for(shard).request(payload, done)

    # -------------------------------------------------------- 2PC phases
    def _mset_2pc(self, by_shard: Dict[int, list],
                  cb: Optional[Callable[[bytes, float], None]]) -> None:
        t0 = self.sim.now
        shards = sorted(by_shard)
        coord = shards[0]
        # the txid's owner tag names the principal that submits the DECIDE:
        # this client's per-coordinator-shard uBFT client.  The consensus
        # layer authenticates that pid on every request (rid/client/sender
        # binding), so only *this* client can ever record a commit
        owner = self._client_for(coord).pid
        txid = make_txid(owner, self._txseq, self._tx_rng.getrandbits(64))
        self._txseq += 1
        deadline = t0 + self.service.tx_timeout_us
        votes: Dict[int, bytes] = {}

        def vote(s: int):
            def done(result: bytes, _lat: float) -> None:
                votes[s] = result
                if len(votes) == len(shards):
                    self._decide(txid, shards, coord, votes, cb, t0)
            return done

        for s in shards:
            self._client_for(s).request(
                tprep_req(txid, deadline, coord, by_shard[s]), vote(s))

    def _decide(self, txid: bytes, shards: List[int], coord: int,
                votes: Dict[int, bytes],
                cb: Optional[Callable[[bytes, float], None]],
                t0: float) -> None:
        if self.drop_decide:
            return      # "crashed" between PREPARE and DECIDE
        proposed = b"C" if all(v == VOTE_OK for v in votes.values()) else b"A"

        def decided(result: bytes, _lat: float) -> None:
            # the reply's recorded outcome is authoritative — a recovery
            # timer may have beaten a slow commit DECIDE to the log
            outcome = result[-1:] if result[:3] == b"OUT" else b"A"
            self._finish(txid, shards, outcome, cb, t0)

        self._client_for(coord).request(tdecide_req(txid, proposed),
                                         decided)

    def _finish(self, txid: bytes, shards: List[int], outcome: bytes,
                cb: Optional[Callable[[bytes, float], None]],
                t0: float) -> None:
        if self.drop_finish:
            return      # "crashed" between DECIDE and FINISH
        left = {"n": len(shards)}

        def done(_result: bytes, _lat: float) -> None:
            left["n"] -= 1
            if left["n"] == 0:
                lat = self.sim.now - t0
                self.latencies.append(lat)
                if cb is not None:
                    cb(b"OK" if outcome == b"C" else b"ABORTED", lat)

        for s in shards:
            self._client_for(s).request(tfinish_req(txid, outcome), done)


class _TxRecovery:
    """Per-replica presumed-abort recovery for abandoned transactions.

    Watches the replica's own execution stream (``on_execute_hooks``): a
    PREPARE that voted OK arms a timer at the transaction deadline (plus a
    per-replica stagger so recoverers probe in sequence rather than in a
    thundering herd).  If the intent is still pending when the timer fires,
    the replica **probes** the coordinator shard with a TXDEC message.
    Each coordinator replica answers with a *signed outcome statement*
    ``("txout", txid, outcome)``: if no outcome is recorded yet it first
    routes DECIDE(abort) through its own shard's consensus as the
    deterministic slot ``("svc", "tdec", txid)`` — presumed abort — and
    signs once the record exists.  (The owner-binding in
    :meth:`~repro.apps.kvstore.ShardKVApp` guarantees an internal DECIDE
    can only ever record ``A``, so these slots need no cross-shard
    verification.)

    f+1 matching statements form an **outcome certificate**; the recoverer
    then proposes a recovery FINISH carrying that certificate
    (:func:`~repro.apps.kvstore.rfinish_req`) into its own shard under the
    deterministic rid ``("svc", "tfin", txid, outcome)`` — concurrent
    recoverers collapse into one slot.  The certificate is the crux: a
    ``("svc", "tfin", ...)`` slot is only endorsed/certified
    (:attr:`~repro.core.consensus.UbftReplica.svc_validators`) when its
    payload's certificate verifies against the coordinator shard's
    membership, so *any* honest replica can vote for a legitimate recovery
    FINISH immediately — no local probe state needed, hence no circular
    wait between slot execution and probe completion — while a Byzantine
    leader's forged FINISH (no valid certificate) never collects an honest
    quorum and merely costs that leader its view.

    Probes re-arm until the intent resolves (a coordinator-shard view
    change mid-probe only delays recovery) and each re-probe replaces the
    previous one's reply bookkeeping, keyed by txid — the table stays
    bounded by the number of live abandoned transactions.

    Instances attach at service-attach time *and* — via
    ``Cluster.replace_hooks`` — to every joiner a membership epoch switch
    installs; a joiner arms probes for the pending intents it adopted via
    snapshot as soon as it activates (``on_activate_hooks``).
    """

    def __init__(self, service: "ShardedService", shard_idx: int,
                 replica: UbftReplica, stagger_us: float):
        self.service = service
        self.shard_idx = shard_idx
        self.replica = replica
        self.stagger_us = stagger_us
        #: recoverer role: txid -> signature collection for the live probe
        #: (re-probes replace their predecessor's entry: bounded by the
        #: number of still-pending abandoned transactions)
        self._sigwait: Dict[bytes, dict] = {}
        #: coordinator role: txid -> requester pids awaiting the outcome
        self._want_outcome: Dict[bytes, set] = {}
        #: txids with a live timer chain (dedupe execute- vs adopt-arming)
        self._armed: set = set()
        replica.on_execute_hooks.append(self._on_execute)
        replica.on_activate_hooks.append(self._arm_adopted)
        replica.svc_validators["tfin"] = self._tfin_certifiable
        replica.svc_validators["tdec"] = self._tdec_certifiable
        replica.handle("TXDEC", self._on_txdec)
        replica.handle("TXOUT", self._on_txout)

    def _on_execute(self, _slot: int, _rid: tuple, payload: bytes,
                    result: bytes) -> None:
        if payload[:1] == b"D" and result[:3] == b"OUT":
            # coordinator role: an outcome just became part of the record —
            # answer every probe that was waiting for it
            self._answer_outcome(payload[1:1 + TXID_LEN], result[-1:])
        if payload[:1] != b"P" or result != VOTE_OK:
            return
        parsed = parse_tprep(payload)
        if parsed is None:
            return
        txid, deadline, coord, _pairs = parsed
        self._arm(txid, deadline, coord)

    def _arm_adopted(self) -> None:
        """Joiner activation: the snapshot may carry pending intents whose
        PREPAREs executed before this replica existed — arm their timers
        now, or a shard whose original replicas are all gone would hold
        those locks forever."""
        for txid, (deadline, coord, _pairs) in \
                list(self.replica.app.pending.items()):
            self._arm(txid, deadline, coord)

    def _arm(self, txid: bytes, deadline: float, coord: int) -> None:
        if txid in self._armed:
            return
        self._armed.add(txid)
        delay = max(deadline - self.replica.sim.now, 0.0) + self.stagger_us
        self.replica.timer(delay, lambda: self._probe(txid, coord))

    def _probe(self, txid: bytes, coord: int) -> None:
        r = self.replica
        # a re-probe supersedes the previous one — drop its bookkeeping so
        # probes that never reached quorum cannot accumulate
        self._sigwait.pop(txid, None)
        if r.crashed:
            return
        if r.joining:
            # not yet a voting member: keep the timer chain alive and try
            # again once activated (activation also arms adopted intents)
            r.timer(self.service.tx_timeout_us,
                    lambda: self._probe(txid, coord))
            return
        if txid not in r.app.pending:
            self._armed.discard(txid)
            return
        if not 0 <= coord < len(self.service.shards):
            return      # malformed coordinator index: nothing to consult
        coord_cluster = self.service.shards[coord]
        self._sigwait[txid] = {
            "coord": coord, "by_outcome": {},
            "need": coord_cluster.replicas[0].f + 1,
        }
        body = (txid,)
        size = crypto.wire_size_shallow(body) + 19
        for pid in coord_cluster.replica_pids:   # resolved live: epoch-aware
            r.send(pid, "TXDEC", body, size=size)
        # re-probe until resolved (coordinator shard may be mid-view-change)
        r.timer(self.service.tx_timeout_us, lambda: self._probe(txid, coord))

    # --------------------------------------- coordinator role: TXDEC/TXOUT
    def _on_txdec(self, src: str, body: Any) -> None:
        """A recoverer asks this coordinator-shard replica for a signed
        outcome statement.  Recorded outcome → sign and answer.  None yet →
        route DECIDE(abort) through this shard's consensus (presumed abort)
        and answer once the record exists (``_on_execute``)."""
        r = self.replica
        if r.crashed or r.joining:
            return
        (txid,) = body
        if not (isinstance(txid, bytes) and len(txid) == TXID_LEN):
            return
        out = r.app.outcomes.get(txid)
        if out is not None:
            self._send_txout({src}, txid, out)
            return
        self._want_outcome.setdefault(txid, set()).add(src)
        r.propose_internal(("svc", "tdec", txid), tdecide_req(txid, b"A"))

    def _answer_outcome(self, txid: bytes, outcome: bytes) -> None:
        waiting = self._want_outcome.pop(txid, None)
        if waiting:
            self._send_txout(waiting, txid, outcome)

    def _send_txout(self, requesters: set, txid: bytes,
                    outcome: bytes) -> None:
        r = self.replica

        def signed(sig: bytes) -> None:
            body = (txid, outcome, sig)
            size = crypto.wire_size_shallow(body) + 19
            for pid in requesters:
                r.send(pid, "TXOUT", body, size=size)

        r.async_sign(("txout", txid, outcome), signed)

    # ------------------------------------------ recoverer role: collection
    def _on_txout(self, src: str, body: Any) -> None:
        txid, outcome, sig = body
        st = self._sigwait.get(txid)
        if st is None or outcome not in (b"C", b"A"):
            return

        def verified(ok: bool) -> None:
            cur = self._sigwait.get(txid)
            if not ok or cur is not st:
                return      # forged statement, or probe superseded meanwhile
            by = st["by_outcome"].setdefault(outcome, {})
            by[src] = sig
            if len(by) < st["need"]:
                return
            del self._sigwait[txid]
            cert = tuple(sorted(by.items()))
            self.replica.propose_internal(
                ("svc", "tfin", txid, outcome),
                rfinish_req(txid, outcome, cert))

        self.replica.async_verify(src, ("txout", txid, outcome), sig,
                                  verified)

    # ------------------------------------------------- svc slot validation
    def _tdec_certifiable(self, rid: tuple, payload: bytes) -> bool:
        """An internal DECIDE slot is endorsable iff it is exactly a
        well-formed presumed-abort proposal: the state machine's
        owner-binding already makes any internal commit unrecordable, so
        abort-only framing is the whole check."""
        if len(rid) != 3:
            return False
        txid = rid[2]
        return (isinstance(txid, bytes) and len(txid) == TXID_LEN
                and payload == tdecide_req(txid, b"A"))

    def _tfin_certifiable(self, rid: tuple, payload: bytes) -> bool:
        """May this replica endorse/certify a ``("svc","tfin",...)`` slot?

        Malformed FINISH slots are never certified.  A FINISH for a
        transaction this shard no longer holds pending is harmless
        (``_finish_tx`` just records the outcome) and must be endorsed, or
        a replica whose intent already resolved would block the slot.  For
        a *still-pending* intent the outcome matters — C applies the
        pairs — so the payload must carry an outcome certificate: f+1
        signatures over ``("txout", txid, outcome)`` from current members
        of the transaction's coordinator shard.  f+1 guarantees at least
        one honest signer, and an honest coordinator replica only signs
        its shard's replicated outcome record.
        """
        if len(rid) != 4:
            return False
        _svc, _kind, txid, outcome = rid
        if not (isinstance(txid, bytes) and len(txid) == TXID_LEN
                and outcome in (b"C", b"A")):
            return False
        if not isinstance(payload, bytes):
            return False
        parsed = parse_rfinish(payload)
        if parsed is None or parsed[0] != txid or parsed[1] != outcome:
            return False
        entry = self.replica.app.pending.get(txid)
        if entry is None:
            return True
        coord = entry[1]
        if not 0 <= coord < len(self.service.shards):
            return False
        coord_cluster = self.service.shards[coord]
        members = set(coord_cluster.replica_pids)
        need = coord_cluster.replicas[0].f + 1
        good = {pid for pid, sig in parsed[2]
                if pid in members and self.replica.registry.verify(
                    pid, ("txout", txid, outcome), sig)}
        return len(good) >= need


class ShardedService:
    """K uBFT groups over one substrate, presented as one keyspace."""

    def __init__(self, substrate: Substrate, name: str,
                 shards: List[Cluster], router: ShardRouter,
                 tx_timeout_us: float, tx_secret: int = 0):
        self.substrate = substrate
        self.name = name
        self.shards = shards
        self.router = router
        self.tx_timeout_us = tx_timeout_us
        #: seeds each client's txid-nonce stream (stands in for per-client
        #: CSPRNG state; vary it to vary the nonces across runs)
        self.tx_secret = tx_secret
        self.clients: List[ServiceClient] = []
        #: every live recovery instance (originals + joiners), for
        #: observability and bounded-state assertions in tests
        self.recoveries: List[_TxRecovery] = []
        #: shard indices retired by a merge — still attached (in-flight
        #: 2PC outcome records must stay probeable) but unroutable
        self.retired: set = set()
        #: (sim time, kind, src_idx, dst_idx, ranges, router_epoch) per
        #: completed reshard operation
        self.reshards: List[tuple] = []
        #: (sim time, phase) per transfer state transition of the current
        #: reshard — where a split spends its time under load
        self.reshard_trace: List[tuple] = []
        #: clients parked on a FROZEN bounce, woken when the router epoch
        #: bumps (instead of polling the frozen shard with retry slots)
        self._epoch_waiters: List[Callable[[], None]] = []
        #: one reshard in flight at a time (the control plane serialises
        #: epoch bumps; concurrent splits would race on the router table)
        self.resharding = False
        # retained so split_shard can attach new groups with the same
        # shape as the original fleet (set by attach())
        self._app_factory: Callable[[], App] = ShardKVApp
        self._cfg: Optional[Any] = None
        self._budget: int = POOL_MEMORY_BUDGET
        self._pools: Optional[Any] = None
        #: self-heal every shard group (True / HealthConfig / dict); split-
        #: born shards inherit it because _wire_shard applies it
        self._self_heal: Optional[Any] = None

    @classmethod
    def attach(cls, substrate: Substrate, n_shards: int, name: str = "kv",
               cfg: Optional[Any] = None,
               app: Callable[[], App] = ShardKVApp,
               budget: int = POOL_MEMORY_BUDGET,
               tx_timeout_us: float = 20_000.0,
               tx_secret: int = 0,
               pools: Optional[Any] = None,
               self_heal: Optional[Any] = None) -> "ShardedService":
        """Attach ``n_shards`` groups (``<name>/s<i>``) to the substrate.

        ``cfg`` is one :class:`ConsensusConfig` shared by every shard
        (fixed per-shard config — the benchmark's scaling axis) or a
        callable ``cfg(i)`` for heterogeneous shards.  ``app`` must build
        a 2PC-capable store (:class:`~repro.apps.kvstore.ShardKVApp` or a
        subclass) when cross-shard MSETs will be issued.
        """
        if name in substrate.services:
            raise ValueError(f"service {name!r} already attached")
        router = ShardRouter(n_shards)
        shards: List[Cluster] = []
        for i in range(n_shards):
            kw: Dict[str, Any] = {}
            if pools is not None:
                kw["pools"] = pools
            shards.append(Cluster.attach(
                substrate, app, name=f"{name}/s{i}",
                cfg=(cfg(i) if callable(cfg) else cfg), budget=budget, **kw))
        svc = cls(substrate, name, shards, router, tx_timeout_us,
                  tx_secret=tx_secret)
        svc._app_factory = app
        svc._cfg = cfg
        svc._budget = budget
        svc._pools = pools
        svc._self_heal = self_heal
        for i, cluster in enumerate(shards):
            svc._wire_shard(i, cluster)
        substrate.services[name] = svc
        return svc

    def _wire_shard(self, idx: int, cluster: Cluster) -> None:
        """Attach the service-layer per-replica machinery to one shard:
        2PC recovery timers and the reshard-slot endorsement validators."""
        for ridx, r in enumerate(cluster.replicas):
            self.recoveries.append(
                _TxRecovery(self, idx, r, stagger_us=200.0 + 150.0 * ridx))
            self._install_reshard_validators(r)
        # membership epoch switches must not shrink the recovery
        # fleet: every joiner gets its own recovery instance, which
        # arms probes for snapshot-adopted intents on activation
        def on_replace(_old, joiner, _i=idx, _c=cluster):
            self.recoveries.append(_TxRecovery(
                self, _i, joiner,
                stagger_us=200.0 + 150.0 * _c.replicas.index(joiner)))
            self._install_reshard_validators(joiner)
        cluster.replace_hooks.append(on_replace)
        if self._self_heal:
            cluster.enable_self_healing(self._self_heal)

    # ------------------------------------------- reshard slot endorsement
    def _install_reshard_validators(self, replica: UbftReplica) -> None:
        v = replica.svc_validators
        v["sfreeze"] = self._freeze_certifiable
        v["scap"] = self._capture_certifiable
        v["scut"] = (lambda rid, payload, _r=replica:
                     self._cut_certifiable(rid, payload, _r))
        v["radopt"] = (lambda rid, payload, _r=replica:
                       self._adopt_certifiable(rid, payload, _r))

    @staticmethod
    def _range_rid_ok(fields) -> bool:
        """Shared well-formedness guard: a Byzantine leader controls rid
        contents, so every field is type- and bounds-checked before it
        reaches a struct.pack."""
        return (all(isinstance(x, int) and not isinstance(x, bool)
                    for x in fields)
                and 1 <= fields[0] < 2 ** 32          # modulus
                and 0 <= fields[1] < fields[0])        # residue

    @classmethod
    def _freeze_certifiable(cls, rid: tuple, payload: Any) -> bool:
        """``("svc","sfreeze", mod, res, target, repoch)`` — exact
        payload match.  A forged freeze is a pure liveness attack (writes
        to the range bounce until an operator intervenes, costing the
        Byzantine leader its view); it can never lose or plant data, so
        framing is the whole check."""
        if len(rid) != 6 or not cls._range_rid_ok(rid[2:]):
            return False
        mod, res, target, repoch = rid[2:]
        if not (0 <= target < 2 ** 16 and 0 <= repoch < 2 ** 32):
            return False
        return payload == freeze_req(mod, res, target, repoch)

    @classmethod
    def _capture_certifiable(cls, rid: tuple, payload: Any) -> bool:
        """``("svc","scap", mod, res, repoch)`` — exact payload match;
        the state machine refuses a capture without a prior freeze."""
        if len(rid) != 5 or not cls._range_rid_ok(rid[2:4]):
            return False
        mod, res, repoch = rid[2:]
        if not (isinstance(repoch, int) and 0 <= repoch < 2 ** 32):
            return False
        return payload == capture_req(mod, res)

    def _cut_certifiable(self, rid: tuple, payload: Any,
                         replica: UbftReplica) -> bool:
        """``("svc","scut", mod, res, target, repoch)``: endorsed only
        with f+1 target-shard signatures over ``("adopted", ...)`` in the
        payload — the cut deletes the range at the source, so it must be
        provably preceded by a committed adoption, or a Byzantine leader
        could destroy data with a forged freeze/capture/cut sequence."""
        if len(rid) != 6 or not self._range_rid_ok(rid[2:]):
            return False
        mod, res, target, repoch = rid[2:]
        if not (0 <= target < 2 ** 16 and 0 <= repoch < 2 ** 32):
            return False
        if not isinstance(payload, bytes):
            return False
        parsed = parse_cut(payload)
        if parsed is None or parsed[:4] != (mod, res, target, repoch):
            return False
        if not 0 <= target < len(self.shards):
            return False
        tgt = self.shards[target]
        members = set(tgt.replica_pids)
        need = tgt.replicas[0].f + 1
        good = {pid for pid, sig in parsed[4]
                if pid in members and replica.registry.verify(
                    pid, ("adopted", mod, res, repoch), sig)}
        return len(good) >= need

    def _adopt_certifiable(self, rid: tuple, payload: Any,
                           replica: UbftReplica) -> bool:
        """``("svc","radopt", src_idx, mod, res, repoch)``: endorsed only
        when the payload's pairs match its fingerprint and f+1 *source*
        shard members signed ``("resh", mod, res, repoch, fp)`` — so a
        Byzantine leader of the adopting shard cannot plant forged keys
        via a fabricated adopt slot (mirrors the recovery FINISH's
        outcome certificate)."""
        if len(rid) != 6:
            return False
        src_idx, mod, res, repoch = rid[2:]
        if not all(isinstance(x, int) and not isinstance(x, bool)
                   for x in rid[2:]):
            return False
        if not isinstance(payload, bytes):
            return False
        parsed = parse_adopt(payload)
        if parsed is None or parsed[:4] != (mod, res, src_idx, repoch):
            return False
        if not 0 <= src_idx < len(self.shards):
            return False
        pairs, cert = parsed[4], parsed[5]
        fp = range_fp(mod, res, repoch, pairs)
        src = self.shards[src_idx]
        members = set(src.replica_pids)
        need = src.replicas[0].f + 1
        good = {pid for pid, sig in cert
                if pid in members and replica.registry.verify(
                    pid, ("resh", mod, res, repoch, fp), sig)}
        return len(good) >= need

    # ------------------------------------------------------- split / merge
    #: control-plane poll cadence (µs) while a reshard is in flight.  The
    #: cadence bounds the freeze window: while a range is frozen its
    #: writes bounce, and every bounce costs the *source* shard a
    #: consensus slot — on a hot shard a leisurely control plane lets
    #: that surge push the queue past the §5.4 direct-copy horizon, where
    #: every slot decays to the slow-path kick.  Microsecond polls keep
    #: the whole transfer well under that cliff.
    _POLL_US = 25.0
    #: register re-read cadence (µs) while a target replica waits for f+1
    #: matching published ranges
    _PULL_RETRY_US = 150.0

    def split_shard(self, idx: int,
                    when_done: Optional[Callable[[], None]] = None) -> int:
        """Split shard ``idx``: attach a fresh 2f+1 group as shard
        ``len(shards)`` and hand it the upper child of ``idx``'s coarsest
        key range (``router.peek_split``).  Returns the new shard index
        immediately; the transfer runs asynchronously (freeze → drain →
        capture → publish via the shared pools → adopt → cut → router
        epoch bump) — drive the simulator and watch ``reshards`` or pass
        ``when_done``."""
        if self.resharding:
            raise RuntimeError("a reshard operation is already in flight")
        if not 0 <= idx < len(self.shards) or idx in self.retired:
            raise ValueError(f"cannot split shard {idx}")
        self.resharding = True
        rng = self.router.peek_split(idx)
        new_idx = len(self.shards)
        kw: Dict[str, Any] = {}
        if self._pools is not None:
            kw["pools"] = self._pools
        cluster = Cluster.attach(
            self.substrate, self._app_factory,
            name=f"{self.name}/s{new_idx}",
            cfg=(self._cfg(new_idx) if callable(self._cfg) else self._cfg),
            budget=self._budget, **kw)
        self.shards.append(cluster)
        self._wire_shard(new_idx, cluster)
        repoch = self.router.epoch + 1

        def commit() -> None:
            moved = self.router.commit_split(idx, new_idx)
            assert moved == rng and self.router.epoch == repoch
            self.reshards.append(
                (self.sim.now, "split", idx, new_idx, (rng,), repoch))

        self._move_ranges(idx, new_idx, [rng], repoch, commit, when_done)
        return new_idx

    def merge_shards(self, src_idx: int, dst_idx: int,
                     when_done: Optional[Callable[[], None]] = None) -> None:
        """Merge shard ``src_idx`` into ``dst_idx``: every range of the
        source moves (same freeze/transfer/cut pipeline as a split, over
        all of its ranges), then the source index is retired.  The
        retired group stays attached — its 2PC outcome records must
        remain probeable by recovery — but is unroutable from the table
        on."""
        if self.resharding:
            raise RuntimeError("a reshard operation is already in flight")
        if src_idx == dst_idx:
            raise ValueError("merge needs two distinct shards")
        for i in (src_idx, dst_idx):
            if not 0 <= i < len(self.shards) or i in self.retired:
                raise ValueError(f"cannot merge shard {i}")
        self.resharding = True
        ranges = self.router.ranges_of(src_idx)
        repoch = self.router.epoch + 1

        def commit() -> None:
            self.router.commit_merge(src_idx, dst_idx)
            assert self.router.epoch == repoch
            self.retired.add(src_idx)
            self.shards[src_idx].retired = True
            self.reshards.append(
                (self.sim.now, "merge", src_idx, dst_idx, tuple(ranges),
                 repoch))

        self._move_ranges(src_idx, dst_idx, ranges, repoch, commit,
                          when_done)

    # ------------------------------------------------ transfer state machine
    def _live(self, cluster: Cluster) -> List[UbftReplica]:
        return [r for r in cluster.replicas
                if not r.crashed and not r.joining]

    def _quorum(self, cluster: Cluster, pred) -> bool:
        need = cluster.replicas[0].f + 1
        return sum(1 for r in self._live(cluster) if pred(r)) >= need

    def _poll(self, cond, then, tick=None) -> None:
        def probe() -> None:
            if tick is not None:
                tick()
            if cond():
                then()
            else:
                self.sim.after(self._POLL_US, probe)
        probe()

    def _move_ranges(self, src_idx: int, dst_idx: int,
                     ranges: List[Tuple[int, int]], repoch: int,
                     commit: Callable[[], None],
                     when_done: Optional[Callable[[], None]]) -> None:
        """Drive one set of key ranges from ``src_idx`` to ``dst_idx``.

        Every state transition is either a BFT slot in an affected
        shard's log (freeze, capture, adopt, cut) or a write/read of the
        shared register pools (the captured range travels the same
        disaggregated-memory path as a membership state transfer); the
        control plane itself only *observes* replica state and submits
        the next slot — it holds no authority any replica trusts, so a
        crashed control plane strands no shard in an unsafe state (a
        frozen range is an availability, not a safety, condition)."""
        src, dst = self.shards[src_idx], self.shards[dst_idx]
        ranges = [tuple(rng) for rng in ranges]
        self.reshard_trace = [(self.sim.now, "start")]
        trace = lambda ph: self.reshard_trace.append((self.sim.now, ph))

        def frozen(rep) -> bool:
            return all((m, r) in rep.app.moving or (m, r) in rep.app.handoff
                       for (m, r) in ranges)

        def drained(rep) -> bool:
            return not any(key_in_range(k, m, r)
                           for (m, r) in ranges for k in rep.app.locks)

        def captured(rep) -> bool:
            return all((m, r) in rep.app.outbound
                       or (m, r) in rep.app.handoff
                       for (m, r) in ranges)

        def adopted(rep) -> bool:
            return all(rep.app.adopted.get((m, r)) == repoch
                       for (m, r) in ranges)

        def cut_done(rep) -> bool:
            return all((m, r) in rep.app.handoff for (m, r) in ranges)

        # 1. FREEZE every moving range: from that log position on, writes
        #    and new PREPAREs bounce; reads are still served at the source
        for (m, r) in ranges:
            src.submit_internal(("svc", "sfreeze", m, r, dst_idx, repoch),
                                freeze_req(m, r, dst_idx, repoch))

        # 2. drain in-flight 2PC: transactions prepared under the old
        #    epoch hold in-range locks and must finish at the source (the
        #    freeze stops new in-range locks, recovery timers bound the
        #    wait), then CAPTURE fixes the outbound snapshot in the log
        def capture() -> None:
            trace("drained")
            for (m, r) in ranges:
                src.submit_internal(("svc", "scap", m, r, repoch),
                                    capture_req(m, r))
            self._poll(lambda: self._quorum(src, captured), publish)

        # 3. PUBLISH: each live source replica signs its (deterministic)
        #    captured range and writes it into its own resh/ register —
        #    the transfer rides the shared pools, not replica-to-replica
        #    messages, exactly like a membership state transfer
        published: set = set()

        def publish_tick() -> None:
            for rep in self._live(src):
                for (m, r) in ranges:
                    if ((rep.pid, m, r) in published
                            or (m, r) not in rep.app.outbound):
                        continue
                    published.add((rep.pid, m, r))
                    self._publish_range(rep, m, r, repoch)

        def publish() -> None:
            trace("captured")
            publish_tick()
            # 4. ADOPT: every live target replica pulls the range from
            #    f+1 matching registers and proposes the adopt slot
            for d in self._live(dst):
                for (m, r) in ranges:
                    self._pull_range(d, src, src_idx, m, r, repoch)
            self._poll(lambda: self._quorum(dst, adopted), cut_phase,
                       tick=publish_tick)

        # 5. CUT: only after the adoption has provably committed at the
        #    target (f+1 signatures ride the cut slot's certificate) does
        #    the source drop the range and start answering MOVED
        def cut_phase() -> None:
            trace("adopted")
            for (m, r) in ranges:
                self._collect_adoption_cert(
                    dst, m, r, repoch,
                    lambda cert, m=m, r=r: src.submit_internal(
                        ("svc", "scut", m, r, dst_idx, repoch),
                        cut_req(m, r, dst_idx, repoch, cert)))
            self._poll(lambda: self._quorum(src, cut_done), finish)

        # 6. the router-table mutation commits last: every client routing
        #    on the old table in the meantime was answered FROZEN/MOVED,
        #    never with stale data
        def finish() -> None:
            trace("cut")
            commit()
            self.resharding = False
            waiters, self._epoch_waiters = self._epoch_waiters, []
            for w in waiters:
                self.sim.after(0.0, w)
            if when_done is not None:
                when_done()

        self._poll(lambda: self._quorum(src, frozen),
                   lambda: (trace("frozen"),
                            self._poll(lambda: self._quorum(src, drained),
                                       capture))[-1])

    def _publish_range(self, rep: UbftReplica, m: int, r: int,
                       repoch: int) -> None:
        pairs = rep.app.outbound[(m, r)]
        fp = range_fp(m, r, repoch, pairs)

        def signed(sig: bytes) -> None:
            rep.regs.write(f"resh/{repoch}/{m}/{r}",
                           crypto.encode((pairs, sig)), lambda: None)

        rep.async_sign(("resh", m, r, repoch, fp), signed)

    def _pull_range(self, d: UbftReplica, src_cluster: Cluster,
                    src_idx: int, m: int, r: int, repoch: int) -> None:
        """One target replica pulls a published range: read every source
        replica's ``resh/`` register (routed under the *source* cluster's
        namespace), verify each signature against the advertised pairs,
        and propose the adopt slot once f+1 registers agree on one
        fingerprint.  Retries on a timer until the adoption executes —
        registers survive source-replica crashes, so f+1 completed
        publishes are durable."""
        reg = f"resh/{repoch}/{m}/{r}"
        need = src_cluster.replicas[0].f + 1

        def attempt() -> None:
            if (d.crashed or d.joining
                    or d.app.adopted.get((m, r)) == repoch):
                return
            got: Dict[str, tuple] = {}

            def mk(pid: str):
                def cb(val, _byz) -> None:
                    if val is None or d.app.adopted.get((m, r)) == repoch:
                        return
                    try:
                        pairs, sig = crypto.decode(val[1])
                    except Exception:
                        return      # torn/garbage blob: ignore this reader
                    pairs = tuple((bytes(k), bytes(v)) for (k, v) in pairs)
                    fp = range_fp(m, r, repoch, pairs)
                    if not d.registry.verify(
                            pid, ("resh", m, r, repoch, fp), sig):
                        return
                    got[pid] = (fp, pairs, sig)
                    by_fp: Dict[bytes, list] = {}
                    for p, (f_, pr, s) in got.items():
                        by_fp.setdefault(f_, []).append((p, pr, s))
                    for entries in by_fp.values():
                        if len(entries) >= need:
                            cert = tuple(sorted(
                                (p, s) for p, _pr, s in entries))
                            d.propose_internal(
                                ("svc", "radopt", src_idx, m, r, repoch),
                                adopt_req(m, r, src_idx, repoch,
                                          entries[0][1], cert))
                            return
                return cb

            for pid in src_cluster.replica_pids:
                d.regs.read(pid, reg, mk(pid), namespace=src_cluster.name)
            d.timer(self._PULL_RETRY_US, attempt)

        attempt()

    def _collect_adoption_cert(self, dst: Cluster, m: int, r: int,
                               repoch: int, cb) -> None:
        """Gather f+1 target-replica signatures over
        ``("adopted", m, r, repoch)`` — the evidence the cut slot carries."""
        need = dst.replicas[0].f + 1
        sigs: Dict[str, Optional[bytes]] = {}
        state = {"done": False}

        def tick() -> None:
            if state["done"]:
                return
            for d in self._live(dst):
                if d.pid in sigs or d.app.adopted.get((m, r)) != repoch:
                    continue
                sigs[d.pid] = None      # signature in flight

                def signed(sig: bytes, pid: str = d.pid) -> None:
                    if state["done"]:
                        return
                    sigs[pid] = sig
                    good = {p: s for p, s in sigs.items() if s is not None}
                    if len(good) >= need:
                        state["done"] = True
                        cb(tuple(sorted(good.items())[:need]))

                d.async_sign(("adopted", m, r, repoch), signed)
            if not state["done"]:
                self.sim.after(self._POLL_US, tick)

        tick()

    # --------------------------------------------- Cluster-like interface
    @property
    def sim(self):
        return self.substrate.sim

    def new_client(self, pid: Optional[str] = None) -> ServiceClient:
        if pid is None:
            pid = f"{self.name}/c{len(self.clients)}"
        c = ServiceClient(self, pid)
        self.clients.append(c)
        return c

    def run_op(self, client: ServiceClient, op: tuple,
               timeout: float = 1_000_000.0) -> Tuple[bytes, float]:
        """Issue one operation and run the simulation to completion."""
        box: dict = {}

        def done(result: bytes, lat: float) -> None:
            box["result"] = result
            box["lat"] = lat

        client.request(op, done)
        ok = self.sim.run_until(lambda: "result" in box, timeout=timeout)
        if not ok:
            raise TimeoutError(f"service op {op[0]!r} did not complete "
                               f"within {timeout} µs (t={self.sim.now})")
        return box["result"], box["lat"]
