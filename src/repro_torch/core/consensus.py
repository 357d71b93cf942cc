"""uBFT consensus + SMR replica — Algorithms 2, 3, 4, 5 of the paper.

Layout of one replica (Figure 2):

    RPC ──> consensus ──> execution ──> RPC reply
             │  fast path: CTBcast(PREPARE) → TB(WILL_CERTIFY) → TB(WILL_COMMIT)
             │  slow path: CTBcast(PREPARE) → TB(CERTIFY,σ) → CTBcast(COMMIT,P_Σ)
             └─ view change: CTBcast(SEAL_VIEW) → direct CRTFY_VC → CTBcast(NEW_VIEW)

Every replica owns one CTBcast *instance per broadcaster* and interprets each
peer's CTBcast messages in FIFO order (Alg. 2 line 1), applying the Byzantine
checks of Algorithm 5 before accepting each message; a check violation
*blocks* that peer permanently.  Tail-validity gaps are healed by CTBcast
summaries (Algorithm 4): the broadcaster blocks every t/2 broadcasts until
f+1 receivers certify a digest of its recent window (double buffering,
footnote 3), and the resulting SUMMARY lets laggards jump their FIFO pointer.

Memory is practically bounded: prepares/commits/promises are dropped when the
application checkpoint (f+1 signed) slides the consensus window forward.

Hot path extensions beyond the paper's evaluation (§9 discusses throughput):
the unit of agreement is a *batch* of client requests (``as_batch``) — the
leader coalesces up to ``max_batch`` pending requests per CTBcast slot and
up to ``pipeline_depth`` slots are in flight concurrently, so throughput is
no longer bound to one request per protocol round.  Replicas execute batches
atomically and reply per-request; all safety invariants (agreement,
integrity, bounded memory) hold over batches.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Set, Tuple

from repro_torch.core import crypto
from repro_torch.core.crypto import SignedBundle
from repro_torch.core.ctbcast import CTBcast
from repro_torch.core.membership import MembershipEpoch
from repro_torch.core.node import Node
from repro_torch.core.registers import RegisterClient
from repro_torch.core.tbcast import TBcastService
from repro_torch.sim.events import Simulator
from repro_torch.sim.net import NetworkModel


# --------------------------------------------------------------------------
# Configuration
# --------------------------------------------------------------------------
@dataclass
class AdmissionConfig:
    """SLO-aware admission control at the leader (the serving plane).

    When the leader's client backlog (requests accepted but not yet
    executed — the queue depth against the §5.4 direct-copy horizon)
    exceeds ``queue_high``, newly echoed client requests are not fed
    into the pipeline; instead the leader proposes an agreed *shed
    marker* ``(("shed", rid), "", b"")`` for them.  Executing the marker
    makes every honest replica send the identical deterministic
    ``reply`` (default ``b"BUSY"``), so the client completes on the
    normal f+1 matching-reply quorum instead of timing out into the
    collapsing queue.

    Sheds are *agreed*, and followers are their auditors: a replica only
    endorses (or signs a certificate over) a shed-bearing slot while its
    own backlog is at least ``queue_accept`` — a Byzantine leader
    shedding honest requests under light load never collects an honest
    certificate quorum and loses its view to the normal progress timer.
    """
    queue_high: int = 64           # leader sheds above this backlog
    queue_accept: Optional[int] = None   # follower vouch floor (default high/2)
    max_shed: int = 8              # shed markers per batch slot
    reply: bytes = b"BUSY"         # deterministic agreed reply

    def accept_floor(self) -> int:
        if self.queue_accept is not None:
            return self.queue_accept
        return max(1, self.queue_high // 2)


@dataclass
class ConsensusConfig:
    window: int = 256          # consensus slots per checkpoint (§7)
    t: int = 128               # CTBcast tail parameter (§7)
    f: int = 1                 # Byzantine replicas tolerated (n = 2f+1)
    f_m: int = 1               # crash-faulty memory nodes (2f_m+1 total)
    slow_after_us: float = 400.0   # fast→slow escalation timeout
    view_timeout_us: float = 4000.0
    fast_enabled: bool = True
    ctb_fast_enabled: bool = True  # CTBcast's own fast path (LOCK/LOCKED)
    slow_mode: str = "timeout"     # "timeout" | "always" (bench the slow path)
    echo_timeout_us: float = 100.0
    max_request_bytes: int = 8192
    # --- batching + pipelining (the consensus hot path) ---------------
    # The unit of agreement is a *batch*: the leader coalesces up to
    # ``max_batch`` pending requests (bounded by ``max_batch_bytes`` of
    # payload) into one CTBcast slot; replicas execute batches atomically
    # and reply per-request.  ``max_batch=1`` is the paper's
    # one-request-per-slot configuration.
    max_batch: int = 1
    max_batch_bytes: int = 16384
    # With queued requests and a non-full batch, wait up to this long for
    # more to coalesce (0 = propose immediately; batches still form under
    # backpressure from the pipeline cap).
    batch_timeout_us: float = 0.0
    # Max consensus slots in flight (proposed but not yet executed) —
    # slots no longer lock-step one decided round at a time.
    pipeline_depth: int = 64
    # Decision gap repair: a replica whose execution is stalled behind an
    # undecided slot while a *later* slot is already decided pulls the
    # missing commit certificate from current members after this grace
    # period (then retries at the same cadence).  None disables the
    # repair path entirely — no timers, no wire traffic (the default:
    # recorded scenarios predate the mechanism).  The self-healing
    # membership layer turns it on.
    gap_repair_us: Optional[float] = None
    # SLO-aware admission control (the serving plane).  None — the
    # default, and every recorded scenario — disables shedding entirely:
    # no shed markers are proposed, validated, or accepted on the wire.
    admission: Optional[AdmissionConfig] = None


# --------------------------------------------------------------------------
# Application interface (the replicated state machine)
# --------------------------------------------------------------------------
class App:
    """Deterministic state machine: bytes request -> bytes response."""

    def apply(self, req: bytes) -> bytes:  # pragma: no cover - interface
        raise NotImplementedError

    def apply_from(self, caller: str, req: bytes) -> bytes:
        """Caller-aware apply.  ``caller`` is the authenticated pid of the
        submitting client — it is part of the agreed batch (and checked
        against the network sender at REQ ingress), so every honest
        replica hands the same caller to the same request and determinism
        is preserved.  ``""`` marks internally-originated requests
        (service-level ``("svc", ...)`` slots).  The default ignores the
        caller; apps enforcing caller-bound operations (e.g. the 2PC
        coordinator's owner-only commit-DECIDE) override this."""
        return self.apply(req)

    def cost_us(self, req: bytes) -> float:
        """Deterministic execution cost of one request in simulated µs.

        The default (0.0 — and any app that does not override this) keeps
        execution instantaneous, exactly the pre-serving-plane behaviour.
        An app that overrides it (e.g. the token server charging roofline
        decode time per generated token) turns on the deferred execution
        engine: each decided slot occupies the replica's serial app engine
        for the batch's summed cost before it applies, so ``exec_upto``
        lags the decided frontier by the true service backlog.  Must be a
        pure function of the request bytes and the app state at the
        slot's execution point — every honest replica computes it at the
        same state, so the engine stays deterministic."""
        return 0.0

    def snapshot(self) -> Any:
        return None

    def adopt(self, snap: Any) -> None:
        pass

    def snapshot_fp(self) -> bytes:
        return crypto.fingerprint_cached(self.snapshot())


# --------------------------------------------------------------------------
# Per-peer consensus state (Alg. 2 lines 6-12)
# --------------------------------------------------------------------------
@dataclass
class PeerState:
    view: int = 0
    seal_view: Optional[int] = None
    new_view: Optional[Any] = None
    noncp_msgs_in_view: int = 0    # non-CHECKPOINT messages since last SEAL_VIEW
    prepares: Dict[int, Tuple[int, Any]] = field(default_factory=dict)  # slot -> (view, req)
    commits: Dict[int, Any] = field(default_factory=dict)               # slot -> commit cert
    checkpoint: Optional[Any] = None
    blocked: bool = False          # Byzantine message observed → stop
    # False while this peer's view lineage is unknown to us: either we
    # joined after the peer last sealed a view (the replayed seals were
    # epoch-gated out), or the peer sealed into a future epoch we have
    # not applied yet.  While unsynced, Byzantine-check failures drop the
    # message instead of blocking the stream — an honest peer whose view
    # we simply cannot know yet must not be cut off forever.  The first
    # same-epoch SEAL_VIEW re-establishes the view and restores strict
    # checking.
    view_synced: bool = True
    # FIFO reorder machinery for this peer's CTBcast stream
    fifo_pending: Dict[int, Any] = field(default_factory=dict)
    fifo_next: int = 0
    recent: Dict[int, Any] = field(default_factory=dict)  # last t processed (k -> msg)


def _cp_payload(start: int, window: int, app_fp: bytes) -> tuple:
    return ("cp", start, window, app_fp)


def _noop_request(v: int, s: int) -> tuple:
    """⊥ proposal used by a new leader to fill unconstrained holes."""
    return (("noop", v, s), "", b"")


def as_batch(reqs: Any) -> tuple:
    """Normalize a PREPARE payload to a batch: a tuple of request triples.

    The legacy wire format carried a single ``(rid, client, payload)``
    triple per slot; batched PREPAREs carry a tuple of such triples.  The
    unit of agreement (what gets fingerprinted, certified and decided) is
    always the normalized batch, so both formats agree on encoding.
    """
    if (isinstance(reqs, tuple) and len(reqs) == 3 and
            isinstance(reqs[1], str) and isinstance(reqs[2], bytes)):
        return (reqs,)
    return tuple(reqs)


class Checkpoint:
    """An f+1-signed application checkpoint (genesis has no sigs)."""

    def __init__(self, start: int, window: int, app_fp: bytes,
                 sigs: Tuple[Tuple[str, bytes], ...] = ()):  # ((pid, sig), ...)
        self.start = start
        self.window = window
        self.app_fp = app_fp
        self.sigs = sigs
        # cached: ``s in cp.open_slots`` runs several times per message and
        # a fresh range() per access showed up in the hot-path profile
        self._open = range(start, start + window)

    @property
    def open_slots(self) -> range:
        return self._open

    def payload(self) -> tuple:
        return _cp_payload(self.start, self.window, self.app_fp)

    def supersedes(self, other: "Checkpoint") -> bool:
        return self.start > other.start

    def valid(self, registry: crypto.KeyRegistry, quorum: int) -> bool:
        if self.start == 0:
            return True  # genesis
        pids = {pid for pid, _ in self.sigs}
        return (len(pids) >= quorum and
                all(registry.verify(pid, self.payload(), sig)
                    for pid, sig in self.sigs))

    def to_wire(self) -> tuple:
        return ("CPCERT", self.start, self.window, self.app_fp, tuple(self.sigs))

    @staticmethod
    def from_wire(w: tuple) -> "Checkpoint":
        _tag, start, window, app_fp, sigs = w
        return Checkpoint(start, window, app_fp, tuple(sigs))


# --------------------------------------------------------------------------
# The replica
# --------------------------------------------------------------------------
class UbftReplica(Node):
    """A uBFT replica: consensus engine + execution + RPC endpoint."""

    #: per-request framing inside a batched slot (rid + client id wire
    #: bytes on top of crypto.REQUEST_WIRE_OVERHEAD's length header)
    _REQ_FRAMING = crypto.REQUEST_WIRE_OVERHEAD + 64

    def __init__(self, sim: Simulator, net: NetworkModel,
                 registry: crypto.KeyRegistry, pid: str,
                 replicas: List[str], mem_nodes,
                 app: App, cfg: Optional[ConsensusConfig] = None,
                 namespace: str = "", joining: bool = False,
                 epoch: int = 0):
        # ``mem_nodes``: a bare pid list (legacy static TCB), one
        # ``MemoryPool`` or a list of pools (sharded disaggregated memory) —
        # handed to RegisterClient, which shards register keys across pools
        # and tracks pool membership across reconfigurations; every CTBcast
        # instance below rides the same pool-aware client.
        # ``namespace`` is the application name when many replicated
        # applications share one substrate: register keys shard by
        # ``crc32(app:owner:reg)`` so each app spreads over the shared
        # pools independently ("" = legacy single-app layout).
        # ``joining``/``epoch``: a replacement replica is installed
        # *non-voting* (``joining=True``) with ``replicas`` naming the
        # current epoch's members (itself excluded); it observes but casts
        # no votes until the epoch bump commits through a consensus slot
        # and f+1 members of the new epoch confirm the switch (EPOCH).
        super().__init__(sim, net, registry, pid)
        self.namespace = namespace
        self.cfg = cfg or ConsensusConfig()
        self.membership = MembershipEpoch(epoch, tuple(replicas))
        self.replicas = list(replicas)
        self.n = len(replicas)
        self.f = self.cfg.f
        assert self.n == 2 * self.f + 1, "uBFT runs with 2f+1 replicas"
        assert self.cfg.max_batch >= 1 and self.cfg.pipeline_depth >= 1, \
            "max_batch and pipeline_depth must be >= 1"
        self.quorum = self.f + 1
        self.joining = joining
        assert joining == (pid not in self.membership.replicas), \
            "a member replica must not join; a joiner is not yet a member"
        self._member_set = frozenset(replicas)
        #: pids replaced out of the group — their streams are stale-epoch
        self.retired: Set[str] = set()
        #: epoch -> (old_pid, new_pid) the control plane announced; a
        #: MEMBERSHIP slot only applies when it matches (a Byzantine leader
        #: cannot smuggle an unauthorised membership change past execution)
        self.pending_membership: Dict[int, Tuple[str, str]] = {}
        #: joiner activation: (epoch, members) -> confirming member pids
        self._epoch_votes: Dict[tuple, Set[str]] = {}
        self._epoch_view: Dict[tuple, int] = {}
        self._join_state: Optional[dict] = None
        #: completed switches, for the control plane / tests:
        #: (sim time, epoch, old_pid, new_pid)
        self.epoch_switches: List[Tuple[float, int, str, str]] = []
        self.app = app

        # A TBcast slot must hold the largest message: with batching that is
        # a PREPARE carrying up to max_batch_bytes of coalesced payload plus
        # per-request framing that scales with max_batch (Table 2 accounting
        # prices the batched slots honestly).
        slot_payload = max(self.cfg.max_request_bytes,
                           self.cfg.max_batch_bytes +
                           self.cfg.max_batch * self._REQ_FRAMING
                           if self.cfg.max_batch > 1 else 0)
        self.tb = TBcastService(self, t=self.cfg.t,
                                max_msg_bytes=slot_payload + 512)
        self.regs = RegisterClient(self, mem_nodes, self.cfg.f_m,
                                   namespace=namespace)

        # --- consensus state (Alg. 2 lines 1-12) ---
        self.view = 0
        self._leader_pid = replicas[0]  # cached replicas[view % n]
        self.next_slot = 0
        self.checkpoint = Checkpoint(0, self.cfg.window, app.snapshot_fp())
        # Participants I interpret CTBcast streams of: the current members,
        # plus myself when I am a joiner (not yet in the member list).
        participants = list(replicas)
        if pid not in self._member_set:
            participants.append(pid)
        self.state: Dict[str, PeerState] = {r: PeerState()
                                            for r in participants}
        for st in self.state.values():
            st.checkpoint = self.checkpoint
            # a joiner has no record of any peer's sealed views — the
            # replay epoch-gates out pre-join lineage, so strict view
            # checks must wait for each peer's first same-epoch seal
            st.view_synced = not joining
        #: app snapshots taken exactly at checkpoint boundaries — the only
        #: snapshots whose fingerprint a signed checkpoint can vouch for
        #: (served to joiners via XFER_REQ and published by publish_xfer)
        self._boundary_snaps: Dict[int, Any] = {0: app.snapshot()}

        self.decided: Dict[int, tuple] = {}        # slot -> request tuple
        self.exec_upto = -1                         # highest executed slot
        self.results: Dict[int, bytes] = {}
        self._last_cp_broadcast = 0

        # fast-path bookkeeping (bounded by window; pruned at checkpoints)
        self.will_certify: Dict[Tuple[int, int], Set[str]] = {}
        self.will_commit: Dict[Tuple[int, int], Set[str]] = {}
        self.my_will_certifies: Set[Tuple[int, int]] = set()
        self.my_will_commits: Set[Tuple[int, int]] = set()
        self.my_certified: Set[Tuple[int, int]] = set()
        self.my_prepared: Dict[int, Tuple[int, tuple]] = {}   # slot -> (view, req)
        self.certify_sigs: Dict[Tuple[int, int, bytes], Dict[str, bytes]] = {}
        self.my_commits: Dict[int, Any] = {}        # slot -> commit cert I broadcast
        #: slot -> sender -> cert: decided-slot certificates attached to a
        #: JOIN_SYNC (vouched by the sender, never on its stream)
        self.vouched_commits: Dict[int, Dict[str, Any]] = {}
        self.cp_sigs: Dict[tuple, Dict[str, bytes]] = {}

        # RPC / client handling
        self.pending_req: Dict[tuple, tuple] = {}   # rid -> request tuple
        self.echoes: Dict[tuple, Set[str]] = {}
        self.propose_queue: Deque[tuple] = deque()
        self.proposed_rids: Set[tuple] = set()
        self.decided_rids: Set[tuple] = set()
        self.waiting_prepare: Dict[tuple, List[Tuple[int, int]]] = {}
        # (v, s) -> rids of the batch still awaiting the clients' direct
        # copies; the slot is endorsed once the set drains (§5.4, batched)
        self.prepare_missing: Dict[Tuple[int, int], Set[tuple]] = {}
        self._batch_timer_armed = False
        self._batch_flush_due = False

        # view change
        self.vc_shares: Dict[Tuple[int, str], Dict[str, Tuple[bytes, bytes]]] = {}
        self.vc_snapshots: Dict[Tuple[int, str], Any] = {}
        self.changing_view = False
        self.new_view_sent: Set[int] = set()
        # views whose NEW_VIEW I (as leader) have FIFO-self-delivered —
        # next_slot is established by _repropose only then
        self.reproposed_views: Set[int] = set()
        self.progress_deadline: Optional[float] = None
        # Patience grows exponentially with consecutive failed views and
        # resets on progress (needed for liveness under eventual synchrony:
        # a view must eventually outlast the slow path).
        self.view_patience = self.cfg.view_timeout_us
        self.executed_rids: Set[tuple] = set()
        # Self-healing telemetry (core/health.py): per-replica health
        # signals latent in the protocol, kept as plain local counters —
        # zero wire traffic, so static/golden deployments are unaffected.
        # ``seated_past`` counts, per peer pid, the progress-timer
        # starvations this replica observed while that pid held the
        # leader's seat (the "repeated view changes seating past the same
        # pid" suspicion signal).
        self.health_counters: Dict[str, Any] = {
            "starvations": 0,       # own progress-deadline expiries
            "view_changes": 0,      # views this replica entered
            "seated_past": {},      # pid -> starvations under its lead
        }
        # fired with the abandoned leader's pid on every local
        # progress-deadline expiry — the health agent's event feed
        self.on_starvation_hooks: List[Callable[[str], None]] = []
        # Decision gap repair (cfg.gap_repair_us; off by default).  A
        # rotation retires one voucher per step, so a replica that joined
        # mid-stream can end up short of the f+1 COMMIT vouchers for a
        # slot decided around its join window — with nothing left on any
        # live stream to close the gap until the sender's next summary
        # boundary.  The repair path pulls the missing certificate from
        # current members instead of waiting.
        self.gap_repair_us: Optional[float] = self.cfg.gap_repair_us
        self._gap_repair_armed = False
        #: slot -> responder pid -> verified commit cert (pruned on decide)
        self.repair_votes: Dict[int, Dict[str, Any]] = {}
        self.gap_repairs = 0          # decisions recovered via repair

        # summaries (Alg. 4)
        self.summary_sigs: Dict[int, Dict[str, bytes]] = {}
        self._summary_digests: Dict[int, bytes] = {}  # k -> my stream digest

        # CTBcast instance per broadcaster (self included)
        self.ctb: Dict[str, CTBcast] = {}
        for p in participants:
            self.ctb[p] = CTBcast(
                self, self.tb, self.regs, broadcaster=p, group=replicas,
                t=self.cfg.t,
                deliver=(lambda k, m, p=p: self._ctb_deliver(p, k, m)),
                auto_slow_after_us=(0.0 if self.cfg.slow_mode == "always"
                                    else self.cfg.slow_after_us),
                on_summary_needed=(lambda seg, p=p: self._need_summary(seg))
                if p == pid else None,
                fast_enabled=self.cfg.ctb_fast_enabled,
            )
        self.my_ctb = self.ctb[pid]
        self.ctb_k = 0

        # TBcast streams for consensus messages — registered per kind so
        # the TB route memo lands directly on the specific handler (the
        # split-and-branch dispatch showed up in the hot-path profile).
        # NB: CERTIFY_CHECKPOINT before CERTIFY (prefix-matched).
        self.tb.register("cons/WILL_CERTIFY", self._on_will_certify)
        self.tb.register("cons/WILL_COMMIT", self._on_will_commit)
        self.tb.register("cons/CERTIFY_CHECKPOINT", self._on_tb_certify_cp)
        self.tb.register("cons/CERTIFY", self._on_tb_certify)
        self.tb.register("cons/SUMMARY", self._on_tb_summary)
        self.tb.register("cons/", self._on_tb_consensus)  # fallback

        # direct messages
        self.handle("REQ", self._on_client_request)
        self.handle("ECHO", self._on_echo)
        self.handle("CRTFY_VC", self._on_crtfy_vc)
        self.handle("CERTIFY_SUMMARY", self._on_certify_summary)
        self.handle("STATE_REQ", self._on_state_req)
        self.handle("STATE_RESP", self._on_state_resp)
        # membership epochs (replica replacement)
        self.handle("EPOCH", self._on_epoch)
        self.handle("JOIN_SYNC", self._on_join_sync)
        self.handle("XFER_REQ", self._on_xfer_req)
        self.handle("XFER_RESP", self._on_xfer_resp)
        # decision gap repair (self-healing deployments)
        self.handle("GAP_REPAIR_REQ", self._on_gap_repair_req)
        self.handle("GAP_REPAIR", self._on_gap_repair)

        # decided callback hooks (runtime integration)
        self.on_decide_hooks: List[Callable[[int, tuple], None]] = []
        # executed callback hooks (service integration): fired after the
        # app applied a request, with ``(slot, rid, payload, result)`` —
        # the sharded-service layer watches executed 2PC PREPAREs here to
        # arm its presumed-abort recovery timers
        self.on_execute_hooks: List[
            Callable[[int, tuple, bytes, bytes], None]] = []
        # fired when a joiner becomes a voting member (``joining`` flips
        # False) — the service layer re-arms recovery timers here for
        # pending 2PC intents adopted via the state-transfer snapshot,
        # which never pass through this replica's own execution stream
        self.on_activate_hooks: List[Callable[[], None]] = []
        # service-level endorsement validators, keyed by the svc request
        # kind (``("svc", kind, ...)`` rids): before this replica endorses
        # or signs a certificate over a slot containing such a request it
        # asks the registered validator whether the request is locally
        # justified (e.g. a 2PC FINISH matching a verified outcome).  A
        # blocked slot is re-checked periodically — a Byzantine leader
        # proposing an unjustifiable svc request never collects an honest
        # certificate quorum and eventually loses its view.  Kinds with no
        # registered validator are endorsed freely (legacy behaviour for
        # deployments without a service layer).
        self.svc_validators: Dict[str, Callable[[tuple, bytes], bool]] = {}
        self._svc_wait: Set[Tuple[int, int]] = set()

        # SLO-aware admission control (cfg.admission; the serving plane).
        # ``_client_backlog`` counts pending_req entries with a client
        # field — accepted-but-unexecuted client requests, i.e. the queue
        # depth against the execution horizon — maintained O(1) at the
        # _pend_put/_pend_pop choke points.
        self.shed_queue: Deque[tuple] = deque()   # rids queued to shed
        self._client_backlog = 0
        self.admission_stats: Dict[str, int] = {
            "shed": 0,           # rids this leader routed to the shed path
            "busy_replies": 0,   # BUSY replies executed here
            "dup_sheds": 0,      # shed markers that lost the race to apply
        }
        # Deferred execution engine (App.cost_us; the serving plane).
        # Checked once: apps that keep the zero-cost default execute
        # inline on the exact pre-existing path.
        self._app_has_cost = type(app).cost_us is not App.cost_us
        self._exec_inflight: Optional[int] = None
        self._exec_gen = 0
        if self._app_has_cost:
            # Node.timer swallows callbacks that fire while crashed, so a
            # crash mid-service would otherwise leave the engine wedged
            # on a completion that never arrives
            self.recover_hooks.append(self._exec_recover)

        # Per-stream high-water marks for slot-keyed TBcast votes, plus
        # the overflow-stream key counters (see _tb_slot_broadcast)
        self._tb_slot_hwm: Dict[str, int] = {}
        self._tb_overflow_k: Dict[str, int] = {}

        self._progress_timer_armed = False

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def leader(self, view: Optional[int] = None) -> str:
        if view is None:
            return self._leader_pid
        return self.replicas[view % self.n]

    def is_leader(self) -> bool:
        return self._leader_pid == self.pid

    def _ctb_broadcast(self, msg: tuple, slow: bool = False) -> None:
        k = self.ctb_k
        self.ctb_k += 1
        self.my_ctb.broadcast(k, msg, slow=slow)

    #: interned "cons/<kind>" stream names (an f-string per broadcast and a
    #: split per delivery showed up in the hot-path profile)
    _STREAMS: Dict[str, str] = {}

    def _tb_broadcast(self, stream: str, key: int, payload: Any) -> None:
        full = self._STREAMS.get(stream)
        if full is None:
            full = self._STREAMS[stream] = f"cons/{stream}"
        self.tb.broadcast(full, key, payload, self.replicas)

    def _tb_slot_broadcast(self, stream: str, s: int, payload: Any) -> None:
        """TBcast a per-slot vote, keyed by the slot — with a catch: TBcast
        receivers deliver strictly FIFO per (origin, stream), and the
        sender's window floor (``min_k``) skips them past any key it never
        buffered.  A vote for a slot *below* this stream's high-water mark
        (a re-certify in a later view, after an endorsement-gate refusal
        let higher slots overtake it) would therefore arrive below the
        receiver's FIFO pointer and be dropped as a duplicate forever —
        wedging the slot across every subsequent view.  Such votes ride a
        dedicated monotone-keyed overflow stream instead (``<stream>2``,
        prefix-routed to the same handler; the payload, not the key,
        carries the slot)."""
        hwm = self._tb_slot_hwm.get(stream, -1)
        if s > hwm:
            self._tb_slot_hwm[stream] = s
            self._tb_broadcast(stream, s, payload)
            return
        over = stream + "2"
        k = self._tb_overflow_k.get(over, 0)
        self._tb_overflow_k[over] = k + 1
        self._tb_broadcast(over, k, payload)

    def _pend_put(self, rid: tuple, req: tuple) -> None:
        """Insert into pending_req, keeping the client-backlog counter."""
        if rid not in self.pending_req and req[1] != "":
            self._client_backlog += 1
        self.pending_req[rid] = req

    def _pend_pop(self, rid: tuple) -> None:
        req = self.pending_req.pop(rid, None)
        if req is not None and req[1] != "":
            self._client_backlog -= 1

    # ==================================================================
    # RPC (client requests; §5.4 Echo round)
    # ==================================================================
    def _on_client_request(self, src: str, body: Any) -> None:
        rid, payload = body
        if not (isinstance(rid, tuple) and rid and rid[0] == src):
            # the rid's first element is the submitting pid, checked here
            # against the network-authenticated sender: a client cannot
            # submit requests under another client's identity, so the
            # ``client`` field of every decided request (and the caller
            # identity handed to ``App.apply_from``) is trustworthy
            return
        if len(payload) > self.cfg.max_request_bytes:
            # Oversized requests never enter the proposal path: an honest
            # leader proposing one would fail Algorithm 5's size check at
            # every follower and be blocked as Byzantine.  Reply with a
            # deterministic error so the client completes instead of
            # timing out (every replica sends the same reply).
            self.send(src, "REP", (rid, b"ERR_REQUEST_TOO_LARGE"))
            return
        req = (rid, src, payload)
        if rid in self.decided_rids:
            # retransmitted request — resend cached reply if executed
            for s, batch in self.decided.items():
                if s > self.exec_upto:
                    continue
                for i, r in enumerate(batch):
                    if r[0] == rid:
                        self.send(src, "REP", (rid, self.results[s][i]))
                        return
            return
        self._pend_put(rid, req)
        if len(self.pending_req) > 4 * self.cfg.window:  # Byzantine clients
            self._pend_pop(next(iter(self.pending_req)))
        # release any PREPARE that waited for the direct client copy; a
        # batched slot is endorsed once ALL its missing rids have arrived
        for (v, s) in self.waiting_prepare.pop(rid, []):
            miss = self.prepare_missing.get((v, s))
            if miss is None:
                self._endorse(v, s)
                continue
            miss.discard(rid)
            if not miss:
                del self.prepare_missing[(v, s)]
                self._endorse(v, s)
        if self.joining:
            return  # a non-voting joiner buffers but does not echo
        if self.is_leader():
            self._note_echo(rid, self.pid)
        else:
            self.send(self.leader(), "ECHO", (rid,))
            self._arm_progress_timer()

    def _on_echo(self, src: str, body: Any) -> None:
        (rid,) = body
        if self.is_leader():
            self._note_echo(rid, src)

    def _note_echo(self, rid: tuple, who: str) -> None:
        if who not in self._member_set:
            return  # only current-epoch members count toward echo quorums
        s = self.echoes.get(rid)
        if s is None:
            s = self.echoes[rid] = set()
        s.add(who)
        if rid in self.proposed_rids or rid in self.decided_rids:
            return
        need = self.n  # timely fast path wants everyone on board
        if len(s) >= need and rid in self.pending_req:
            self._enqueue_proposal(self.pending_req[rid])
        elif len(s) == 1:
            # echo timeout: propose with whoever echoed (slow path will cope)
            self.timer(self.cfg.echo_timeout_us,
                       lambda: self._echo_timeout(rid))

    def _echo_timeout(self, rid: tuple) -> None:
        if rid in self.proposed_rids or rid in self.decided_rids:
            return
        if rid in self.pending_req and len(self.echoes.get(rid, ())) >= 1:
            self._enqueue_proposal(self.pending_req[rid])

    def _enqueue_proposal(self, req: tuple) -> None:
        rid = req[0]
        if rid in self.proposed_rids:
            return
        adm = self.cfg.admission
        if (adm is not None and req[1] != "" and
                self._client_backlog > adm.queue_high):
            # over the queue-depth horizon: shed with an agreed BUSY
            # marker instead of feeding the overload into the pipeline
            self.proposed_rids.add(rid)
            self.shed_queue.append(rid)
            self.admission_stats["shed"] += 1
            self._drain_proposals()
            return
        self.proposed_rids.add(rid)
        self.propose_queue.append(req)
        self._drain_proposals()

    # ------------------------------------------------------------------
    # Service-level requests (no client, applied to the app, no reply)
    # ------------------------------------------------------------------
    def propose_internal(self, rid: tuple, payload: bytes) -> None:
        """Route an internally-originated request into the consensus hot
        path: ``rid`` must be a ``("svc", ...)`` tuple, deterministic
        across replicas, so concurrent submissions from every replica
        dedupe into one slot.  The decided request is applied to the app
        like a client request (unlike the no-op ⊥/MEMBERSHIP class) but
        sends no reply — the service layer built on top (cross-shard 2PC
        recovery) observes execution via ``on_execute_hooks``.

        Mirrors ``propose_membership``'s enqueue path: the request rides
        the normal echo/propose machinery, trips the same progress timer
        (a leader that refuses to propose it loses its view), and is
        re-routed across view changes like any pending request."""
        assert isinstance(rid, tuple) and rid and rid[0] == "svc", \
            "service-level rids are ('svc', ...) tuples"
        if self.joining:
            return  # a non-voting joiner neither echoes nor proposes
        if rid in self.decided_rids or rid in self.executed_rids:
            return
        if rid not in self.pending_req:
            self.pending_req[rid] = (rid, "", payload)
        # a slot held back by the svc endorsement gate may now be
        # justified by this very proposal (the validator matches it
        # against pending_req) — re-check immediately instead of waiting
        # for the periodic recheck timer
        for (v, s) in list(self._svc_wait):
            self._svc_recheck(v, s)
        if self.is_leader():
            self._note_echo(rid, self.pid)
        else:
            self.send(self.leader(), "ECHO", (rid,))
        self._arm_progress_timer()

    # ==================================================================
    # Propose (Alg. 2 lines 14-16) — batched + pipelined
    # ==================================================================
    def _slots_in_flight(self) -> int:
        """Slots proposed but not yet executed (the pipeline window)."""
        return max(0, self.next_slot - self.exec_upto - 1)

    def _assemble_batch(self) -> Optional[tuple]:
        """Coalesce pending requests into one batch, bounded by
        ``max_batch`` requests / ``max_batch_bytes`` of payload.  A single
        request may exceed the byte bound (up to max_request_bytes)."""
        batch: List[tuple] = []
        rids: Set[tuple] = set()
        size = 0
        while self.propose_queue and len(batch) < self.cfg.max_batch:
            req = self.propose_queue[0]
            if req[0] in self.decided_rids or req[0] in rids:
                # stale or duplicate enqueue (possible across view changes)
                self.propose_queue.popleft()
                continue
            if batch and size + len(req[2]) > self.cfg.max_batch_bytes:
                break
            self.propose_queue.popleft()
            batch.append(req)
            rids.add(req[0])
            size += len(req[2])
        adm = self.cfg.admission
        if adm is not None and self.shed_queue:
            # shed markers ride along (or form a shed-only slot): agreed,
            # zero-payload, and capped so they never starve real requests
            n_shed = 0
            while self.shed_queue and n_shed < adm.max_shed:
                orig = self.shed_queue.popleft()
                if orig in self.decided_rids or orig in rids:
                    continue  # settled (or racing a real proposal) already
                batch.append((("shed", orig), "", b""))
                rids.add(orig)
                n_shed += 1
        return tuple(batch) if batch else None

    def _full_batch_queued(self) -> bool:
        """O(max_batch) check: is a full batch's worth of requests queued?
        Queue length may overcount by stale (already decided) rids —
        harmless: we propose a slightly smaller batch instead of waiting."""
        if len(self.propose_queue) >= self.cfg.max_batch:
            return True
        size = 0
        for r in self.propose_queue:
            size += len(r[2])
            if size >= self.cfg.max_batch_bytes:
                return True
        return False

    def _drain_proposals(self) -> None:
        if not self.is_leader():
            return
        if self.view > 0 and self.view not in self.new_view_sent:
            return  # NEW_VIEW must precede proposals in this view
        if (self.gap_repair_us is not None and self.view > 0 and
                self.view not in self.reproposed_views):
            # NEW_VIEW is broadcast but not yet FIFO-self-delivered:
            # next_slot is blind until _repropose runs, and proposing a
            # fresh batch now can land on an already-decided slot — a
            # duplicate PREPARE that byz-blocks my own stream everywhere
            return
        while ((self.propose_queue or self.shed_queue) and
               self.next_slot in self.checkpoint.open_slots and
               self._slots_in_flight() < self.cfg.pipeline_depth):
            # drop already-decided heads (stale after view changes)
            while (self.propose_queue and
                   self.propose_queue[0][0] in self.decided_rids):
                self.propose_queue.popleft()
            if not self.propose_queue and not self.shed_queue:
                return
            if (self.propose_queue and
                    self.cfg.batch_timeout_us > 0 and
                    not self._batch_flush_due and
                    not self._full_batch_queued()):
                # wait (bounded) for more requests to coalesce
                if not self._batch_timer_armed:
                    self._batch_timer_armed = True
                    self.timer(self.cfg.batch_timeout_us, self._batch_flush)
                return
            batch = self._assemble_batch()
            if batch is None:
                return
            s = self.next_slot
            self.next_slot += 1
            self._ctb_broadcast(("PREPARE", self.view, s, batch))

    def _batch_flush(self) -> None:
        self._batch_timer_armed = False
        self._batch_flush_due = True
        try:
            self._drain_proposals()
        finally:
            self._batch_flush_due = False

    # ==================================================================
    # CTBcast delivery → FIFO interpretation (Alg. 2 line 1)
    # ==================================================================
    def _ctb_deliver(self, p: str, k: int, m: Any) -> None:
        st = self.state.get(p)
        if st is None or st.blocked or p in self.retired:
            return
        if k < st.fifo_next:
            return
        st.fifo_pending[k] = m
        self._fifo_drain(p)

    def _fifo_drain(self, p: str) -> None:
        st = self.state[p]
        while not st.blocked and st.fifo_next in st.fifo_pending:
            k = st.fifo_next
            m = st.fifo_pending.pop(k)
            st.fifo_next += 1
            st.recent[k] = m
            # ks enter in strictly increasing order, so the dict's first
            # key is the oldest — O(1) expiry instead of an O(t) scan
            while st.recent:
                first = next(iter(st.recent))
                if first > k - self.cfg.t:
                    break
                del st.recent[first]
            if not self._byz_check(p, m):       # Algorithm 5
                if self.gap_repair_us is not None and not st.view_synced:
                    # The peer's view lineage is unknown here (post-join,
                    # or the peer sealed into an epoch we haven't applied
                    # yet): a check against the stale st.view says nothing
                    # about honesty.  Drop instead of block — but still
                    # adopt COMMIT certificates, which carry f+1 certify
                    # signatures and are re-verified on every path.
                    if m[0] == "COMMIT":
                        self._on_commit(p, m)
                    continue
                st.blocked = True               # "block upon a Byzantine message"
                return
            self._process_ctb(p, k, m)
            if (k + 1) % self.my_ctb.summary_interval == 0:
                self._send_certify_summary(p, k)

    # ------------------------------------------------------------------
    # Algorithm 5 — CTBcast's Byzantine checks
    # ------------------------------------------------------------------
    def _byz_check(self, p: str, m: tuple) -> bool:
        st = self.state[p]
        kind = m[0]
        if kind == "PREPARE":
            _, v, s, req = m
            if self._valid_batch(req) is None:  # malformed / oversized batch
                return False
            cp = st.checkpoint or self.checkpoint
            prepared_in_v = s in st.prepares and st.prepares[s][0] == v
            return (st.view == v and self.leader(v) == p and
                    s in cp.open_slots and
                    not prepared_in_v and       # never prepared s before in v
                    (v == 0 or (st.new_view is not None and
                                self._must_propose_ok(s, req, st.new_view))))
        if kind == "COMMIT":
            cert = m[1]
            v, s = cert["view"], cert["slot"]
            cp = st.checkpoint or self.checkpoint
            return (s in cp.open_slots and v == st.view and
                    st.commits.get(s) is not cert)
        if kind == "CHECKPOINT":
            cp = Checkpoint.from_wire(m[1])
            old = st.checkpoint or self.checkpoint
            return cp.supersedes(old) and cp.valid(self.registry, self.quorum)
        if kind == "SEAL_VIEW":
            return st.view < m[1]
        if kind == "NEW_VIEW":
            certs = m[1]
            if self.leader(st.view) != p:
                return False
            if st.noncp_msgs_in_view > 0:
                return False   # must be p's first non-CHECKPOINT msg this view
            seen = set()
            for q, (snap, shares) in certs.items():
                if q in seen:
                    return False
                seen.add(q)
                digest = crypto.fingerprint_cached(snap)
                pids = {pid for pid, _ in shares}
                if len(pids) < self.quorum:
                    return False
                for pid, sig in shares:
                    if not self.registry.verify(
                            pid, ("vc", st.view, q, digest), sig):
                        return False
            return len(seen) >= self.quorum
        return True

    def _valid_batch(self, raw: Any) -> Optional[tuple]:
        """Structural check on a PREPARE payload: a well-formed batch of
        1..max_batch request triples within the byte bounds (a Byzantine
        leader may not smuggle oversized batches past the cost model)."""
        try:
            batch = as_batch(raw)
        except TypeError:
            return None
        adm = self.cfg.admission
        cap = self.cfg.max_batch + (adm.max_shed if adm is not None else 0)
        if not 1 <= len(batch) <= cap:
            return None
        total = 0
        rids = set()
        n_real = 0
        n_shed = 0
        for r in batch:
            if not (isinstance(r, tuple) and len(r) == 3 and
                    isinstance(r[1], str) and isinstance(r[2], bytes)):
                return None
            rid = r[0]
            if (isinstance(rid, tuple) and len(rid) == 2 and
                    rid[0] == "shed" and r[1] == ""):
                # an admission shed marker: only meaningful — and only
                # valid on the wire — when admission control is deployed;
                # the shed's *target* rid joins the duplicate check so a
                # slot can never both apply and shed the same request
                orig = rid[1]
                if (adm is None or r[2] != b"" or
                        not (isinstance(orig, tuple) and orig and
                             isinstance(orig[0], str))):
                    return None
                if orig in rids or rid in rids:
                    return None
                rids.add(orig)
                rids.add(rid)
                n_shed += 1
                continue
            n_real += 1
            if r[1] != "" and not (isinstance(rid, tuple) and rid and
                                   rid[0] == r[1]):
                # a client request's rid leads with the client pid (checked
                # against the network sender at REQ ingress); a batch whose
                # ``client`` field disagrees is a leader forging the caller
                # identity that ``App.apply_from`` will be handed
                return None
            try:
                if rid in rids:   # duplicate rids: one reply per rid
                    return None
                rids.add(rid)  # rids key sets/dicts everywhere downstream
            except TypeError:
                return None
            if len(r[2]) > self.cfg.max_request_bytes:
                return None
            total += len(r[2])
        if n_real > self.cfg.max_batch:
            return None
        if n_shed and (adm is None or n_shed > adm.max_shed):
            return None
        if n_real > 1 and total > self.cfg.max_batch_bytes:
            return None
        return batch

    @staticmethod
    def _needs_execution(r: tuple) -> bool:
        """A request whose execution has effects worth re-proposing across
        a view change: any client request, plus the service-level
        ``("svc", ...)`` class (⊥ fillers and MEMBERSHIP markers are not —
        MEMBERSHIP is re-announced by the control plane's survivors)."""
        return r[1] != "" or (isinstance(r[0], tuple) and bool(r[0]) and
                              r[0][0] == "svc")

    def _must_propose_ok(self, slot: int, req: Any, new_view: Any) -> bool:
        must = self._must_propose(slot, new_view)
        if must is None:        # any request may be proposed
            return True
        return (crypto.encode_cached(as_batch(req)) ==
                crypto.encode_cached(as_batch(must)))

    # ------------------------------------------------------------------
    # FIFO message processing (Alg. 2 / Alg. 3 receive sides)
    # ------------------------------------------------------------------
    def _process_ctb(self, p: str, k: int, m: tuple) -> None:
        kind = m[0]
        st = self.state[p]
        if kind == "PREPARE":
            st.noncp_msgs_in_view += 1
            self._on_prepare(p, m)
        elif kind == "COMMIT":
            st.noncp_msgs_in_view += 1
            self._on_commit(p, m)
        elif kind == "CHECKPOINT":
            self._on_checkpoint_msg(p, m)
        elif kind == "SEAL_VIEW":
            self._on_seal_view(p, m)   # resets the per-view counters
        elif kind == "NEW_VIEW":
            st.noncp_msgs_in_view += 1
            self._on_new_view(p, m)

    # --- PREPARE (lines 18-22) ---
    def _on_prepare(self, p: str, m: tuple) -> None:
        _, v, s, raw = m
        batch = as_batch(raw)
        self.state[p].prepares[s] = (v, batch)
        if v != self.view or s not in self.checkpoint.open_slots:
            return
        for r in batch:
            if (r[1] != "" and r[0] in self.pending_req and
                    self.pending_req[r[0]] != r):
                # the leader's copy contradicts the client's direct copy
                # (§5.4): never adopt or endorse a rewritten request
                return
        if not self._batch_certifiable(raw):
            # an unjustifiable service request is not even *stored*: were it
            # kept in my_prepared, an honest replica leading the next view
            # would faithfully re-propose it (_repropose) and a Byzantine
            # leader's forgery could wedge the slot across view changes.
            # Certification stays gated separately (_endorse/_do_certify)
            # for requests whose justification arrives later.
            self._arm_svc_recheck(v, s)
            return
        self.my_prepared[s] = (v, batch)
        if s > self.exec_upto + 1:
            self._arm_gap_repair()   # leader moved past a stalled slot
        missing = {r[0] for r in batch
                   if r[1] != "" and r[0] not in self.pending_req and
                   r[0] not in self.decided_rids}
        if p == self.pid or not missing:
            self._endorse(v, s)
        else:
            # wait for the clients' direct copies before endorsing (§5.4);
            # a batched slot endorses once every missing rid has arrived
            self.prepare_missing[(v, s)] = missing
            for rid in missing:
                self.waiting_prepare.setdefault(rid, []).append((v, s))
            self._arm_progress_timer()
        if self.cfg.slow_mode == "always":
            self._do_certify(v, s)
        else:
            self.timer(self.cfg.slow_after_us,
                       lambda: self._slow_path_kick(v, s))

    # ------------------------------------------------------------------
    # Service-slot endorsement gating
    # ------------------------------------------------------------------
    def _svc_certifiable(self, raw: Any) -> bool:
        """May this replica vouch (WILL_CERTIFY / CERTIFY signature) for a
        slot containing this batch?  Client requests always qualify —
        their authenticity is carried by the rid/client binding.  A
        ``("svc", kind, ...)`` request is checked against the service
        layer's registered validator: only locally-justified service
        actions get this replica's vote."""
        if not self.svc_validators:
            return True
        for r in as_batch(raw):
            rid = r[0]
            if (r[1] == "" and isinstance(rid, tuple) and len(rid) >= 2 and
                    rid[0] == "svc" and rid not in self.decided_rids and
                    rid not in self.executed_rids):
                val = self.svc_validators.get(rid[1])
                if val is not None and not val(rid, r[2]):
                    return False
        return True

    def _admission_ok(self, raw: Any) -> bool:
        """May this replica vouch for a slot carrying shed markers?  A
        shed is justified only while this replica's *own* client backlog
        confirms the overload (the ``queue_accept`` floor) — a Byzantine
        leader shedding honest requests under light load never collects
        an honest certificate quorum and loses its view to the normal
        progress timer.  Deployments without admission control never see
        shed markers past ``_valid_batch``, so this is a no-op there."""
        adm = self.cfg.admission
        if adm is None:
            return True
        floor = adm.accept_floor()
        for r in as_batch(raw):
            rid = r[0]
            if (r[1] == "" and isinstance(rid, tuple) and len(rid) == 2 and
                    rid[0] == "shed"):
                orig = rid[1]
                if orig in self.decided_rids or orig in self.executed_rids:
                    continue   # settled elsewhere: the shed is a no-op
                if orig not in self.pending_req:
                    # an honest client broadcasts to every replica, so a
                    # rid we never saw has no honest client waiting on it
                    # — shedding it cannot censor anyone we answer to
                    continue
                if self._client_backlog < floor:
                    return False
        return True

    def _batch_certifiable(self, raw: Any) -> bool:
        """All local-justification gates a batch must pass before this
        replica promises or signs for it (svc validators + admission)."""
        return self._admission_ok(raw) and self._svc_certifiable(raw)

    def _arm_svc_recheck(self, v: int, s: int) -> None:
        if (v, s) in self._svc_wait:
            return
        self._svc_wait.add((v, s))
        self.timer(self.cfg.echo_timeout_us,
                   lambda: self._svc_recheck(v, s))
        # a held-back slot stalls execution even when every rid is decided:
        # keep view-change pressure on so a leader proposing unjustifiable
        # svc requests loses its view instead of wedging the log
        self._arm_progress_timer()

    def _svc_recheck(self, v: int, s: int) -> None:
        """A slot was held back because a svc request in it was not yet
        locally justified; re-test (the local recovery probe may have
        verified the outcome and proposed the identical rid, or the
        transaction may have resolved meanwhile) and vote if now safe."""
        self._svc_wait.discard((v, s))
        if (v != self.view or s in self.decided or
                s not in self.checkpoint.open_slots):
            return
        pr = self.my_prepared.get(s)
        if pr is None or pr[0] != v:
            # the prepare was refused storage outright: keep the pressure
            # on (view-change timer) until the slot decides elsewhere or
            # the view moves on
            self._arm_svc_recheck(v, s)
            return
        if not self._batch_certifiable(pr[1]):
            self._arm_svc_recheck(v, s)
            return
        if (v, s) not in self.my_will_certifies:
            self._endorse(v, s)
        self._do_certify(v, s)

    def _endorse(self, v: int, s: int) -> None:
        if self.joining:
            return  # non-voting: observe, never promise
        if v != self.view or s not in self.checkpoint.open_slots:
            return
        pr = self.my_prepared.get(s)
        if pr is not None and pr[0] == v and not self._batch_certifiable(pr[1]):
            self._arm_svc_recheck(v, s)
            return
        if self.cfg.fast_enabled:
            self.my_will_certifies.add((v, s))
            self._tb_slot_broadcast("WILL_CERTIFY", s, (v, s))  # line 21
        else:
            self._do_certify(v, s)

    def _slow_path_kick(self, v: int, s: int) -> None:
        if s in self.decided or v != self.view:
            return
        self._do_certify(v, s)

    # --- CERTIFY (lines 22, 34-36) ---
    def _do_certify(self, v: int, s: int) -> None:
        if self.joining:
            return  # non-voting: a joiner's signature must never complete
        if (v, s) in self.my_certified:  # a certificate quorum
            return
        pr = self.my_prepared.get(s)
        if pr is None or pr[0] != v:
            return
        if not self._batch_certifiable(pr[1]):
            # the slow path reaches here without passing _endorse, so the
            # service-slot gate must sit on the signature itself: no
            # honest certificate for an unjustified svc request (or an
            # unjustified admission shed)
            self._arm_svc_recheck(v, s)
            return
        self.my_certified.add((v, s))
        req = pr[1]
        fp = crypto.fingerprint_cached(req)
        payload = ("certify", v, s, fp)
        self.async_sign(payload, lambda sig: self._tb_slot_broadcast(
            "CERTIFY", s, (v, s, fp, sig)))

    def _on_certify(self, q: str, body: tuple) -> None:
        v, s, fp, sig = body
        # accept certificates for any view ≤ ours (they may be completing a
        # promise from the view we are sealing); the signature binds (v,s,fp)
        if v > self.view or s not in self.checkpoint.open_slots:
            return
        self.async_verify(q, ("certify", v, s, fp), sig,
                          lambda ok: self._certify_verified(ok, q, v, s, fp, sig))

    def _certify_verified(self, ok: bool, q: str, v: int, s: int,
                          fp: bytes, sig: bytes) -> None:
        if not ok:
            return
        sigs = self.certify_sigs.setdefault((v, s, fp), {})
        sigs[q] = sig
        if len(sigs) >= self.quorum and s not in self.my_commits:
            pr = self.my_prepared.get(s)
            if pr is None or pr[0] != v:
                return
            if crypto.fingerprint_cached(pr[1]) != fp:
                return
            if v != self.view:
                return   # never broadcast a COMMIT for a view I have sealed
            cert = {"view": v, "slot": s, "fp": fp, "req": pr[1],
                    "sigs": tuple(sorted(sigs.items()))}
            self.my_commits[s] = cert
            self._ctb_broadcast(("COMMIT", cert))              # line 36

    # --- COMMIT (lines 38-41) ---
    def _on_commit(self, p: str, m: tuple, vouch_only: bool = False) -> None:
        cert = m[1]
        v, s, fp, req = cert["view"], cert["slot"], cert["fp"], cert["req"]
        if crypto.fingerprint_cached(req) != fp:
            return
        items = [(pid, ("certify", v, s, fp), sig) for pid, sig in cert["sigs"]]
        if len({pid for pid, _, _ in items}) < self.quorum:
            return
        self.async_verify_many(items, lambda oks: self._commit_verified(
            oks, p, cert, vouch_only))

    def _commit_verified(self, oks: List[bool], p: str, cert: dict,
                         vouch_only: bool = False) -> None:
        if not all(oks):
            return
        s = cert["slot"]
        if vouch_only:
            # a JOIN_SYNC-attached certificate: the sender vouches it
            # decided s, but the cert was never carried on its CTBcast
            # stream — recording it in st.commits would make my snapshot
            # of that stream diverge from every other replica's (and from
            # the sender's own), wedging view-change certificates forever
            self.vouched_commits.setdefault(s, {})[p] = cert
        else:
            st = self.state[p]
            prev = st.commits.get(s)
            if prev is None or prev["view"] <= cert["view"]:
                st.commits[s] = cert
        # f+1 members vouching (a COMMIT on their stream, or an attached
        # cert) with a matching PREPARE → decide (line 40)
        matching = set()
        for q in self.replicas:
            c = self.state[q].commits.get(s)
            if c is None:
                c = self.vouched_commits.get(s, {}).get(q)
            if (c is not None and c["fp"] == cert["fp"] and
                    c["view"] == cert["view"]):
                matching.add(q)
        if len(matching) >= self.quorum:
            self._decide(s, cert["req"])

    # --- fast path (lines 24-31) ---
    def _on_will_certify(self, origin: str, stream: str, key: int,
                         payload: Any) -> None:
        if origin not in self._member_set:
            return  # promises from outside the current epoch never count
        v, s = payload
        ws = self.will_certify.get((v, s))
        if ws is None:
            ws = self.will_certify[(v, s)] = set()
        ws.add(origin)
        if (len(ws) >= 2 * self.f + 1 and v == self.view and
                not self.joining and
                s in self.checkpoint.open_slots and
                (v, s) not in self.my_will_commits):
            self.my_will_commits.add((v, s))
            self._tb_slot_broadcast("WILL_COMMIT", s, (v, s))   # line 27

    def _on_will_commit(self, origin: str, stream: str, key: int,
                        payload: Any) -> None:
        if origin not in self._member_set:
            return  # promises from outside the current epoch never count
        v, s = payload
        ws = self.will_commit.get((v, s))
        if ws is None:
            ws = self.will_commit[(v, s)] = set()
        ws.add(origin)
        if (len(ws) >= 2 * self.f + 1 and v == self.view and
                s in self.checkpoint.open_slots):
            pr = self.state[self.leader(v)].prepares.get(s)
            if pr is not None and pr[0] == v:
                self._decide(s, pr[1])                         # line 31

    def _on_tb_certify(self, origin: str, stream: str, key: int,
                       payload: Any) -> None:
        if origin not in self._member_set:
            return  # a non-member (joiner / retired pid) casts no votes
        self._on_certify(origin, payload)

    def _on_tb_certify_cp(self, origin: str, stream: str, key: int,
                          payload: Any) -> None:
        if origin not in self._member_set:
            return  # a non-member (joiner / retired pid) casts no votes
        self._on_certify_checkpoint(origin, payload)

    def _on_tb_summary(self, origin: str, stream: str, key: int,
                       payload: Any) -> None:
        self._on_summary(origin, payload)

    def _on_tb_consensus(self, origin: str, stream: str, key: int,
                         payload: Any) -> None:
        """Fallback for unknown cons/ streams (Byzantine noise tolerance)."""
        return

    # ==================================================================
    # Decide → execute → reply
    # ==================================================================
    def _decide(self, s: int, reqs: tuple) -> None:
        if s in self.decided:
            return
        batch = as_batch(reqs)
        self.decided[s] = batch
        self.repair_votes.pop(s, None)
        for r in batch:
            self.decided_rids.add(r[0])
            # a decided rid no longer gates any endorsement: clear its
            # waits so _has_pending() cannot trigger spurious view changes
            # while the client's direct copy is still in flight
            for key in self.waiting_prepare.pop(r[0], []):
                miss = self.prepare_missing.get(key)
                if miss is not None:
                    miss.discard(r[0])
                    if not miss:
                        del self.prepare_missing[key]
        self.progress_deadline = None
        self.view_patience = self.cfg.view_timeout_us  # progress resets patience
        for hook in self.on_decide_hooks:
            hook(s, batch)
        self._execute_ready()
        self._arm_gap_repair()

    def _execute_ready(self) -> None:
        if self._app_has_cost:
            # deferred engine: slots occupy the serial app engine for
            # their summed App.cost_us before applying
            self._exec_pump()
            return
        while self.exec_upto + 1 in self.decided:
            self._execute_slot(self.exec_upto + 1)
        self._maybe_checkpoint_round()
        self._drain_proposals()

    def _execute_slot(self, s: int) -> None:
        results = []
        # the batch executes atomically (one slot), replies per-request
        for rid, client, payload in self.decided[s]:
            if (client == "" and isinstance(rid, tuple) and
                    len(rid) == 4 and rid[0] == "member"):
                # agreed MEMBERSHIP slot: every honest replica applies
                # the epoch bump at the same point of its execution
                # order — the switch is atomic across the group
                self._apply_membership(rid[1], rid[2], rid[3], s)
            if (client == "" and isinstance(rid, tuple) and
                    len(rid) == 2 and rid[0] == "shed"):
                # agreed admission shed: every honest replica sends the
                # identical deterministic BUSY for the target rid, so the
                # client completes on the normal f+1 reply quorum.  The
                # target joins executed_rids — a later slot carrying the
                # real request degrades to a duplicate, so a shed can
                # never be torn against applied state (and vice versa: a
                # shed for an already-applied rid degrades to a no-op)
                adm = self.cfg.admission
                orig = rid[1]
                self.decided_rids.add(orig)
                if adm is None or orig in self.executed_rids:
                    self.admission_stats["dup_sheds"] += 1
                    results.append(b"")
                else:
                    self.executed_rids.add(orig)
                    results.append(adm.reply)
                    self.admission_stats["busy_replies"] += 1
                    if orig[0] in self.sim.processes:
                        self.send(orig[0], "REP", (orig, adm.reply))
                self._pend_pop(orig)
                self.echoes.pop(orig, None)
                continue
            if (client == "" and isinstance(rid, tuple) and rid and
                    rid[0] == "svc" and rid not in self.executed_rids):
                # service-level request (cross-shard 2PC recovery):
                # applied to the app like a client request, but with no
                # reply — there is no client waiting, the effect IS the
                # point (e.g. a presumed-abort FINISH releasing locks)
                result = self.app.apply_from("", payload)
                self.executed_rids.add(rid)
                results.append(result)
                self._pend_pop(rid)
                self.echoes.pop(rid, None)
                for hook in self.on_execute_hooks:
                    hook(s, rid, payload, result)
                continue
            if client == "" or rid in self.executed_rids:
                # no-op / duplicate: does not touch the app and sends
                # no reply (a duplicate's real reply came from the slot
                # that executed it; a second b"" REP could otherwise
                # outvote it at the client)
                results.append(b"")
                self._pend_pop(rid)
                self.echoes.pop(rid, None)
                continue
            result = self.app.apply_from(client, payload)
            self.executed_rids.add(rid)
            results.append(result)
            self._pend_pop(rid)
            self.echoes.pop(rid, None)
            if client in self.sim.processes:
                self.send(client, "REP", (rid, result))
            for hook in self.on_execute_hooks:
                hook(s, rid, payload, result)
        self.results[s] = tuple(results)
        self.exec_upto = s

    # ------------------------------------------------------------------
    # Deferred execution engine (App.cost_us > 0; the serving plane)
    # ------------------------------------------------------------------
    def _slot_cost_us(self, s: int) -> float:
        """Summed service cost of the entries that will actually execute
        in slot ``s`` — computed at the slot's execution point, where
        every honest replica holds the identical app state."""
        cost = 0.0
        for rid, client, payload in self.decided[s]:
            if rid in self.executed_rids:
                continue   # duplicate: executes as a free no-op
            if client != "" or (isinstance(rid, tuple) and rid and
                                rid[0] == "svc"):
                cost += self.app.cost_us(payload)
        return cost

    def _exec_pump(self) -> None:
        """Serial engine: the next ready slot applies only after its
        summed per-request cost has elapsed on this replica's (single)
        app engine.  ``exec_upto`` lags the decided frontier by the true
        service backlog, so the pipeline cap and the leader's admission
        backlog both measure the real execution horizon."""
        if self._exec_inflight is not None or self.crashed:
            return
        while self.exec_upto + 1 in self.decided:
            s = self.exec_upto + 1
            cost = self._slot_cost_us(s)
            if cost > 0.0:
                self._exec_inflight = s
                gen = self._exec_gen
                self.timer(cost, lambda: self._exec_fire(gen))
                break
            self._execute_slot(s)   # free slots apply immediately
        self._maybe_checkpoint_round()
        self._drain_proposals()

    def _exec_fire(self, gen: int) -> None:
        if gen != self._exec_gen:
            return   # stale completion from before a crash/recover cycle
        s = self._exec_inflight
        self._exec_inflight = None
        if s is not None and s == self.exec_upto + 1 and s in self.decided:
            self._execute_slot(s)
        self._exec_pump()

    def _exec_recover(self) -> None:
        # a crash swallowed the in-flight service completion timer
        # (Node.timer drops callbacks that fire while crashed): the slot
        # re-enters service from scratch after recovery
        self._exec_gen += 1
        self._exec_inflight = None
        self._exec_pump()

    # ==================================================================
    # Decision gap repair (self-healing deployments; cfg.gap_repair_us)
    # ==================================================================
    def _arm_gap_repair(self) -> None:
        """Arm (once) a timer that pulls missing decisions from members.

        Fires only while execution is stalled behind undecided slots that
        some *later* decided/prepared slot proves the group moved past.
        Each firing requests ALL such holes at once — a joiner that came
        up short of vouchers for a window of slots heals in one round
        trip, not one slot per timer period.  The per-response trust
        model is the JOIN_SYNC vouched-certificate one: a responder
        attests "I decided s" with a re-verified f+1-signed commit
        certificate, and f+1 current members agreeing on the value decide
        it here (≥1 of them is honest, and honest decisions for a slot
        are unique)."""
        if (self.gap_repair_us is None or self._gap_repair_armed or
                self.crashed or self.joining):
            return
        if not self._gap_slots():
            return
        self._gap_repair_armed = True

        def _fire() -> None:
            self._gap_repair_armed = False
            if self.crashed or self.joining:
                return
            gaps = self._gap_slots()
            if not gaps:
                return
            for q in self.replicas:
                if q != self.pid:
                    self.send(q, "GAP_REPAIR_REQ", (tuple(gaps),))
            self._arm_gap_repair()       # retry cadence while stalled

        self.timer(self.gap_repair_us, _fire)

    def _gap_slots(self) -> List[int]:
        """Undecided slots below the highest slot this replica has seen
        decided or prepared.  A bare stall with nothing beyond is normal
        pipeline state — the progress timer, not repair, owns that case."""
        known = max(max(self.decided, default=-1),
                    max(self.my_prepared, default=-1))
        lo = max(self.exec_upto + 1, self.checkpoint.start)
        return [s for s in range(lo, known)
                if s not in self.decided][:self.cfg.window]

    def _on_gap_repair_req(self, src: str, body: tuple) -> None:
        if self.gap_repair_us is None:
            return
        slots = body[0]
        if not isinstance(slots, tuple):
            return
        certs = []
        for s in slots[:self.cfg.window]:
            if not isinstance(s, int) or s not in self.decided:
                continue
            cert = self.my_commits.get(s)
            if cert is None:
                # scan ALL tracked streams (retired peers may be the only
                # holders of certs for slots decided around a rotation)
                for ps in self.state.values():
                    cert = ps.commits.get(s)
                    if cert is not None:
                        break
            if cert is None:
                for c in self.vouched_commits.get(s, {}).values():
                    cert = c
                    break
            if cert is not None:
                certs.append(cert)
        if certs:
            self.send(src, "GAP_REPAIR", (tuple(certs),),
                      extra_bytes=64 * len(certs))

    def _on_gap_repair(self, src: str, body: tuple) -> None:
        if self.gap_repair_us is None or src not in self._member_set:
            return
        certs = body[0]
        if not isinstance(certs, tuple):
            return
        items: List[tuple] = []
        parsed: List[dict] = []
        for cert in certs[:self.cfg.window]:
            try:
                v, s, fp, req = (cert["view"], cert["slot"], cert["fp"],
                                 cert["req"])
            except (TypeError, KeyError):
                return
            if s in self.decided:
                continue
            if crypto.fingerprint_cached(req) != fp:
                return
            sub = [(pid, ("certify", v, s, fp), sig)
                   for pid, sig in cert["sigs"]]
            if len({pid for pid, _, _ in sub}) < self.quorum:
                return
            parsed.append(cert)
            items.extend(sub)
        if parsed:
            self.async_verify_many(
                items, lambda oks: self._gap_repair_verified(oks, src,
                                                             parsed))

    def _gap_repair_verified(self, oks: List[bool], src: str,
                             parsed: List[dict]) -> None:
        if not all(oks):
            return
        for cert in parsed:
            s = cert["slot"]
            if s in self.decided:
                continue
            votes = self.repair_votes.setdefault(s, {})
            votes[src] = cert
            # f+1 current members attesting the same value (view-agnostic:
            # across a view change honest members may hold certificates
            # from different views for the one decided value)
            matching = {q for q, c in votes.items()
                        if c["fp"] == cert["fp"] and q in self._member_set}
            if len(matching) >= self.quorum:
                del self.repair_votes[s]
                self.gap_repairs += 1
                self._decide(s, cert["req"])

    # ==================================================================
    # Checkpoints (Alg. 2 lines 43-61)
    # ==================================================================
    def _maybe_checkpoint_round(self) -> None:
        last = self.checkpoint.open_slots[-1]
        if self.exec_upto >= last:
            # the boundary snapshot is the only one a signed checkpoint can
            # vouch for — retained (bounded) for joiner state transfer
            self._boundary_snaps[last + 1] = self.app.snapshot()
            for old in [k for k in self._boundary_snaps
                        if k < last + 1 - self.cfg.window]:
                del self._boundary_snaps[old]
            if self.joining:
                return  # non-voting: no checkpoint certificate shares
            payload = _cp_payload(last + 1, self.cfg.window, self.app.snapshot_fp())
            self.async_sign(payload, lambda sig: self._tb_broadcast(
                "CERTIFY_CHECKPOINT", last + 1, (payload, sig)))

    def _on_certify_checkpoint(self, q: str, body: tuple) -> None:
        payload, sig = body
        self.async_verify(q, payload, sig,
                          lambda ok: self._cp_sig_verified(ok, q, payload, sig))

    def _cp_sig_verified(self, ok: bool, q: str, payload: tuple,
                         sig: bytes) -> None:
        if not ok:
            return
        sigs = self.cp_sigs.setdefault(payload, {})
        sigs[q] = sig
        if len(sigs) >= self.quorum:
            _tag, start, window, app_fp = payload
            cp = Checkpoint(start, window, app_fp, tuple(sorted(sigs.items())))
            self._maybe_checkpoint(cp)

    def _on_checkpoint_msg(self, p: str, m: tuple) -> None:
        cp = Checkpoint.from_wire(m[1])
        st = self.state[p]
        st.checkpoint = cp
        # forget this peer's prepares/commits outside the window (line 54)
        for s in [s for s in st.prepares if s not in cp.open_slots]:
            del st.prepares[s]
        for s in [s for s in st.commits if s not in cp.open_slots]:
            del st.commits[s]
        self._maybe_checkpoint(cp)

    def _maybe_checkpoint(self, cp: Checkpoint) -> bool:
        if not cp.supersedes(self.checkpoint):
            return False
        if not cp.valid(self.registry, self.quorum):
            return False
        self.checkpoint = cp
        # Re-broadcast the checkpoint on MY OWN CTBcast stream *before* any
        # proposal into the new window: peers validate my PREPAREs against
        # state[me].checkpoint (Alg. 5), which only advances when they
        # FIFO-process my CHECKPOINT.  This is also the liveness relay of
        # §B.3 ("re-broadcast by the potentially single correct process").
        if cp.start > self._last_cp_broadcast:
            self._last_cp_broadcast = cp.start
            self._ctb_broadcast(("CHECKPOINT", cp.to_wire()))
        # drop fast-path promises outside the window (§5.4)
        for d in (self.will_certify, self.will_commit):
            for key in [k for k in d if k[1] not in cp.open_slots]:
                del d[key]
        self.my_will_commits = {k for k in self.my_will_commits
                                if k[1] in cp.open_slots}
        self.my_will_certifies = {k for k in self.my_will_certifies
                                  if k[1] in cp.open_slots}
        self.my_certified = {k for k in self.my_certified
                             if k[1] in cp.open_slots}
        # decided/results are the execution queue, not just agreement
        # bookkeeping: with a costed app (deferred execution engine) the
        # decode backlog can lag a checkpoint boundary, and pruning a
        # decided-but-unexecuted slot would strand this replica on the
        # state-transfer path mid-service.  Keep everything the engine
        # still has to walk; prune only what is both settled and executed.
        exec_floor = min(cp.start, self.exec_upto + 1)
        for d2 in (self.my_prepared, self.my_commits, self.vouched_commits):
            for s in [s for s in d2 if s < cp.start]:
                del d2[s]
        for d2 in (self.decided, self.results):
            for s in [s for s in d2 if s < exec_floor]:
                del d2[s]
        for key in [k for k in self.certify_sigs if k[1] < cp.start]:
            del self.certify_sigs[key]
        for key in [k for k in self.cp_sigs if k[1] < cp.start]:
            del self.cp_sigs[key]
        for key in [k for k in self.prepare_missing if k[1] < cp.start]:
            del self.prepare_missing[key]
        for rid in list(self.waiting_prepare):
            live = [(v, s) for (v, s) in self.waiting_prepare[rid]
                    if s >= cp.start]
            if live:
                self.waiting_prepare[rid] = live
            else:
                del self.waiting_prepare[rid]
        if self.exec_upto < cp.start - 1:
            if any(s not in self.decided
                   for s in range(self.exec_upto + 1, cp.start)):
                # behind with missing decisions: adopt via state transfer
                # (fp-verified)
                self._request_state(cp)
            else:
                # behind but holding every decision up to the boundary:
                # the (possibly deferred) execution engine walks there on
                # its own — adopting a snapshot would skip the costed
                # slots' service time and replies
                self._execute_ready()
        self.next_slot = max(self.next_slot, cp.start)
        self._drain_proposals()
        return True

    # --- state transfer (checkpoint adoption) ---
    def _request_state(self, cp: Checkpoint) -> None:
        # epoch-0 groups keep the historical STATE_REQ path bit-for-bit;
        # reconfigured groups use the boundary-snapshot path (XFER_REQ),
        # which verifies against the signed checkpoint unconditionally
        kind = "STATE_REQ" if self.membership.epoch == 0 else "XFER_REQ"
        for q in self.replicas:
            if q != self.pid:
                self.send(q, kind, (cp.start,))

    def _on_state_req(self, src: str, body: tuple) -> None:
        (start,) = body
        if self.checkpoint.start >= start and self.exec_upto >= start - 1:
            snap = self.app.snapshot()
            self.send(src, "STATE_RESP",
                      (start, snap, self.exec_upto),
                      extra_bytes=256)

    def _on_state_resp(self, src: str, body: tuple) -> None:
        start, snap, upto = body
        if self.exec_upto >= start - 1:
            return
        fp = crypto.fingerprint_cached(snap)
        if fp != self.checkpoint.app_fp:
            return  # unverifiable snapshot — ignore
        self.app.adopt(snap)
        self.exec_upto = max(self.exec_upto, self.checkpoint.start - 1)
        self._execute_ready()

    # --- boundary-snapshot state transfer (post-epoch-0 deployments) ---
    # STATE_RESP ships the responder's *current* snapshot, which only
    # verifies against the checkpoint fingerprint when the responder sits
    # exactly at the boundary.  Reconfigurable deployments instead serve
    # the retained boundary snapshot (``_boundary_snaps``), whose
    # fingerprint the f+1-signed checkpoint vouches for unconditionally —
    # a joiner that lags the window always converges.  Epoch-0 groups keep
    # the historical STATE_REQ wire path bit-for-bit.
    def _on_xfer_req(self, src: str, body: tuple) -> None:
        (start,) = body
        snap = self._boundary_snaps.get(start)
        if snap is None or self.checkpoint.start < start:
            return
        self.send(src, "XFER_RESP", (start, snap), extra_bytes=256)

    def _on_xfer_resp(self, src: str, body: tuple) -> None:
        start, snap = body
        if self.exec_upto >= start - 1 or start != self.checkpoint.start:
            return
        if crypto.fingerprint_cached(snap) != self.checkpoint.app_fp:
            return  # unverifiable snapshot — ignore
        self.app.adopt(snap)
        self._boundary_snaps[start] = snap
        self.exec_upto = max(self.exec_upto, start - 1)
        self._execute_ready()

    # ==================================================================
    # Membership epochs — live replica replacement
    # ==================================================================
    def publish_xfer(self, new_epoch: int) -> None:
        """Survivor side of joiner state transfer: WRITE my latest signed
        checkpoint + its boundary snapshot + prepared-slot state into my
        own SWMR register ``xfer/<epoch>`` — the transfer travels through
        the disaggregated-memory pools (the same machinery PR 2 built for
        memory-node replacement), never through a trusted side channel."""
        cp = self.checkpoint
        snap = self._boundary_snaps.get(cp.start)
        prepared = tuple(sorted(
            (s, v, batch) for s, (v, batch) in self.my_prepared.items()
            if s in cp.open_slots))
        payload = (cp.to_wire(),
                   snap if snap is not None else (),
                   self.exec_upto, self.view, prepared)
        self.regs.write(f"xfer/{new_epoch}", crypto.encode(payload),
                        lambda: None)

    def propose_membership(self, new_epoch: int, old_pid: str,
                           new_pid: str) -> None:
        """Arm the epoch bump: record the control plane's announcement and
        route a MEMBERSHIP request into the consensus hot path (it rides a
        normal slot, so the switch is *agreed*, not merely broadcast).  A
        Byzantine leader that refuses to propose it loses its view: the
        pending request trips the same progress timer as any client
        request, and the next honest leader proposes it."""
        if new_epoch <= self.membership.epoch or self.joining:
            return
        self.pending_membership[new_epoch] = (old_pid, new_pid)
        # interpretation state for the joiner's stream exists *before* its
        # first broadcast can arrive (its pre-switch messages are dropped
        # by the epoch checks, not lost at the wire layer)
        self._ensure_participant(new_pid)
        rid = ("member", new_epoch, old_pid, new_pid)
        if rid in self.decided_rids or rid in self.proposed_rids:
            return
        self.pending_req[rid] = (rid, "", b"")
        if self.is_leader():
            self._note_echo(rid, self.pid)
        else:
            self.send(self.leader(), "ECHO", (rid,))
        self._arm_progress_timer()

    def _switch_epoch(self, membership: MembershipEpoch, old: str,
                      new: str) -> None:
        """The one epoch-switch mutation sequence, shared by the member
        path (executing a MEMBERSHIP slot) and the joiner path
        (activation): install the new member set, retire everyone who
        left, create interpretation state for everyone who arrived, and
        re-derive every membership-dependent structure."""
        self.membership = membership
        self.replicas = list(membership.replicas)
        self._member_set = frozenset(self.replicas)
        for p in list(self.state):
            if p not in self._member_set and p != self.pid:
                self.state[p].blocked = True   # stop interpreting it
                self.retired.add(p)
                self.tb.drop_peer(p)   # free retired wire buffers (Table 2)
        # fresh interpretation state for arrivals (the joiner's broadcasts)
        for p in self.replicas:
            self._ensure_participant(p)
        # quorums (LOCKED unanimity, summary groups) follow the new epoch
        for c in self.ctb.values():
            c.set_group(self.replicas)
        self._leader_pid = self.replicas[self.view % self.n]
        self.epoch_switches.append((self.sim.now, membership.epoch, old,
                                    new))

    def _ensure_participant(self, p: str) -> None:
        """Interpretation state (PeerState + a receiver CTBcast instance)
        for a broadcaster that is not yet / no longer in the member list."""
        if p not in self.state:
            st = PeerState()
            st.checkpoint = self.checkpoint
            self.state[p] = st
        if p not in self.ctb:
            self.ctb[p] = CTBcast(
                self, self.tb, self.regs, broadcaster=p,
                group=self.replicas, t=self.cfg.t,
                deliver=(lambda k, m, p=p: self._ctb_deliver(p, k, m)),
                auto_slow_after_us=(0.0 if self.cfg.slow_mode == "always"
                                    else self.cfg.slow_after_us),
                fast_enabled=self.cfg.ctb_fast_enabled,
            )

    def _apply_membership(self, e: int, old: str, new: str,
                          slot: int) -> None:
        """Execute an agreed MEMBERSHIP slot: switch to the next epoch.

        Applied only when it matches the control plane's announcement
        (``pending_membership``) — a forged MEMBERSHIP request decided by a
        Byzantine leader is a no-op at every honest replica, identically.
        """
        if e != self.membership.epoch + 1:
            return  # stale or out-of-order bump
        if self.pending_membership.get(e) != (old, new):
            return  # unannounced (forged) membership change
        if old not in self._member_set or new in self._member_set:
            return
        self._switch_epoch(self.membership.replace(old, new), old, new)
        # the joiner could not see this slot (it was outside the old
        # group's broadcast set): f+1 members vouching for the switch
        # activate it
        if new != self.pid:
            # replay my own recent stream first, so the joiner's view of
            # *my* broadcasts (commits, seals) converges with everyone
            # else's — without this, view-change certificates about my
            # stream could never match the joiner's share (liveness); the
            # EPOCH confirmation follows so the replay lands while the
            # joiner is still in its observer-only phase
            history = tuple(sorted(self.my_ctb.buf.items()))
            # a member that itself joined recently decided open slots from
            # *replayed* certificates without ever broadcasting COMMIT for
            # them — its own stream cannot vouch for those decisions, and
            # a second-generation joiner counting f+1 vouching members
            # would come up short once the originals are gone.  Attach the
            # stored certificates explicitly: the receiver re-verifies the
            # f+1 certify signatures and counts this sender as one of the
            # vouching members.  Members whose stream already carries every
            # COMMIT (the common case) attach nothing, bit-identically.
            have = {m[1]["slot"] for _k, m in history
                    if isinstance(m, tuple) and m and m[0] == "COMMIT"}
            extra = []
            for s in sorted(self.decided):
                if s in have or s not in self.checkpoint.open_slots:
                    continue
                cert = self.my_commits.get(s)
                if cert is None and self.gap_repair_us is None:
                    for q in self.replicas:
                        cert = self.state[q].commits.get(s)
                        if cert is not None:
                            break
                elif cert is None:
                    # scan ALL tracked streams, not just current members:
                    # after a rotation the only holder of an old cert may
                    # be a retired peer's state
                    for ps in self.state.values():
                        cert = ps.commits.get(s)
                        if cert is not None:
                            break
                    if cert is None:
                        for c in self.vouched_commits.get(s, {}).values():
                            cert = c
                            break
                if cert is not None:
                    extra.append(cert)
            body = (history, tuple(extra)) if extra else (history,)
            if history or extra:
                self.send(new, "JOIN_SYNC", body, extra_bytes=64)
            self.send(new, "EPOCH",
                      (e, tuple(self.replicas), slot, self.view))
        elif self.joining:
            # the joiner decided the MEMBERSHIP slot itself (JOIN_SYNC
            # replays can carry it): it just activated along with everyone
            self.joining = False
            self._after_view_entered()
            if self.leader() == self.pid:
                # same blind-next_slot hazard as _activate: hand the seat
                # on through the certified view-change machinery instead
                # of proposing into already-decided slots
                self.change_view()
            for hook in self.on_activate_hooks:
                hook()

    # ----------------------------------------------------- joiner side
    def begin_join(self, new_epoch: int, survivors: List[str],
                   expected: Tuple[str, str]) -> None:
        """Joiner side of the replacement: pull the survivors' published
        ``xfer/<epoch>`` registers (f+1 needed), adopt the best signed
        checkpoint + snapshot, then wait for the agreed epoch bump."""
        assert self.joining
        self.pending_membership[new_epoch] = expected
        self._join_state = {"e": new_epoch, "survivors": list(survivors),
                            "done": False}
        self._poll_xfer()

    def _poll_xfer(self) -> None:
        js = self._join_state
        if js is None or js["done"]:
            return
        reg = f"xfer/{js['e']}"
        results: Dict[str, Any] = {}
        remaining = set(js["survivors"])

        def on_read(q: str, val, _byz: bool) -> None:
            results[q] = val
            remaining.discard(q)
            if remaining:
                return
            good = {q: v for q, v in results.items() if v is not None}
            if len(good) >= self.quorum and self._adopt_xfer(good):
                js["done"] = True
            else:
                self.timer(200.0, self._poll_xfer)

        for q in js["survivors"]:
            self.regs.read(q, reg, lambda val, byz, q=q: on_read(q, val, byz))

    def _adopt_xfer(self, good: Dict[str, tuple]) -> bool:
        """Adopt transferred state.  Only quorum-verifiable pieces are
        trusted unconditionally: the checkpoint must carry f+1 signatures
        and the snapshot must match its fingerprint.  Prepared-slot state
        is adopted only when f+1 survivors agree on a slot's (view, batch)
        — a single Byzantine survivor cannot plant a proposal."""
        best: Optional[Tuple[Checkpoint, Any]] = None
        views: List[int] = []
        prep_votes: Dict[Tuple[int, int, bytes], List[tuple]] = {}
        for q in sorted(good):
            _ts, raw = good[q]
            try:
                cp_wire, snap, _upto, view, prepared = crypto.decode(raw)
                cp = Checkpoint.from_wire(cp_wire)
            except Exception:
                continue
            views.append(view)
            if (cp.valid(self.registry, self.quorum) and
                    (best is None or cp.supersedes(best[0]))):
                if (cp.start == 0 or
                        crypto.fingerprint_cached(snap) == cp.app_fp):
                    best = (cp, snap)
            for (s, v, batch) in prepared:
                key = (s, v, crypto.fingerprint_cached(batch))
                prep_votes.setdefault(key, []).append(batch)
        if best is None:
            return False
        cp, snap = best
        if cp.start > 0:
            self.app.adopt(snap)
            self._boundary_snaps[cp.start] = snap
            self.exec_upto = max(self.exec_upto, cp.start - 1)
            self._maybe_checkpoint(cp)
        for (s, v, _fp), batches in sorted(prep_votes.items()):
            if len(batches) >= self.quorum and s not in self.my_prepared:
                self.my_prepared[s] = (v, as_batch(batches[0]))
        target = max(views, default=0)
        self._join_view_hint = target
        return True

    def _on_join_sync(self, src: str, body: tuple) -> None:
        """A member replays its own recent CTBcast stream to me (I joined
        after those broadcasts left the tail).  The broadcaster vouching
        for its own stream is exactly what a broadcast is — a Byzantine
        sender can only mis-describe *its own* history, which at worst
        keeps its view-change certificates from forming (liveness), never
        alters what verified certificates let me adopt (COMMITs are
        f+1-signed and re-verified on this path like on any other).

        Full replay is gated to the observer-only joining phase: a voting
        replica accepting replays would let a Byzantine leader equivocate
        around CTBcast (send one PREPARE on its stream, a different one as
        a replay) — the joiner casts no votes, so nothing it interprets
        here can complete any quorum.  Once voting (a replay can race the
        activation), only the self-authenticating part is salvaged: COMMIT
        certificates carry f+1 certify signatures and are re-verified, so
        adopting one is safe on any path at any time."""
        st = self.state.get(src)
        if st is None or st.blocked or src in self.retired:
            return
        history = body[0]
        certs = body[1] if len(body) > 1 else ()
        for cert in certs:
            # explicitly attached decided-slot certificates (the sender's
            # own stream never carried a COMMIT for them): re-verified and
            # attributed to the sender as one vouching member
            self._on_commit(src, ("COMMIT", cert), vouch_only=True)
        if not self.joining and self.gap_repair_us is None:
            # historical salvage (recorded deployments): adopt COMMITs,
            # and consume the replayed keys only for a recent-joiner
            # sender whose short stream nobody else can vouch for
            for kk, m in history:
                if certs and kk >= st.fifo_next:
                    st.fifo_next = kk + 1
                    st.recent[kk] = m
                if isinstance(m, tuple) and m and m[0] == "COMMIT":
                    self._on_commit(src, m)
            if certs:
                self._fifo_drain(src)
            return
        if not self.joining:
            # salvage the self-authenticating part, and *consume* the
            # replayed FIFO keys: the EPOCH confirmations that activate a
            # joiner are small and routinely overtake the (much larger)
            # JOIN_SYNC replays on the wire, so this branch is the common
            # landing spot for a freshly activated replica.  Without
            # advancing fifo_next, every later live broadcast from the
            # sender would wait forever on pre-join keys that are never
            # resent — the replica stays deaf to that stream until the
            # sender's next summary boundary, which under a quiet stream
            # (view-change churn only) is unboundedly far away.  The
            # skipped messages are still not interpreted (a replay racing
            # the activation must not complete any live quorum); COMMITs
            # carry f+1 re-verified signatures and are safe to adopt on
            # any path.
            for kk, m in history:
                fresh = kk >= st.fifo_next
                if fresh:
                    st.fifo_next = kk + 1
                    st.recent[kk] = m
                if not isinstance(m, tuple) or not m:
                    continue
                kind = m[0]
                if kind == "COMMIT":
                    if fresh:
                        st.noncp_msgs_in_view += 1
                    self._on_commit(src, m)
                elif not fresh:
                    continue
                elif kind == "SEAL_VIEW":
                    # mirror _on_seal_view's per-peer bookkeeping (minus
                    # the live actions: no CRTFY_VC share, no catch-up of
                    # our own view).  Skipping this leaves st.view stale,
                    # and the sender's first live COMMIT/PREPARE in its
                    # current view would fail _byz_check — permanently
                    # blocking an honest peer.
                    e2 = m[2] if len(m) > 2 else 0
                    if e2 == self.membership.epoch:
                        st.seal_view = m[1]
                        st.view = m[1]
                        st.view_synced = True
                        st.noncp_msgs_in_view = 0
                        st.new_view = None
                    elif e2 > self.membership.epoch:
                        st.view_synced = False
                elif kind == "NEW_VIEW":
                    st.noncp_msgs_in_view += 1
                    e2 = m[2] if len(m) > 2 else 0
                    if e2 == self.membership.epoch:
                        st.new_view = m[1]
                elif kind == "CHECKPOINT":
                    # self-authenticating (f+1 signatures): verify before
                    # trusting, then track like _on_checkpoint_msg so live
                    # PREPAREs against the new window aren't rejected
                    cp = Checkpoint.from_wire(m[1])
                    old_cp = st.checkpoint or self.checkpoint
                    if (cp.supersedes(old_cp) and
                            cp.valid(self.registry, self.quorum)):
                        st.checkpoint = cp
                        self._maybe_checkpoint(cp)
                elif kind == "PREPARE":
                    # counted but NOT recorded into st.prepares: replays
                    # skip _byz_check, and recorded prepares feed the
                    # fast-path decision logic
                    st.noncp_msgs_in_view += 1
            self._fifo_drain(src)
            return
        for kk, m in history:
            if kk >= st.fifo_next:
                st.fifo_next = kk + 1
                st.recent[kk] = m
                self._process_ctb(src, kk, m)
        self._fifo_drain(src)

    def _on_epoch(self, src: str, body: tuple) -> None:
        """f+1 members of the new epoch confirm the agreed switch — the
        joiner becomes a voting member."""
        e, members, _slot, view = body
        if not self.joining or self.pid not in members:
            return
        key = (e, members)
        votes = self._epoch_votes.setdefault(key, set())
        votes.add(src)
        self._epoch_view[key] = max(self._epoch_view.get(key, 0), view)
        if len(votes & set(members)) >= self.quorum:
            self._activate(e, members, self._epoch_view[key])

    def _activate(self, e: int, members: Tuple[str, ...],
                  view_hint: int) -> None:
        if not self.joining or e <= self.membership.epoch:
            return
        self.joining = False
        self._switch_epoch(MembershipEpoch(e, tuple(members)), "", self.pid)
        # catch the group's view up loudly (peers track my view through my
        # SEAL_VIEWs) and re-route anything a client already sent me
        target = max(view_hint, getattr(self, "_join_view_hint", 0))
        if target > self.view:
            self._catch_up_view(target)
        else:
            self._after_view_entered()
        if self.leader() == self.pid:
            # Activated straight into the seated-leader chair, but without
            # NEW_VIEW certificates the log position (next_slot) is blind —
            # proposing would land on already-decided slots and stall the
            # group for a full patience window.  Hand leadership on through
            # the certified view-change machinery instead.
            self.change_view()
        for hook in self.on_activate_hooks:
            hook()

    # ==================================================================
    # View change (Algorithm 3)
    # ==================================================================
    def _arm_progress_timer(self) -> None:
        if self.progress_deadline is None:
            self.progress_deadline = self.sim.now + self.view_patience
        if self._progress_timer_armed:
            return
        self._progress_timer_armed = True

        def _check() -> None:
            self._progress_timer_armed = False
            if not self._has_pending():
                self.progress_deadline = None
                return
            if (self.progress_deadline is not None and
                    self.sim.now >= self.progress_deadline):
                # starvation episode: pending work outlived the deadline
                # under the current leader's seat — record it against that
                # seat before rotating (the suspicion signal feed)
                hc = self.health_counters
                hc["starvations"] += 1
                stale = self._leader_pid
                if stale != self.pid:
                    sp = hc["seated_past"]
                    sp[stale] = sp.get(stale, 0) + 1
                for hook in self.on_starvation_hooks:
                    hook(stale)
                # patience for the next leader starts now, doubled (liveness
                # under eventual synchrony: a view must outlast the slow path)
                self.view_patience = min(self.view_patience * 2,
                                         64 * self.cfg.view_timeout_us)
                self.progress_deadline = self.sim.now + self.view_patience
                self.change_view()
            self._arm_progress_timer()

        self.timer(self.cfg.view_timeout_us / 4, _check)

    def _has_pending(self) -> bool:
        undecided = any(rid not in self.decided_rids for rid in self.pending_req)
        return (undecided or bool(self.waiting_prepare)
                or bool(self._svc_wait))

    def change_view(self) -> None:
        if self.changing_view or self.joining:
            return
        self.changing_view = True
        self._fulfill_promises_then_seal()

    def _seal_view_msg(self) -> tuple:
        """SEAL_VIEW carries the membership epoch once it is non-zero;
        epoch-0 messages keep the historical 2-tuple shape (bit-identical
        static deployments)."""
        e = self.membership.epoch
        if e == 0:
            return ("SEAL_VIEW", self.view)
        return ("SEAL_VIEW", self.view, e)

    def _fulfill_promises_then_seal(self) -> None:
        """Alg. 3 lines 4-5 + §5.4 promises.

        Before SEAL_VIEW: (1) every WILL_CERTIFY promise of this view is
        fulfilled by broadcasting CERTIFY (unconditional — this is what makes
        the WILL_COMMIT waits below live at *other* replicas), and (2) every
        WILL_COMMIT promise is fulfilled by broadcasting a COMMIT certificate
        (or the slot is covered by a checkpoint).  fast-path decisions
        survive the view change exactly because of these waits.
        """
        for (v, s) in sorted(self.my_will_certifies):
            if v == self.view and s in self.checkpoint.open_slots:
                self._do_certify(v, s)
        pending = [s for (v, s) in self.my_will_commits
                   if v == self.view and s not in self.my_commits
                   and s in self.checkpoint.open_slots]
        if pending:
            self.timer(50.0, self._fulfill_promises_then_seal)
            return
        self.view += 1
        self._leader_pid = self.replicas[self.view % self.n]
        self.health_counters["view_changes"] += 1
        self._ctb_broadcast(self._seal_view_msg())
        self.changing_view = False
        self._after_view_entered()

    def _after_view_entered(self) -> None:
        """RPC re-routing after a view change: followers re-echo pending
        requests to the new leader; the new leader re-notes them."""
        # requests proposed in dead views may be proposed again
        self.proposed_rids = {rid for rid in self.proposed_rids
                              if rid in self.decided_rids}
        # rids with a live PREPARE in an open slot will be re-proposed by
        # _repropose — don't also queue them (double assignment)
        prepared_rids = {r[0] for s, (_v, batch) in self.my_prepared.items()
                         if s > self.exec_upto for r in batch}
        for rid, req in list(self.pending_req.items()):
            if rid in self.decided_rids or rid in prepared_rids:
                continue
            if self.is_leader():
                self._note_echo(rid, self.pid)
            else:
                self.send(self.leader(), "ECHO", (rid,))
        if self._has_pending():
            self._arm_progress_timer()

    def _on_seal_view(self, p: str, m: tuple) -> None:
        v = m[1]
        e = m[2] if len(m) > 2 else 0
        if e != self.membership.epoch:
            # Wrong-epoch SEAL_VIEW: rejected like a stale view.  The
            # drop is permanent (the FIFO slot is consumed) — recovery is
            # by *fresh* seals, not resends: a replica whose pending work
            # stalls re-seals through its own progress timer, and later
            # same-epoch SEAL_VIEWs re-establish the peer's view.  Worst
            # case is a bounded liveness delay around the switch window.
            if e > self.membership.epoch:
                # the peer advanced past my epoch: its views are now
                # unknowable until I catch up and it seals afresh — relax
                # the strict per-view checks so I don't block an honest
                # peer on its post-switch traffic
                self.state[p].view_synced = False
            return
        st = self.state[p]
        st.seal_view = v
        st.view = v
        st.view_synced = True
        st.noncp_msgs_in_view = 0
        st.new_view = None
        if not self.joining:
            # certificate share attesting q's state (as of this FIFO point)
            snap = self._peer_snapshot(p)
            digest = crypto.fingerprint_cached(snap)
            self.vc_snapshots[(v, p)] = snap
            ldr = self.leader(v)
            self.async_sign(("vc", v, p, digest), lambda sig: self.send(
                ldr, "CRTFY_VC", (v, p, digest, sig)))
        if v > self.view:
            # peer is ahead: join the view change
            self._catch_up_view(v)

    def _catch_up_view(self, v: int) -> None:
        while self.view < v:
            self.view += 1
            self._leader_pid = self.replicas[self.view % self.n]
            self.health_counters["view_changes"] += 1
            self._ctb_broadcast(self._seal_view_msg())
        self._after_view_entered()

    def _peer_snapshot(self, p: str) -> tuple:
        st = self.state[p]
        cp = st.checkpoint or self.checkpoint
        commits = tuple(sorted(
            (s, self._cert_wire(c)) for s, c in st.commits.items()
            if s in cp.open_slots))
        return ("snap", p, st.view, cp.to_wire(), commits)

    @staticmethod
    def _cert_wire(c: dict) -> tuple:
        return (c["view"], c["slot"], c["fp"], c["req"], tuple(c["sigs"]))

    def _on_crtfy_vc(self, src: str, body: tuple) -> None:
        v, q, digest, sig = body
        if src not in self._member_set:
            return  # view-change shares come from current-epoch members
        if self.leader(v) != self.pid:
            return
        self.async_verify(src, ("vc", v, q, digest), sig,
                          lambda ok: self._vc_share_verified(ok, src, v, q,
                                                             digest, sig))

    def _vc_share_verified(self, ok: bool, src: str, v: int, q: str,
                           digest: bytes, sig: bytes) -> None:
        if not ok:
            return
        shares = self.vc_shares.setdefault((v, q), {})
        shares[src] = (digest, sig)
        self._try_new_view(v)

    def _try_new_view(self, v: int) -> None:
        if (self.leader(v) != self.pid or v in self.new_view_sent or
                self.view != v):
            return
        certs: Dict[str, tuple] = {}
        for q in self.replicas:
            shares = self.vc_shares.get((v, q), {})
            snap = self.vc_snapshots.get((v, q))
            if snap is None:
                continue
            my_digest = crypto.fingerprint_cached(snap)
            matching = tuple((pid, sig) for pid, (dg, sig) in sorted(shares.items())
                             if dg == my_digest)
            if len({pid for pid, _ in matching}) >= self.quorum:
                certs[q] = (snap, matching)
        if len(certs) < self.quorum:
            return
        self.new_view_sent.add(v)
        e = self.membership.epoch
        self._ctb_broadcast(("NEW_VIEW", certs) if e == 0
                            else ("NEW_VIEW", certs, e))
        # leader applies its own NEW_VIEW when it FIFO-delivers it

    def _on_new_view(self, p: str, m: tuple) -> None:
        certs = m[1]
        e = m[2] if len(m) > 2 else 0
        if e != self.membership.epoch:
            return  # stale-epoch NEW_VIEW: rejected like a stale view
        st = self.state[p]
        st.new_view = certs
        v = st.view
        while self.view < v:
            self.view += 1
            self._leader_pid = self.replicas[self.view % self.n]
            self._ctb_broadcast(self._seal_view_msg())
        # adopt the highest checkpoint in the certificates
        best_cp = self.checkpoint
        for q, (snap, _shares) in certs.items():
            cp = Checkpoint.from_wire(snap[3])
            if cp.supersedes(best_cp):
                best_cp = cp
        self._maybe_checkpoint(best_cp)
        if self.leader(v) == self.pid:
            self._repropose(v, certs)

    def _repropose(self, v: int, certs: Dict[str, tuple]) -> None:
        """Alg. 3 lines 17-19: transfer constrained slots, no-op the holes,
        then open the remaining slots for new requests."""
        committed_slots = [s for _q, (snap, _sh) in certs.items()
                           for s, _cw in snap[4]]
        max_committed = max(committed_slots, default=self.checkpoint.start - 1)
        proposed_upto = self.checkpoint.start - 1
        for s in self.checkpoint.open_slots:
            if (self.gap_repair_us is not None and s in self.decided and
                    s <= self.exec_upto):
                # Already decided AND executed here: a fresh PREPARE round
                # would re-run the full certify/commit machinery for a
                # settled slot, and a rotation's worth of them in one
                # burst saturates the event loop for the slots that
                # actually need agreement.  A member missing the decision
                # heals from stored commits or the batch gap repair —
                # which is exactly the feature this skip is gated on,
                # keeping non-self-healing deployments bit-identical.
                proposed_upto = s
                continue
            must = self._must_propose(s, certs)
            prior = self.my_prepared.get(s)
            if must is not None:
                req = must
            elif (prior is not None and s > self.exec_upto and
                  any(self._needs_execution(r) and
                      r[0] not in self.executed_rids
                      for r in prior[1])):
                req = prior[1]              # re-propose the in-flight batch
            elif s <= max_committed or s <= self.exec_upto:
                req = _noop_request(v, s)   # ⊥ slot below a committed one
            elif self.propose_queue:
                req = self._assemble_batch()
                if req is None:
                    break
            else:
                break
            proposed_upto = s
            self._ctb_broadcast(("PREPARE", v, s, req))
        self.next_slot = max(self.next_slot, proposed_upto + 1,
                             self.checkpoint.start)
        self.reproposed_views.add(v)
        self._drain_proposals()

    def _must_propose(self, slot: int, certs: Dict[str, tuple]) -> Optional[tuple]:
        """Latest committed request for slot among the certificates, or None."""
        best: Optional[Tuple[int, tuple]] = None
        for q, (snap, _shares) in certs.items():
            commits = snap[4]
            for s, cw in commits:
                if s != slot:
                    continue
                cv, cs, cfp, creq, csigs = cw
                if best is None or cv > best[0]:
                    best = (cv, creq)
        return None if best is None else best[1]

    # ==================================================================
    # CTBcast summaries (Algorithm 4)
    # ==================================================================
    def _need_summary(self, seg: int) -> None:
        """My CTBcast finished segment ``seg`` — gather f+1 certificates."""
        # Receivers send CERTIFY_SUMMARY when their FIFO pointer passes the
        # segment end (see _fifo_drain); nothing to send here — we simply
        # wait.  Self-certify immediately (we trivially know our own stream).
        k_end = (seg + 1) * self.my_ctb.summary_interval - 1
        self._send_certify_summary(self.pid, k_end)

    def _send_certify_summary(self, p: str, k: int) -> None:
        """I have FIFO-processed p's stream up to k (a segment boundary) —
        sign a certificate share of p's recent window (Alg. 4 line 2)."""
        if self.joining:
            return  # summary quorums are drawn from the current epoch
        if p == self.pid:
            recent = dict(self.my_ctb.buf)
        else:
            recent = self.state[p].recent
        # batch-digest the window (t entries; overlapping segment windows
        # hit the memo) and digest the one-shot wrapper cache-free
        lo = k - self.cfg.t
        kks = sorted(kk for kk in recent if lo < kk <= k)
        fps = crypto.fingerprint_batch_cached([recent[kk] for kk in kks])
        window = tuple(zip(kks, fps))
        digest = crypto.fingerprint_fresh(("sum", p, k, window))
        # bookkeeping signature → background task (§3), not the critical path
        self.background(lambda: self.async_sign(
            ("sum", p, k, digest),
            lambda sig: self.send(p, "CERTIFY_SUMMARY", (k, digest, sig))))

    def _on_certify_summary(self, src: str, body: tuple) -> None:
        k, digest, sig = body
        if src not in self._member_set:
            return  # summary quorums are drawn from the current epoch
        si = self.my_ctb.summary_interval
        if (k + 1) % si != 0:
            return
        # one digest per segment end, not one per incoming share: buf is
        # append-only below k at this point, so the window is stable
        my_digest = self._summary_digests.get(k)
        if my_digest is None:
            buf = self.my_ctb.buf
            lo = k - self.cfg.t
            kks = sorted(kk for kk in buf if lo < kk <= k)
            fps = crypto.fingerprint_batch_cached([buf[kk] for kk in kks])
            my_digest = crypto.fingerprint_fresh(
                ("sum", self.pid, k, tuple(zip(kks, fps))))
            self._summary_digests[k] = my_digest
            for old in [kk for kk in self._summary_digests
                        if kk <= k - self.cfg.t]:
                del self._summary_digests[old]
        if digest != my_digest:
            return
        self.background(lambda: self.async_verify(
            src, ("sum", self.pid, k, digest), sig,
            lambda ok: self._summary_sig_ok(ok, src, k, digest, sig)))

    def _summary_sig_ok(self, ok: bool, src: str, k: int, digest: bytes,
                        sig: bytes) -> None:
        if not ok:
            return
        sigs = self.summary_sigs.setdefault(k, {})
        sigs[src] = sig
        si = self.my_ctb.summary_interval
        seg = k // si
        # quorum drawn from the *current* epoch's membership (shares from
        # since-retired replicas must not certify a summary on their own)
        live = sum(1 for q in sigs if q in self._member_set)
        if live >= self.quorum and seg > self.my_ctb.summaries_ok:
            history = tuple(sorted((kk, m) for kk, m in self.my_ctb.buf.items()
                                   if k - self.cfg.t < kk <= k))
            bundle = (k, digest, tuple(sorted(sigs.items())), history)
            self._tb_broadcast("SUMMARY", k, bundle)
            self.my_ctb.summary_certified(seg)

    def _on_summary(self, origin: str, payload: tuple) -> None:
        k, digest, sigs, history = payload
        window = tuple(zip(
            (kk for kk, _ in history),
            crypto.fingerprint_batch_cached([m for _, m in history])))
        if crypto.fingerprint_fresh(("sum", origin, k, window)) != digest:
            return
        pids = {pid for pid, _ in sigs}
        if len(pids) < self.quorum:
            return
        share = ("sum", origin, k, digest)
        if not all(self.registry.verify_batch(
                [(pid, share, sig) for pid, sig in sigs])):
            return
        st = self.state.get(origin)
        if st is None or st.blocked or origin in self.retired:
            return
        if st.fifo_next > k:
            return  # no gap — nothing to heal
        # Heal the gap: apply missed messages in order WITHOUT the Byzantine
        # checks (Alg. 4 line 14 — the f+1 certificate vouches for them).
        start = max(st.fifo_next, k - self.cfg.t + 1)
        for kk, m in history:
            if start <= kk <= k and kk >= st.fifo_next:
                st.fifo_next = kk + 1
                st.recent[kk] = m
                self._process_ctb(origin, kk, m)
        st.fifo_next = max(st.fifo_next, k + 1)
        self._fifo_drain(origin)

    # ==================================================================
    # accounting (Table 2)
    # ==================================================================
    def memory_bytes(self) -> dict:
        tb = self.tb.memory_bytes()
        ctb = sum(c.memory_bytes() for c in self.ctb.values())
        # Per-slot buffers are sized for what a slot can hold: one request
        # in the paper's configuration, up to max_batch requests (bounded
        # by max_batch_bytes) with batching — still O(window), per Table 2.
        slot_cap = 64 + (max(self.cfg.max_batch_bytes +
                             self.cfg.max_batch * self._REQ_FRAMING,
                             self.cfg.max_request_bytes)
                         if self.cfg.max_batch > 1
                         else self.cfg.max_request_bytes)
        window_slots = (len(self.decided) + len(self.my_prepared))
        window_bufs = window_slots * slot_cap
        # executed results are retained at their actual (batched) size
        result_bufs = sum(64 + sum(len(r) for r in res)
                          for res in self.results.values())
        # actual occupancy of the retained batches (≤ the preallocated cap)
        window_actual = (
            sum(crypto.batch_wire_size(b) for b in self.decided.values()) +
            sum(crypto.batch_wire_size(b) for _v, b in self.my_prepared.values()))
        return {"tbcast_buffers": tb, "ctbcast_arrays": ctb,
                "window_state": window_bufs + result_bufs,
                "window_actual": window_actual + result_bufs,
                "total": tb + ctb + window_bufs + result_bufs}
