"""Tail Broadcast (TBcast) — §4.1/§6.2 of the paper.

Best-effort broadcast with *tail* semantics and finite memory:

* the broadcaster buffers only its last ``2t`` messages per stream and
  retransmits them until acknowledged — older messages are evicted
  ("overwritten", §6.2) and may never be delivered;
* correct receivers deliver FIFO per stream and are guaranteed the last
  ``2t`` messages of a correct broadcaster (eventually, post-GST);
* TBcast provides all CTBcast properties except agreement (a Byzantine
  broadcaster can equivocate here — CTBcast fixes that on top).

The wire substrate is the paper's circular-buffer primitive (§6.2): no
per-message acknowledgements on the critical path (acks ride a coarse timer,
mirroring the paper's piggybacking), sender-side eviction under backlog, and
FIFO skip-ahead at the receiver when the sender's window has moved on (the
``min_k`` field plays the role of the incarnation-number scan).

Memory accounting (Table 2): each stream×peer connection owns ``t`` wire
slots plus a ``t``-deep staging buffer, each slot sized for the largest
message — exposed through :meth:`TBcastService.memory_bytes`.

Ack/RTO timer lifecycle across crashes
--------------------------------------
Both coarse timers are guarded by a *pending* flag (``ack_pending`` on the
receive side, ``rto_pending`` on the send side) so at most one timer per
state is ever in flight.  The flags therefore carry a liveness obligation:
whoever sets one must guarantee the matching ``_fire`` eventually clears
it, **including across a crash+recover of this node** (crash-recover
preserves all state — §2's crash-recovery processes).  The rules:

* timers are scheduled on the raw simulator (``sim.after``), *not* through
  ``Node.timer``: the fire always runs, clears its pending flag first, and
  only then checks ``crashed`` before acting.  A fire during the crash
  window is thus a flag reset, never an ack/retransmission — a crashed
  node stays silent, but cannot strand its own bookkeeping.
* a ``Node.recover_hooks`` entry (:meth:`TBcastService._on_recover`)
  re-arms whatever the crash window dropped: receive states with
  undelivered acks schedule a fresh ack (so live senders' retransmission
  loops quiesce as soon as the node returns), and send states with live
  unacked window entries re-arm their RTO (a crash between fires would
  otherwise leave the window un-retransmitted until an unrelated broadcast
  happened to land on the same stream).
* retransmission to an unresponsive peer decays: every RTO fire that
  retransmits without intervening ack progress doubles the next interval
  (bounded by ``2^rto_backoff_max``); any ack progress resets the interval
  to ``rto_us``.  Steady-state chatter toward a crashed/partitioned peer
  is therefore bounded instead of a full-window resend every ``rto_us``
  forever.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import crypto
from repro_torch.core.node import Node

#: per-slot header: checksum(8) + incarnation(8) + size(8)  (§6.2)
SLOT_HEADER = 24


@dataclass
class _SendState:
    """Sender-side per (stream, dst) window."""
    window: Dict[int, Any] = field(default_factory=dict)  # k -> payload
    min_k: int = 0          # lowest k still buffered
    next_k: int = 0
    acked: int = -1         # highest contiguously acked k
    rto_pending: bool = False
    backoff: int = 0        # consecutive no-progress RTO fires (exponent)
    rto_gen: int = 0        # invalidates superseded in-flight RTO timers
    rto_at: float = 0.0     # when the pending RTO fire is scheduled


@dataclass
class _RecvState:
    """Receiver-side per (origin, stream) reorder buffer."""
    pending: Dict[int, Any] = field(default_factory=dict)
    next_k: int = 0         # next k to deliver FIFO
    max_seen: int = -1
    ack_pending: bool = False
    last_acked: int = -1


class TBcastService:
    """Multiplexes tail-broadcast streams for one node."""

    def __init__(self, node: Node, t: int, rto_us: float = 60.0,
                 ack_interval_us: float = 40.0, max_msg_bytes: int = 4096,
                 rto_backoff_max: int = 6):
        self.node = node
        self.t = t
        self.rto_us = rto_us
        self.ack_interval_us = ack_interval_us
        self.max_msg_bytes = max_msg_bytes
        #: cap on the no-progress backoff exponent: the retransmission
        #: interval to an unresponsive peer decays to 2^max × rto_us and
        #: stays there (bounded — the peer may yet recover)
        self.rto_backoff_max = rto_backoff_max
        self._send: Dict[Tuple[str, str], _SendState] = {}   # (stream, dst)
        self._recv: Dict[Tuple[str, str], _RecvState] = {}   # (origin, stream)
        #: per-dst count of RTO fires that actually retransmitted — a peer
        #: that stops acking shows up here (the health layer's "ack
        #: silence" suspicion signal; local bookkeeping, no wire effect)
        self.retx_fires: Dict[str, int] = {}
        self._handlers: List[Tuple[str, Callable[[str, str, int, Any], None]]] = []
        self._route: Dict[str, Optional[Callable]] = {}  # stream -> handler
        self._conns: set = set()
        node.handle("TB", self._on_tb)
        node.handle("TB_ACK", self._on_ack)
        node.recover_hooks.append(self._on_recover)

    # ------------------------------------------------------------------ API
    def register(self, prefix: str,
                 handler: Callable[[str, str, int, Any], None]) -> None:
        """handler(origin_pid, stream, k, payload); matched by stream prefix."""
        self._handlers.append((prefix, handler))
        self._route.clear()   # memoized routes may predate this prefix

    def broadcast(self, stream: str, k: int, payload: Any,
                  group: List[str]) -> None:
        """Broadcast (k, payload) on ``stream`` to ``group`` (may include self)."""
        # wire size is identical for every destination — price it once.
        # Shallow sizing: vote payloads are fresh per-broadcast tuples
        # (their shared subtrees still hit the memo), so inserting the
        # wrapper itself into the wire cache would be pure churn.
        # (38 = tuple header 4 + two int fields 16 + kind "TB" 2 + framing 16)
        size = 38 + len(stream) + crypto.wire_size_shallow(payload)
        node = self.node
        sim = node.sim
        now = sim.now
        rto = self.rto_us
        # Consecutive wire destinations accumulate into one run shipped via
        # send_fanout (guards + pricing hoisted, one heap entry when jitter
        # permits).  A self-delivery flushes the run first, so every heap
        # push happens in the same relative order as the per-dst loop this
        # replaced.  Regrouping each run's sends before its RTO arms cannot
        # create a (time, seq) tie: arrivals land ≤ ~6 µs out, RTO timers
        # ≥ rto_us (60 µs) out — see DESIGN_PERF.md.
        pend_dst: List[str] = []
        pend_st: List[_SendState] = []

        def _flush() -> None:
            mk = pend_st[0].min_k
            if all(st.min_k == mk for st in pend_st):
                node.net.send_fanout(node.pid, pend_dst,
                                     ("TB", (stream, k, mk, payload)), size)
            else:   # window floors diverged (post-eviction): per-dst frames
                for dst, st in zip(pend_dst, pend_st):
                    node.net.send(node.pid, dst,
                                  ("TB", (stream, k, st.min_k, payload)), size)
            for dst, st in zip(pend_dst, pend_st):
                # the second disjunct catches a stale long-backoff timer
                # outliving an ack-progress reset: fresh traffic then
                # supersedes it instead of waiting out the decay
                if (not st.rto_pending or
                        st.rto_at > now + rto * (1 << st.backoff)):
                    self._arm_rto(stream, dst, st)
            pend_dst.clear()
            pend_st.clear()

        for dst in group:
            if dst == node.pid:
                if pend_dst:
                    _flush()
                # Local self-delivery (no wire) — still costs a dispatch.
                if not node.crashed:
                    done = node.occupy(node.handling_cost)

                    def _self(kk=k, pl=payload) -> None:
                        if not node.crashed:
                            self._deliver(node.pid, stream, kk, pl)

                    sim.at(done, _self)
                continue
            key = (stream, dst)
            st = self._send.get(key)
            if st is None:   # avoid constructing a throwaway default
                st = self._send[key] = _SendState()
                self._conns.add(key)
            # min_k is maintained incrementally (an O(n) min() per
            # broadcast dominated the hot path); the O(n) recompute only
            # runs on the rare eviction under backlog.
            if not st.window or k < st.min_k:
                st.min_k = k
            st.window[k] = payload
            if k >= st.next_k:
                st.next_k = k + 1
            # Evict beyond 2t (tail semantics: old messages are overwritten).
            while len(st.window) > 2 * self.t:
                oldest = min(st.window)
                del st.window[oldest]
                st.min_k = min(st.window)
            pend_dst.append(dst)
            pend_st.append(st)
        if pend_dst:
            _flush()

    def drop_peer(self, pid: str) -> None:
        """Free every connection to/from a replica retired by an epoch
        switch: its send windows stop retransmitting and its receive
        buffers are released, so the preallocated wire memory of §6.2
        (``memory_bytes``) stays bounded across replacements instead of
        accumulating one dead connection set per retired pid."""
        for key in [key for key in self._send if key[1] == pid]:
            st = self._send[key]
            # a pending RTO still holds a reference: empty the window so
            # the timer chain finds nothing live and stops re-arming
            st.window.clear()
            st.acked = st.next_k
            del self._send[key]
            self._conns.discard(key)
        for key in [key for key in self._recv if key[0] == pid]:
            del self._recv[key]

    # ----------------------------------------------------------------- wire
    def _arm_rto(self, stream: str, dst: str,
                 st: Optional[_SendState] = None) -> None:
        if st is None:
            st = self._send[(stream, dst)]
        delay = self.rto_us * (1 << st.backoff)
        due = self.node.sim.now + delay
        if st.rto_pending and st.rto_at <= due:
            return
        # either nothing pending, or the pending fire sits further out than
        # the current backoff warrants (it was armed under a higher exponent
        # before an ack reset it): supersede the old timer via the
        # generation counter — simulator timers cannot be cancelled
        st.rto_pending = True
        st.rto_at = due
        st.rto_gen += 1
        gen = st.rto_gen

        def _fire() -> None:
            if gen != st.rto_gen:
                return      # superseded by a re-arm with a shorter delay
            # the flag reset must survive a crash window (see the module
            # docstring's timer-lifecycle rules): clear first, then gate
            # the actual retransmission on liveness.  Recovery re-arms.
            st.rto_pending = False
            if self.node.crashed:
                return
            live = {k: v for k, v in st.window.items() if k > st.acked}
            if not live:
                st.backoff = 0
                return
            st.min_k = min(st.window) if st.window else st.next_k
            self.retx_fires[dst] = self.retx_fires.get(dst, 0) + 1
            # batch-size the retransmission sweep: one sizing pass for the
            # whole live window (payloads are long-lived — all memo hits)
            ks = sorted(live)
            sizes = crypto.wire_size_batch([live[kk] for kk in ks])
            frame = 38 + len(stream)
            send = self.node.net.send
            pid = self.node.pid
            mk = st.min_k
            for kk, sz in zip(ks, sizes):
                send(pid, dst, ("TB", (stream, kk, mk, live[kk])), frame + sz)
            # no ack progress since the last fire (an ack would have reset
            # the exponent): decay the next interval instead of flooding a
            # dead peer with a full-window resend every rto_us forever
            if st.backoff < self.rto_backoff_max:
                st.backoff += 1
            self._arm_rto(stream, dst)

        self.node.sim.after(delay, _fire)

    # ------------------------------------------------------------- receive
    def _on_tb(self, src: str, body: Any) -> None:
        stream, k, min_k, payload = body
        key = (src, stream)
        rs = self._recv.get(key)
        if rs is None:
            rs = self._recv[key] = _RecvState()
        if k < rs.next_k:
            self._maybe_ack(src, stream, rs)
            return  # duplicate / already delivered
        if k == rs.next_k and not rs.pending:
            # in-order fast path (the overwhelmingly common case): skip the
            # reorder-buffer round trip.  k == next_k implies min_k <= next_k,
            # so the skip-ahead below would be a no-op anyway.
            if k > rs.max_seen:
                rs.max_seen = k
            rs.next_k = k + 1
            handler = self._route.get(stream)
            if handler is not None:
                handler(src, stream, k, payload)
            else:
                self._deliver(src, stream, k, payload)
            if not rs.ack_pending and k > rs.last_acked:
                self._maybe_ack(src, stream, rs)
            return
        rs.max_seen = max(rs.max_seen, k)
        rs.pending[k] = payload
        # Skip-ahead: anything below the sender's window floor is lost
        # (overwritten at the sender) — FIFO pointer jumps forward (§6.2).
        if min_k > rs.next_k:
            for kk in [x for x in rs.pending if x < min_k]:
                del rs.pending[kk]
            rs.next_k = min_k
        self._drain(src, stream, rs)
        self._maybe_ack(src, stream, rs)

    def _drain(self, origin: str, stream: str, rs: _RecvState) -> None:
        while rs.next_k in rs.pending:
            payload = rs.pending.pop(rs.next_k)
            k = rs.next_k
            rs.next_k += 1
            self._deliver(origin, stream, k, payload)
        # Bound the reorder buffer (Byzantine sender flooding far-future ks).
        if len(rs.pending) > 2 * self.t:
            for kk in sorted(rs.pending)[: len(rs.pending) - 2 * self.t]:
                del rs.pending[kk]

    def _deliver(self, origin: str, stream: str, k: int, payload: Any) -> None:
        try:
            handler = self._route[stream]
        except KeyError:
            handler = None
            for prefix, h in self._handlers:
                if stream.startswith(prefix):
                    handler = h
                    break
            self._route[stream] = handler
        if handler is not None:
            handler(origin, stream, k, payload)

    def _maybe_ack(self, origin: str, stream: str, rs: _RecvState) -> None:
        if rs.ack_pending or rs.next_k - 1 <= rs.last_acked:
            return
        rs.ack_pending = True

        def _fire() -> None:
            # clear the flag unconditionally — a fire swallowed whole by a
            # crash guard used to strand ack_pending=True forever, leaving
            # every live sender retransmitting its window to this replica
            # indefinitely after recovery (duplicates with k < next_k hit
            # the pending-flag early-return above and never re-acked)
            rs.ack_pending = False
            if self.node.crashed:
                return      # stay silent; _on_recover re-arms if needed
            rs.last_acked = rs.next_k - 1
            self.node.send(origin, "TB_ACK", (stream, rs.last_acked))

        self.node.sim.after(self.ack_interval_us, _fire)

    def _on_ack(self, src: str, body: Any) -> None:
        stream, upto = body
        st = self._send.get((stream, src))
        if st is None:
            return
        if upto > st.acked:
            st.backoff = 0      # ack progress: retransmission back to rto_us
        st.acked = max(st.acked, upto)
        for k in [k for k in st.window if k <= st.acked]:
            del st.window[k]
        if st.window:
            st.min_k = min(st.window)

    # ------------------------------------------------------------- recovery
    def _on_recover(self) -> None:
        """Re-arm timer-driven state after a crash+recover of this node.

        Crash-recover preserves all broadcast state, but any ack/RTO fire
        that landed inside the crash window only reset its pending flag —
        the ack was never sent and the RTO chain was not re-armed.  On the
        receive side that leaves live senders retransmitting to us until we
        ack again; on the send side it leaves unacked window entries that
        would only be retransmitted if a fresh broadcast happened to land
        on the same stream.  Both are quiesced here."""
        for (origin, stream), rs in self._recv.items():
            self._maybe_ack(origin, stream, rs)
        for (stream, dst), st in self._send.items():
            if any(k > st.acked for k in st.window):
                self._arm_rto(stream, dst, st)

    # ---------------------------------------------------------- accounting
    def memory_bytes(self) -> int:
        """Preallocated wire memory (§6.2): per connection, t slots + t-deep
        staging area, each slot sized for the largest message + header."""
        slot = self.max_msg_bytes + SLOT_HEADER
        return len(self._conns) * 2 * self.t * slot
