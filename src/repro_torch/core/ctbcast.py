"""Consistent Tail Broadcast — Algorithm 1 of the paper.

CTBcast prevents equivocation for *all* messages while guaranteeing delivery
of only the last ``t`` messages of a correct broadcaster (tail-validity).
Properties: Tail-validity, Agreement, Integrity, No-duplication.

Fast path (signature-free, no disaggregated memory):
    broadcaster:  TBcast <LOCK, k, m>
    receiver:     on LOCK   — commit in ``locks[k%t]``, TBcast <LOCKED, k, m>
                  on LOCKED — unanimity over all n processes → deliver

Slow path (signatures + SWMR registers; triggered on timeout / by caller):
    broadcaster:  TBcast <SIGNED, k, m, sign((k, H(m)))>
    receiver:     verify sig → check/update locks → WRITE own register[k%t]
                  → READ everyone's register[k%t] → abort on conflicting k /
                  out-of-tail higher k → deliver

Registers store ``(k, sig, H(m))`` — only the 32 B fingerprint goes to
disaggregated memory (§7.6); the message body travels over TBcast.

The fast and slow paths are linked through ``locks`` (lines 15/29): whichever
path executes first at a receiver pins the message for the other path.

Summaries / broadcast blocking (§5.2, Algorithm 4 hooks): every ``t/2``
broadcasts the broadcaster requests a summary certificate of its state from
f+1 receivers and blocks once *two* segments are outstanding (the paper's
double-buffering, footnote 3).  The summary content is supplied by the layer
above (consensus) through callbacks; a standalone default is provided for
direct CTBcast use (benchmarks Figs 10/11).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import crypto
from repro_torch.core.node import Node
from repro_torch.core.registers import RegisterClient
from repro_torch.core.tbcast import TBcastService


@dataclass
class _Slot:
    k: int = -1
    m: Any = None


class CTBcast:
    """One CTBcast instance: a designated broadcaster, n receivers.

    In uBFT every replica runs one instance per broadcaster (n instances per
    node); the broadcaster participates as a receiver of its own instance.
    """

    def __init__(self, node: Node, tb: TBcastService, regs: Optional[RegisterClient],
                 broadcaster: str, group: List[str], t: int,
                 deliver: Callable[[int, Any], None],
                 auto_slow_after_us: Optional[float] = None,
                 summary_interval: Optional[int] = None,
                 on_summary_needed: Optional[Callable[[int], None]] = None,
                 fast_enabled: bool = True):
        self.node = node
        self.tb = tb
        self.regs = regs
        self.broadcaster = broadcaster
        self.group = list(group)
        self.n = len(group)
        self.t = t
        self.deliver_cb = deliver
        self.auto_slow_after_us = auto_slow_after_us
        self.fast_enabled = fast_enabled
        self.is_broadcaster = node.pid == broadcaster

        # Receiver state (Algorithm 1, lines 6-10) — all arrays are t-sized.
        self.locks: List[_Slot] = [_Slot() for _ in range(t)]
        self.locked: Dict[str, List[_Slot]] = {q: [_Slot() for _ in range(t)]
                                               for q in group}
        self.delivered: List[int] = [-1] * t

        # Broadcaster state: buffer of the last 2t broadcasts (for slow-path
        # escalation and summary-based catch-up).
        self.buf: Dict[int, Any] = {}
        self.next_k = 0

        # Summary machinery (double-buffered blocking).
        self.summary_interval = summary_interval or max(1, t // 2)
        self.on_summary_needed = on_summary_needed
        self.summaries_ok: int = -1           # highest summary id certified
        self.blocked_queue: List[Tuple[int, Any]] = []
        self.stall_count = 0
        self.stalled_since: Optional[float] = None
        self.total_stall_us = 0.0

        # NB: stream names must not be prefixes of one another (TBcast
        # dispatches by prefix): LOCK vs LOCKED would collide.
        base = f"ctb/{broadcaster}"
        self._s_lock = f"{base}/LK/"
        self._s_signed = f"{base}/SG/"
        self._s_locked = f"{base}/LD/"        # per-origin via TB origin
        tb.register(self._s_lock, self._on_lock)
        tb.register(self._s_signed, self._on_signed)
        tb.register(self._s_locked, self._on_locked)

    # ------------------------------------------------------------ broadcast
    def broadcast(self, k: int, m: Any, slow: bool = False) -> None:
        """Algorithm 1, lines 2-4 (+ summary blocking)."""
        assert self.is_broadcaster
        if self._blocked(k):
            self.blocked_queue.append((k, m))
            if self.stalled_since is None:
                self.stalled_since = self.node.sim.now
                self.stall_count += 1
            return
        self._do_broadcast(k, m, slow)

    def _blocked(self, k: int) -> bool:
        # Segment i covers ks [i*si, (i+1)*si).  Before broadcasting into
        # segment i we must hold the certificate for segment i-2
        # (double buffering): summaries_ok >= i-2.
        si = self.summary_interval
        seg = k // si
        return seg - 2 > self.summaries_ok

    def _do_broadcast(self, k: int, m: Any, slow: bool) -> None:
        self.buf[k] = m
        self.next_k = max(self.next_k, k + 1)
        while len(self.buf) > 2 * self.t:
            del self.buf[min(self.buf)]
        if self.fast_enabled:
            self.tb.broadcast(self._s_lock, k, m, self.group)
        si = self.summary_interval
        if k % si == si - 1 and self.on_summary_needed is not None:
            # end of segment — ask the upper layer to certify a summary
            self.on_summary_needed(k // si)
        if slow or not self.fast_enabled:
            self.escalate(k)
        elif self.auto_slow_after_us is not None and self.auto_slow_after_us > 0:
            self.node.timer(self.auto_slow_after_us,
                            lambda: self._maybe_escalate(k))
        elif self.auto_slow_after_us == 0.0:
            self.escalate(k)

    def _maybe_escalate(self, k: int) -> None:
        if self.delivered[k % self.t] < k and k in self.buf:
            self.escalate(k)

    def escalate(self, k: int) -> None:
        """Trigger the slow path for k: sign and TBcast <SIGNED, k, m, sig>."""
        if k not in self.buf:
            return
        m = self.buf[k]
        fp = crypto.fingerprint_cached(m)
        self.node.async_sign(("ctb", self.broadcaster, k, fp), lambda sig:
                             self.tb.broadcast(self._s_signed, k, (m, sig),
                                               self.group))

    def summary_certified(self, seg: int) -> None:
        """Upper layer certified summary segment ``seg`` — unblock."""
        self.summaries_ok = max(self.summaries_ok, seg)
        q, self.blocked_queue = self.blocked_queue, []
        if self.stalled_since is not None:
            self.total_stall_us += self.node.sim.now - self.stalled_since
            self.stalled_since = None
        for k, m in q:
            self.broadcast(k, m)

    # --------------------------------------------------------- membership
    def set_group(self, group: List[str]) -> None:
        """Switch the receiver group to the current membership epoch.

        LOCKED unanimity (line 22) and every fan-out are computed over
        ``group``; a replaced replica's slots are dropped (its LOCKEDs must
        no longer gate delivery) and a joiner gets fresh t-sized arrays.
        Called by the consensus layer when an agreed MEMBERSHIP slot
        executes — never on the static path.
        """
        group = list(group)
        if group == self.group:
            return
        for q in group:
            if q not in self.locked:
                self.locked[q] = [_Slot() for _ in range(self.t)]
        for q in [q for q in self.locked if q not in group]:
            del self.locked[q]
        self.group = group
        self.n = len(group)

    # ------------------------------------------------------------ fast path
    def _on_lock(self, origin: str, stream: str, k: int, m: Any) -> None:
        if origin != self.broadcaster:
            return  # only the designated broadcaster may LOCK
        slot = self.locks[k % self.t]
        if k > slot.k:                       # line 14
            slot.k, slot.m = k, m            # line 15 (commit)
            if self.fast_enabled:
                self.tb.broadcast(self._s_locked, k, m, self.group)  # line 16

    def _on_locked(self, origin: str, stream: str, k: int, m: Any) -> None:
        if origin not in self.locked:
            return
        i = k % self.t
        slot = self.locked[origin][i]
        if k > slot.k:                       # line 20
            slot.k, slot.m = k, m            # line 21
        mismatched = None
        for q in self.group:                 # line 22 (unanimity)
            s2 = self.locked[q][i]
            if s2.k != k:
                return
            if s2.m is not m:
                if mismatched is None:
                    mismatched = []
                mismatched.append(s2.m)
        if mismatched:
            # honest LOCKEDs all carry the broadcaster's object by
            # reference; fall back to encoding only on mismatch — one
            # batch encode for every diverging slot at once
            enc = crypto.encode_cached(m)
            if any(e != enc
                   for e in crypto.encode_batch_cached(mismatched)):
                return
        self._deliver_once(k, m)             # line 23

    # ------------------------------------------------------------ slow path
    def _on_signed(self, origin: str, stream: str, k: int, payload: Any) -> None:
        if origin != self.broadcaster or self.regs is None:
            return
        m, sig = payload
        fp = crypto.fingerprint_cached(m)
        self.node.async_verify(self.broadcaster, ("ctb", self.broadcaster, k, fp),
                               sig, lambda ok: self._signed_verified(ok, k, m, sig, fp))

    def _signed_verified(self, ok: bool, k: int, m: Any, sig: bytes,
                         fp: bytes) -> None:
        if not ok:                           # line 26
            return
        slot = self.locks[k % self.t]
        same = slot.k == k and (slot.m is m or
                                crypto.encode_cached(slot.m) ==
                                crypto.encode_cached(m))
        if not (k > slot.k or same):         # lines 27-28
            return
        slot.k, slot.m = k, m                # line 29
        value = crypto.encode((k, sig, fp))
        reg = f"{self.broadcaster}/{k % self.t}"
        self.regs.write(reg, value,
                        lambda: self._read_all(k, m, fp))  # line 30

    def _read_all(self, k: int, m: Any, fp: bytes) -> None:
        reg = f"{self.broadcaster}/{k % self.t}"
        results: Dict[str, Any] = {}
        remaining = set(self.group)

        def on_read(q: str, val, byz: bool) -> None:
            results[q] = (val, byz)
            remaining.discard(q)
            if not remaining:
                self._check_registers(k, m, fp, results)

        for q in self.group:
            self.regs.read(q, reg, lambda val, byz, q=q: on_read(q, val, byz))

    def _check_registers(self, k: int, m: Any, fp: bytes, results: Dict) -> None:
        # lines 31-37: verify entries; abort on conflicting same-k message or
        # a higher k aliasing the same register (out of tail).
        entries = []
        for q, (val, byz) in results.items():
            if val is None:
                continue
            try:
                k2, sig2, fp2 = crypto.decode_tuple3(val[1])
            except Exception:
                continue
            entries.append((q, k2, sig2, fp2))
        items = [(self.broadcaster, ("ctb", self.broadcaster, k2, fp2), sig2)
                 for (_q, k2, sig2, fp2) in entries]

        def verified(oks: List[bool]) -> None:
            for ok, (_q, k2, _sig2, fp2) in zip(oks, entries):
                if not ok:
                    continue                  # line 32 (invalid → ignore)
                if k2 == k and fp2 != fp:
                    return                    # line 33: Byzantine broadcaster
                if k2 > k and (k2 - k) % self.t == 0:
                    return                    # line 35: out of tail
            self._deliver_once(k, m)          # line 37

        if items:
            self.node.async_verify_many(items, verified)
        else:
            verified([])

    # ------------------------------------------------------------- deliver
    def _deliver_once(self, k: int, m: Any) -> None:
        if k > self.delivered[k % self.t]:   # lines 40-42
            self.delivered[k % self.t] = k
            self.deliver_cb(k, m)

    # --------------------------------------------------------- accounting
    def memory_bytes(self) -> int:
        """Local bookkeeping arrays: locks(t) + locked(n·t) + delivered(t)."""
        slot = 8 + 64  # k + small message ref
        return self.t * slot + self.n * self.t * slot + self.t * 8
