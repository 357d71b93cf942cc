"""In-memory KV store — the Memcached/Redis analog of §7.1.

Request wire format (binary, matching the paper's 16 B keys / 32 B values):
    b"G" + key            -> GET
    b"S" + klen(1) + key + value -> SET
    b"M" + n(1) + n × (klen(1) + key + vlen(1) + value) -> MSET (multi-put)
Responses: value bytes (b"" on miss) or b"OK".

Every length field is one byte, so the encoders *raise* on anything that
cannot be framed (``>255`` pairs, keys or values) instead of silently
truncating, and :meth:`KVStoreApp.apply` answers a deterministic ``b"ERR"``
on any payload whose declared lengths disagree with its actual bytes — a
malformed request must never mis-parse into a different (but valid-looking)
operation, because every honest replica must produce the *same* reply.

:class:`ShardKVApp` extends the store with the participant/coordinator
state of cross-shard two-phase commit (``repro/service/``): PREPARE locks
keys and records a pending intent, DECIDE records the transaction outcome
exactly once on the coordinator shard's log, FINISH applies-or-discards the
intent.  Each of those is an ordinary consensus request — *each 2PC phase
is itself a BFT-committed slot* (see DESIGN_SHARDING.md):

    b"P" + txid(20) + deadline_us(<Q) + coord(<H) + n(1) + pairs -> TPREP
    b"D" + txid(20) + outcome(1: C|A)                            -> TDECIDE
    b"F" + txid(20) + outcome(1: C|A)                            -> TFINISH
    b"R" + txid(20) + outcome(1) + n(1) + n × (plen(1)+pid+sig(64))
                                             -> recovery TFINISH + outcome
                                                certificate (f+1 coordinator
                                                replica signatures; verified
                                                at the consensus layer's svc
                                                endorsement gate, not here)
    b"O" + txid(20)                                              -> outcome?

A txid is ``owner_tag(8) || seq(<I) || nonce(<Q)``: the tag binds the
transaction to the submitting client (sha256 of its pid — collision-free
where the old crc32 salt was not), the seq separates one client's
transactions, and the nonce makes the txid unguessable to other clients.
The coordinator's DECIDE record enforces the binding: a commit outcome is
only ever recorded when proposed by the txid's owner (authenticated caller
via :meth:`~repro.core.consensus.App.apply_from`); abort stays open to
anyone so replica recovery probes can presume-abort abandoned
transactions.
"""

from __future__ import annotations

import hashlib
import struct
import zlib
from typing import Dict, List, Tuple

from repro_torch.core.consensus import App

#: one-byte length fields frame every key/value/pair-count on the wire
MAX_LEN = 255

#: owner tag (8) + per-client seq (4) + unguessable nonce (8)
TXID_LEN = 20

VOTE_OK = b"VOTE_OK"
VOTE_CONFLICT = b"VOTE_CONFLICT"


def tx_owner_tag(pid: str) -> bytes:
    """The 8-byte owner component of a txid: a collision-resistant digest
    of the submitting client's pid.  Forging a commit-DECIDE for another
    client's transaction would need a second preimage of its tag under an
    authenticated caller identity — out of the model's reach."""
    return hashlib.sha256(pid.encode()).digest()[:8]


def make_txid(pid: str, seq: int, nonce: int) -> bytes:
    """``owner_tag || seq || nonce``.  ``nonce`` models a draw from the
    client's CSPRNG: unpredictable to every other client, so in-flight
    transactions cannot even be *named* (let alone decided) by a
    Byzantine client that merely guesses txids."""
    return tx_owner_tag(pid) + struct.pack("<IQ", seq & 0xFFFFFFFF, nonce)


def get_req(key: bytes) -> bytes:
    return b"G" + key


def set_req(key: bytes, value: bytes) -> bytes:
    if len(key) > MAX_LEN:
        raise ValueError(f"key of {len(key)} B does not fit the 1-byte "
                         f"length field (max {MAX_LEN})")
    return b"S" + bytes([len(key)]) + key + value


def mset_req(pairs: List[Tuple[bytes, bytes]]) -> bytes:
    """One request carrying several puts — application-level batching that
    composes with the consensus layer's slot batching."""
    return b"M" + _encode_pairs(pairs)


def _encode_pairs(pairs: List[Tuple[bytes, bytes]]) -> bytes:
    if len(pairs) > MAX_LEN:
        raise ValueError(f"{len(pairs)} pairs do not fit the 1-byte count "
                         f"field (max {MAX_LEN})")
    out = bytes([len(pairs)])
    for k, v in pairs:
        if len(k) > MAX_LEN or len(v) > MAX_LEN:
            raise ValueError(f"key/value of {len(k)}/{len(v)} B does not "
                             f"fit the 1-byte length field (max {MAX_LEN})")
        out += bytes([len(k)]) + k + bytes([len(v)]) + v
    return out


def _decode_pairs(req: bytes, off: int):
    """Parse ``n(1) + n × (klen+key+vlen+value)`` fully before anything is
    applied; returns ``None`` on any length mismatch (deterministic ERR at
    the caller) so a truncated payload can never half-apply."""
    if off >= len(req):
        return None
    n = req[off]
    off += 1
    pairs = []
    for _ in range(n):
        if off >= len(req):
            return None
        klen = req[off]
        key = req[off + 1:off + 1 + klen]
        off += 1 + klen
        if len(key) != klen or off >= len(req):
            return None
        vlen = req[off]
        value = req[off + 1:off + 1 + vlen]
        off += 1 + vlen
        if len(value) != vlen:
            return None
        pairs.append((key, value))
    if off != len(req):
        return None
    return pairs


class KVStoreApp(App):
    def __init__(self) -> None:
        self.store: Dict[bytes, bytes] = {}

    def apply(self, req: bytes) -> bytes:
        op = req[:1]
        if op == b"G":
            return self.store.get(req[1:], b"")
        if op == b"S":
            if len(req) < 2:
                return b"ERR"
            klen = req[1]
            key = req[2:2 + klen]
            if len(key) != klen:
                return b"ERR"   # declared length overruns the payload
            value = req[2 + klen:]
            self.store[key] = value
            return b"OK"
        if op == b"M":
            # parse the whole payload before touching the store: a
            # malformed/truncated request is rejected atomically
            pairs = _decode_pairs(req, 1)
            if pairs is None:
                return b"ERR"
            for key, value in pairs:
                self.store[key] = value
            return b"OK"
        return b"ERR"

    def snapshot(self):
        return tuple(sorted(self.store.items()))

    def adopt(self, snap) -> None:
        self.store = dict(snap)


# --------------------------------------------------------------------------
# Sharded-service participant: 2PC state behind the same App interface
# --------------------------------------------------------------------------
_TPREP_HDR = struct.Struct("<QH")   # deadline_us, coordinator shard index


def tprep_req(txid: bytes, deadline_us: float, coord_shard: int,
              pairs: List[Tuple[bytes, bytes]]) -> bytes:
    """PREPARE this shard's slice of a cross-shard transaction: lock the
    keys, record the intent, vote.  ``deadline_us`` (absolute sim time) is
    consumed by the *replica-layer* recovery timers, never by apply()."""
    assert len(txid) == TXID_LEN
    return (b"P" + txid + _TPREP_HDR.pack(int(deadline_us), coord_shard) +
            _encode_pairs(pairs))


def tdecide_req(txid: bytes, outcome: bytes) -> bytes:
    """Record the transaction outcome on the coordinator shard (exactly
    once: the first DECIDE in its log wins; later ones read it back)."""
    assert outcome in (b"C", b"A") and len(txid) == TXID_LEN
    return b"D" + txid + outcome


def tfinish_req(txid: bytes, outcome: bytes) -> bytes:
    """Apply (C) or discard (A) the pending intent and release its locks."""
    assert outcome in (b"C", b"A") and len(txid) == TXID_LEN
    return b"F" + txid + outcome


def toutcome_req(txid: bytes) -> bytes:
    """Read the recorded outcome (b"OUT"+o, or b"NONE")."""
    assert len(txid) == TXID_LEN
    return b"O" + txid


#: wire size of one signature in an outcome certificate (Ed25519)
SIG_LEN = 64


def rfinish_req(txid: bytes, outcome: bytes,
                cert: Tuple[Tuple[str, bytes], ...]) -> bytes:
    """A *recovery* FINISH: semantically TFINISH, but carrying the f+1
    coordinator-shard signatures over ``("txout", txid, outcome)`` that
    prove the outcome against the coordinator's replicated record.  The
    certificate is what lets every honest replica endorse the slot
    immediately (no local probe state needed) while refusing a Byzantine
    leader's forged outcome."""
    assert outcome in (b"C", b"A") and len(txid) == TXID_LEN
    assert len(cert) <= MAX_LEN
    blob = bytes([len(cert)])
    for pid, sig in cert:
        p = pid.encode()
        assert len(p) <= MAX_LEN and len(sig) == SIG_LEN
        blob += bytes([len(p)]) + p + sig
    return b"R" + txid + outcome + blob


def parse_rfinish(req: bytes):
    """(txid, outcome, ((pid, sig), ...)) of a recovery FINISH, or None."""
    if req[:1] != b"R" or len(req) < 3 + TXID_LEN:
        return None
    txid, outcome = req[1:1 + TXID_LEN], req[1 + TXID_LEN:2 + TXID_LEN]
    if outcome not in (b"C", b"A"):
        return None
    off = 2 + TXID_LEN
    n = req[off]
    off += 1
    cert = []
    for _ in range(n):
        if off >= len(req):
            return None
        plen = req[off]
        pid = req[off + 1:off + 1 + plen]
        off += 1 + plen
        if len(pid) != plen:
            return None
        sig = req[off:off + SIG_LEN]
        off += SIG_LEN
        if len(sig) != SIG_LEN:
            return None
        cert.append((pid.decode(), sig))
    if off != len(req):
        return None
    return txid, outcome, tuple(cert)


def parse_tprep(req: bytes):
    """(txid, deadline_us, coord_shard, pairs) of a TPREP, or None."""
    if req[:1] != b"P" or len(req) < 1 + TXID_LEN + _TPREP_HDR.size:
        return None
    txid = req[1:1 + TXID_LEN]
    deadline, coord = _TPREP_HDR.unpack_from(req, 1 + TXID_LEN)
    pairs = _decode_pairs(req, 1 + TXID_LEN + _TPREP_HDR.size)
    if pairs is None:
        return None
    return txid, float(deadline), coord, pairs


# --------------------------------------------------------------------------
# Keyrange handoff (shard split/merge) — ISSUE 7
# --------------------------------------------------------------------------
#: range header: modulus(4) + residue(4) + target shard(2) + router epoch(4)
_RANGE_HDR = struct.Struct("<IIHI")
_RANGE_KEY = struct.Struct("<II")      # modulus + residue
_RB_LEN = struct.Struct("<H")          # 2-byte framing for range blobs


def key_in_range(key: bytes, mod: int, res: int) -> bool:
    """Does ``key`` fall in the (modulus, residue) crc32 range?  The same
    function the router's table lookup applies — replicas and routers must
    agree bit-for-bit on range membership."""
    return zlib.crc32(key) % mod == res


def freeze_req(mod: int, res: int, target: int, repoch: int) -> bytes:
    """FREEZE a key range ahead of its handoff: from this slot on, writes
    and new PREPAREs touching the range bounce deterministically
    (``b"FROZEN"`` / VOTE_CONFLICT) while reads keep being served — the
    range's data has not moved yet."""
    return b"B" + _RANGE_HDR.pack(mod, res, target, repoch)


def capture_req(mod: int, res: int) -> bytes:
    """CAPTURE a frozen, drained range: record the range's store pairs as
    an outbound snapshot at this exact log position (identical on every
    replica — it feeds the transfer fingerprint)."""
    return b"T" + _RANGE_KEY.pack(mod, res)


def _encode_cert(cert: Tuple[Tuple[str, bytes], ...]) -> bytes:
    """(pid, sig) entries, 1-byte-count framed — the certificate format
    shared by recovery FINISH, range ADOPT and range CUT slots."""
    assert len(cert) <= MAX_LEN
    out = bytes([len(cert)])
    for pid, sig in cert:
        p = pid.encode()
        assert len(p) <= MAX_LEN and len(sig) == SIG_LEN
        out += bytes([len(p)]) + p + sig
    return out


def _parse_cert(req: bytes, off: int):
    """(((pid, sig), ...), next_off) or None on any length mismatch."""
    if off >= len(req):
        return None
    n = req[off]
    off += 1
    cert = []
    for _ in range(n):
        if off >= len(req):
            return None
        plen = req[off]
        pid = req[off + 1:off + 1 + plen]
        off += 1 + plen
        if len(pid) != plen:
            return None
        sig = req[off:off + SIG_LEN]
        off += SIG_LEN
        if len(sig) != SIG_LEN:
            return None
        cert.append((pid.decode(), sig))
    return tuple(cert), off


def cut_req(mod: int, res: int, target: int, repoch: int,
            cert: Tuple[Tuple[str, bytes], ...] = ()) -> bytes:
    """CUT a transferred range: drop its keys from the store, record the
    handoff (subsequent ops answer ``b"MOVED"+target``), and commit the
    router epoch bump into this shard's log.  ``cert`` carries f+1
    target-shard signatures over ``("adopted", mod, res, repoch)`` —
    checked at the svc endorsement gate, so a Byzantine leader cannot
    delete a range that no shard has adopted."""
    return b"X" + _RANGE_HDR.pack(mod, res, target, repoch) + \
        _encode_cert(cert)


def parse_cut(req: bytes):
    """(mod, res, target, repoch, cert) of a CUT, or None."""
    if req[:1] != b"X" or len(req) < 1 + _RANGE_HDR.size:
        return None
    mod, res, target, repoch = _RANGE_HDR.unpack_from(req, 1)
    parsed = _parse_cert(req, 1 + _RANGE_HDR.size)
    if parsed is None or parsed[1] != len(req):
        return None
    return mod, res, target, repoch, parsed[0]


def _range_blob(pairs: List[Tuple[bytes, bytes]]) -> bytes:
    """2-byte-framed pair encoding for range transfer (a captured range
    may exceed the 1-byte MSET framing limits)."""
    out = _RB_LEN.pack(len(pairs))
    for k, v in pairs:
        out += _RB_LEN.pack(len(k)) + k + _RB_LEN.pack(len(v)) + v
    return out


def _parse_range_blob(req: bytes, off: int):
    """((pairs...), next_off) or None on any length mismatch."""
    if off + _RB_LEN.size > len(req):
        return None
    (n,) = _RB_LEN.unpack_from(req, off)
    off += _RB_LEN.size
    pairs = []
    for _ in range(n):
        if off + _RB_LEN.size > len(req):
            return None
        (klen,) = _RB_LEN.unpack_from(req, off)
        off += _RB_LEN.size
        key = req[off:off + klen]
        off += klen
        if len(key) != klen or off + _RB_LEN.size > len(req):
            return None
        (vlen,) = _RB_LEN.unpack_from(req, off)
        off += _RB_LEN.size
        value = req[off:off + vlen]
        off += vlen
        if len(value) != vlen:
            return None
        pairs.append((key, value))
    return tuple(pairs), off


def range_fp(mod: int, res: int, repoch: int,
             pairs: Tuple[Tuple[bytes, bytes], ...]) -> bytes:
    """Fingerprint of a captured range — what the source replicas sign
    (``("resh", mod, res, repoch, fp)``) and the adopt slot's certificate
    attests to."""
    h = hashlib.sha256(_RANGE_KEY.pack(mod, res) + struct.pack("<I", repoch))
    for k, v in pairs:
        h.update(_RB_LEN.pack(len(k)) + k + _RB_LEN.pack(len(v)) + v)
    return h.digest()


def adopt_req(mod: int, res: int, src_shard: int, repoch: int,
              pairs: Tuple[Tuple[bytes, bytes], ...],
              cert: Tuple[Tuple[str, bytes], ...]) -> bytes:
    """ADOPT a transferred range at the target shard: install the pairs.
    Carries the f+1 source-shard signatures over the range fingerprint —
    verified at the consensus layer's svc endorsement gate (like a
    recovery FINISH's outcome certificate), so a Byzantine leader cannot
    plant forged keys via a fabricated adopt slot."""
    return (b"J" + _RANGE_HDR.pack(mod, res, src_shard, repoch) +
            _range_blob(list(pairs)) + _encode_cert(cert))


def parse_adopt(req: bytes):
    """(mod, res, src_shard, repoch, pairs, cert) of an ADOPT, or None."""
    if req[:1] != b"J" or len(req) < 1 + _RANGE_HDR.size:
        return None
    mod, res, src_shard, repoch = _RANGE_HDR.unpack_from(req, 1)
    parsed = _parse_range_blob(req, 1 + _RANGE_HDR.size)
    if parsed is None:
        return None
    pairs, off = parsed
    certp = _parse_cert(req, off)
    if certp is None or certp[1] != len(req):
        return None
    return mod, res, src_shard, repoch, pairs, certp[0]


class ShardKVApp(KVStoreApp):
    """One shard of the partitioned keyspace: the plain kvstore plus the
    replicated 2PC state of in-flight cross-shard transactions.

    Everything here is deterministic state-machine logic — votes, outcome
    records and lock transitions are all products of the shard's consensus
    log, so 2f+1 replicas hold identical 2PC state at identical log
    positions.  GETs return only *committed* values: a pending intent lives
    outside ``store`` until its FINISH(C) executes.
    """

    def __init__(self) -> None:
        super().__init__()
        #: authenticated pid of the client whose request is being applied
        #: ("" for internal/service slots) — set by apply_from for the
        #: duration of one apply; part of the agreed batch, so identical
        #: on every honest replica (determinism preserved)
        self._caller = ""
        #: key -> txid holding its write lock
        self.locks: Dict[bytes, bytes] = {}
        #: txid -> (deadline_us, coord_shard, pairs) awaiting the outcome
        self.pending: Dict[bytes, Tuple[float, int, tuple]] = {}
        #: txid -> vote this shard committed (idempotent re-PREPARE)
        self.votes: Dict[bytes, bytes] = {}
        #: coordinator role: txid -> recorded outcome (b"C" | b"A")
        self.outcomes: Dict[bytes, bytes] = {}
        #: txid -> outcome applied at this shard (idempotent re-FINISH)
        self.finished: Dict[bytes, bytes] = {}
        # ---- keyrange handoff state (shard split/merge, ISSUE 7) ----
        #: frozen ranges awaiting handoff: (mod, res) -> (target, repoch)
        self.moving: Dict[Tuple[int, int], Tuple[int, int]] = {}
        #: captured outbound snapshots: (mod, res) -> ((key, value), ...)
        self.outbound: Dict[Tuple[int, int], tuple] = {}
        #: completed handoffs: (mod, res) -> target shard (MOVED bounces)
        self.handoff: Dict[Tuple[int, int], int] = {}
        #: ranges this shard adopted: (mod, res) -> router epoch
        self.adopted: Dict[Tuple[int, int], int] = {}
        #: highest router epoch committed into this shard's log
        self.router_epoch = 0

    # ------------------------------------------------------------- apply
    def apply_from(self, caller: str, req: bytes) -> bytes:
        self._caller = caller
        try:
            return self.apply(req)
        finally:
            self._caller = ""

    def apply(self, req: bytes) -> bytes:
        op = req[:1]
        if op == b"P":
            return self._tprep(req)
        if op == b"D":
            return self._tdecide(req)
        if op == b"F":
            return self._tfinish(req)
        if op == b"B":
            return self._freeze(req)
        if op == b"T":
            return self._capture(req)
        if op == b"X":
            return self._cut(req)
        if op == b"J":
            return self._adopt_range(req)
        if op == b"G":
            state = self._range_state(req[1:])
            if state is not None and state[0] == "moved":
                # a GET for a handed-off key must *redirect*, never serve a
                # stale miss — the key may exist at the target
                return b"MOVED" + struct.pack("<H", state[1])
            return super().apply(req)
        if op == b"R":
            # recovery FINISH: the outcome certificate was verified by the
            # consensus layer before this slot could be certified; here it
            # only needs to frame correctly
            parsed = parse_rfinish(req)
            if parsed is None:
                return b"ERR"
            txid, outcome, _cert = parsed
            return self._finish_tx(txid, outcome)
        if op == b"O":
            if len(req) != 1 + TXID_LEN:
                return b"ERR"
            out = self.outcomes.get(req[1:1 + TXID_LEN])
            return b"NONE" if out is None else b"OUT" + out
        if op == b"S" or op == b"M":
            # single-shard writes respect transaction locks: a locked key
            # bounces (deterministically) until the transaction finishes,
            # so a cross-shard MSET cannot be half-overwritten mid-flight
            return self._locked_write(req)
        return super().apply(req)

    # ----------------------------------------------------- range handoff
    def _range_state(self, key: bytes):
        """("moved", target) / ("frozen", target) / None for ``key``.
        A product of this shard's log (freeze/cut slots), so identical on
        every replica at the same log position."""
        if self.handoff:
            h = zlib.crc32(key)
            for (m, r), tgt in self.handoff.items():
                if h % m == r:
                    return ("moved", tgt)
        if self.moving:
            h = zlib.crc32(key)
            for (m, r), (tgt, _e) in self.moving.items():
                if h % m == r:
                    return ("frozen", tgt)
        return None

    def _write_bounce(self, keys) -> bytes:
        """The deterministic bounce for a write touching a frozen or
        handed-off range (b"" = no bounce).  Writes are refused during the
        whole freeze window — unlike reads, which this shard keeps serving
        until the cut — so the captured snapshot can never miss a write."""
        for k in keys:
            state = self._range_state(k)
            if state is None:
                continue
            if state[0] == "moved":
                return b"MOVED" + struct.pack("<H", state[1])
            return b"FROZEN"
        return b""

    def _freeze(self, req: bytes) -> bytes:
        if len(req) != 1 + _RANGE_HDR.size:
            return b"ERR"
        mod, res, target, repoch = _RANGE_HDR.unpack_from(req, 1)
        if mod < 1:
            return b"ERR"
        key = (mod, res)
        if key in self.handoff or key in self.moving:
            return b"OK"    # idempotent replay
        self.moving[key] = (target, repoch)
        return b"OK"

    def _capture(self, req: bytes) -> bytes:
        if len(req) != 1 + _RANGE_KEY.size:
            return b"ERR"
        mod, res = _RANGE_KEY.unpack_from(req, 1)
        key = (mod, res)
        if key in self.outbound:
            return b"OK"    # idempotent replay: keep the first capture
        if key not in self.moving:
            return b"ERR"   # capture without a freeze is never legal
        if any(key_in_range(k, mod, res) for k in self.locks):
            # an in-flight transaction prepared under the old epoch still
            # holds in-range locks: it must finish at *this* shard before
            # the range snapshot is fixed (the control plane drains and
            # retries — this guard keeps the invariant deterministic)
            return b"BUSY"
        self.outbound[key] = tuple(sorted(
            (k, v) for k, v in self.store.items()
            if key_in_range(k, mod, res)))
        return b"OK"

    def _cut(self, req: bytes) -> bytes:
        parsed = parse_cut(req)
        if parsed is None:
            return b"ERR"
        mod, res, target, repoch, _cert = parsed
        key = (mod, res)
        if key in self.handoff:
            return b"OK"    # idempotent replay
        if key not in self.outbound:
            return b"ERR"   # cut before capture would lose the range
        for k in [k for k in self.store if key_in_range(k, mod, res)]:
            del self.store[k]
        self.moving.pop(key, None)
        self.outbound.pop(key, None)
        # the range is leaving: a stale adoption marker from an earlier
        # epoch must not suppress a future re-adoption of the same range
        self.adopted.pop(key, None)
        self.handoff[key] = target
        self.router_epoch = max(self.router_epoch, repoch)
        return b"OK"

    def _adopt_range(self, req: bytes) -> bytes:
        parsed = parse_adopt(req)
        if parsed is None:
            return b"ERR"
        mod, res, _src_shard, repoch, pairs, _cert = parsed
        key = (mod, res)
        if self.adopted.get(key) == repoch:
            # idempotent replay — epoch-keyed, because the same range may
            # leave (cut) and come back under a later epoch
            return b"OK"
        for k, v in pairs:
            self.store[k] = v
        self.adopted[key] = repoch
        # the range is ours again: drop the MOVED marker a previous
        # outbound handoff of this same range left behind (split → merge
        # back), or every in-range op bounces to a shard that no longer
        # owns it
        self.handoff.pop(key, None)
        self.router_epoch = max(self.router_epoch, repoch)
        return b"OK"

    def _locked_write(self, req: bytes) -> bytes:
        if req[:1] == b"S":
            if len(req) < 2:
                return b"ERR"
            klen = req[1]
            key = req[2:2 + klen]
            if len(key) != klen:
                return b"ERR"
            bounce = self._write_bounce((key,))
            if bounce:
                return bounce
            if key in self.locks:
                return b"LOCKED"
            return super().apply(req)
        pairs = _decode_pairs(req, 1)
        if pairs is None:
            return b"ERR"
        bounce = self._write_bounce(k for k, _v in pairs)
        if bounce:
            return bounce
        if any(k in self.locks for k, _v in pairs):
            return b"LOCKED"
        return super().apply(req)

    def _tprep(self, req: bytes) -> bytes:
        parsed = parse_tprep(req)
        if parsed is None:
            return b"ERR"
        txid, deadline, coord, pairs = parsed
        prior = self.votes.get(txid)
        if prior is not None:
            return prior                       # idempotent re-PREPARE
        if self.finished.get(txid) is not None:
            return VOTE_CONFLICT               # already finished (aborted)
        if any(self._range_state(k) is not None for k, _v in pairs):
            # a PREPARE that would lock a frozen or handed-off range loses
            # without being recorded: the coordinator presumes abort, the
            # client re-splits against the new routing table and retries
            return VOTE_CONFLICT
        if any(self.locks.get(k, txid) != txid for k, _v in pairs):
            self.votes[txid] = VOTE_CONFLICT   # a losing vote never locks
            return VOTE_CONFLICT
        for k, _v in pairs:
            self.locks[k] = txid
        self.pending[txid] = (deadline, coord, tuple(pairs))
        self.votes[txid] = VOTE_OK
        return VOTE_OK

    def _tdecide(self, req: bytes) -> bytes:
        if len(req) != 2 + TXID_LEN or req[-1:] not in (b"C", b"A"):
            return b"ERR"
        txid, proposed = req[1:1 + TXID_LEN], req[-1:]
        out = self.outcomes.get(txid)
        if out is None:
            if proposed == b"C" and tx_owner_tag(self._caller) != txid[:8]:
                # only the transaction's owner may record a *commit*: an
                # honest owner proposes C only after collecting all-OK
                # votes, so a recorded C implies every participant locked
                # and will apply — no torn transaction.  Anyone (recovery
                # probes included) may still record an abort: aborting is
                # always atomic under presumed-abort, so the worst a
                # non-owner can do is deny progress, never tear.
                return b"ERR_NOT_OWNER"
            # first DECIDE in the coordinator shard's log wins — the log's
            # total order is what makes the outcome unique and replicated
            out = self.outcomes[txid] = proposed
        return b"OUT" + out

    def _tfinish(self, req: bytes) -> bytes:
        if len(req) != 2 + TXID_LEN or req[-1:] not in (b"C", b"A"):
            return b"ERR"
        return self._finish_tx(req[1:1 + TXID_LEN], req[-1:])

    def _finish_tx(self, txid: bytes, outcome: bytes) -> bytes:
        prior = self.finished.get(txid)
        if prior is not None:
            return b"OK" if prior == outcome else b"ERR"
        entry = self.pending.pop(txid, None)
        if entry is None:
            # FINISH without a live intent: record the outcome so a late
            # PREPARE replay cannot resurrect the transaction
            self.finished[txid] = outcome
            return b"OK"
        _deadline, _coord, pairs = entry
        if outcome == b"C":
            for k, v in pairs:
                self.store[k] = v
        for k, _v in pairs:
            if self.locks.get(k) == txid:
                del self.locks[k]
        self.finished[txid] = outcome
        return b"OK"

    # --------------------------------------------------------- snapshots
    def snapshot(self):
        return (tuple(sorted(self.store.items())),
                tuple(sorted(self.locks.items())),
                tuple(sorted(self.pending.items())),
                tuple(sorted(self.votes.items())),
                tuple(sorted(self.outcomes.items())),
                tuple(sorted(self.finished.items())),
                tuple(sorted(self.moving.items())),
                tuple(sorted(self.outbound.items())),
                tuple(sorted(self.handoff.items())),
                tuple(sorted(self.adopted.items())),
                self.router_epoch)

    def adopt(self, snap) -> None:
        (store, locks, pending, votes, outcomes, finished,
         moving, outbound, handoff, adopted, repoch) = snap
        self.store = dict(store)
        self.locks = dict(locks)
        self.pending = dict(pending)
        self.votes = dict(votes)
        self.outcomes = dict(outcomes)
        self.finished = dict(finished)
        self.moving = dict(moving)
        self.outbound = dict(outbound)
        self.handoff = dict(handoff)
        self.adopted = dict(adopted)
        self.router_epoch = repoch
