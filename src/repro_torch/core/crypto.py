"""Simulation-faithful cryptography (DESIGN.md §3).

The paper uses Ed25519 (dalek), BLAKE3 HMACs and xxHash checksums.  Inside the
simulation we need the *semantics* — unforgeability, transferable
authentication, collision-resistant fingerprints — with a calibrated cost
model (the costs live in ``repro.sim.net.NetParams``; timing is applied by the
protocol layer, these functions are pure).

Unforgeability discipline: secrets live privately inside :class:`Signer`
objects; a process (including Byzantine test adversaries) is only ever handed
its *own* Signer.  ``KeyRegistry.verify`` recomputes the MAC from its private
secret table — it plays the role of "the math", not of a trusted process.
Adversary code in tests never touches the registry internals, so signatures
are unforgeable by construction.
"""

from __future__ import annotations

import hashlib
import hmac
import struct
import zlib
from dataclasses import dataclass, is_dataclass, fields
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as _np

SIG_SIZE = 64        # wire size of an Ed25519 signature
FINGERPRINT_SIZE = 32  # BLAKE3-style 256-bit digest
CHECKSUM_SIZE = 8    # xxHash64


# ---------------------------------------------------------------------------
# Digest-path observability
# ---------------------------------------------------------------------------
# Module-global counters (plain ints: an increment is the cheapest thing
# Python can do, and these sit on the hottest paths in the repo).  Surfaced
# through Cluster.stats()["engine"] so benchmarks can prove the batched
# path is actually taken, not merely available.

_wire_hits = 0          # _entry() found a live cache entry
_wire_misses = 0        # _entry() had to create one
_fp_scalar = 0          # SHA-256 digests computed one at a time
_fp_batch_calls = 0     # fingerprint_batch() invocations
_fp_batch_items = 0     # messages digested through the batch API
_fp_batch_hits = 0      # batch items answered from the wire cache
_ck_scalar = 0          # checksums computed one at a time
_ck_batch_calls = 0
_ck_batch_items = 0
_mac_scalar = 0         # HMACs computed one at a time (sign + verify)
_mac_batch_calls = 0
_mac_batch_items = 0


def digest_stats() -> Dict[str, int]:
    """Snapshot of the wire-cache / digest-path counters."""
    return {
        "wire_cache_hits": _wire_hits,
        "wire_cache_misses": _wire_misses,
        "scalar_fingerprints": _fp_scalar,
        "batch_fingerprint_calls": _fp_batch_calls,
        "batch_fingerprint_items": _fp_batch_items,
        "batch_fingerprint_hits": _fp_batch_hits,
        "scalar_checksums": _ck_scalar,
        "batch_checksum_calls": _ck_batch_calls,
        "batch_checksum_items": _ck_batch_items,
        "scalar_macs": _mac_scalar,
        "batch_mac_calls": _mac_batch_calls,
        "batch_mac_items": _mac_batch_items,
    }


def reset_digest_stats() -> None:
    global _wire_hits, _wire_misses, _fp_scalar, _fp_batch_calls, \
        _fp_batch_items, _fp_batch_hits, _ck_scalar, _ck_batch_calls, \
        _ck_batch_items, _mac_scalar, _mac_batch_calls, _mac_batch_items
    _wire_hits = _wire_misses = _fp_scalar = 0
    _fp_batch_calls = _fp_batch_items = _fp_batch_hits = 0
    _ck_scalar = _ck_batch_calls = _ck_batch_items = 0
    _mac_scalar = _mac_batch_calls = _mac_batch_items = 0


def fingerprint(data: bytes) -> bytes:
    """Collision-resistant 32 B digest (stands in for BLAKE3)."""
    global _fp_scalar
    _fp_scalar += 1
    return hashlib.sha256(data).digest()


#: suffix fed to the second CRC pass of :func:`checksum` — continuing the
#: running CRC over a fixed salt decorrelates the two words without the
#: O(n) reversed copy the old ``data[::-1]`` pass required.
_CHECKSUM_SALT = b"\xa5ubft\x5a"


def checksum(data: bytes) -> int:
    """Fast 8-byte checksum (stands in for xxHash64): the plain CRC32 in
    the high word and a salted continuation of it in the low word —
    single pass over ``data``, no copies."""
    global _ck_scalar
    _ck_scalar += 1
    hi = zlib.crc32(data)
    return (hi << 32) | zlib.crc32(_CHECKSUM_SALT, hi)


def checksum_bytes(data: bytes) -> bytes:
    return struct.pack("<Q", checksum(data) & 0xFFFFFFFFFFFFFFFF)


def encode(obj: Any) -> bytes:
    """Canonical deterministic encoding of protocol payloads.

    This is the *fresh* (uncached) computation; the hot path goes through
    :func:`encode_cached`, which must always agree with it (enforced by a
    property test).
    """
    return _enc(obj)


# ---------------------------------------------------------------------------
# Zero-re-encode wire layer (DESIGN.md "wire-cache invariant")
# ---------------------------------------------------------------------------
# Protocol payloads are immutable tuples (and bytes) passed *by reference*
# through the simulator, so a payload can be encoded / fingerprinted /
# sized once per lifetime and every later touch — the sender's retransmits,
# every receiver, every verify — reuses that result.  The cache is
# identity-keyed: each entry holds a strong reference to its payload, which
# pins the id() for the entry's lifetime (no aliasing is possible while the
# entry lives).  Two generations bound memory: inserts go to the young
# generation; when it fills, it becomes the old generation and the previous
# old generation (entries unreferenced for a full cycle) is dropped.
#
# Only immutable containers (tuple, bytes) are cached.  Lists, dicts and
# dataclasses always re-encode — mutating *those* after send is therefore
# visible, while the discipline for tuples/bytes is: a payload handed to
# ``Node.send`` / ``TBcastService.broadcast`` must never be mutated
# afterwards (Byzantine test adversaries included — build a new tuple
# instead).  Receiver-side reuse does not weaken unforgeability: the
# KeyRegistry still recomputes MACs from its private secret table; the
# cache only memoizes the *public* deterministic encoding.

_CACHE_LIMIT = 1 << 16
# id(obj) -> [obj, enc|None, fp|None, size|None, deeply_immutable|None]
_g0: Dict[int, list] = {}
_g1: Dict[int, list] = {}

#: scalar types that are safe to memoize beneath a cached tuple
_PURE_SCALARS = (int, float, str, bool, type(None))


def _entry(obj: Any) -> list:
    global _g0, _g1, _wire_hits, _wire_misses
    key = id(obj)
    e = _g0.get(key)
    if e is not None:
        _wire_hits += 1
        return e
    e = _g1.get(key)
    if e is not None:
        _wire_hits += 1
        _g0[key] = e        # promote: survived a generation
        return e
    _wire_misses += 1
    if len(_g0) >= _CACHE_LIMIT:
        _g1 = _g0
        _g0 = {}
    e = [obj, None, None, None, None]
    _g0[key] = e
    return e


def _pure(obj: Any) -> bool:
    """True iff ``obj`` is deeply immutable (tuples of tuples/bytes/
    scalars).  A tuple with a list/dict/dataclass anywhere beneath it must
    never be memoized — mutating that child has to stay visible."""
    if type(obj) is tuple:
        e = _entry(obj)
        p = e[4]
        if p is None:
            p = e[4] = all(_pure(x) for x in obj)
        return p
    return type(obj) is bytes or isinstance(obj, _PURE_SCALARS)


def clear_wire_cache() -> None:
    """Drop all memoized encodings (tests / long-lived drivers)."""
    global _g0, _g1
    _g0 = {}
    _g1 = {}


def wire_cache_len() -> int:
    return len(_g0) + len(_g1)


def _enc_c(obj: Any) -> bytes:
    """Cache-aware mirror of :func:`_enc` — identical bytes, but deeply
    immutable tuple subtrees are memoized so shared payloads encode once.
    Tuples with mutable descendants (a COMMIT's cert dict, NEW_VIEW's cert
    map) re-encode every time, keeping child mutation visible."""
    if type(obj) is tuple:
        e = _entry(obj)
        v = e[1]
        if v is None:
            v = (b"T" + struct.pack("<I", len(obj)) +
                 b"".join(_enc_c(x) for x in obj))
            if _pure(obj):
                e[1] = v
        return v
    return _enc(obj)


def encode_cached(obj: Any) -> bytes:
    """Memoized :func:`encode` for immutable payloads (tuples / bytes);
    falls through to a fresh encode for anything else."""
    if type(obj) is tuple:
        return _enc_c(obj)
    if type(obj) is bytes:
        e = _entry(obj)
        v = e[1]
        if v is None:
            v = e[1] = _enc(obj)
        return v
    return _enc(obj)


def encode_shallow(obj: Any) -> bytes:
    """Encode a freshly-built wrapper without caching the wrapper itself:
    tuple *children* (the shared subtrees) still go through the memo.
    Signature payloads are built fresh per sign/verify call, so caching
    them would be all misses."""
    if type(obj) is tuple:
        return (b"T" + struct.pack("<I", len(obj)) +
                b"".join(_enc_c(x) for x in obj))
    return _enc(obj)


def fingerprint_cached(obj: Any) -> bytes:
    """Memoized ``fingerprint(encode(obj))`` — the protocol-layer digest."""
    global _fp_scalar
    if type(obj) is tuple or type(obj) is bytes:
        e = _entry(obj)
        v = e[2]
        if v is None:
            _fp_scalar += 1
            v = hashlib.sha256(encode_cached(obj)).digest()
            if _pure(obj):
                e[2] = v
        return v
    _fp_scalar += 1
    return hashlib.sha256(_enc(obj)).digest()


def fingerprint_fresh(obj: Any) -> bytes:
    """``fingerprint(encode(obj))`` with no memoization anywhere on the
    wrapper path: for one-shot wrapper tuples (summary digests, ballot
    wrappers) whose top levels never recur, inserting them into the wire
    cache is pure churn — this digests through the plain recursive
    encoder instead.  Byte-identical to the cached/fresh variants."""
    global _fp_scalar
    _fp_scalar += 1
    return hashlib.sha256(_enc(obj)).digest()


def _enc(obj: Any) -> bytes:
    if obj is None:
        return b"N"
    if isinstance(obj, bool):
        return b"B" + (b"1" if obj else b"0")
    if isinstance(obj, int):
        return b"I" + struct.pack("<q", obj)
    if isinstance(obj, float):
        return b"F" + struct.pack("<d", obj)
    if isinstance(obj, bytes):
        return b"Y" + struct.pack("<I", len(obj)) + obj
    if isinstance(obj, str):
        b = obj.encode()
        return b"S" + struct.pack("<I", len(b)) + b
    if isinstance(obj, (tuple, list)):
        inner = b"".join(_enc(x) for x in obj)
        return b"T" + struct.pack("<I", len(obj)) + inner
    if isinstance(obj, dict):
        items = sorted(obj.items(), key=lambda kv: repr(kv[0]))
        inner = b"".join(_enc(k) + _enc(v) for k, v in items)
        return b"D" + struct.pack("<I", len(items)) + inner
    if is_dataclass(obj):
        inner = b"".join(_enc(getattr(obj, f.name)) for f in fields(obj))
        name = type(obj).__name__.encode()
        return b"C" + struct.pack("<I", len(name)) + name + inner
    raise TypeError(f"cannot encode {type(obj)!r}")


def decode(data: bytes) -> Any:
    """Inverse of :func:`encode` for the container/scalar subset."""
    obj, off = _dec(data, 0)
    if off != len(data):
        raise ValueError("trailing bytes in encoded payload")
    return obj


def decode_tuple3(data: bytes) -> Tuple[Any, Any, Any]:
    obj = decode(data)
    if not (isinstance(obj, tuple) and len(obj) == 3):
        raise ValueError("bad 3-tuple payload")
    return obj


def _dec(data: bytes, off: int):
    tag = data[off:off + 1]
    off += 1
    if tag == b"N":
        return None, off
    if tag == b"B":
        return data[off:off + 1] == b"1", off + 1
    if tag == b"I":
        return struct.unpack_from("<q", data, off)[0], off + 8
    if tag == b"F":
        return struct.unpack_from("<d", data, off)[0], off + 8
    if tag == b"Y":
        ln = struct.unpack_from("<I", data, off)[0]
        return data[off + 4:off + 4 + ln], off + 4 + ln
    if tag == b"S":
        ln = struct.unpack_from("<I", data, off)[0]
        return data[off + 4:off + 4 + ln].decode(), off + 4 + ln
    if tag == b"T":
        n = struct.unpack_from("<I", data, off)[0]
        off += 4
        items = []
        for _ in range(n):
            it, off = _dec(data, off)
            items.append(it)
        return tuple(items), off
    raise ValueError(f"bad tag {tag!r}")


def wire_size(obj: Any) -> int:
    """Estimated wire size in bytes of a protocol payload (fresh
    computation; the hot path uses :func:`wire_size_cached`)."""
    if obj is None:
        return 1
    if isinstance(obj, bool):
        return 1
    if isinstance(obj, (int, float)):
        return 8
    if isinstance(obj, bytes):
        return len(obj)
    if isinstance(obj, str):
        return len(obj)
    if isinstance(obj, (tuple, list)):
        return 4 + sum(wire_size(x) for x in obj)
    if isinstance(obj, dict):
        return 4 + sum(wire_size(k) + wire_size(v) for k, v in obj.items())
    if is_dataclass(obj):
        return 8 + sum(wire_size(getattr(obj, f.name)) for f in fields(obj))
    raise TypeError(f"cannot size {type(obj)!r}")


def wire_size_cached(obj: Any) -> int:
    """Memoized :func:`wire_size`: tuple subtrees are sized once, so a
    fresh wrapper around a shared payload costs O(shallow fields)."""
    if type(obj) is tuple:
        e = _entry(obj)
        v = e[3]
        if v is None:
            v = 4 + sum(wire_size_cached(x) for x in obj)
            if _pure(obj):
                e[3] = v
        return v
    return wire_size(obj)


def wire_size_shallow(obj: Any) -> int:
    """Size a message body without inserting it into the cache: scalar
    fields are priced inline and only *nested tuples* (the shared payload
    subtrees that actually recur — batches, certs, window contents) go
    through the memo.  ``Node.send`` wraps every message in a fresh tuple,
    so caching the wrapper itself would be all misses."""
    if type(obj) is not tuple:
        return wire_size_cached(obj)
    n = 4
    for x in obj:
        t = type(x)
        if t is tuple:
            n += wire_size_cached(x)
        elif t is int or t is float:
            n += 8
        elif t is bytes or t is str:
            n += len(x)
        elif x is None or t is bool:
            n += 1
        else:
            n += wire_size(x)
    return n


#: per-request framing inside a batched slot: rid + client id + length header
REQUEST_WIRE_OVERHEAD = 16


def batch_wire_size(batch: Any) -> int:
    """Wire size of a batched consensus payload (a tuple of request
    triples): every coalesced request pays its own framing overhead on top
    of its recursive payload size, so the cost model prices batches
    honestly rather than treating a batch as one flat blob."""
    return 4 + sum(wire_size_cached(r) + REQUEST_WIRE_OVERHEAD for r in batch)


def wire_size_batch(objs: Sequence[Any]) -> List[int]:
    """Batch :func:`wire_size_cached` — one audited entry point for call
    sites that size a run of payloads at once (TBcast retransmission
    sweeps), so batching shows up in profiles as one frame."""
    ws = wire_size_cached
    return [ws(o) for o in objs]


def encode_batch_cached(objs: Sequence[Any]) -> List[bytes]:
    """Batch :func:`encode_cached` (CTBcast unanimity fallback compares a
    run of diverging LOCKED slots in one pass)."""
    enc = encode_cached
    return [enc(o) for o in objs]


# ---------------------------------------------------------------------------
# Batched digests (ROADMAP item 3a)
# ---------------------------------------------------------------------------
# The protocol layer digests messages in *runs* — a certify window of t
# fingerprints, a read quorum's 2q checksum blobs, a slot's n-way MAC check —
# and at that volume the per-call Python dispatch costs as much as the
# digest.  The batch APIs below share one dispatch across a run and are
# byte-identical to mapping their scalar counterparts (property-tested in
# tests/test_batch_engine.py).
#
# SHA-256 has two compute backends:
#   * "hashlib" — one C call per lane; fastest below ~2k one-block lanes.
#   * "numpy"   — a lane-wise vectorization of the compression function
#     over the 32-bit word representation: each lane is one (padded)
#     message, and all 64 rounds run across the whole batch per block.
#     Wins only for very large batches of short messages; it exists so
#     the equivalence contract has a vectorized witness and so wide
#     attestation sweeps have a non-serial path.
# ``backend=None`` picks by batch size.  The device-attestation digest
# (Weyl reduce, repro.runtime.attest) additionally has the
# kernels/fingerprint.py Pallas kernel as a selectable backend — see
# :func:`attest_batch`.

_U32 = _np.uint32

_SHA256_H0 = _np.array(
    [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
     0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19], dtype=_np.uint32)

_SHA256_K = _np.array(
    [0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
     0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
     0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
     0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
     0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
     0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
     0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
     0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
     0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
     0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
     0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2], dtype=_np.uint32)


def _rotr(x: _np.ndarray, n: int) -> _np.ndarray:
    return (x >> _U32(n)) | (x << _U32(32 - n))


def _sha256_batch_np(datas: Sequence[bytes]) -> List[bytes]:
    """Lane-wise vectorized SHA-256: digest ``n`` messages at once.

    Each lane holds one message, padded per FIPS 180-4 into its own block
    run; every round of the compression function executes across all lanes
    as uint32 array ops (silent mod-2**32 wraparound is exactly the
    arithmetic SHA-256 wants).  Lanes whose messages need fewer blocks
    freeze their state once their last block is folded in.  Byte-identical
    to ``hashlib.sha256`` (property-tested)."""
    n = len(datas)
    if n == 0:
        return []
    lens = [len(d) for d in datas]
    nblk = _np.array([(ln + 8) // 64 + 1 for ln in lens], dtype=_np.int64)
    maxb = int(nblk.max())
    buf = _np.zeros((n, maxb * 64), dtype=_np.uint8)
    for i, d in enumerate(datas):
        ln = lens[i]
        if ln:
            buf[i, :ln] = _np.frombuffer(d, dtype=_np.uint8)
        buf[i, ln] = 0x80
        end = int(nblk[i]) * 64
        buf[i, end - 8:end] = _np.frombuffer(
            struct.pack(">Q", ln * 8), dtype=_np.uint8)
    w8 = buf.reshape(n, maxb * 16, 4).astype(_np.uint32)
    w32 = ((w8[:, :, 0] << _U32(24)) | (w8[:, :, 1] << _U32(16)) |
           (w8[:, :, 2] << _U32(8)) | w8[:, :, 3]).reshape(n, maxb, 16)
    state = _np.tile(_SHA256_H0, (n, 1))
    W = _np.empty((n, 64), dtype=_np.uint32)
    for b in range(maxb):
        W[:, :16] = w32[:, b]
        for t in range(16, 64):
            w15 = W[:, t - 15]
            w2 = W[:, t - 2]
            s0 = _rotr(w15, 7) ^ _rotr(w15, 18) ^ (w15 >> _U32(3))
            s1 = _rotr(w2, 17) ^ _rotr(w2, 19) ^ (w2 >> _U32(10))
            W[:, t] = W[:, t - 16] + s0 + W[:, t - 7] + s1
        a, bv, c, d = (state[:, j].copy() for j in range(4))
        e, f, g, h = (state[:, j].copy() for j in range(4, 8))
        for t in range(64):
            s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ (~e & g)
            t1 = h + s1 + ch + _SHA256_K[t] + W[:, t]
            s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & bv) ^ (a & c) ^ (bv & c)
            t2 = s0 + maj
            h = g
            g = f
            f = e
            e = d + t1
            d = c
            c = bv
            bv = a
            a = t1 + t2
        folded = state + _np.stack((a, bv, c, d, e, f, g, h), axis=1)
        if b == 0:
            state = folded
        else:
            state = _np.where((nblk > b)[:, None], folded, state)
    raw = state.astype(">u4").tobytes()
    return [raw[i * 32:(i + 1) * 32] for i in range(n)]


#: below this many lanes hashlib's per-message C call beats the numpy
#: round-loop's fixed vector-dispatch cost (measured crossover ~2k
#: one-block lanes; kept conservative)
_SHA_NUMPY_MIN_LANES = 2048


def fingerprint_batch(datas: Sequence[bytes],
                      backend: Optional[str] = None) -> List[bytes]:
    """Batch :func:`fingerprint`: digests for a run of encoded messages.

    Byte-identical to ``[fingerprint(d) for d in datas]`` on every
    backend.  ``backend`` is ``"hashlib"``, ``"numpy"``, or ``None`` to
    pick by batch size."""
    global _fp_batch_calls, _fp_batch_items
    _fp_batch_calls += 1
    _fp_batch_items += len(datas)
    if backend is None:
        backend = ("numpy" if len(datas) >= _SHA_NUMPY_MIN_LANES
                   else "hashlib")
    if backend == "hashlib":
        sha = hashlib.sha256
        return [sha(d).digest() for d in datas]
    if backend == "numpy":
        return _sha256_batch_np(datas)
    raise ValueError(f"unknown fingerprint backend {backend!r}")


def fingerprint_batch_cached(objs: Sequence[Any]) -> List[bytes]:
    """Batch :func:`fingerprint_cached`: one pass collects memoized
    digests, the misses are digested through :func:`fingerprint_batch`,
    and pure misses are written back — so overlapping batches (sliding
    certify windows) converge to all-hits."""
    global _fp_batch_hits
    out: List[Optional[bytes]] = [None] * len(objs)
    miss_i: List[int] = []
    miss_e: List[Optional[list]] = []
    miss_d: List[bytes] = []
    for i, obj in enumerate(objs):
        if type(obj) is tuple or type(obj) is bytes:
            e = _entry(obj)
            v = e[2]
            if v is None:
                miss_i.append(i)
                miss_e.append(e)
                miss_d.append(encode_cached(obj))
            else:
                out[i] = v
        else:
            miss_i.append(i)
            miss_e.append(None)
            miss_d.append(_enc(obj))
    _fp_batch_hits += len(objs) - len(miss_i)
    if miss_i:
        for i, e, dg in zip(miss_i, miss_e, fingerprint_batch(miss_d)):
            out[i] = dg
            if e is not None and _pure(e[0]):
                e[2] = dg
    return out  # type: ignore[return-value]


def checksum_batch(datas: Sequence[bytes]) -> List[int]:
    """Batch :func:`checksum` for a run of blobs (a read quorum's
    sub-register pairs).  CRC32 is already one C call per blob; the batch
    form amortizes the Python dispatch and keeps the loop in one frame.
    (A lane-wise numpy CRC needs a table gather per byte *position* —
    measured slower than zlib's C loop below several hundred lanes, so it
    earns no backend here.)"""
    global _ck_batch_calls, _ck_batch_items
    _ck_batch_calls += 1
    _ck_batch_items += len(datas)
    crc = zlib.crc32
    salt = _CHECKSUM_SALT
    out: List[int] = []
    append = out.append
    for d in datas:
        hi = crc(d)
        append((hi << 32) | crc(salt, hi))
    return out


def checksum_bytes_batch(datas: Sequence[bytes]) -> List[bytes]:
    pack = struct.pack
    return [pack("<Q", c & 0xFFFFFFFFFFFFFFFF)
            for c in checksum_batch(datas)]


# -- device attestation (Weyl reduce; matches repro.runtime.attest) ---------

MIX32 = 0x9E3779B9  # golden-ratio Weyl constant


def attest_words_np(words: Any) -> int:
    """Numpy reference of the Pallas fingerprint kernel
    (repro.kernels.fingerprint): order-independent per-word Weyl mix
    summed mod 2**32.  Block structure is irrelevant to a plain sum, so
    this matches the kernel for every block size and padding (zero words
    mix to zero)."""
    w = _np.asarray(words, dtype=_np.uint32).ravel()
    w = w * _U32(MIX32) ^ (w >> _U32(16))
    return int(w.sum(dtype=_np.uint32))


def attest_batch(arrays: Sequence[Any], backend: str = "numpy") -> List[int]:
    """Attestation digests for a batch of word arrays.

    ``backend="numpy"`` runs the reference reduction; ``backend="cuda"``
    uploads the words and runs the CUDA fingerprint kernel
    (``repro_torch.kernels.ops.fingerprint``), so GPU deployments hand the
    reduction to the data plane while the simulator stays numpy-only.
    Both backends produce identical uint32 digests."""
    if backend == "numpy":
        return [attest_words_np(a) for a in arrays]
    if backend == "cuda":
        import torch
        from repro_torch.kernels import ops
        out: List[int] = []
        for a in arrays:
            w = _np.asarray(a, dtype=_np.uint32).ravel()
            if w.size == 0:
                out.append(0)  # empty shard: sum of no words
                continue
            # int32 carries the uint32 bits; the kernel reads them as words
            out.append(ops.fingerprint(
                torch.from_numpy(w.view(_np.int32)).to("cuda")))
        return out
    raise ValueError(f"unknown attest backend {backend!r}")


class Signer:
    """Holds a private key; the only way to produce this pid's signatures."""

    def __init__(self, pid: str, secret: bytes):
        self.pid = pid
        self.__secret = secret

    def sign(self, payload: Any) -> bytes:
        global _mac_scalar
        _mac_scalar += 1
        data = encode_shallow(payload)
        mac = hmac.new(self.__secret, data, hashlib.sha256).digest()
        return mac + mac  # pad to 64 B like Ed25519

    def sign_batch(self, payloads: Sequence[Any]) -> List[bytes]:
        """Batch :meth:`sign`: one dispatch for a run of signatures
        (element-wise identical to mapping ``sign``).  The secret never
        leaves the loop body."""
        global _mac_batch_calls, _mac_batch_items
        _mac_batch_calls += 1
        _mac_batch_items += len(payloads)
        secret = self.__secret
        new = hmac.new
        sha = hashlib.sha256
        enc = encode_shallow
        out: List[bytes] = []
        append = out.append
        for p in payloads:
            mac = new(secret, enc(p), sha).digest()
            append(mac + mac)
        return out


class KeyRegistry:
    """Public-key infrastructure stand-in (pre-published public keys)."""

    def __init__(self) -> None:
        self._secrets: Dict[str, bytes] = {}

    def keygen(self, pid: str) -> Signer:
        secret = hashlib.sha256(b"key:" + pid.encode()).digest()
        self._secrets[pid] = secret
        return Signer(pid, secret)

    def verify(self, pid: str, payload: Any, sig: bytes) -> bool:
        # Recomputes the MAC from the private secret table on every call —
        # memoizing the *encoding* is safe (it is public and deterministic),
        # memoizing the verdict would not model "the math".
        global _mac_scalar
        _mac_scalar += 1
        secret = self._secrets.get(pid)
        if secret is None or sig is None:
            return False
        data = encode_shallow(payload)
        mac = hmac.new(secret, data, hashlib.sha256).digest()
        return hmac.compare_digest(mac + mac, sig)

    def verify_batch(self, items: Iterable[Tuple[str, Any, bytes]]
                     ) -> List[bool]:
        """Batch :meth:`verify` over ``(pid, payload, sig)`` triples — one
        dispatch for a quorum's worth of MACs.  Every MAC is still
        recomputed from the private secret table exactly like ``verify``:
        batching shares the encoding work and the Python dispatch, never
        verdicts or secrets."""
        global _mac_batch_calls, _mac_batch_items
        _mac_batch_calls += 1
        secrets = self._secrets
        new = hmac.new
        sha = hashlib.sha256
        enc = encode_shallow
        eq = hmac.compare_digest
        out: List[bool] = []
        append = out.append
        n = 0
        for pid, payload, sig in items:
            n += 1
            secret = secrets.get(pid)
            if secret is None or sig is None:
                append(False)
                continue
            mac = new(secret, enc(payload), sha).digest()
            append(eq(mac + mac, sig))
        _mac_batch_items += n
        return out


@dataclass(frozen=True)
class SignedBundle:
    """A payload with f+1 signatures from distinct processes (a certificate)."""
    payload: Any
    sigs: Tuple[Tuple[str, bytes], ...]  # ((pid, sig), ...)

    def verify(self, registry: KeyRegistry, quorum: int) -> bool:
        pids = {pid for pid, _ in self.sigs}
        if len(pids) < quorum:
            return False
        return all(registry.verify(pid, self.payload, sig) for pid, sig in self.sigs)
