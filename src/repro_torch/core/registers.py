"""Reliable SWMR regular registers over disaggregated memory (§6.1).

Faithful to the paper's construction:

* **SWMR** — memory nodes enforce single-writer access control (the RDMA
  permission tokens of §6.1 become an owner check at the node).
* **Regular** — RDMA is atomic only at 8-byte granularity, so a READ that
  overlaps a WRITE may return torn data.  The simulation models torn reads
  explicitly (8-byte splicing during the write window); the register layer
  recovers regularity via checksums + double-buffering (two sub-registers,
  round-robin) + a δ cooldown between WRITEs, exactly as in the paper.
* **Reliable** — each register is replicated on 2f_m+1 memory nodes; WRITEs
  and READs complete at a majority (f_m+1); the highest valid timestamp wins.
* **Byzantine-writer detection** — if both sub-registers carry *data-sized*
  blobs with invalid checksums and the READ took < δ, or both carry the same
  timestamp, the owner is exposed as Byzantine and a default value is
  returned.  (An empty sub-register next to a torn one is *not* Byzantine —
  it is simply a READ overlapping the very first WRITE, which regularity
  allows to return ⊥.)
* **Inconclusive slow reads** retry, but at most :data:`MAX_READ_ATTEMPTS`
  times end-to-end; a permanently torn register yields ⊥ rather than an
  unbounded retry loop.

Memory nodes are *trusted to crash only* — they are the paper's TCB.  They
are application-oblivious: they store opaque blobs under (owner, register)
keys and can be shared by many replicated applications.

Memory pools (reconfiguration + sharding)
-----------------------------------------
The TCB is organised into :class:`MemoryPool`\\ s.  A pool owns 2f_m+1
:class:`MemoryNode` processes plus a tiny :class:`_PoolManager` (the paper's
external membership/lease service, e.g. the provider's control plane):

* **Leases** — each member must answer the manager's periodic ``LEASE_PING``
  within ``lease_us``; a member whose lease expires is *suspected* and (when
  ``auto_reconfigure`` is on) replaced.
* **Reconfiguration** — the manager installs a fresh memory node, pulls the
  cell state from f_m+1 surviving members (any such quorum intersects every
  completed WRITE's ack quorum), re-replicates the highest-valid-timestamp
  blob per (owner, register, sub-register) to the fresh node, and only then
  swaps it into the membership — a fresh node never serves READs before it
  has been synced (``serving`` flag), so quorum intersection is preserved
  across configuration changes.
* **Sharding** — a :class:`RegisterClient` may be given several pools;
  register keys are hashed ``crc32(owner:reg) % n_pools`` so many streams /
  replicated applications share disaggregated memory without one pool
  becoming the bottleneck ("shared by many replicated applications", §6.1).
  A client attached under an application *namespace* (see
  :mod:`repro.core.substrate`) hashes ``crc32(app:owner:reg)`` instead, so
  each app's register keys spread over the shared pools independently; the
  empty namespace preserves the legacy layout bit-for-bit.  Each pool
  independently satisfies the < 1 MiB Table 2 budget — accounted *per app*
  when pools are shared (:meth:`MemoryPool.memory_bytes_by_owner`).

Clients read the pool's *current* membership at each operation (epoch bumps
on every reconfiguration); in-flight operations started against the previous
membership still complete because at most f_m members change at once.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import crypto
from repro_torch.core.node import Node
from repro_torch.sim.events import Simulator
from repro_torch.sim.net import NetworkModel

#: sub-register blob layout: ts(8) + checksum(8) + len(4) + value
BLOB_HEADER = 20

#: end-to-end cap on inconclusive-slow-read retries (§6.1): a permanently
#: torn register yields ⊥ after this many attempts instead of looping.
MAX_READ_ATTEMPTS = 8

#: Table 2 budget: occupied disaggregated memory per pool must stay under
#: 1 MiB (enforced by benchmarks/table2_memory.py and the fault tests).
POOL_MEMORY_BUDGET = 2**20


def _pack(ts: int, value: bytes) -> bytes:
    body = struct.pack("<qI", ts, len(value)) + value
    return crypto.checksum_bytes(body) + body


def _unpack(blob: Optional[bytes]) -> Optional[Tuple[int, bytes]]:
    """Returns (ts, value) if the checksum validates, else None."""
    if not blob or len(blob) < BLOB_HEADER:
        return None
    csum, body = blob[:8], blob[8:]
    if crypto.checksum_bytes(body) != csum:
        return None
    ts, ln = struct.unpack_from("<qI", body, 0)
    value = body[12:12 + ln]
    if len(value) != ln:
        return None
    return ts, value


def _unpack_batch(blobs: List[Optional[bytes]]
                  ) -> List[Optional[Tuple[int, bytes]]]:
    """Batch :func:`_unpack`: validate a read quorum's worth of
    sub-register blobs through one :func:`crypto.checksum_bytes_batch`
    call.  Element-wise identical to mapping ``_unpack``."""
    out: List[Optional[Tuple[int, bytes]]] = [None] * len(blobs)
    idx: List[int] = []
    bodies: List[bytes] = []
    for i, blob in enumerate(blobs):
        if blob and len(blob) >= BLOB_HEADER:
            idx.append(i)
            bodies.append(blob[8:])
    if not idx:
        return out
    for i, body, csum in zip(idx, bodies,
                             crypto.checksum_bytes_batch(bodies)):
        if blobs[i][:8] != csum:
            continue
        ts, ln = struct.unpack_from("<qI", body, 0)
        value = body[12:12 + ln]
        if len(value) == ln:
            out[i] = (ts, value)
    return out


@dataclass
class _Cell:
    """One sub-register replica at one memory node, with write-window
    modeling for torn reads (8-byte atomicity)."""
    blob: bytes = b""
    prev: bytes = b""
    t_start: float = -1.0
    t_end: float = -1.0

    def write(self, blob: bytes, now: float, dur: float) -> None:
        self.prev = self.blob if now >= self.t_end else self.read(now)
        self.blob = blob
        self.t_start, self.t_end = now, now + dur

    def read(self, now: float) -> bytes:
        if now >= self.t_end or self.t_start < 0:
            return self.blob
        if now <= self.t_start:
            return self.prev
        # torn read: new prefix + old suffix at 8-byte granularity
        frac = (now - self.t_start) / max(self.t_end - self.t_start, 1e-9)
        cut = int(frac * max(len(self.blob), len(self.prev)) / 8) * 8
        new = self.blob[:cut]
        old = self.prev[cut:] if len(self.prev) > cut else b"\x00" * 8
        return new + old


class MemoryNode(Node):
    """Disaggregated memory node: READ/WRITE with access control.  Part of
    the trusted computing base — fails only by crashing.

    A node installed as a *replacement* starts with ``serving=False`` and
    drops READs until its pool manager has pushed the re-replicated state
    (``POOL_PUSH``); WRITEs are always accepted so no new data is lost
    during the sync window.
    """

    handling_cost = 0.3  # memnode service time (µs)

    def __init__(self, sim: Simulator, net: NetworkModel, registry, pid: str,
                 write_duration_us: float = 0.4,
                 manager: Optional[str] = None, serving: bool = True):
        super().__init__(sim, net, registry, pid)
        self.cells: Dict[Tuple[str, str, int], _Cell] = {}
        self.write_duration_us = write_duration_us
        self.manager = manager
        self.serving = serving
        #: owners whose write permission was re-keyed away (replica
        #: replacement): their WRITEs are dropped like any permission
        #: violation — a Byzantine replaced replica cannot keep writing
        self.revoked: set = set()
        #: Byzantine memory-side adversary (beyond the crash-only TCB
        #: contract): serve old-but-well-formed blobs — valid checksums,
        #: stale timestamps (see ``set_stale_serve``)
        self.stale_serve = False
        self._stale_cells: Dict[Tuple[str, str, int], bytes] = {}
        self.handle("REG_WRITE", self._on_write)
        self.handle("REG_READ", self._on_read)
        self.handle("LEASE_PING", self._on_lease_ping)
        self.handle("POOL_PULL", self._on_pool_pull)
        self.handle("POOL_PUSH", self._on_pool_push)
        self.handle("POOL_REKEY", self._on_pool_rekey)

    def _on_write(self, src: str, body: Any) -> None:
        owner, reg, sub, blob, token = body
        if owner != src or owner in self.revoked:
            return  # permission violation: only the owner may write (SWMR)
        cell = self.cells.setdefault((owner, reg, sub), _Cell())
        cell.write(blob, self.sim.now, self.write_duration_us)
        self.send(src, "REG_WRITE_ACK", (reg, sub, token))

    def _on_read(self, src: str, body: Any) -> None:
        if not self.serving:
            return  # replacement node: no READs before re-replication
        owner, reg, token = body
        if self.stale_serve:
            # adversarial mode: answer from the frozen snapshot — complete,
            # checksum-valid blobs whose timestamps have fallen behind
            blobs = tuple(self._stale_cells.get((owner, reg, sub), b"")
                          for sub in (0, 1))
        else:
            blobs = tuple(
                self.cells.setdefault((owner, reg, sub), _Cell()).read(self.sim.now)
                for sub in (0, 1)
            )
        self.send(src, "REG_READ_ACK", (owner, reg, token, blobs))

    def set_stale_serve(self, on: bool = True) -> None:
        """Toggle the stale-serve adversary.  On enable, the node freezes
        its current committed blobs and serves those for every subsequent
        READ (it keeps *applying and acking* WRITEs, so its stored state
        stays fresh — only what it serves is stale).  This is strictly
        outside the paper's crash-only TCB contract.  What the
        fault-schedule tests show: once a completed write has propagated
        to the other live members (the steady state — WRITEs go to every
        member, only the ack quorum is f_m+1), ≤ f_m such nodes cannot
        break regularity, because READs take the highest valid timestamp
        over f_m+1 responses and some fresh responder outbids the stale
        one.  The residual hole is the propagation race: a stale server
        still *acks* writes, so it can transiently be the only write-acker
        inside a read quorum whose other members have not yet applied the
        write — that schedule can return stale data, and it is exactly
        where the crash-only boundary of §3 sits (see ROADMAP: locating
        it with a negative test is queued work)."""
        if on and not self.stale_serve:
            self._stale_cells = {key: c.blob for key, c in self.cells.items()
                                 if c.blob}
        if not on:
            self._stale_cells = {}
        self.stale_serve = on

    # ---------------------------------------------- pool-management plane
    def _on_lease_ping(self, src: str, body: Any) -> None:
        if self.manager is not None and src != self.manager:
            return
        self.send(src, "LEASE_ACK", body)

    def _on_pool_pull(self, src: str, body: Any) -> None:
        """State transfer for reconfiguration: ship the committed blob of
        every cell to the pool manager (only complete blobs — ``cell.blob``
        holds the final value; tearing is a read-time artifact)."""
        if self.manager is not None and src != self.manager:
            return
        token = body
        cells = [((owner, reg, sub), c.blob)
                 for (owner, reg, sub), c in self.cells.items() if c.blob]
        self.send(src, "POOL_PULL_ACK", (token, cells))

    def _on_pool_push(self, src: str, body: Any) -> None:
        """Install re-replicated state (highest valid ts wins) and start
        serving READs."""
        if self.manager is not None and src != self.manager:
            return
        token, cells = body
        for key, blob in cells:
            key = tuple(key)
            new = _unpack(blob)
            if new is None:
                continue
            cur = _unpack(self.cells.get(key, _Cell()).blob)
            if cur is None or new[0] > cur[0]:
                cell = self.cells.setdefault(key, _Cell())
                cell.write(blob, self.sim.now, 0.0)
        self.serving = True
        self.send(src, "POOL_PUSH_ACK", token)

    def _on_pool_rekey(self, src: str, body: Any) -> None:
        """Re-key a replaced replica's register permission: install the
        merged cells under the new owner pid, revoke the old owner's write
        access, and drop its cells (the permission token moves — §6.1's
        RDMA access control, now epoch-aware)."""
        if self.manager is not None and src != self.manager:
            return
        token, old, new, cells = body
        self.revoked.add(old)
        for key, blob in cells:
            _owner, reg, sub = tuple(key)
            v = _unpack(blob)
            if v is None:
                continue
            cell = self.cells.setdefault((new, reg, sub), _Cell())
            cur = _unpack(cell.blob)
            if cur is None or v[0] > cur[0]:
                cell.write(blob, self.sim.now, 0.0)
        for key in [k for k in self.cells if k[0] == old]:
            del self.cells[key]
        self.send(src, "POOL_REKEY_ACK", token)

    def memory_bytes(self) -> int:
        """Occupied disaggregated memory: one RDMA buffer per sub-register.
        WRITEs overwrite it in place (which is why READs can tear) —
        ``_Cell.prev`` is torn-read modeling, not allocated memory."""
        return sum(len(c.blob) for c in self.cells.values())

    def memory_bytes_by_owner(self) -> Dict[str, int]:
        """Occupancy split by writing owner pid — the attribution unit for
        per-application Table 2 accounting on a shared substrate."""
        out: Dict[str, int] = {}
        for (owner, _reg, _sub), c in self.cells.items():
            if c.blob:
                out[owner] = out.get(owner, 0) + len(c.blob)
        return out


class _PoolManager(Node):
    """Lease + reconfiguration orchestrator for one :class:`MemoryPool`.

    Models the paper's assumption that disaggregated memory is provided by
    the infrastructure: the manager is a crash-free control-plane process
    (not on any data path) that grants leases and performs state transfer
    when a member is replaced.
    """

    handling_cost = 0.3

    def __init__(self, sim: Simulator, net: NetworkModel, registry,
                 pid: str, pool: "MemoryPool"):
        super().__init__(sim, net, registry, pid)
        self.pool = pool
        self._last_ack: Dict[str, float] = {}
        self._sync: Dict[int, dict] = {}
        self._tok = 0
        self._leasing = False
        self._lease_timer = None
        self.suspected: List[Tuple[float, str]] = []
        self._suspect_live: set = set()
        self.handle("LEASE_ACK", self._on_lease_ack)
        self.handle("POOL_PULL_ACK", self._on_pull_ack)
        self.handle("POOL_PUSH_ACK", self._on_push_ack)
        self.handle("POOL_REKEY_ACK", self._on_rekey_ack)

    # ------------------------------------------------------------- leases
    def start_leases(self) -> None:
        if self._leasing:
            return
        self._leasing = True
        for m in self.pool.members:
            self._last_ack[m] = self.sim.now
        # First tick immediately, then coalesced on the shared periodic
        # bucket: every pool with the same lease quantum rides ONE heap
        # event per tick instead of one timer chain per pool manager.
        self._tick()
        self._lease_timer = self.sim.periodic(self.pool.lease_us / 2,
                                              self._tick)

    def stop_leases(self) -> None:
        self._leasing = False
        if self._lease_timer is not None:
            self._lease_timer.cancel()
            self._lease_timer = None

    def _tick(self) -> None:
        if self._leasing:
            now = self.sim.now
            for m in list(self.pool.members):
                self.send(m, "LEASE_PING", now)
                expiry = self._last_ack.setdefault(m, now) + self.pool.lease_us
                if now > expiry:
                    self._suspect(m)

    def _on_lease_ack(self, src: str, body: Any) -> None:
        self._last_ack[src] = self.sim.now
        self._suspect_live.discard(src)

    def _suspect(self, pid: str) -> None:
        if pid not in self._suspect_live:     # one suspicion per episode
            self._suspect_live.add(pid)
            self.suspected.append((self.sim.now, pid))
        if self.pool.auto_reconfigure:
            self.pool.reconfigure(pid)

    # ---------------------------------------------------- reconfiguration
    def begin_sync(self, dead: str, fresh: str, survivors: List[str],
                   on_done: Callable[[], None],
                   on_abort: Callable[[], None]) -> None:
        self._tok += 1
        tok = self._tok
        self._sync[tok] = {"kind": "sync", "resps": [], "fresh": fresh,
                           "dead": dead, "pushed": False, "cb": on_done,
                           "need": self.pool.f_m + 1}
        for s in survivors:
            self.send(s, "POOL_PULL", tok)
        # A sync that cannot gather f_m+1 pull acks (fault budget transiently
        # exceeded) must not wedge the pool: abort and let the caller retry.
        def expire() -> None:
            if self._sync.pop(tok, None) is not None:
                on_abort()

        self.timer(self.pool.sync_timeout_us, expire)

    def begin_rekey(self, old: str, new: str,
                    on_done: Callable[[Dict[str, int]], None],
                    on_abort: Optional[Callable[[], None]] = None) -> None:
        """Re-key register permissions ``old`` → ``new`` (replica
        replacement): the *same* pull/merge path as reconfiguration
        gathers the old owner's highest-valid-timestamp cells from f_m+1
        members, then every member installs them under the new owner and
        revokes the old one's write access (POOL_REKEY).  ``on_done``
        receives the per-register max write timestamps so the new owner's
        RegisterClient can adopt them (its next WRITE must supersede the
        inherited blobs).  A round that cannot complete within
        ``sync_timeout_us`` calls ``on_abort`` (the pool's
        :meth:`MemoryPool.rekey_owner` retries — a transiently degraded
        pool must not silently leave the old permission live)."""
        self._tok += 1
        tok = self._tok
        self._sync[tok] = {"kind": "rekey", "resps": [], "old": old,
                           "new": new, "pushed": False, "cb": on_done,
                           "need": self.pool.f_m + 1, "acks": 0,
                           "wts": {}}
        for s in self.pool.members:
            self.send(s, "POOL_PULL", tok)

        def expire() -> None:
            if self._sync.pop(tok, None) is not None and on_abort is not None:
                on_abort()

        self.timer(self.pool.sync_timeout_us, expire)

    def _on_pull_ack(self, src: str, body: Any) -> None:
        tok, cells = body
        st = self._sync.get(tok)
        if st is None or st["pushed"]:
            return
        st["resps"].append(cells)
        if len(st["resps"]) < st["need"]:
            return
        # merge: highest valid timestamp per (owner, reg, sub).  f_m+1
        # responses intersect every completed WRITE's f_m+1 ack quorum, so
        # the merge contains every acknowledged value.
        st["pushed"] = True
        merged: Dict[tuple, Tuple[int, bytes]] = {}
        for cells in st["resps"]:
            for key, blob in cells:
                key = tuple(key)
                v = _unpack(blob)
                if v is None:
                    continue
                if key not in merged or v[0] > merged[key][0]:
                    merged[key] = (v[0], blob)
        if st["kind"] == "rekey":
            old, new = st["old"], st["new"]
            keep = [(k, blob) for k, (_ts, blob) in merged.items()
                    if k[0] == old]
            wts: Dict[str, int] = {}
            for (owner, reg, _sub), (ts, _blob) in merged.items():
                if owner == old and ts > wts.get(reg, 0):
                    wts[reg] = ts
            st["wts"] = wts
            for m in self.pool.members:
                self.send(m, "POOL_REKEY", (tok, old, new, keep))
            return
        self.send(st["fresh"], "POOL_PUSH",
                  (tok, [(k, blob) for k, (_ts, blob) in merged.items()]))

    def _on_push_ack(self, src: str, body: Any) -> None:
        st = self._sync.pop(body, None)
        if st is not None:
            st["cb"]()

    def _on_rekey_ack(self, src: str, body: Any) -> None:
        st = self._sync.get(body)
        if st is None or st.get("kind") != "rekey":
            return
        st["acks"] += 1
        if st["acks"] >= st["need"]:
            del self._sync[body]
            st["cb"](st["wts"])


class MemoryPool:
    """A pool of 2f_m+1 crash-injectable disaggregated-memory nodes with
    lease-based reconfiguration (see module docstring).

    The pool object doubles as the *directory* clients consult for the
    current membership (``members`` / ``epoch``) — the sim-level stand-in
    for the provider's membership service.
    """

    def __init__(self, sim: Simulator, net: NetworkModel, registry,
                 f_m: int = 1, name: str = "pool0",
                 prefix: Optional[str] = None,
                 write_duration_us: float = 0.4,
                 lease_us: float = 200.0,
                 auto_reconfigure: bool = False,
                 sync_timeout_us: float = 2_000.0):
        self.sim = sim
        self.net = net
        self.registry = registry
        self.f_m = f_m
        self.name = name
        self.prefix = prefix if prefix is not None else f"{name}/m"
        self.write_duration_us = write_duration_us
        self.lease_us = lease_us
        self.auto_reconfigure = auto_reconfigure
        self.sync_timeout_us = sync_timeout_us
        self.epoch = 0
        self.nodes: Dict[str, MemoryNode] = {}
        self.members: List[str] = []
        self._next_id = 0
        self._reconfiguring = False
        #: (time, dead_pid, fresh_pid) per completed reconfiguration
        self.reconfigurations: List[Tuple[float, str, str]] = []
        #: (time, dead_pid, fresh_pid) per timed-out, rolled-back sync
        self.aborted_syncs: List[Tuple[float, str, str]] = []
        #: (time, old_owner, new_owner) per completed permission rekey
        self.rekeys: List[Tuple[float, str, str]] = []
        #: (time, old_owner, new_owner) per timed-out (retried) rekey round
        self.aborted_rekeys: List[Tuple[float, str, str]] = []
        self.manager = _PoolManager(sim, net, registry, f"{self.prefix}gr",
                                    self)
        for _ in range(2 * f_m + 1):
            self.members.append(self._spawn(serving=True).pid)
        if auto_reconfigure and lease_us > 0:
            self.manager.start_leases()

    def _spawn(self, serving: bool) -> MemoryNode:
        pid = f"{self.prefix}{self._next_id}"
        self._next_id += 1
        node = MemoryNode(self.sim, self.net, self.registry, pid,
                          write_duration_us=self.write_duration_us,
                          manager=self.manager.pid, serving=serving)
        self.nodes[pid] = node
        return node

    # ------------------------------------------------------ fault surface
    def crash_node(self, pid: str) -> None:
        self.nodes[pid].crash()

    def recover_node(self, pid: str) -> None:
        self.nodes[pid].recover()

    def crashed_members(self) -> List[str]:
        return [m for m in self.members if self.nodes[m].crashed]

    # ---------------------------------------------------- reconfiguration
    def reconfigure(self, dead: Optional[str] = None,
                    cb: Optional[Callable[[], None]] = None) -> bool:
        """Replace ``dead`` (default: first crashed member) with a fresh
        node: pull state from f_m+1 survivors, push the highest-timestamp
        merge to the fresh node, then swap it into the membership.  Returns
        False when there is nothing to do / a swap is already in flight.
        A sync that cannot complete within ``sync_timeout_us`` (e.g. the
        crash budget is transiently exceeded and f_m+1 survivors cannot
        answer) is aborted — the pool stays on the old membership and a
        later ``reconfigure`` (or the next lease tick) retries."""
        if self._reconfiguring:
            return False
        if dead is None:
            crashed = self.crashed_members()
            if not crashed:
                return False
            dead = crashed[0]
        if dead not in self.members:
            return False
        self._reconfiguring = True
        fresh = self._spawn(serving=False)
        survivors = [m for m in self.members if m != dead]

        def done() -> None:
            idx = self.members.index(dead)
            self.members[idx] = fresh.pid
            self.epoch += 1
            self._reconfiguring = False
            self.reconfigurations.append((self.sim.now, dead, fresh.pid))
            if cb is not None:
                cb()

        def abort() -> None:
            # discard the never-served replacement and unwedge the pool
            self.nodes.pop(fresh.pid, None)
            self.sim.processes.pop(fresh.pid, None)
            self._reconfiguring = False
            self.aborted_syncs.append((self.sim.now, dead, fresh.pid))

        self.manager.begin_sync(dead, fresh.pid, survivors, done, abort)
        return True

    def rekey_owner(self, old: str, new: str,
                    cb: Optional[Callable[[Dict[str, int]], None]] = None
                    ) -> None:
        """Move the register permission of owner ``old`` to ``new`` on
        every member (replica replacement).  Reuses the reconfiguration
        pull/merge machinery; records the completed rekey and forwards the
        inherited per-register write timestamps to ``cb``.  A round that
        times out (pull quorum transiently unreachable) is recorded in
        ``aborted_rekeys`` and retried — the revocation must eventually
        land on every serving member, or a Byzantine replaced replica
        could keep writing."""

        def done(wts: Dict[str, int]) -> None:
            self.rekeys.append((self.sim.now, old, new))
            if cb is not None:
                cb(wts)

        def aborted() -> None:
            self.aborted_rekeys.append((self.sim.now, old, new))
            self.manager.timer(self.sync_timeout_us / 2, retry)

        def retry() -> None:
            if not any(o == old and n == new
                       for (_t, o, n) in self.rekeys):
                self.manager.begin_rekey(old, new, done, aborted)

        self.manager.begin_rekey(old, new, done, aborted)

    # --------------------------------------------------------- accounting
    def member_nodes(self) -> List[MemoryNode]:
        return [self.nodes[m] for m in self.members]

    def memory_bytes(self) -> int:
        """Occupancy of the pool's *current* members (Table 2: must stay
        under 1 MiB per pool)."""
        return sum(n.memory_bytes() for n in self.member_nodes())

    def memory_bytes_by_owner(self) -> Dict[str, int]:
        """Occupancy of the current members split by owner pid; the
        substrate rolls this up into per-application accounting."""
        out: Dict[str, int] = {}
        for n in self.member_nodes():
            for owner, nbytes in n.memory_bytes_by_owner().items():
                out[owner] = out.get(owner, 0) + nbytes
        return out


@dataclass
class _StaticPool:
    """Legacy fixed-membership view: a bare pid list wrapped to look like a
    pool (no manager, no reconfiguration)."""
    members: List[str]
    name: str = "static"
    epoch: int = 0


class RegisterClient:
    """Reliable SWMR regular register operations for one node (§6.1).

    ``mem`` may be a bare list of memory-node pids (legacy static
    deployment), one :class:`MemoryPool`, or a list of pools — register
    keys are then sharded ``crc32(owner:reg) % n_pools``, or
    ``crc32(app:owner:reg)`` when the client carries an application
    ``namespace`` (many replicated applications over one substrate; the
    empty namespace is the legacy single-app layout, preserved
    bit-for-bit).  Membership is re-read from the pool directory at every
    operation, so reconfigurations are picked up without any client-side
    protocol change.
    """

    def __init__(self, node: Node, mem, f_m: int, slot_bytes: int = 128,
                 namespace: str = ""):
        self.node = node
        self.namespace = namespace
        self.pools = self._normalize(mem)
        for p in self.pools:
            assert len(p.members) >= 2 * f_m + 1
        self.quorum = f_m + 1
        self.slot_bytes = slot_bytes
        self._wts: Dict[str, int] = {}
        self._last_write: Dict[str, float] = {}
        self._pending: Dict[int, dict] = {}
        self._token = 0
        self.stats = {"read_attempts": 0, "read_retries": 0,
                      "reads_exhausted": 0}
        node.handle("REG_WRITE_ACK", self._on_write_ack)
        node.handle("REG_READ_ACK", self._on_read_ack)

    @staticmethod
    def _normalize(mem) -> List[Any]:
        if isinstance(mem, MemoryPool):
            return [mem]
        mem = list(mem)
        assert mem, "need at least one memory node / pool"
        if isinstance(mem[0], str):
            return [_StaticPool(members=mem)]
        return mem

    # ------------------------------------------------------------ routing
    @property
    def n_shards(self) -> int:
        return len(self.pools)

    def pool_for(self, owner: str, reg: str,
                 namespace: Optional[str] = None):
        """Stable shard routing of register keys across pools.  Namespaced
        clients hash ``app:owner:reg`` so each application's keys spread
        independently; the unnamed app hashes the legacy ``owner:reg``.
        ``namespace`` overrides the client's own namespace — a reader in
        one application following a register written under another's
        namespace (shard split/merge range transfer) must route with the
        *writer's* namespace or it consults the wrong pool."""
        if len(self.pools) == 1:
            return self.pools[0]
        ns = self.namespace if namespace is None else namespace
        key = f"{ns}:{owner}:{reg}" if ns else f"{owner}:{reg}"
        h = zlib.crc32(key.encode())
        return self.pools[h % len(self.pools)]

    @property
    def mem_nodes(self) -> List[str]:
        """Legacy single-pool view of the current membership."""
        return list(self.pools[0].members)

    def adopt_wts(self, wts: Dict[str, int]) -> None:
        """Adopt inherited per-register write timestamps (permission rekey
        during replica replacement): the new owner's next WRITE to an
        inherited register must carry a higher timestamp than any blob the
        pools re-keyed over, or readers would keep preferring the stale
        inherited value."""
        for reg, ts in wts.items():
            if ts > self._wts.get(reg, 0):
                self._wts[reg] = ts

    # ------------------------------------------------------------- WRITE
    def write(self, reg: str, value: bytes, cb: Callable[[], None]) -> None:
        """WRITE my register ``reg`` (owner = this node).  Completes at a
        majority of the owning pool's memory nodes.  Enforces the δ cooldown
        between WRITEs to the same register (§6.1) so readers can always
        find a complete sub-register."""
        now = self.node.sim.now
        delta = self.node.netp.delta_us
        earliest = self._last_write.get(reg, -delta) + delta
        if now < earliest:
            self.node.timer(earliest - now, lambda: self.write(reg, value, cb))
            return
        self._last_write[reg] = now
        if self.node.sim.tracing:
            t0 = now
            inner_cb = cb
            def cb():
                self.node.sim.trace.append(("smwr", t0, self.node.sim.now))
                inner_cb()
        ts = self._wts.get(reg, 0) + 1
        self._wts[reg] = ts
        blob = _pack(ts, value)
        sub = ts % 2  # round-robin double buffering
        self._token += 1
        tok = self._token
        self._pending[tok] = {"kind": "w", "acks": 0, "cb": cb, "done": False}
        body = (self.node.pid, reg, sub, blob, tok)
        size = crypto.wire_size_shallow(body) + 25  # len("REG_WRITE") + 16
        self.node.send_fanout(self.pool_for(self.node.pid, reg).members,
                              "REG_WRITE", body, size=size)

    def _on_write_ack(self, src: str, body: Any) -> None:
        _reg, _sub, tok = body
        st = self._pending.get(tok)
        if st is None or st["kind"] != "w" or st["done"]:
            return
        st["acks"] += 1
        if st["acks"] >= self.quorum:
            st["done"] = True
            del self._pending[tok]
            st["cb"]()

    # -------------------------------------------------------------- READ
    def read(self, owner: str, reg: str,
             cb: Callable[[Optional[Tuple[int, bytes]], bool], None],
             namespace: Optional[str] = None) -> None:
        """READ ``owner``'s register.  cb(value, owner_is_byzantine) where
        value is (ts, bytes) or None (default value ⊥).  ``namespace``
        routes the read under another application's namespace (see
        :meth:`pool_for`)."""
        if self.node.sim.tracing:
            t0 = self.node.sim.now
            inner_cb = cb
            def cb(val, byz):
                self.node.sim.trace.append(("smwr", t0, self.node.sim.now))
                inner_cb(val, byz)
        self._start_read(owner, reg, cb, attempt=1, namespace=namespace)

    def _start_read(self, owner: str, reg: str, cb, attempt: int,
                    namespace: Optional[str] = None) -> None:
        self.stats["read_attempts"] += 1
        self._token += 1
        tok = self._token
        self._pending[tok] = {
            "kind": "r", "resps": [], "cb": cb, "done": False,
            "start": self.node.sim.now, "owner": owner, "reg": reg,
            "attempt": attempt, "ns": namespace,
        }
        body = (owner, reg, tok)
        size = crypto.wire_size_shallow(body) + 24  # len("REG_READ") + 16
        self.node.send_fanout(self.pool_for(owner, reg, namespace).members,
                              "REG_READ", body, size=size)

    def _on_read_ack(self, src: str, body: Any) -> None:
        owner, reg, tok, blobs = body
        st = self._pending.get(tok)
        if st is None or st["kind"] != "r" or st["done"]:
            return
        st["resps"].append(blobs)
        if len(st["resps"]) < self.quorum:
            return
        st["done"] = True
        del self._pending[tok]
        self._conclude_read(st)

    def _conclude_read(self, st: dict) -> None:
        took = self.node.sim.now - st["start"]
        delta = self.node.netp.delta_us
        best: Optional[Tuple[int, bytes]] = None
        byz = False
        resps = st["resps"]
        # one checksum batch for the whole quorum (2 sub-registers × q acks)
        flat = _unpack_batch([b for blobs in resps for b in blobs])
        pos = 0
        for blobs in resps:
            vals = flat[pos:pos + len(blobs)]
            pos += len(blobs)
            ok = [v for v in vals if v is not None]
            if len(ok) == 2 and ok[0][0] == ok[1][0]:
                byz = True  # both sub-registers with the same timestamp
            if (not ok and took < delta
                    and all(len(b) >= BLOB_HEADER for b in blobs)):
                # Both sub-registers carry data yet neither validates within
                # δ — an honest writer can tear at most one sub-register per
                # δ window, so the owner is Byzantine.  (An *empty* second
                # sub-register means a READ overlapping the first-ever
                # WRITE: regularity allows ⊥, no verdict.)
                byz = True
            for v in ok:
                if best is None or v[0] > best[0]:
                    best = v
        if best is None and not byz:
            blank = all(not b for blobs in st["resps"] for b in blobs)
            if took >= delta and not blank:
                # inconclusive slow read — retry, capped end-to-end (§6.1)
                if st["attempt"] < MAX_READ_ATTEMPTS:
                    self.stats["read_retries"] += 1
                    self._start_read(st["owner"], st["reg"], st["cb"],
                                     st["attempt"] + 1,
                                     namespace=st.get("ns"))
                else:
                    self.stats["reads_exhausted"] += 1
                    st["cb"](None, False)
                return
        st["cb"](best, byz)

    # --------------------------------------------------------- accounting
    def disaggregated_bytes_per_register(self) -> int:
        """Table 2 model: 2 sub-registers × (checksum 8 + header 12 + value)."""
        return 2 * (8 + 12 + self.slot_bytes)
