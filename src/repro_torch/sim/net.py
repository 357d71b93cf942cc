"""Calibrated network + CPU cost model (DESIGN.md §4).

All constants live in :class:`NetParams` so the calibration is in one place.
The model is calibrated so that the *unreplicated* RPC and Mu baselines land
on the paper's measurements (Fig 8); uBFT / MinBFT / SGX numbers are then
*predicted* by protocol structure, which is the reproduction claim.

Message size accounting: every protocol message computes its wire size from
its payload (see ``repro.core.crypto.wire_size_cached`` — sizes of shared
payload subtrees are memoized); batched payloads (tuples of request tuples)
are priced recursively, so a PREPARE carrying a batch pays for every request
it coalesces; latency = ``base + size * per_byte`` plus a small lognormal
jitter, plus unbounded extra delay before GST if asynchrony injection is
enabled.

Jitter draws are pre-drawn in vectorized numpy blocks from the simulator's
seeded RNG.  Filling an array consumes the PCG64 bitstream exactly like the
equivalent sequence of scalar draws, so per-hop jitter values are
bit-identical to the scalar-draw implementation — provided every consumer
pulls from the *same* stream in call order, which is why the Mu baseline's
leader also draws through :meth:`NetworkModel.jitter`.
"""

from __future__ import annotations

import heapq
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.sim.events import Process, Simulator


@dataclass
class NetParams:
    # One-way RDMA-write-style message: base latency (µs) and per-byte cost
    # (µs/byte).  0.9 µs + 1.1 ns/B reproduces: 32 B hop ≈ 0.94 µs (unrepl.
    # RPC 2.2 µs incl. handling), 8 KiB hop ≈ 9.9 µs (unrepl. RPC ≈ 20 µs).
    base_us: float = 0.9
    per_byte_us: float = 0.0011
    # Lognormal jitter on each hop (multiplicative, mean≈1).
    jitter_sigma: float = 0.08
    # Known post-GST delay bound δ (µs) — used by the register δ-cooldown.
    delta_us: float = 10.0
    # Crypto cost model (µs) — DESIGN.md §4, backed out of Fig 9/10.
    sign_us: float = 15.0
    verify_us: float = 30.0
    hmac_us: float = 0.1
    checksum_per_byte_us: float = 0.0001  # xxHash ≈ 10 GB/s
    crypto_dispatch_us: float = 3.0       # thread-pool dispatch+sync
    # SGX baseline: cost of one enclave access (paper: 7–12.5 µs).
    enclave_access_us: float = 8.0
    # Bookkeeping signatures (CTBcast summaries, checkpoints) run in a
    # BACKGROUND task (§3: "relegating the few bookkeeping signatures to a
    # background task") that wakes on a scheduling quantum:
    bg_quantum_us: float = 75.0
    # Disaggregated-memory node service time per READ/WRITE (µs).
    memnode_service_us: float = 0.3


class NetworkModel:
    """Point-to-point message fabric with per-link asynchrony hooks."""

    #: jitter factors pre-drawn per refill (vectorized; see module docstring)
    JITTER_BLOCK = 4096

    def __init__(self, sim: Simulator, params: Optional[NetParams] = None):
        self.sim = sim
        self.p = params or NetParams()
        # (src, dst) -> extra one-way delay in µs (adversarial asynchrony /
        # partition modeling; applied only before sim.gst unless forced).
        self.link_delay: Dict[Tuple[str, str], float] = {}
        self.partitioned: set = set()
        # Forced partitions drop regardless of GST (fault-schedule driver:
        # an operator-visible network fault, not pre-GST asynchrony).
        self.forced: set = set()
        # Gray failure (``slow_replica`` fault): a degraded *source* stays
        # up but every send pays an extra delay and/or loses a seeded
        # fraction.  Applied regardless of GST (a sick NIC, not pre-GST
        # asynchrony).  Drop draws come from a dedicated per-entry RNG —
        # never the simulator's jitter stream, so enabling a degradation
        # cannot perturb the jitter draws of unaffected traffic.
        self.degraded: Dict[str, Tuple[float, float, random.Random]] = {}
        self.bytes_sent: int = 0
        self.msgs_sent: int = 0
        #: messages that went through :meth:`send_fanout`
        self.fanout_msgs: int = 0
        #: same-timestamp delivery runs enqueued as one heap entry
        self.coalesced_runs: int = 0
        self._jitter_buf = None
        self._jitter_idx = 0
        self._jitter_sigma = None   # sigma the buffer was drawn with

    # -- latency model ----------------------------------------------------
    def jitter(self) -> float:
        """Next multiplicative jitter factor (lognormal, mean≈1) from the
        pre-drawn block.  Blocks refill deterministically from the seeded
        RNG (vectorized fills consume the bitstream exactly like scalar
        draws); a mid-run ``jitter_sigma`` change discards the stale
        block.  The block lives as a plain Python list — scalar indexing
        into a numpy array costs more than the draw itself."""
        i = self._jitter_idx
        buf = self._jitter_buf
        sigma = self.p.jitter_sigma
        if buf is None or i >= len(buf) or sigma != self._jitter_sigma:
            buf = self._jitter_buf = self.sim.rng.lognormal(
                mean=0.0, sigma=sigma, size=self.JITTER_BLOCK).tolist()
            self._jitter_sigma = sigma
            i = 0
        self._jitter_idx = i + 1
        return buf[i]

    def latency(self, src: str, dst: str, size: int) -> float:
        lat = self.p.base_us + size * self.p.per_byte_us
        if self.p.jitter_sigma > 0:
            lat *= self.jitter()
        if self.link_delay:
            extra = self.link_delay.get((src, dst), 0.0)
            if extra and self.sim.now < self.sim.gst:
                lat += extra
        return lat

    # -- send --------------------------------------------------------------
    def send(self, src: str, dst: str, msg: Any, size: int,
             deliver: Optional[Callable[[], None]] = None) -> None:
        """One-way message.  If ``deliver`` is given it is invoked at arrival
        time instead of the default ``Process.deliver`` (used by the circular
        buffer primitive to model slot overwrites)."""
        if (self.forced or self.partitioned) and (
                (src, dst) in self.forced or (
                    (src, dst) in self.partitioned and
                    self.sim.now < self.sim.gst)):
            return  # dropped; retransmission layers must cope
        deg = None
        if self.degraded:
            deg = self.degraded.get(src)
            if deg is not None and deg[1] and deg[2].random() < deg[1]:
                return  # gray failure: the sender's NIC lost it
        self.bytes_sent += size
        self.msgs_sent += 1
        # inlined latency(): base + per-byte, jittered from the pre-drawn
        # block — one call frame per message matters at this volume
        p = self.p
        lat = p.base_us + size * p.per_byte_us
        if p.jitter_sigma > 0:
            i = self._jitter_idx
            buf = self._jitter_buf
            if buf is None or i >= len(buf) or \
                    p.jitter_sigma != self._jitter_sigma:
                lat *= self.jitter()
            else:
                self._jitter_idx = i + 1
                lat *= buf[i]
        sim = self.sim
        if self.link_delay:
            extra = self.link_delay.get((src, dst), 0.0)
            if extra and sim.now < sim.gst:
                lat += extra
        if deg is not None:
            lat += deg[0]

        if deliver is not None:
            sim.after(lat, deliver)
            return

        procs = sim.processes
        proc = procs.get(dst)
        if proc is None or proc.crashed:
            return

        def _arrive() -> None:
            p = procs.get(dst)
            if p is not None:
                p.deliver(src, msg, size)

        # inlined sim.after() — one call frame per message matters here
        sim._seq += 1
        heapq.heappush(sim._heap, (sim.now + lat, sim._seq, _arrive))

    def send_fanout(self, src: str, dsts: Any, msg: Any, size: int) -> None:
        """Fan ONE encoded message to many peers in one call.

        Equivalent to ``for dst in dsts: send(src, dst, msg, size)`` —
        bit-identical, because jitter factors are drawn per destination in
        ``dsts`` order from the same pre-drawn block — but the guard
        checks, accounting, and base-latency math are hoisted out of the
        loop.  Whenever the fabric has *any* per-link state (partitions,
        forced drops, degradations, link delays) it falls back to the
        scalar path, which short-circuits drops before drawing jitter.

        When the per-hop latency is fully deterministic (``jitter_sigma ==
        0``), all n deliveries land on the same timestamp and are enqueued
        as one coalesced heap run (``Simulator.push_run``), preserving
        ``(time, seq)`` execution order exactly (the n individual pushes
        would have held consecutive seqs)."""
        if self.forced or self.partitioned or self.degraded or self.link_delay:
            for dst in dsts:
                self.send(src, dst, msg, size)
            return
        ndst = len(dsts)
        self.bytes_sent += size * ndst
        self.msgs_sent += ndst
        self.fanout_msgs += ndst
        p = self.p
        base = p.base_us + size * p.per_byte_us
        sim = self.sim
        now = sim.now
        procs = sim.processes
        heap = sim._heap
        sigma = p.jitter_sigma

        if sigma > 0:
            buf = self._jitter_buf
            i = self._jitter_idx
            for dst in dsts:
                if buf is None or i >= len(buf) or \
                        sigma != self._jitter_sigma:
                    self._jitter_idx = i
                    lat = base * self.jitter()
                    buf = self._jitter_buf
                    i = self._jitter_idx
                else:
                    lat = base * buf[i]
                    i += 1
                proc = procs.get(dst)
                if proc is None or proc.crashed:
                    continue

                def _arrive(dst: str = dst) -> None:
                    pr = procs.get(dst)
                    if pr is not None:
                        pr.deliver(src, msg, size)

                sim._seq += 1
                heapq.heappush(heap, (now + lat, sim._seq, _arrive))
            self._jitter_idx = i
            return

        # deterministic latency: every delivery shares one timestamp
        run = []
        append = run.append
        for dst in dsts:
            proc = procs.get(dst)
            if proc is None or proc.crashed:
                continue

            def _arrive(dst: str = dst) -> None:
                pr = procs.get(dst)
                if pr is not None:
                    pr.deliver(src, msg, size)

            append(_arrive)
        if not run:
            return
        if len(run) == 1:
            sim._seq += 1
            heapq.heappush(heap, (now + base, sim._seq, run[0]))
            return
        self.coalesced_runs += 1
        sim.push_run(now + base, run)

    # -- asynchrony / failure injection ------------------------------------
    def degrade_src(self, pid: str, delay_us: float = 0.0,
                    drop: float = 0.0, seed: int = 0) -> None:
        """Gray-degrade every send *from* ``pid``: add ``delay_us`` to its
        one-way latency and drop a ``drop`` fraction (seeded, deterministic,
        independent of the jitter stream).  Applies regardless of GST."""
        if not 0.0 <= drop < 1.0:
            raise ValueError(f"drop fraction must be in [0, 1): {drop!r}")
        self.degraded[pid] = (float(delay_us), float(drop),
                              random.Random(seed))

    def clear_degrade(self, pid: str) -> None:
        self.degraded.pop(pid, None)

    def delay_link(self, src: str, dst: str, extra_us: float) -> None:
        self.link_delay[(src, dst)] = extra_us

    def partition(self, src: str, dst: str, forced: bool = False) -> None:
        self.partitioned.add((src, dst))
        if forced:
            self.forced.add((src, dst))

    def heal_link(self, src: str, dst: str) -> None:
        self.partitioned.discard((src, dst))
        self.forced.discard((src, dst))
        self.link_delay.pop((src, dst), None)

    def heal(self) -> None:
        self.partitioned.clear()
        self.forced.clear()
        self.link_delay.clear()
