"""Discrete-event simulator with a microsecond virtual clock.

Design notes
------------
* Time is a float, in microseconds.
* Every :class:`Process` is a busy server: it handles one event at a time and
  each handler has a CPU cost; events that arrive while the process is busy
  queue behind ``busy_until``.  This is what produces realistic tail-latency
  distributions (the paper's Figs 7/11 depend on queueing effects).
* Determinism: all randomness flows through ``Simulator.rng`` (seeded); the
  event heap breaks ties with a monotonically increasing sequence number, so
  runs are exactly reproducible.
* The heap holds plain ``(time, seq, callback)`` tuples — tuple comparison
  is C-level and ``seq`` is unique, so callbacks are never compared.  The
  ``note`` argument accepted by the scheduling calls is a debugging label
  and is deliberately *not* stored: labels must cost nothing when tracing
  is off, which also means call sites must not build f-strings for them on
  hot paths.
* Periodic work (lease pings, background quanta) goes through
  :meth:`Simulator.periodic`: subscribers with the same period and phase
  share ONE heap event per tick and run in registration order — exactly the
  times and ordering that per-subscriber timer chains would produce, at a
  fraction of the heap traffic (PR 2's per-pool ``LEASE_PING`` storm).
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np


class _PeriodicBucket:
    """All periodic subscribers sharing (period, phase): one heap event per
    tick, callbacks run in registration order.  Cancelled slots are None."""

    __slots__ = ("sim", "period", "next_fire", "cbs")

    def __init__(self, sim: "Simulator", period: float, next_fire: float):
        self.sim = sim
        self.period = period
        self.next_fire = next_fire
        self.cbs: List[Optional[Callable[[], None]]] = []

    def fire(self) -> None:
        sim = self.sim
        sim._periodic.pop((self.period, self.next_fire), None)
        cbs = [c for c in self.cbs if c is not None]
        if not cbs:
            return  # every subscriber cancelled — bucket dies
        self.cbs = cbs
        # Re-key and reschedule *before* running callbacks so a callback
        # registering a same-phase periodic joins this bucket.
        self.next_fire += self.period
        sim._periodic[(self.period, self.next_fire)] = self
        sim.at(self.next_fire, self.fire)
        for c in cbs:
            if c is not None:   # cancelled by an earlier cb this tick
                c()


class PeriodicHandle:
    """Cancellation handle returned by :meth:`Simulator.periodic`."""

    __slots__ = ("_bucket", "_cb")

    def __init__(self, bucket: _PeriodicBucket, cb: Callable[[], None]):
        self._bucket = bucket
        self._cb = cb

    def cancel(self) -> None:
        cbs = self._bucket.cbs
        for i, c in enumerate(cbs):
            if c is self._cb:
                cbs[i] = None
                return


class Simulator:
    """Virtual-time event loop."""

    def __init__(self, seed: int = 0):
        self.now: float = 0.0
        self._heap: List[Tuple[float, int, Callable[[], None]]] = []
        self._seq = 0
        self.rng = np.random.default_rng(seed)
        self.processes: Dict[str, "Process"] = {}
        self.trace: List[tuple] = []
        self.tracing = False
        #: total events executed by run()/run_until() (perf accounting)
        self.events_processed: int = 0
        self._periodic: Dict[Tuple[float, float], _PeriodicBucket] = {}
        # Global stabilization: before ``gst`` the network may apply extra
        # delay (asynchrony); after it, delays are bounded (eventual synchrony).
        self.gst: float = 0.0

    # -- scheduling ------------------------------------------------------
    def at(self, time: float, callback: Callable[[], None],
           note: str = "") -> None:
        if time < self.now:
            time = self.now
        self._seq += 1
        heapq.heappush(self._heap, (time, self._seq, callback))

    def after(self, delay: float, callback: Callable[[], None],
              note: str = "") -> None:
        # inlined at() — one call frame per event matters at this volume
        time = self.now + delay if delay > 0.0 else self.now
        self._seq += 1
        heapq.heappush(self._heap, (time, self._seq, callback))

    def periodic(self, period: float, callback: Callable[[], None]
                 ) -> PeriodicHandle:
        """Run ``callback`` every ``period`` µs, first at ``now + period``.
        Subscribers registered at the same time with the same period share
        one heap event per tick (coalescing); within a tick they run in
        registration order — identical timing to a per-subscriber timer
        chain.  Returns a handle whose ``cancel()`` stops the callback."""
        if period <= 0:
            raise ValueError("periodic() needs a positive period")
        key = (period, self.now + period)
        bucket = self._periodic.get(key)
        if bucket is None:
            bucket = _PeriodicBucket(self, period, self.now + period)
            self._periodic[key] = bucket
            self.at(bucket.next_fire, bucket.fire)
        bucket.cbs.append(callback)
        return PeriodicHandle(bucket, callback)

    # -- process registry ------------------------------------------------
    def add_process(self, proc: "Process") -> None:
        if proc.pid in self.processes:
            raise ValueError(f"duplicate pid {proc.pid}")
        self.processes[proc.pid] = proc

    # -- batch scheduling -------------------------------------------------
    def push_run(self, time: float, cbs: List[Callable[[], None]]) -> None:
        """Enqueue a contiguous same-timestamp run of callbacks as ONE heap
        entry (batch fan-out; see ``NetworkModel.send_fanout``).  The run
        shares a single sequence number and executes back-to-back in list
        order, which is exactly the ``(time, seq)`` order n individual
        pushes made in the same loop would produce: the pushes would hold
        consecutive seqs with nothing in between, so no other event can
        sort into the middle of the run."""
        if time < self.now:
            time = self.now
        self._seq += 1
        heapq.heappush(self._heap, (time, self._seq, cbs))

    # -- main loop -------------------------------------------------------
    def _drain(self, until: Optional[float], pred: Optional[Callable[[], bool]],
               max_events: int) -> None:
        """The one pop loop behind :meth:`run` and :meth:`run_until`.

        Executes events in ``(time, seq)`` order until the heap drains,
        the next event lies past ``until``, or ``pred()`` turns true
        (sampled between events, exactly like the per-event loops this
        replaced).  A heap entry whose callback slot holds a *list* is a
        coalesced run from :meth:`push_run` — its callbacks execute
        back-to-back under one heap pop, and each counts as one event."""
        heap = self._heap
        pop = heapq.heappop
        n = 0
        try:
            while heap:
                if pred is not None and pred():
                    return
                if until is not None and heap[0][0] > until:
                    return
                time, _seq, cb = pop(heap)
                self.now = time
                if cb.__class__ is list:
                    for c in cb:
                        c()
                    n += len(cb)
                else:
                    cb()
                    n += 1
                if n >= max_events:
                    raise RuntimeError(
                        f"simulation exceeded {max_events} events at t={self.now}")
        finally:
            self.events_processed += n

    def run(self, until: Optional[float] = None, max_events: int = 50_000_000) -> None:
        self._drain(until, None, max_events)
        if until is not None:
            self.now = until

    def run_until(self, pred: Callable[[], bool], timeout: float = 10_000_000.0,
                  max_events: int = 50_000_000) -> bool:
        """Run until ``pred()`` is true.  Returns False on timeout."""
        self._drain(self.now + timeout, pred, max_events)
        return pred()


class Process:
    """A busy-server process on the simulator.

    Subclasses implement ``on_message(src, msg)``.  Handlers execute with a
    CPU cost (``handling_cost``); while a handler runs, later events queue.
    Crashed processes silently drop everything.  Byzantine subclasses may
    override anything — the simulator does not trust process code, only the
    crypto registry (see repro.core.crypto) prevents forgery.
    """

    #: default CPU cost of handling one message, µs (calibrated; see DESIGN §4)
    handling_cost: float = 0.15

    def __init__(self, sim: Simulator, pid: str):
        self.sim = sim
        self.pid = pid
        self.busy_until: float = 0.0
        self.crashed = False
        sim.add_process(self)

    # -- lifecycle -------------------------------------------------------
    def crash(self) -> None:
        self.crashed = True

    def recover(self) -> None:
        self.crashed = False

    # -- CPU accounting --------------------------------------------------
    def occupy(self, cost: float) -> float:
        """Claim ``cost`` µs of this process's CPU starting no earlier than
        now; returns the completion time."""
        start = self.sim.now
        if self.busy_until > start:
            start = self.busy_until
        self.busy_until = start + cost
        return self.busy_until

    def execute(self, fn: Callable[[], None], cost: Optional[float] = None,
                note: str = "") -> None:
        """Run ``fn`` on this process's CPU, honoring the busy-server model."""
        if self.crashed:
            return
        done = self.occupy(self.handling_cost if cost is None else cost)

        def _run() -> None:
            if not self.crashed:
                fn()

        self.sim.at(done, _run)

    # -- messaging entry point (called by Network) ------------------------
    def deliver(self, src: str, msg: Any, size: int) -> None:
        # flattened execute() with occupy() and at() inlined: one closure,
        # one heap push, no intermediate frames — the per-message floor
        if self.crashed:
            return
        sim = self.sim
        start = sim.now
        if self.busy_until > start:
            start = self.busy_until
        done = start + self.handling_cost
        self.busy_until = done

        def _handle() -> None:
            if not self.crashed:
                self.on_message(src, msg)

        sim._seq += 1
        heapq.heappush(sim._heap, (done, sim._seq, _handle))

    def on_message(self, src: str, msg: Any) -> None:  # pragma: no cover - abstract
        raise NotImplementedError
