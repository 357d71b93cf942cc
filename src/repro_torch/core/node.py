"""Base class for protocol participants (replicas, clients, memory nodes).

Bundles the simulator process model with the substrate every uBFT node needs:
network handle, key material, asynchronous-crypto helpers (thread-pool cost
model), and a message dispatch table.
"""

from __future__ import annotations

from heapq import heappush as _heappush
from typing import Any, Callable, Dict, List, Optional

from repro_torch.core import crypto
from repro_torch.sim.events import Process, Simulator
from repro_torch.sim.net import NetworkModel


class Node(Process):
    def __init__(self, sim: Simulator, net: NetworkModel, registry: crypto.KeyRegistry,
                 pid: str):
        super().__init__(sim, pid)
        self.net = net
        self.netp = net.p
        self._net_send = net.send   # bound once; send() is the hot path
        self.registry = registry
        self.signer = registry.keygen(pid)
        self._dispatch: Dict[str, Callable[[str, Any], None]] = {}
        #: called (in registration order) every time this node transitions
        #: crashed -> recovered.  Timer-driven subsystems register here to
        #: re-arm state whose pending timers fired (and were swallowed, or
        #: deliberately no-op'd) while the node was down — e.g. TBcast's
        #: ack/RTO flags, which would otherwise strand retransmission
        #: forever (see core/tbcast.py).
        self.recover_hooks: List[Callable[[], None]] = []
        # Subclasses overriding on_message (interceptors, Byzantine
        # adversaries) must keep receiving messages even though the fast
        # deliver() path below inlines the dispatch-table lookup.
        self._custom_on_message = (type(self).on_message
                                   is not Node.on_message)

    # -- message plumbing --------------------------------------------------
    def send(self, dst: str, kind: str, body: Any, extra_bytes: int = 0,
             size: Optional[int] = None) -> None:
        # Cached sizing: shared payload subtrees (batches, certs) are sized
        # once per lifetime — see the wire-cache invariant in core/crypto.py.
        # Fan-out senders that ship one body to many peers precompute the
        # full wire size once and pass it via ``size``.
        if size is None:
            size = crypto.wire_size_shallow(body) + len(kind) + 16 + extra_bytes
        self._net_send(self.pid, dst, (kind, body), size)

    def send_fanout(self, dsts: List[str], kind: str, body: Any,
                    extra_bytes: int = 0, size: Optional[int] = None) -> None:
        """Ship one body to many peers: size once, encode once, price and
        schedule all deliveries in one network call (bit-identical to a
        per-dst ``send`` loop — see ``NetworkModel.send_fanout``)."""
        if size is None:
            size = crypto.wire_size_shallow(body) + len(kind) + 16 + extra_bytes
        self.net.send_fanout(self.pid, dsts, (kind, body), size)

    def handle(self, kind: str, fn: Callable[[str, Any], None]) -> None:
        self._dispatch[kind] = fn

    def deliver(self, src: str, msg: Any, size: int) -> None:
        # Hot-path override of Process.deliver: same busy-server semantics,
        # but the dispatch-table lookup happens inside the single closure —
        # no intermediate on_message frame per message.
        if self.crashed:
            return
        sim = self.sim
        start = sim.now
        if self.busy_until > start:
            start = self.busy_until
        done = start + self.handling_cost
        self.busy_until = done

        def _handle() -> None:
            if self.crashed:
                return
            if self._custom_on_message:
                self.on_message(src, msg)
                return
            kind, body = msg
            fn = self._dispatch.get(kind)
            if fn is None:
                self.on_unhandled(src, kind, body)
            else:
                fn(src, body)

        sim._seq += 1
        _heappush(sim._heap, (done, sim._seq, _handle))

    def on_message(self, src: str, msg: Any) -> None:
        kind, body = msg
        fn = self._dispatch.get(kind)
        if fn is None:
            self.on_unhandled(src, kind, body)
        else:
            fn(src, body)

    def on_unhandled(self, src: str, kind: str, body: Any) -> None:
        pass  # unknown messages are ignored (Byzantine noise tolerance)

    # -- asynchronous crypto (thread-pool model) ----------------------------
    # The paper dispatches signatures/verifications to a pool (Fig 9's Crypto
    # bucket includes dispatch+sync).  We occupy the event loop thread only
    # for the dispatch cost; the op completes after its latency in parallel.
    def async_sign(self, payload: Any, cb: Callable[[bytes], None]) -> None:
        sig = self.signer.sign(payload)
        self._async_done(self.netp.sign_us, lambda: cb(sig))

    def async_verify(self, pid: str, payload: Any, sig: bytes,
                     cb: Callable[[bool], None]) -> None:
        ok = self.registry.verify(pid, payload, sig)
        self._async_done(self.netp.verify_us, lambda: cb(ok))

    def async_verify_many(self, items, cb: Callable[[list], None]) -> None:
        """Verify [(pid, payload, sig)] in parallel on the pool.

        Cost model: dispatch + one verify latency + 3 µs per extra item
        (pool contention), not n×verify — matches the paper's slow path
        adding ~30 µs per round, not ~90 µs.
        """
        oks = self.registry.verify_batch(items)
        extra = 3.0 * max(0, len(oks) - 1)
        self._async_done(self.netp.verify_us + extra, lambda: cb(oks))

    def _async_done(self, latency: float, cb: Callable[[], None]) -> None:
        if self.crashed:
            return
        start = self.sim.now
        done = self.occupy(self.netp.crypto_dispatch_us)
        if self.sim.tracing:
            self.sim.trace.append(("crypto", start, done + latency))

        def _fire() -> None:
            if not self.crashed:
                # completion handling costs a dispatch on the event thread
                self.execute(cb, cost=self.handling_cost)

        self.sim.at(done + latency, _fire)

    def background(self, cb: Callable[[], None]) -> None:
        """Run ``cb`` at the next background-task quantum boundary (the
        paper's bookkeeping-signature path, off the critical path)."""
        q = self.netp.bg_quantum_us
        delay = q - (self.sim.now % q)
        self.timer(delay, cb)

    # -- crash / recovery ----------------------------------------------------
    def recover(self) -> None:
        was_crashed = self.crashed
        super().recover()
        if was_crashed:
            for hook in list(self.recover_hooks):
                hook()

    # -- timers --------------------------------------------------------------
    def timer(self, delay: float, cb: Callable[[], None], note: str = "") -> None:
        def _fire() -> None:
            if not self.crashed:
                cb()
        self.sim.after(delay, _fire)
