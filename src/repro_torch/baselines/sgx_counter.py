"""SGX trusted-counter non-equivocation baseline (Fig 10, §7.4) and the
standalone CTBcast harness it is compared against.

The SGX mechanism: before sending, the sender's enclave binds the message to
a monotonic counter (HMAC_secret(msg‖counter‖pid)); each receiver verifies
the HMAC inside its own enclave.  Latency = enclave access at the sender +
broadcast + enclave access at each receiver (enclave access ≈ 8 µs,
paper: 7–12.5 µs).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.core import crypto
from repro_torch.core.ctbcast import CTBcast
from repro_torch.core.node import Node
from repro_torch.core.registers import MemoryNode, RegisterClient
from repro_torch.core.tbcast import TBcastService
from repro_torch.sim.events import Simulator
from repro_torch.sim.net import NetParams, NetworkModel


# ---------------------------------------------------------------------------
# SGX trusted-counter broadcast
# ---------------------------------------------------------------------------
class SgxSender(Node):
    def __init__(self, sim, net, registry, pid: str, receivers: List[str]):
        super().__init__(sim, net, registry, pid)
        self.receivers = receivers
        self.counter = 0

    def broadcast(self, payload: bytes) -> None:
        self.counter += 1
        ctr = self.counter
        # enclave access: createUI(msg, counter)
        done = self.occupy(self.netp.enclave_access_us +
                           self.netp.hmac_us * (1 + len(payload) / 64))

        def fire() -> None:
            for r in self.receivers:
                self.send(r, "SGX_MSG", (ctr, payload, "UI"))

        self.sim.at(done, fire)


class SgxReceiver(Node):
    def __init__(self, sim, net, registry, pid: str,
                 on_deliver: Callable[[str, int, bytes], None]):
        super().__init__(sim, net, registry, pid)
        self.on_deliver = on_deliver
        self.handle("SGX_MSG", self._on_msg)

    def _on_msg(self, src: str, body) -> None:
        ctr, payload, ui = body
        # enclave access: verifyUI
        done = self.occupy(self.netp.enclave_access_us +
                           self.netp.hmac_us * (1 + len(payload) / 64))
        self.sim.at(done, lambda: self.on_deliver(src, ctr, payload))


def build_sgx_broadcast(n_receivers: int = 2,
                        params: Optional[NetParams] = None, seed: int = 0):
    sim = Simulator(seed=seed)
    net = NetworkModel(sim, params)
    registry = crypto.KeyRegistry()
    delivered: Dict[int, List[float]] = {}

    def on_deliver(receiver_pid):
        def cb(src, ctr, payload):
            delivered.setdefault(ctr, []).append(sim.now)
        return cb

    receivers = []
    for i in range(n_receivers):
        pid = f"q{i}"
        r = SgxReceiver(sim, net, registry, pid, None)
        r.on_deliver = on_deliver(pid)
        receivers.append(pid)
    sender = SgxSender(sim, net, registry, "p0", receivers)
    return sim, sender, delivered


# ---------------------------------------------------------------------------
# Standalone CTBcast deployment (one broadcaster, n receivers, memory nodes)
# ---------------------------------------------------------------------------
class CtbNode(Node):
    """A process participating in a single CTBcast instance."""

    def __init__(self, sim, net, registry, pid: str, group: List[str],
                 mem_nodes: List[str], t: int, broadcaster: str,
                 deliveries: Dict, fast: bool = True, f_m: int = 1,
                 auto_slow_after_us: Optional[float] = None):
        super().__init__(sim, net, registry, pid)
        self.tb = TBcastService(self, t=t, max_msg_bytes=16384)
        self.regs = RegisterClient(self, mem_nodes, f_m)
        self.deliveries = deliveries

        def deliver(k, m):
            self.deliveries.setdefault(k, {})[pid] = sim.now

        self.ctb = CTBcast(self, self.tb, self.regs, broadcaster, group, t,
                           deliver, fast_enabled=fast,
                           auto_slow_after_us=auto_slow_after_us,
                           on_summary_needed=self._summary
                           if pid == broadcaster else None)
        self._pending_summaries: List[int] = []

    def _summary(self, seg: int) -> None:
        # standalone summary provider: self-certification after one network
        # round + f+1 signatures (matches the consensus-level machinery's
        # cost without pulling in consensus state)
        cost = self.netp.sign_us + 2 * self.netp.base_us
        self.timer(cost, lambda: self.ctb.summary_certified(seg))


def build_ctbcast(n: int = 3, t: int = 128, fast: bool = True, f_m: int = 1,
                  params: Optional[NetParams] = None, seed: int = 0,
                  auto_slow_after_us: Optional[float] = None):
    """One CTBcast instance: p0 broadcasts, everyone delivers."""
    sim = Simulator(seed=seed)
    net = NetworkModel(sim, params)
    registry = crypto.KeyRegistry()
    group = [f"p{i}" for i in range(n)]
    mems = [f"m{i}" for i in range(2 * f_m + 1)]
    for m in mems:
        MemoryNode(sim, net, registry, m)
    deliveries: Dict[int, Dict[str, float]] = {}
    nodes = [CtbNode(sim, net, registry, pid, group, mems, t, "p0",
                     deliveries, fast=fast, f_m=f_m,
                     auto_slow_after_us=auto_slow_after_us)
             for pid in group]
    return sim, nodes, deliveries
