"""Unreplicated RPC baseline (Fig 8 "Unrepl.").

Client sends the request to one server over the same point-to-point
primitive; the server executes and replies.  This is the latency floor that
calibrates the network model (2.2 µs at 32 B → 20 µs at 8 KiB).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

from repro_torch.core import crypto
from repro_torch.core.consensus import App
from repro_torch.core.node import Node
from repro_torch.sim.events import Simulator
from repro_torch.sim.net import NetParams, NetworkModel


class UnreplicatedServer(Node):
    """Single server, same network primitive.  Apps with a non-zero
    ``App.cost_us`` get the same serial service model as the replicated
    deferred execution engine — one decode engine, FIFO — so replicated
    vs unreplicated comparisons isolate the consensus overhead instead
    of handing the baseline an infinitely parallel app."""

    def __init__(self, sim, net, registry, pid: str, app: App):
        super().__init__(sim, net, registry, pid)
        self.app = app
        self._app_has_cost = type(app).cost_us is not App.cost_us
        self._busy_until = 0.0
        self.handle("REQ", self._on_req)

    def _on_req(self, src: str, body) -> None:
        rid, payload = body
        if self._app_has_cost:
            cost = self.app.cost_us(payload)
            if cost > 0.0:
                start = max(self.sim.now, self._busy_until)
                self._busy_until = start + cost

                def _finish() -> None:
                    result = self.app.apply(payload)
                    self.send(src, "REP", (rid, result))

                self.sim.at(self._busy_until, _finish,
                            note="unrepl.service")
                return
        result = self.app.apply(payload)
        self.send(src, "REP", (rid, result))


class UnreplicatedClient(Node):
    def __init__(self, sim, net, registry, pid: str, server: str):
        super().__init__(sim, net, registry, pid)
        self.server = server
        self._next = 0
        self._cbs = {}
        self.latencies: List[float] = []
        self.handle("REP", self._on_rep)

    def request(self, payload: bytes, cb=None):
        rid = (self.pid, self._next)
        self._next += 1
        self._cbs[rid] = (self.sim.now, cb)
        self.send(self.server, "REQ", (rid, payload))
        return rid

    def _on_rep(self, src, body) -> None:
        rid, result = body
        ent = self._cbs.pop(rid, None)
        if ent is None:
            return
        t0, cb = ent
        lat = self.sim.now - t0
        self.latencies.append(lat)
        if cb:
            cb(result, lat)


def build_unreplicated(app_factory: Callable[[], App],
                       params: Optional[NetParams] = None, seed: int = 0):
    sim = Simulator(seed=seed)
    net = NetworkModel(sim, params)
    registry = crypto.KeyRegistry()
    server = UnreplicatedServer(sim, net, registry, "s0", app_factory())
    client = UnreplicatedClient(sim, net, registry, "c0", "s0")
    return sim, server, client


def run_closed_loop(sim: Simulator, client, payload: bytes, n: int,
                    timeout: float = 10_000_000.0) -> List[float]:
    """Issue ``n`` requests back-to-back (closed loop); return latencies."""
    state = {"left": n}

    def fire(*_args) -> None:
        state["left"] -= 1
        if state["left"] > 0:
            client.request(payload, fire)

    client.request(payload, fire)
    sim.run_until(lambda: state["left"] <= 0, timeout=timeout)
    return list(client.latencies)
