"""Mu [Aguilera et al., OSDI'20] baseline — crash-only SMR, the fastest
SMR system the paper compares against (§7.1/§7.2).

Model (faithful to Mu's failure-free critical path): the client sends its
request to the leader; the leader RDMA-writes the log entry into a majority
of followers' memory.  Followers' CPUs are *not* on the critical path — the
write completes when the NIC acknowledges it (one network RTT), after which
the leader executes and replies.  Followers lazily apply entries in the
background (modeled, but off the critical path).
"""

from __future__ import annotations

from typing import Callable, List, Optional

from repro_torch.core import crypto
from repro_torch.core.consensus import App
from repro_torch.core.node import Node
from repro_torch.sim.events import Simulator
from repro_torch.sim.net import NetParams, NetworkModel

#: Mu's replication writes complete at NIC level — no receiver dispatch, no
#: host copies: cheaper base and per-byte than the RPC path (calibrated to
#: the paper's +64% small / +26% 8 KiB overhead over unreplicated).
MU_WRITE_BASE_US = 0.6
MU_WRITE_PER_BYTE_US = 0.00035


class MuLeader(Node):
    def __init__(self, sim, net, registry, pid: str, followers: List[str],
                 app: App):
        super().__init__(sim, net, registry, pid)
        self.followers = followers
        self.majority = (len(followers) + 1) // 2 + 1  # incl. self
        self.app = app
        self._pending = {}
        self.handle("REQ", self._on_req)

    def _on_req(self, src: str, body) -> None:
        rid, payload = body
        size = crypto.wire_size_cached(body) + 32
        st = {"acks": 1, "done": False}  # self counts
        self._pending[rid] = st

        def nic_ack(rid=rid, src=src, payload=payload) -> None:
            st = self._pending.get(rid)
            if st is None or st["done"]:
                return
            st["acks"] += 1
            if st["acks"] >= self.majority:
                st["done"] = True
                del self._pending[rid]
                result = self.app.apply(payload)
                self.send(src, "REP", (rid, result))

        for fo in self.followers:
            # RDMA write + NIC-level completion: one RTT, no follower CPU,
            # no host copies (see MU_WRITE_* calibration above)
            # draw through the network model's pre-drawn block so the
            # seeded stream is consumed in the same order as scalar draws
            jit = self.net.jitter()
            rtt = 2 * MU_WRITE_BASE_US * jit + size * MU_WRITE_PER_BYTE_US
            self.sim.after(rtt, nic_ack)
            # background apply at the follower (off critical path)
            self.net.send(self.pid, fo, ("MU_APPLY", (rid, payload)), size)


class MuFollower(Node):
    def __init__(self, sim, net, registry, pid: str, app: App):
        super().__init__(sim, net, registry, pid)
        self.app = app
        self.handle("MU_APPLY", self._on_apply)

    def _on_apply(self, src: str, body) -> None:
        _rid, payload = body
        self.app.apply(payload)


def build_mu(app_factory: Callable[[], App], n_followers: int = 2,
             params: Optional[NetParams] = None, seed: int = 0):
    from repro_torch.baselines.unreplicated import UnreplicatedClient
    sim = Simulator(seed=seed)
    net = NetworkModel(sim, params)
    registry = crypto.KeyRegistry()
    followers = [f"f{i}" for i in range(n_followers)]
    for f in followers:
        MuFollower(sim, net, registry, f, app_factory())
    MuLeader(sim, net, registry, "l0", followers, app_factory())
    client = UnreplicatedClient(sim, net, registry, "c0", "l0")
    return sim, client
