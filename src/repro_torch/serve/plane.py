"""The replicated inference plane: SLOs, admission sizing, and the
"millions of users" scenario glue.

Composes the pieces into one runnable deployment:

* :class:`repro.runtime.server.TokenServerApp` — session/KV metadata as
  the replicated state machine;
* :class:`repro.serve.costmodel.ServingCostModel` — roofline decode
  cost charged per request through ``App.cost_us`` (the consensus
  layer's deferred execution engine);
* :class:`repro.core.consensus.AdmissionConfig` — leader-side shedding
  with agreed deterministic BUSY replies, sized here from the SLO: the
  queue-depth horizon is ``deadline / per-request cost``, the depth at
  which a newly admitted request could still meet its deadline.

``InferencePlane.build`` wires them; ``run_trace`` replays a workload
trace (``repro.workloads``) open-loop and ``slo_report`` reduces the
outcomes to SLO attainment / shed fraction / latency percentiles plus
the cluster's admission telemetry.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.consensus import AdmissionConfig, ConsensusConfig
from repro_torch.runtime.server import ReplicatedServer, TokenServerApp
from repro_torch.serve.costmodel import ServingCostModel


@dataclass(frozen=True)
class SLOSpec:
    """Per-app service-level objective."""
    deadline_us: float            # end-to-end latency target
    target_attainment: float = 0.99


def admission_for(cost_model: ServingCostModel, slo: SLOSpec,
                  typical_prompt: int = 16, typical_decode: int = 8,
                  headroom: float = 1.0,
                  max_shed: int = 8) -> AdmissionConfig:
    """Size admission control from the SLO and the roofline cost: shed
    once the backlog is deep enough that a newly admitted request would
    blow ``deadline_us`` just waiting for the decode engine."""
    per_req = cost_model.request_us(typical_prompt, typical_decode,
                                    ctx=typical_prompt)
    q_high = max(2, int(headroom * slo.deadline_us / max(per_req, 1e-9)))
    return AdmissionConfig(queue_high=q_high,
                           queue_accept=max(1, q_high // 2),
                           max_shed=max_shed)


def greedy_decode_fn(vocab: int = 50_257
                     ) -> Callable[[str, List[int], int], List[int]]:
    """A deterministic stand-in decoder (greedy argmax of a fixed hash):
    replicas produce identical tokens, which is all consensus needs."""
    def decode(sid: str, hist: List[int], n: int) -> List[int]:
        h = len(hist) * 2654435761
        return [(h + 40_503 * k) % vocab for k in range(1, n + 1)]
    return decode


@dataclass
class InferencePlane:
    """One uBFT-replicated token server with SLO-aware admission."""
    server: ReplicatedServer
    cost_model: ServingCostModel
    slo: SLOSpec
    admission: Optional[AdmissionConfig]
    #: per-request outcomes from run_trace: (t_issue_us, latency_us, ok)
    #: where ok=False marks an admission-shed (BUSY) reply
    outcomes: List[Tuple[float, float, bool]] = field(default_factory=list)

    @property
    def cluster(self):
        return self.server.cluster

    @classmethod
    def build(cls, cost_model: ServingCostModel, slo: SLOSpec,
              decode_fn: Optional[Callable] = None, f: int = 1,
              admission: Any = True,
              cfg: Optional[ConsensusConfig] = None,
              substrate=None, name: str = "",
              typical_prompt: int = 16, typical_decode: int = 8,
              ) -> "InferencePlane":
        """``admission=True`` sizes an AdmissionConfig from the SLO and
        cost model; pass an AdmissionConfig to pin it, or False/None for
        a no-admission plane (the collapse baseline)."""
        if admission is True:
            adm = admission_for(cost_model, slo, typical_prompt,
                                typical_decode)
        elif isinstance(admission, AdmissionConfig):
            adm = admission
        else:
            adm = None
        if cfg is None:
            cfg = ConsensusConfig(f=f, max_request_bytes=4096)
        cfg.admission = adm
        server = ReplicatedServer.build(
            decode_fn or greedy_decode_fn(), cfg=cfg, substrate=substrate,
            name=name, cost_model=cost_model)
        return cls(server=server, cost_model=cost_model, slo=slo,
                   admission=adm)

    # ------------------------------------------------------------ driving
    def run_trace(self, trace: List[Tuple[float, bytes]],
                  n_clients: int = 4, drain_us: float = 2_000_000.0,
                  ) -> List[Tuple[float, float, bool]]:
        """Replay a ``(t_us, payload)`` trace open-loop (arrivals fire
        regardless of completions), then drain.  Appends to and returns
        ``outcomes``."""
        cluster = self.cluster
        sim = cluster.sim
        clients = [cluster.new_client() for _ in range(n_clients)]
        t0 = sim.now
        pending = {"n": 0}

        def fire(cl, t: float, payload: bytes) -> None:
            pending["n"] += 1

            def done(res: bytes, lat: float) -> None:
                pending["n"] -= 1
                self.outcomes.append((t, lat, res != b"BUSY"))

            cl.request(payload, done)

        n = 0
        for j, (t, payload) in enumerate(trace):
            cl = clients[j % n_clients]
            sim.at(t0 + t, (lambda cl=cl, t=t, p=payload: fire(cl, t, p)),
                   note="serve.arrival")
            n += 1
        t_end = t0 + (max(t for t, _ in trace) if trace else 0.0)
        sim.run(until=t_end)
        sim.run_until(lambda: pending["n"] == 0 and
                      len(self.outcomes) >= n, timeout=drain_us)
        return self.outcomes

    # ---------------------------------------------------------- reporting
    def slo_report(self) -> Dict[str, Any]:
        """SLO attainment over *all* arrivals: a request counts as
        attained only if it was served (not shed) within the deadline.
        Sheds are the price of keeping the served tail flat — they are
        reported separately, not hidden."""
        outs = self.outcomes
        served = sorted(lat for _, lat, ok in outs if ok)
        shed = sum(1 for _, _, ok in outs if not ok)
        n = len(outs)
        within = sum(1 for _, lat, ok in outs
                     if ok and lat <= self.slo.deadline_us)

        def pct(p: float) -> float:
            if not served:
                return float("nan")
            return served[min(len(served) - 1, int(p * len(served)))]

        report = {
            "issued": n,
            "served": len(served),
            "shed": shed,
            "shed_frac": shed / n if n else 0.0,
            "attainment": within / n if n else 0.0,
            "served_p50_us": pct(0.50),
            "served_p99_us": pct(0.99),
            "deadline_us": self.slo.deadline_us,
        }
        stats = self.cluster.stats()
        if "admission" in stats:
            report["admission"] = stats["admission"]
        return report
