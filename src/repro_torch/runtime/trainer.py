"""uBFT-replicated training coordinator (the paper's technique as a
first-class framework feature — DESIGN.md §2).

Deployment model: each *training replica* is a full copy of the training job
(its own data-plane mesh slice or an independent run of the same job, per
the fault model being defended against).  The replicas' control decisions —
which step to run next, over which data range, when to cut a checkpoint,
membership changes — flow through uBFT SMR, so up to f Byzantine replicas
(silent data corruption, fail-slow nodes, bad actors — the paper's §1
failure taxonomy) cannot equivocate or diverge the run.

Per step, the coordinator state machine orders:
    STEP(step_id, data_epoch)          — all replicas run this step
    ATTEST(step_id, grad_fp, param_fp) — fingerprint votes; divergence of a
                                         replica's fingerprint exposes it
    CHECKPOINT(step_id, param_fp)      — agreed checkpoint cut (f+1 attested
                                         before any replica trusts it)

Straggler/failure handling falls out of the protocol: a slow leader loses
the fast path (unanimity) and the system continues on the slow path; a dead
leader is rotated out by the view change.  This module also provides the
in-process simulation harness used by tests/examples (2f+1 trainers on the
discrete-event simulator, each driving a real JAX train step).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core import crypto
from repro_torch.core.consensus import App, ConsensusConfig
from repro_torch.core.smr import Cluster, build_cluster


# ---------------------------------------------------------------------------
# The replicated coordinator state machine
# ---------------------------------------------------------------------------
class CoordinatorApp(App):
    """Deterministic control-plane state machine replicated via uBFT."""

    def __init__(self) -> None:
        self.next_step = 0
        self.attestations: Dict[int, Dict[str, Tuple[int, int]]] = {}
        self.checkpoints: List[Tuple[int, int]] = []   # (step, param_fp)
        self.flagged: Dict[str, str] = {}              # replica -> reason
        self.members: List[str] = []

    def apply(self, req: bytes) -> bytes:
        msg = json.loads(req.decode()) if req else {"op": "noop"}
        op = msg.get("op")
        if op == "step":
            step = self.next_step
            self.next_step += 1
            return json.dumps({"step": step,
                               "data_epoch": msg.get("data_epoch", 0)}).encode()
        if op == "attest":
            step = msg["step"]
            who = msg["who"]
            fp = (msg["grad_fp"], msg["param_fp"])
            votes = self.attestations.setdefault(step, {})
            votes[who] = fp
            # expose divergent replicas: majority fingerprint wins
            if len(votes) >= 2:
                counts: Dict[Tuple[int, int], int] = {}
                for v in votes.values():
                    counts[v] = counts.get(v, 0) + 1
                majority = max(counts, key=counts.get)
                if counts[majority] >= 2:
                    for w, v in votes.items():
                        if v != majority and w not in self.flagged:
                            self.flagged[w] = f"divergent@step{step}"
            return json.dumps({"ok": True,
                               "flagged": sorted(self.flagged)}).encode()
        if op == "checkpoint":
            self.checkpoints.append((msg["step"], msg["param_fp"]))
            return json.dumps({"ok": True}).encode()
        if op == "join":
            if msg["who"] not in self.members:
                self.members.append(msg["who"])
            return json.dumps({"members": self.members}).encode()
        return b"{}"

    def snapshot(self):
        return (self.next_step, tuple(self.checkpoints),
                tuple(sorted(self.flagged.items())), tuple(self.members))

    def adopt(self, snap) -> None:
        self.next_step, cps, flagged, members = snap
        self.checkpoints = list(cps)
        self.flagged = dict(flagged)
        self.members = list(members)


# ---------------------------------------------------------------------------
# In-process replicated trainer harness
# ---------------------------------------------------------------------------
@dataclass
class ReplicatedTrainer:
    """2f+1 training replicas coordinated through a uBFT cluster.

    ``train_step_fn(replica_idx, step, data_epoch) -> (grad_fp, param_fp,
    metrics)`` is the data-plane callback — in production the pjit'd step on
    the replica's mesh; in tests a real (small) JAX step.
    """

    cluster: Cluster
    train_step_fn: Callable[[int, int, int], Tuple[int, int, Dict]]
    f: int = 1
    history: List[Dict] = field(default_factory=list)

    @classmethod
    def build(cls, train_step_fn, f: Optional[int] = None,
              cfg: Optional[ConsensusConfig] = None) -> "ReplicatedTrainer":
        # f comes from cfg alone in the substrate API; a conflicting
        # explicit f raises (mirrors build_cluster) instead of being
        # silently dropped.
        if cfg is not None:
            if f is not None and f != cfg.f:
                raise ValueError(f"conflicting fault budgets: f={f} vs "
                                 f"cfg.f={cfg.f}")
        else:
            cfg = ConsensusConfig(f=1 if f is None else f)
        cluster = build_cluster(CoordinatorApp, cfg=cfg)
        return cls(cluster=cluster, train_step_fn=train_step_fn, f=cfg.f)

    def _submit(self, client, payload: dict, timeout=60_000_000.0) -> dict:
        raw, _lat = self.cluster.run_request(
            client, json.dumps(payload).encode(), timeout=timeout)
        return json.loads(raw.decode() or "{}")

    def run_steps(self, n_steps: int,
                  byzantine_replica: Optional[int] = None) -> List[Dict]:
        """Drive n agreed steps; every live replica executes each step and
        attests its fingerprints.  ``byzantine_replica`` injects a corrupted
        replica (flips its gradients) to demonstrate detection."""
        client = self.cluster.new_client()
        out = []
        for _ in range(n_steps):
            order = self._submit(client, {"op": "step"})
            step = order["step"]
            fps = {}
            for idx in range(len(self.cluster.replicas)):
                if self.cluster.replicas[idx].crashed:
                    continue
                gfp, pfp, metrics = self.train_step_fn(idx, step,
                                                       order["data_epoch"])
                if byzantine_replica == idx:
                    gfp ^= 0xDEADBEEF      # silent corruption
                    pfp ^= 0xDEADBEEF
                fps[idx] = (gfp, pfp)
                resp = self._submit(client, {
                    "op": "attest", "step": step,
                    "who": f"t{idx}", "grad_fp": gfp, "param_fp": pfp})
            rec = {"step": step, "fps": fps,
                   "flagged": resp.get("flagged", [])}
            self.history.append(rec)
            out.append(rec)
        return out

    def agree_checkpoint(self, step: int, param_fp: int) -> dict:
        client = self.cluster.new_client()
        return self._submit(client, {"op": "checkpoint", "step": step,
                                     "param_fp": param_fp})

    @property
    def coordinator_state(self) -> CoordinatorApp:
        return self.cluster.replicas[0].app
