"""uBFT-replicated inference serving (the Memcached/Redis analog: a token
server whose request order is agreed through consensus).

Every replica holds the same model + decoding state; client generation
requests are totally ordered by uBFT, so all replicas produce identical
tokens and the client accepts f+1 matching responses — a Byzantine replica
cannot forge a generation.  This is exactly the paper's SMR deployment with
the application = an autoregressive decoder.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.consensus import App, ConsensusConfig
from repro_torch.core.smr import Cluster, build_cluster


class TokenServerApp(App):
    """Replicated state machine wrapping a deterministic decode function.

    ``decode_fn(session, prompt_tokens, n_tokens) -> tokens`` must be
    deterministic (greedy argmax) so replicas stay identical.

    The per-session token history IS the KV-cache metadata riding the
    consensus slots: every replica holds the same context per session,
    so a joiner adopting the snapshot continues decoding mid-session
    bit-for-bit.  With a ``cost_model``
    (:class:`repro.serve.costmodel.ServingCostModel`) the app reports
    each request's roofline service time — prefill over the new prompt
    plus per-token decode at the session's current context — through
    ``App.cost_us``, turning on the consensus layer's deferred execution
    engine (decided slots occupy the replica's serial decode engine for
    that long before applying).
    """

    def __init__(self, decode_fn: Callable[[str, List[int], int], List[int]],
                 cost_model: Any = None):
        self.decode_fn = decode_fn
        self.cost_model = cost_model
        self.sessions: Dict[str, List[int]] = {}

    def apply(self, req: bytes) -> bytes:
        msg = json.loads(req.decode())
        sid = msg["session"]
        hist = self.sessions.setdefault(sid, [])
        prompt = msg.get("prompt", [])
        hist.extend(int(t) for t in prompt)
        toks = self.decode_fn(sid, list(hist), int(msg.get("n", 1)))
        hist.extend(int(t) for t in toks)
        return json.dumps({"tokens": [int(t) for t in toks]}).encode()

    def cost_us(self, req: bytes) -> float:
        if self.cost_model is None:
            return 0.0
        try:
            msg = json.loads(req.decode())
            sid = msg["session"]
            n_prompt = len(msg.get("prompt", []))
            n_decode = int(msg.get("n", 1))
        except Exception:
            return 0.0   # malformed requests fail fast in apply()
        ctx = len(self.sessions.get(sid, ()))
        return float(self.cost_model.request_us(n_prompt, n_decode, ctx))

    def snapshot(self):
        return tuple(sorted((k, tuple(v)) for k, v in self.sessions.items()))

    def adopt(self, snap) -> None:
        self.sessions = {k: list(v) for k, v in snap}


@dataclass
class ReplicatedServer:
    cluster: Cluster

    @classmethod
    def build(cls, decode_fn, f: Optional[int] = None,
              f_m: Optional[int] = None, n_pools: int = 1,
              auto_reconfigure: bool = False,
              cfg: Optional[ConsensusConfig] = None,
              substrate=None, name: str = "",
              cost_model: Any = None) -> "ReplicatedServer":
        """``n_pools`` shards the serving cluster's register keys over that
        many disaggregated-memory pools (the paper's "shared by many
        replicated applications" deployment); ``auto_reconfigure`` enables
        lease-based replacement of crashed memory nodes underneath a
        running token server.

        Pass ``substrate=`` (and a ``name``) to attach the token server to
        an *existing* shared substrate instead of building a private one —
        several replicated servers (or a server next to other replicated
        apps) then co-run over the same disaggregated-memory pools.  With
        ``cfg=`` the fault budgets come from the config alone (a
        conflicting explicit ``f``/``f_m`` raises, mirroring
        ``build_cluster``); with ``substrate=`` the pool topology comes
        from the substrate alone."""
        if cfg is not None:
            if f is not None and f != cfg.f:
                raise ValueError(f"conflicting fault budgets: f={f} vs "
                                 f"cfg.f={cfg.f}")
            if f_m is not None and f_m != cfg.f_m:
                raise ValueError(f"conflicting fault budgets: f_m={f_m} vs "
                                 f"cfg.f_m={cfg.f_m}")
        else:
            cfg = ConsensusConfig(f=1 if f is None else f,
                                  f_m=1 if f_m is None else f_m,
                                  max_request_bytes=4096)
        if substrate is not None:
            if n_pools != 1 or auto_reconfigure:
                raise ValueError(
                    "n_pools/auto_reconfigure describe a private substrate "
                    "— with substrate=, the pool topology is already fixed")
            from repro_torch.core.smr import Cluster
            cluster = Cluster.attach(substrate, lambda: TokenServerApp(
                decode_fn, cost_model=cost_model), name=name, cfg=cfg)
        else:
            cluster = build_cluster(
                lambda: TokenServerApp(decode_fn, cost_model=cost_model),
                n_pools=n_pools, auto_reconfigure=auto_reconfigure, cfg=cfg)
        return cls(cluster=cluster)

    def generate(self, client, session: str, prompt: List[int], n: int,
                 timeout: float = 60_000_000.0
                 ) -> Tuple[Optional[List[int]], float]:
        """One generation round-trip.  Returns ``(tokens, latency_us)`` —
        or ``(None, latency_us)`` when admission control shed the request
        with the agreed deterministic BUSY reply."""
        payload = json.dumps({"session": session, "prompt": prompt,
                              "n": n}).encode()
        raw, lat = self.cluster.run_request(client, payload, timeout=timeout)
        return self._parse(raw), lat

    def generate_many(self, client, requests: List[Tuple[str, List[int], int]],
                      timeout: float = 60_000_000.0
                      ) -> List[Tuple[Optional[List[int]], float]]:
        """Submit many generation requests concurrently; consensus orders
        them (coalesced into batched slots when the leader is configured
        with max_batch > 1) and every replica decodes the same sequence."""
        payloads = [json.dumps({"session": s, "prompt": p, "n": n}).encode()
                    for s, p, n in requests]
        outs = self.cluster.run_requests(client, payloads, timeout=timeout)
        return [(self._parse(raw), lat) for raw, lat in outs]

    @staticmethod
    def _parse(raw: bytes) -> Optional[List[int]]:
        if raw == b"BUSY":
            return None
        return json.loads(raw.decode())["tokens"]
