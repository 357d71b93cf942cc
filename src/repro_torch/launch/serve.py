"""Serving launcher: a uBFT-replicated token server on the port's model.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch gemma3-1b|qwen3-moe-235b-a22b|... \\
      [--smoke] [--device cpu] [--requests 10] [--batch 4]

``--arch`` takes any of the ten archs of ``repro_torch.configs``; a
frontend arch is served from token ids, as its decode is.

Three replicas hold the same model (one weight copy, attested by its
fingerprint); client requests are ordered through uBFT consensus; the
client accepts f+1 matching token streams, so a Byzantine replica cannot
forge a generation.  Runs on the GPU unless ``--device cpu`` is given.
Every replica calls the same ``decode_fn``, so decoding runs with
deterministic algorithms: the replicas must produce identical tokens.
"""

from __future__ import annotations

import argparse
import gc
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig, Transformer, init_params
from repro_torch.models.transformer import decode_step, init_caches, prefill
from repro_torch.runtime import spans
from repro_torch.runtime.attest import fingerprint_tree
from repro_torch.runtime.server import ReplicatedServer


def resolve_device(device: Optional[str]) -> torch.device:
    """The GPU unless the caller names another device; never a silent CPU."""
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass --device cpu to run "
                           "on the CPU")
    return dev


def set_deterministic() -> None:
    # cuBLAS is deterministic only with a fixed workspace configuration
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)


class GreedyDecoder:
    """The token server's ``decode_fn``: greedy prefill of the session's
    history, then ``n`` greedy tokens.  ``timings`` collects, per call, the
    prompt length, the seconds to the first token (prefill) and the seconds
    of the remaining decode steps.

    On CUDA (the model's parameters there) the decode steps are replays of
    the step captured once, at the first call, as a chain of graphs
    (:class:`StepGraphs`): the prefill runs eagerly and its caches are
    copied into the graphs' static ones.  Elsewhere every step runs
    eagerly.  ``captures`` counts the captures, ``replayed_steps`` the
    decode steps served by replay.

    With spans on (``runtime.spans``) a call is a ``serve.call`` span, its
    request id ``(session, len(hist))`` shared by every replica's call of
    one request, holding ``serve.prefill`` (the prefill up to the first
    token's read) and, a decode step each, ``decode.launch`` (the step and
    its argmax enqueued) and ``decode.sync`` (the token's read, where the
    host waits for the device).  ``timings`` and the spans share their
    clock reads."""

    def __init__(self, model: Transformer, max_seq: int):
        self.model = model
        self.max_seq = max_seq
        self.timings: List[Tuple[int, float, float]] = []
        self.graphs: Optional[StepGraphs] = None
        self.captures = 0
        self.replayed_steps = 0

    def __call__(self, session: str, hist: List[int], n: int) -> List[int]:
        if self.graphs is None and graphs_engage(self.model):
            self.graphs = StepGraphs(self.model, self.max_seq)
            self.captures += 1
        graphs = self.graphs
        t0 = time.perf_counter_ns()
        call = spans.begin("serve.call", (session, len(hist)), t0)
        first = spans.begin("serve.prefill", None, t0)
        toks = torch.tensor([hist], dtype=torch.int64,
                            device=self.model.embed.device)
        logits, caches = prefill(self.model, toks, max_seq=self.max_seq)
        tok = torch.argmax(logits, -1)
        if graphs is not None:
            graphs.load(caches, tok, len(hist))
        out = [int(tok[0])]
        t1 = time.perf_counter_ns()
        spans.end(first, t1)
        pos = len(hist)
        for i in range(n - 1):
            with spans.span("decode.launch"):
                if graphs is None:
                    logits, caches = decode_step(self.model, caches, tok,
                                                 pos + i)
                    tok = torch.argmax(logits, -1)
                else:
                    graphs.replay()
                    tok = graphs.tok
                    self.replayed_steps += 1
            with spans.span("decode.sync"):
                out.append(int(tok[0]))
        t2 = time.perf_counter_ns()
        spans.end(call, t2)
        self.timings.append((len(hist), (t1 - t0) / 1e9, (t2 - t1) / 1e9))
        return out[:n]


#: what a decoder captures its step into; a stand-in with the same
#: ``capture_begin`` / ``capture_end`` / ``replay`` / ``pool`` runs the
#: same segmenting where there is no card
CUDAGraph = torch.cuda.CUDAGraph


def graphs_engage(model: Transformer) -> bool:
    """Whether a decoder replays its steps as graphs: on CUDA, always."""
    return model.embed.is_cuda


class StepGraphs:
    """A batch-1 greedy decode step of ``model`` as a chain of graphs over
    static state: the token (1,), the position (a 0-d tensor) and caches
    of ``max_seq``.  The capture (at construction, after one eager step on
    the capture stream that sets up the libraries' workspaces) runs
    ``decode_step`` once under ``transformer.routed_ffn_cut``: each
    routed-FFN call closes the open graph and is recorded with its
    parameters, its input (a tensor the closed graph wrote) and an output
    buffer that the next graph reads; the last graph ends with the argmax
    written into the token and the position advanced by one.  A dense
    model is one graph.  :meth:`replay` replays graph i, then calls
    ``moe_ffn`` as ``repro_torch.models.transformer`` names it at that
    moment (so a wrapper put there is seen) and copies its result into
    the buffer, and so on to the last graph.  The graphs share one memory
    pool and are replayed in the order they were captured."""

    def __init__(self, model: Transformer, max_seq: int):
        dev = model.embed.device
        self.model = model
        self.caches = init_caches(model.cfg, 1, max_seq, dev)
        self.tok = torch.zeros(1, dtype=torch.int64, device=dev)
        self.pos = torch.zeros((), dtype=torch.int64, device=dev)
        self.graphs: List = []
        self.cuts: List[Tuple] = []
        # captured on a side stream, as CUDA requires, after a warm-up
        # step there; the state it leaves is overwritten by ``load``
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        if side is not None:
            side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._step()
            if side is not None:
                torch.cuda.synchronize(dev)
            # a collection inside the capture could free CUDA objects
            # (events, streams), which a capture refuses
            gc.collect()
            self._open()
            try:
                with transformer.routed_ffn_cut(self._cut):
                    self._step()
            finally:
                self.graphs[-1].capture_end()
        if side is not None:
            torch.cuda.current_stream(dev).wait_stream(side)

    def _step(self) -> None:
        logits, _ = decode_step(self.model, self.caches, self.tok, self.pos)
        self.tok.copy_(torch.argmax(logits, -1))
        self.pos.add_(1)

    def _open(self) -> None:
        g = CUDAGraph()
        g.capture_begin(pool=self.graphs[0].pool() if self.graphs else None)
        self.graphs.append(g)

    def _cut(self, cfg: ModelConfig, p, h: torch.Tensor) -> torch.Tensor:
        self.graphs[-1].capture_end()
        out = torch.empty_like(h)
        self.cuts.append((cfg, p, h, out))
        self._open()
        return out

    def load(self, caches, tok: torch.Tensor, position: int) -> None:
        """A prefill's caches and first token, and the position of the
        first decode step, into the static state."""
        for group, new_group in zip(self.caches, caches):
            for state, new in zip(group, new_group):
                for k, t in state.items():
                    t.copy_(new[k])
        self.tok.copy_(tok)
        self.pos.fill_(position)

    def replay(self) -> None:
        """One decode step: ``tok`` holds its token afterwards."""
        for g, (cfg, p, h, out) in zip(self.graphs, self.cuts):
            g.replay()
            out.copy_(transformer.moe_ffn(cfg, p, h))
        self.graphs[-1].replay()


def build_decoder(cfg: ModelConfig, device: torch.device, max_seq: int,
                  seed: int = 0) -> Tuple[GreedyDecoder, int]:
    """Random weights from ``torch.Generator(seed)`` on ``device`` behind
    a :class:`GreedyDecoder`, and their fingerprint: the one weight copy
    that every replica of a token server shares."""
    gen = torch.Generator(device=device).manual_seed(seed)
    model = init_params(cfg, gen, device=device)
    digest = fingerprint_tree(model.param_leaves())
    return GreedyDecoder(model, max_seq), digest


def build_server(cfg: ModelConfig, device: torch.device, max_seq: int,
                 seed: int = 0) -> Tuple[ReplicatedServer, GreedyDecoder, int]:
    """:func:`build_decoder`'s model and fingerprint, and a 3-replica
    token server (f = 1, f_m = 1) whose replicas share the decoder."""
    decoder, digest = build_decoder(cfg, device, max_seq, seed)
    return ReplicatedServer.build(decoder), decoder, digest


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4, help="client sessions")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    set_deterministic()
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    max_seq = args.prompt_len + args.gen * args.requests + 8
    server, _, digest = build_server(cfg, device, max_seq)
    print(f"{cfg.name} on {device}: weights fingerprint {digest:#010x}")

    clients = [server.cluster.new_client() for _ in range(args.batch)]
    rng = np.random.default_rng(0)
    lats, streams = [], []
    t0 = time.time()
    for r in range(args.requests):
        cl = clients[r % len(clients)]
        prompt = rng.integers(0, cfg.vocab, size=args.prompt_len).tolist()
        toks, lat = server.generate(cl, f"s{r % len(clients)}",
                                    prompt if r < len(clients) else [],
                                    args.gen)
        lats.append(lat)
        streams.append(toks)
        print(f"[req {r}] session=s{r % len(clients)} tokens={toks} "
              f"smr_latency={lat:.1f}us")
    srt = sorted(lats)
    print(f"\n{args.requests} requests, {args.batch} sessions | "
          f"SMR-ordering latency p50={srt[len(srt)//2]:.1f}us "
          f"p90={srt[int(len(srt)*0.9)]:.1f}us | wall={time.time()-t0:.1f}s")
    # all replicas hold identical session state (BFT guarantee)
    snaps = [r.app.snapshot() for r in server.cluster.replicas]
    if not snaps[0] == snaps[1] == snaps[2]:
        raise RuntimeError("replica session states diverged")
    print("replica state identical across 2f+1 replicas: OK")
    return {"tokens": streams, "latencies_us": lats,
            "weights_fingerprint": digest}


if __name__ == "__main__":
    main()
