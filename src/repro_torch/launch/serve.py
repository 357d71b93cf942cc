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
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.models.common import ModelConfig, Transformer, init_params
from repro_torch.models.transformer import decode_step, prefill
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
    of the remaining decode steps."""

    def __init__(self, model: Transformer, max_seq: int):
        self.model = model
        self.max_seq = max_seq
        self.timings: List[Tuple[int, float, float]] = []

    def __call__(self, session: str, hist: List[int], n: int) -> List[int]:
        t0 = time.perf_counter()
        toks = torch.tensor([hist], dtype=torch.int64,
                            device=self.model.embed.device)
        logits, caches = prefill(self.model, toks, max_seq=self.max_seq)
        tok = torch.argmax(logits, -1)
        out = [int(tok[0])]
        t1 = time.perf_counter()
        pos = len(hist)
        for i in range(n - 1):
            logits, caches = decode_step(self.model, caches, tok, pos + i)
            tok = torch.argmax(logits, -1)
            out.append(int(tok[0]))
        self.timings.append((len(hist), t1 - t0, time.perf_counter() - t1))
        return out[:n]


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
