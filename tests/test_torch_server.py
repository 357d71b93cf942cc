"""The port's uBFT-replicated token server: the replicated-serving tests of
``tests/test_system.py`` on the port, parity of token streams and SMR
latencies with the JAX token server, and the port's serving entry point on
the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.common import init_params as jax_init_params
from repro.models.transformer import decode_step as jax_decode_step
from repro.models.transformer import prefill as jax_prefill
from repro.runtime.server import ReplicatedServer as JaxReplicatedServer

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.consensus import ConsensusConfig
from repro_torch.launch import serve
from repro_torch.models.common import init_params
from repro_torch.runtime.server import ReplicatedServer

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "gemma3-1b"


def test_replicated_server_identical_generations():
    cfg = get_smoke_config(ARCH)
    model = init_params(cfg, torch.Generator().manual_seed(0))
    server = ReplicatedServer.build(serve.GreedyDecoder(model, max_seq=64))
    client = server.cluster.new_client()
    toks, lat = server.generate(client, "s0", [1, 2, 3, 4], 4)
    assert len(toks) == 4
    snaps = [r.app.snapshot() for r in server.cluster.replicas]
    assert snaps[0] == snaps[1] == snaps[2]
    toks2, _ = server.generate(client, "s0", [], 2)
    assert len(toks2) == 2


def test_replicated_server_batched_multi_request_submission():
    def decode_fn(session, hist, n):
        # deterministic toy decoder: next token = len(hist) + i
        return [len(hist) + i for i in range(n)]

    cfg = ConsensusConfig(max_request_bytes=4096, max_batch=8,
                          pipeline_depth=4, batch_timeout_us=20.0)
    server = ReplicatedServer.build(decode_fn, cfg=cfg)
    client = server.cluster.new_client()
    reqs = [(f"s{i % 4}", [i], 2) for i in range(12)]
    outs = server.generate_many(client, reqs)
    assert len(outs) == 12
    assert all(len(toks) == 2 for toks, _lat in outs)
    snaps = [r.app.snapshot() for r in server.cluster.replicas]
    assert snaps[0] == snaps[1] == snaps[2]
    decided = server.cluster.replicas[0].decided
    assert sum(len(b) for b in decided.values()) == 12
    assert len(decided) < 12


def _jax_decode_fn(cfg, params, max_seq):
    pf = jax.jit(lambda p, i: jax_prefill(cfg, p, i, max_seq=max_seq))
    ds = jax.jit(lambda p, c, t, pos: jax_decode_step(cfg, p, c, t, pos))

    def decode_fn(session, hist, n):
        toks = jnp.asarray([hist], jnp.int32)
        logits, caches = pf(params, toks)
        out = []
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for i in range(n):
            out.append(int(tok[0]))
            logits, caches = ds(params, caches, tok, jnp.int32(len(hist) + i))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
        return out

    return decode_fn


def _serve_turns(server, turns):
    clients = {s: server.cluster.new_client() for s, _, _ in turns}
    return [server.generate(clients[s], s, prompt, n) for s, prompt, n in turns]


def test_token_streams_and_smr_latencies_match_jax_server():
    """fp32, two sessions, three turns each; the histories (14, 24, 34
    tokens) cross the window of 16, so later prefills roll the ring."""
    max_seq = 48
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(5)
    turns = [(f"s{i % 2}", rng.integers(0, tcfg.vocab, size=10 if i < 2 else 6
                                        ).tolist(), 4) for i in range(6)]
    want = _serve_turns(JaxReplicatedServer.build(
        _jax_decode_fn(jcfg, jparams, max_seq)), turns)
    got = _serve_turns(ReplicatedServer.build(
        serve.GreedyDecoder(model, max_seq)), turns)
    assert [len(t) for t, _ in got] == [4] * 6
    assert got == want


def test_serve_main_runs_on_cpu():
    was = torch.are_deterministic_algorithms_enabled()
    try:
        out = serve.main(["--smoke", "--device", "cpu", "--requests", "4",
                          "--batch", "2", "--gen", "3"])
    finally:
        torch.use_deterministic_algorithms(was)
    assert [len(t) for t in out["tokens"]] == [3] * 4
    assert len(out["latencies_us"]) == 4
    assert 0 <= out["weights_fingerprint"] < 2 ** 32
