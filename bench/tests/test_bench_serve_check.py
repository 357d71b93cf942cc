"""The serving cells' checks on the CPU: the replica check waits for a
replica that applies the last request after the client's replies, and
still counts one that never converges; the share of served tokens past a
logit gap, on logits whose gaps are known."""

import numpy as np
import pytest
import torch

from bench import arch, drive_serve, harness, weights
from bench.reference import serve as ref_serve
from bench.traffic import generator

VOCAB = 151936
SEED = 2 ** 31 + 7
# a stream of stand-in tokens under which replica r0 applies request 61
# (the 64th consensus slot, after two warm-ups) about 1.4 virtual µs after
# the client holds f + 1 matching replies
LAGGING_STREAM, LAGGING_REQUEST = 1, 61


def _stand_in(stream: int):
    """A deterministic decoder without a model: the same tokens on every
    replica for the same history."""
    def decode(session, hist, n):
        rng = np.random.default_rng([stream, len(hist)] + list(hist[-4:]))
        return rng.integers(0, VOCAB, size=n).tolist()
    return decode


def _serve(stream: int, requests: int):
    """The decode mix through the cell's server over the stand-in decoder;
    the server and the histories the client was served."""
    mix = generator.load_mix("decode")
    server, clients = drive_serve.start(_stand_in(stream), mix, VOCAB)
    reqs = generator.session_requests(mix, VOCAB, SEED)
    hist = {}
    for _ in range(requests):
        r = next(reqs)
        toks, _ = server.generate(clients[r.slot], r.session, r.prompt, r.n)
        h = hist.setdefault(r.session, [])
        h.extend(r.prompt)
        h.extend(toks)
    return server, hist


def test_a_replica_behind_the_replies_is_drained_before_the_check(
        monkeypatch):
    server, hist = _serve(LAGGING_STREAM, LAGGING_REQUEST + 1)
    cluster = server.cluster
    t = cluster.sim.now
    with monkeypatch.context() as mp:
        mp.setattr(drive_serve, "DRAIN_US", 0)
        assert drive_serve.replicas_differing(cluster, hist) == 1
    assert drive_serve.replicas_differing(cluster, hist) == 0
    assert 0 < cluster.sim.now - t < drive_serve.DRAIN_US


def test_a_replica_that_alters_its_session_still_differs():
    server, hist = _serve(LAGGING_STREAM, LAGGING_REQUEST + 1)
    cluster = server.cluster
    session = max(hist, key=lambda s: int(s[1:]))
    cluster.replicas[1].app.sessions[session][-1] += 1
    t = cluster.sim.now
    assert drive_serve.replicas_differing(cluster, hist) == 1
    # the simulation ran out of events or time without the replica
    # converging
    assert cluster.sim.now - t <= drive_serve.DRAIN_US


def _model():
    torch.set_num_threads(2)
    ctx = harness.Context(harness.load_benchmark(),
                          "qwen3-moe-235b-a22b.decode", SEED, 1.0, False,
                          torch.device("cpu"), 0.0, smoke=True)
    return dict(ctx.model, dtype="float32")


def _logits(m, tokens, segments, positions):
    ref = arch.module(m)
    g = {n: weights.draw(m, SEED, n, -1, "cpu", torch.float32)
         for n in weights.global_specs(m)}
    x = ref.embed(m, g["embed"], torch.tensor(tokens))[None]
    for l in range(m["n_layers"]):
        p = {n: weights.draw(m, SEED, n, l, "cpu", torch.float32)
             for n in weights.layer_specs(m, l)}
        x = ref.layer(m, p, x, segments, index=l)
    return ref.logits(m, ref.head(m, g), g["out_norm"], x[0][positions])


@pytest.mark.parametrize("tau", [0.0, 0.3, 1.0])
def test_gap_share_counts_the_tokens_past_tau(tau):
    m = _model()
    gen = torch.Generator().manual_seed(5)
    tokens = torch.randint(0, m["vocab"], (24,), generator=gen).tolist()
    segments = [(0, 12)] + [(12 + i, 13 + i) for i in range(12)]
    positions = list(range(11, 24))
    lg = _logits(m, tokens, segments, positions)
    # the served token at each position: the one ranked 0, 1, 2, ...
    order = lg.argsort(-1, descending=True)
    picks = [int(order[i, i % 5]) for i in range(len(positions))]
    want = [float(lg[i].max() - lg[i, t]) for i, t in enumerate(picks)]
    # no gap lies near a threshold, so rounding cannot move a token across
    assert all(abs(g - tau) > 1e-3 for g in want if g)
    seqs = [{"tokens": tokens, "segments": segments,
             "checks": list(zip(positions, picks))}]
    got = ref_serve.check(m, SEED, "cpu", seqs, control=True, tau=tau)
    _, ctrl, _ = ref_serve.gaps(m, SEED, "cpu", seqs, control=True)
    assert got["control_gap_share"] == sum(g > tau for g in ctrl) / len(ctrl)
    assert got["tokens_checked"] == len(want)
    assert got["tokens_not_argmax"] == sum(g > 0 for g in want)
    assert got["max_logit_gap"] == pytest.approx(max(want), abs=1e-4)
    assert got["gap_share"] == sum(g > tau for g in want) / len(want)
    assert 0 < sum(g > 0.3 for g in want) < len(want)


@pytest.mark.parametrize("drop", ["limits", "thresholds"])
def test_gap_share_without_its_pair_is_refused_before_the_run(drop):
    ctx = harness.Context(harness.load_benchmark(), "k-exaone-236b-a23b.code",
                          SEED, 1.0, False, torch.device("cpu"), 0.0,
                          smoke=True)
    assert drive_serve.gap_threshold(ctx) == ctx.thresholds["gap_share"]
    del getattr(ctx, drop)["gap_share"]
    with pytest.raises(ValueError, match="gap_share"):
        drive_serve.run(ctx)
