"""The served model as one app of a faulted shared-substrate deployment,
on the port against the reference.

One seeded ``ScenarioSpec`` (three apps on one disaggregated-memory
substrate of two pools: a token server over smoke gemma3-1b in fp32, a
closed-loop KV store and an open-loop matching engine; a token-server
replica crashed while its decode engine is busy and recovered, a memory
node crashed and its pool reconfigured, another token-server replica
crashed and replaced between turns) runs twice: through
``repro.scenario.run_scenario`` with the JAX decode function, and through
``repro_torch.scenario.run_scenario`` with ``serve.GreedyDecoder`` on the
CPU.  Virtual time does not depend on decode wall time, so latencies must
be equal as exact floats, and message counts, byte counts (the token
server's JSON payloads carry the tokens), per-app memory and every
replica's snapshot equal.  The unreplicated baseline is compared the same
way on the same requests.
"""

import dataclasses
import importlib
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.common import init_params as jax_init_params
from test_torch_server import _jax_decode_fn

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve

torch.set_num_threads(2)

ARCH = "gemma3-1b"
APPS = ("tok", "kv", "match")
#: the faults, in virtual µs: tok/r2 crashes while its decode engine runs
#: the first turns' backlog (with no register operation in flight: a
#: crash swallows the replies to one) and recovers before the next slot
#: is decided; m1 (a memory node of pool0) crashes and its pool
#: reconfigures; tok/r1 crashes and is replaced between turns
CRASH_US, RECOVER_US = 600.0, 1400.0
MEM_CRASH_US, RECONFIGURE_US = 1000.0, 1800.0
STOP_US, REPLACE_US = 2800.0, 3000.0


def _pkg(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _trace(pkg: str, vocab: int):
    """Four sessions whose first turns arrive together, then three more
    turns (seeded draws: 7 requests)."""
    return _pkg(pkg, "workloads").llm_session_trace(
        9, 8_000.0, session_times=[0.0, 60.0, 120.0, 180.0],
        mean_turns=2.0, think_us=4_000.0, first_prompt_tokens=64,
        next_prompt_tokens=16, decode_tokens=8, vocab=vocab)


def _spec(pkg: str, decode_fn, cost_model, trace, probe: dict):
    """The deployment through package ``pkg``'s own modules; ``probe``
    receives what the first crash's victim holds in flight."""
    scenario = _pkg(pkg, "scenario")
    kvstore, matching = _pkg(pkg, "apps.kvstore"), _pkg(pkg, "apps.matching")
    ConsensusConfig = _pkg(pkg, "core.consensus").ConsensusConfig
    TokenServerApp = _pkg(pkg, "runtime.server").TokenServerApp
    FaultSchedule = _pkg(pkg, "sim.faults").FaultSchedule

    def slow():
        return ConsensusConfig(t=16, window=16, slow_mode="always",
                               ctb_fast_enabled=False,
                               view_timeout_us=20_000.0)

    # tests/golden_scenarios.py's token_server consensus: a roofline-costed
    # engine needs a progress timer that outlasts its backlog
    tok_cfg = ConsensusConfig(t=16, window=32, slow_mode="always",
                              ctb_fast_enabled=False,
                              view_timeout_us=200_000.0, max_batch=4,
                              pipeline_depth=4, max_request_bytes=4096)

    def faults(substrate):
        # what tok/r2 holds in flight just before it crashes
        victim = substrate.clusters["tok"].replicas[2]
        substrate.sim.at(CRASH_US - 1e-3, lambda: probe.update(
            engine_slot=victim._exec_inflight,
            register_ops=len(victim.regs._pending)))
        return (FaultSchedule()
                .add(CRASH_US, "crash", "tok/r2")
                .add(RECOVER_US, "recover", "tok/r2")
                .add(MEM_CRASH_US, "crash", "m1")
                .add(RECONFIGURE_US, "reconfigure", ("pool0", "m1"))
                .add(STOP_US, "crash", "tok/r1")
                .add(REPLACE_US, "replace_replica", "tok/r1"))

    return scenario.ScenarioSpec(
        n_pools=2, f_m=1, seed=5, faults=faults, drain_us=100_000.0,
        apps=[
            scenario.AppSpec(
                name="tok", cfg=tok_cfg,
                app=lambda: TokenServerApp(decode_fn, cost_model=cost_model),
                # one client a request: client j's latency is request j's
                workload=scenario.Workload(kind="trace", trace=trace,
                                           n_clients=len(trace),
                                           timeout_us=10_000_000.0)),
            scenario.AppSpec(
                name="kv", app=kvstore.KVStoreApp, cfg=slow(),
                workload=scenario.Workload(
                    kind="closed", n_requests=40, timeout_us=10_000_000.0,
                    payload_fn=lambda i: kvstore.set_req(
                        b"key%d" % (i % 16), b"value%d" % i))),
            scenario.AppSpec(
                name="match", app=matching.MatchingEngineApp, cfg=slow(),
                workload=scenario.Workload(
                    kind="open", rate_rps=4_000.0, duration_us=6_000.0,
                    seed=7, timeout_us=10_000_000.0,
                    payload_fn=lambda i: matching.order_req(
                        "buy" if i % 2 == 0 else "sell", i,
                        100 + (i * 7) % 11 - 5, 10))),
        ])


def _unreplicated(pkg: str, decode_fn, cost_model, trace):
    """The same requests at the same times through the unreplicated
    baseline: [(tokens, latency_us)] in trace order."""
    TokenServerApp = _pkg(pkg, "runtime.server").TokenServerApp
    build = _pkg(pkg, "baselines.unreplicated").build_unreplicated
    sim, _server, client = build(
        lambda: TokenServerApp(decode_fn, cost_model=cost_model))
    out = [None] * len(trace)
    for j, (t, payload) in enumerate(trace):
        def done(raw, lat, j=j):
            out[j] = (json.loads(raw.decode())["tokens"], lat)
        sim.at(t, lambda p=payload, cb=done: client.request(p, cb))
    assert sim.run_until(lambda: all(o is not None for o in out),
                         timeout=10_000_000.0)
    return out


def _longest_history(trace) -> int:
    total = {}
    for _t, payload in trace:
        msg = json.loads(payload)
        total[msg["session"]] = (total.get(msg["session"], 0)
                                 + len(msg["prompt"]) + msg["n"])
    return max(total.values())


def _run(pkg: str, decode_fn, cost_model, trace) -> dict:
    probe = {}
    res = _pkg(pkg, "scenario").run_scenario(
        _spec(pkg, decode_fn, cost_model, trace, probe))
    return {
        "result": res,
        "probe": probe,
        "latencies": {a: res.apps[a].latencies for a in APPS},
        "memory": {a: res.apps[a].memory_by_pool for a in APPS},
        "snapshots": {a: [(r.pid, r.app.snapshot())
                          for r in res.clusters[a].replicas] for a in APPS},
        "faults": list(res.injector.log),
        "per_request": [c.latencies
                        for c in res.clusters["tok"].clients],
        "unreplicated": _unreplicated(pkg, decode_fn, cost_model, trace),
    }


@pytest.fixture(scope="module")
def runs():
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    trace = _trace("repro_torch", tcfg.vocab)
    assert trace == _trace("repro", jcfg.vocab)
    max_seq = _longest_history(trace) + 8
    port_cm = _pkg("repro_torch", "serve").ServingCostModel.from_arch(ARCH)
    # the same charge on both sides: the reference's cost model with the
    # port's (the card's) rates
    ref_cm = dataclasses.replace(
        _pkg("repro", "serve").ServingCostModel.from_arch(ARCH),
        peak_flops=port_cm.peak_flops, hbm_bw=port_cm.hbm_bw)
    assert dataclasses.astuple(ref_cm) == dataclasses.astuple(port_cm)
    decoder = serve.GreedyDecoder(model, max_seq)
    return {"trace": trace, "decoder": decoder,
            "jax": _run("repro", _jax_decode_fn(jcfg, jparams, max_seq),
                        ref_cm, trace),
            "port": _run("repro_torch", decoder, port_cm, trace)}


def test_trace_has_later_turns(runs):
    sessions = [json.loads(p)["session"] for _t, p in runs["trace"]]
    assert len(sessions) == 7 and len(set(sessions)) == 4


def test_latencies_equal_exact(runs):
    want, got = runs["jax"]["latencies"], runs["port"]["latencies"]
    assert all(len(got[a]) > 0 for a in APPS)
    assert got == want
    assert runs["port"]["per_request"] == runs["jax"]["per_request"]


def test_message_and_byte_counts_equal(runs):
    want, got = runs["jax"]["result"], runs["port"]["result"]
    assert (got.msgs_sent, got.bytes_sent) == (want.msgs_sent, want.bytes_sent)
    assert got.events_processed == want.events_processed
    assert not got.budget_overruns and not want.budget_overruns


def test_memory_equal(runs):
    assert runs["port"]["memory"] == runs["jax"]["memory"]


def test_faults_took_effect_alike(runs):
    log = runs["port"]["faults"]
    assert log == runs["jax"]["faults"]
    # tok/r2 crashed with a decided slot in its decode engine and no
    # register operation in flight
    assert runs["port"]["probe"] == runs["jax"]["probe"]
    assert runs["port"]["probe"]["engine_slot"] is not None
    assert runs["port"]["probe"]["register_ops"] == 0
    assert [a for _t, a, _x in log] == [
        "crash", "crash", "recover", "reconfigure", "crash",
        "replace_replica"]
    tok = runs["port"]["result"].clusters["tok"]
    assert [r.pid for r in tok.replicas] == ["tok/r0", "tok/r3", "tok/r2"]
    assert all(r.membership.epoch == 1 and not r.joining and not r.crashed
               for r in tok.replicas)


def test_snapshots_identical(runs):
    """Every replica of every app holds one state, the recovered tok/r2
    and the joiner tok/r3 included, and the packages agree on it."""
    got = runs["port"]["snapshots"]
    assert got == runs["jax"]["snapshots"]
    for app in APPS:
        assert len({repr(s) for _pid, s in got[app]}) == 1, app


def test_replies_equal_a_direct_decode(runs):
    """Each session's agreed history is its turns' prompts, each followed
    by the tokens the decoder gives on the history so far."""
    decoder = runs["decoder"]
    hist = dict(runs["port"]["snapshots"]["tok"][0][1])
    for sid, full in hist.items():
        at = 0
        for _t, payload in runs["trace"]:
            msg = json.loads(payload)
            if msg["session"] != sid:
                continue
            prompt, n = msg["prompt"], msg["n"]
            assert list(full[at:at + len(prompt)]) == prompt
            at += len(prompt)
            assert list(full[at:at + n]) == decoder(sid, list(full[:at]), n)
            at += n
        assert at == len(full)


def test_unreplicated_baseline_agrees(runs):
    """The baseline gives the same tokens and latencies under both
    packages, and the replicated server's tokens."""
    want, got = runs["jax"]["unreplicated"], runs["port"]["unreplicated"]
    assert got == want
    hist = dict(runs["port"]["snapshots"]["tok"][0][1])
    at = {sid: 0 for sid in hist}
    for (_t, payload), (toks, lat) in zip(runs["trace"], got):
        msg = json.loads(payload)
        sid = msg["session"]
        at[sid] += len(msg["prompt"])
        assert toks == list(hist[sid][at[sid]:at[sid] + msg["n"]])
        at[sid] += msg["n"]
        assert lat > 0
    # consensus costs time on top of the same serial service
    replicated = [lats[0] for lats in runs["port"]["per_request"]]
    assert all(r > u for r, (_toks, u) in zip(replicated, got))
