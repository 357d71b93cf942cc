"""A serving cell: the port's uBFT-replicated token server
(``repro_torch.runtime.server.ReplicatedServer``, three replicas, f = 1,
f_m = 1) behind the ``GreedyDecoder`` of ``repro_torch.launch.serve``, on
one weight copy attested by ``runtime.attest.fingerprint_tree``, driven in
a closed loop with one request in flight.

The window opens at the first request and closes on the reply that ends
past ``--seconds`` (in a traced run, past ``--seconds`` plus the time
spent reading the trace of its first part).  Then the peak memory is
read, the simulation runs on until every replica has applied the last
request, every replica's session state is held against the histories
the client was served, the program's state is freed, and the plain
reference checks every served token of the window (``reference/serve.py``:
the widest logit gap and, where the cell's limits name it, the share of
gaps past a threshold) and the weights' digest.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List, Optional

from bench import harness, trace
from bench.reference import serve as ref_serve
from bench.traffic import generator

TRACE_SECONDS = 4.0
# virtual µs that the replica check lets the simulation run on for a
# replica that applies the last request after the client's replies (a
# lagging replica catches up in about 1.4 µs)
DRAIN_US = 10_000.0


def _max_request_bytes(mix: Dict, vocab: int) -> int:
    """The largest request the mix sends, as the server's JSON: digits and
    separators of the longest prompt, and the framing."""
    longest = max(generator.largest(mix["first_prompt"]),
                  generator.largest(mix.get("next_prompt",
                                            mix["first_prompt"])))
    return longest * (len(str(vocab - 1)) + 2) + 256


def _patches(model: Dict) -> List[trace.Patch]:
    out: List[trace.Patch] = [
        ("repro_torch.launch.serve", "prefill", "bench.prefill"),
        ("repro_torch.launch.serve", "decode_step", "bench.decode_step")]
    if model.get("moe"):
        out.append(("repro_torch.models.transformer", "moe_ffn",
                    lambda cfg, p, x, ctx=None:
                    "bench.moe_ffn.t1" if x.shape[0] * x.shape[1] == 1
                    else "bench.moe_ffn"))
    return out


def start(decode_fn: Callable[[str, List[int], int], List[int]],
          mix: Dict, vocab: int):
    """The token server over ``decode_fn`` (three replicas, f = 1,
    f_m = 1), a client for each of the mix's concurrent sessions, and the
    warm-up: the largest shapes the mix reaches, then a short prompt."""
    from repro_torch.core.consensus import ConsensusConfig
    from repro_torch.runtime.server import ReplicatedServer

    server = ReplicatedServer.build(decode_fn, cfg=ConsensusConfig(
        f=1, f_m=1, max_request_bytes=_max_request_bytes(mix, vocab)))
    clients = [server.cluster.new_client() for _ in range(mix["concurrent"])]
    warm = server.cluster.new_client()
    server.generate(warm, "warmup", [1] * (mix["max_history"] - 2), 2)
    server.generate(warm, "warmup-short", [2] * 16, 2)
    return server, clients


def replicas_differing(cluster, hist: Dict[str, List[int]]) -> int:
    """Replicas whose sessions differ from the histories the client was
    served.  The client takes f + 1 matching replies, so a replica may
    apply the last request a little after them: the simulation first
    runs until every replica holds the histories, or for ``DRAIN_US`` of
    virtual time, after which a replica that never converged counts."""
    def holds(app) -> bool:
        return all(app.sessions.get(sid) == h for sid, h in hist.items())

    cluster.sim.run_until(
        lambda: all(holds(r.app) for r in cluster.replicas),
        timeout=DRAIN_US)
    return sum(not holds(r.app) for r in cluster.replicas)


def gap_threshold(ctx: harness.Context) -> Optional[float]:
    """The threshold of the cell's ``gap_share``, or None where the cell
    compares no share; a limit without a threshold, or a threshold
    without a limit, is refused before anything is built."""
    tau = ctx.thresholds.get("gap_share")
    if (tau is None) != ("gap_share" not in ctx.limits):
        raise ValueError(f"{ctx.cell['name']}: gap_share needs both a "
                         "limit and a threshold in its limits file")
    return tau


def run(ctx: harness.Context) -> Dict:
    from repro_torch.launch.serve import GreedyDecoder, set_deterministic
    from repro_torch.runtime.attest import fingerprint_tree

    m, mix, dev = ctx.model, ctx.mix, ctx.device
    tau = gap_threshold(ctx)
    set_deterministic()
    model = harness.build_model(ctx)
    digest = fingerprint_tree(model.param_leaves())
    decoder = GreedyDecoder(model, mix["max_history"])
    decode_fn = decoder
    if ctx.fault == "token":        # a planted fault: one token altered
        def decode_fn(session, hist, n):
            out = decoder(session, hist, n)
            out[-1] = (out[-1] + 1) % m["vocab"]
            return out
    server, clients = start(decode_fn, mix, m["vocab"])
    ctx.replicas = len(server.cluster.replicas)
    ctx.sync()
    decoder.timings.clear()
    requests = generator.session_requests(mix, m["vocab"], ctx.seed)
    hist: Dict[str, List[int]] = {}
    recs: List[Dict] = []
    tracer = trace.Tracer(_patches(m) if ctx.trace else [], dev)
    ctx.setup_done()
    t0 = time.perf_counter()
    deadline = ctx.seconds
    if ctx.trace:
        tracer.start()
    while True:
        req = next(requests)
        n_before = len(decoder.timings)
        a = time.perf_counter()
        with tracer.span("bench.request"):
            toks, _ = server.generate(clients[req.slot], req.session,
                                      req.prompt, req.n)
        b = time.perf_counter()
        calls = decoder.timings[n_before:]
        ok = toks is not None and len(toks) == req.n
        recs.append({"t0": a - t0, "t1": b - t0, "n": req.n,
                     "n_prompt": len(req.prompt), "context": req.context,
                     "session": req.session, "ok": ok,
                     "traced": tracer.on,
                     "prefill_s": [c[1] for c in calls],
                     "decode_s": [c[2] for c in calls],
                     "tokens": toks or []})
        h = hist.setdefault(req.session, [])
        h.extend(req.prompt)
        h.extend(toks or [])
        if tracer.on and b - t0 >= TRACE_SECONDS:
            ctx.summary = tracer.stop()
            ctx.untraced_from = time.perf_counter() - t0
            # reading the trace is no part of the window's work
            deadline += ctx.untraced_from - (b - t0)
        if b - t0 >= deadline:
            break
    if tracer.on:
        ctx.summary = tracer.stop()
    ctx.window_s = recs[-1]["t1"]
    ctx.records = recs
    ctx.window_closed()

    ctx.check("replicas_differing",
              replicas_differing(server.cluster, hist), 0)
    del server, decode_fn, decoder, model, clients
    gc.collect()
    ctx.free()

    d = ref_serve.weights_digest(m, ctx.seed, dev)
    ctx.check("weights_digest_mismatch", int(d != digest), 0)
    res = ref_serve.check(m, ctx.seed, dev, checked(m, recs, hist),
                          control=ctx.control, tau=tau)
    ctx.check("max_logit_gap", res["max_logit_gap"])
    if tau is not None:
        ctx.check("gap_share", res["gap_share"])
    ctx.info.update(res)
    ctx.attempted = len(recs)
    ctx.failed = sum(not r["ok"] for r in recs)
    return res


def checked(model: Dict, recs: List[Dict], hist: Dict[str, List[int]]
            ) -> List[Dict]:
    """The sequences the reference runs: a session's history for a dense
    model (the logits at a position do not depend on what follows it),
    each request's own history for a routed one, whose capacity depends
    on the calls the tokens were run in (the history prefilled in one
    call, then one token a decode step)."""
    out: List[Dict] = []
    by_session: Dict[str, List[Dict]] = {}
    for r in recs:
        if r["ok"]:
            by_session.setdefault(r["session"], []).append(r)
    for sid, rs in by_session.items():
        h = hist[sid]
        if model.get("moe"):
            for r in rs:
                end = r["context"] + r["n_prompt"]
                out.append({"tokens": h[:end + r["n"] - 1],
                            "segments": [(0, end)] + [
                                (end + i, end + i + 1)
                                for i in range(r["n"] - 1)],
                            "checks": _checks(r)})
        else:
            last = rs[-1]
            end = last["context"] + last["n_prompt"] + last["n"] - 1
            out.append({"tokens": h[:end], "segments": None,
                        "checks": [c for r in rs for c in _checks(r)]})
    return out


def _checks(r: Dict):
    p = r["context"] + r["n_prompt"] - 1
    return [(p + i, t) for i, t in enumerate(r["tokens"])]
