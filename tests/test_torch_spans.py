"""The port's spans (``repro_torch.runtime.spans``): off, they record
nothing and open no profiler range; on, the decoder's and the train
step's spans nest as documented, a request's id is shared by its three
replica calls, the profiler's clock is fitted, and the tokens and digests
are the same bits as with spans off."""

import statistics
import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models.common import init_params
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime import spans
from repro_torch.runtime.server import ReplicatedServer
from repro_torch.runtime.steps import make_train_step

torch.set_num_threads(2)

PARENT = {"serve.call": None, "serve.prefill": "serve.call",
          "decode.launch": "serve.call", "decode.sync": "serve.call",
          "train.step": None, "train.forward": "train.step",
          "train.backward": "train.step", "train.adamw": "train.step",
          "train.attest": "train.step"}
REQUESTS = [("s0", [5, 6, 7, 8, 9], 4), ("s1", [3, 1, 4], 3),
            ("s0", [2, 7], 3)]


@pytest.fixture(autouse=True)
def spans_reset():
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


def _model(arch: str, seed: int = 0):
    return init_params(get_smoke_config(arch),
                       torch.Generator().manual_seed(seed))


def _serve(model, requests=REQUESTS):
    """Tokens of each request through a three-replica token server."""
    decoder = serve.GreedyDecoder(model, max_seq=64)
    server = ReplicatedServer.build(decoder)
    client = server.cluster.new_client()
    out = [server.generate(client, sid, prompt, n)[0]
           for sid, prompt, n in requests]
    return out, decoder


def _train(steps: int = 2):
    """Loss and both digests of each step of one replica."""
    cfg = get_smoke_config("qwen3-8b")
    model = init_params(cfg, torch.Generator().manual_seed(1))
    ocfg = AdamWConfig(lr=1e-3)
    opt = adamw_init(model.param_leaves(), ocfg)
    step = make_train_step(cfg, ocfg)
    g = torch.Generator().manual_seed(2)
    out = []
    for _ in range(steps):
        toks = torch.randint(0, cfg.vocab, (2, 9), generator=g)
        opt, m = step(model, opt, {"inputs": toks[:, :-1],
                                   "targets": toks[:, 1:]})
        out.append((float(m["loss"]), m["grad_fp"], m["param_fp"]))
    return out


def _host_ranges(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CPU and e.name() in PARENT]


def test_off_span_is_one_shared_null_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("a span read the clock while off")

    monkeypatch.setattr(spans.time, "perf_counter_ns", no_clock)
    assert spans.span("decode.launch") is spans.span("train.step")
    with spans.span("decode.sync"):
        pass
    assert spans.begin("serve.call", ("s", 1)) is None
    spans.end(None)
    assert spans.records() == []


def test_spans_nest_and_inherit_the_request_id():
    spans.enable()
    top = spans.begin("serve.call", ("s0", 5), t=100)
    with spans.span("decode.launch"):
        with spans.span("decode.sync", rid="other"):
            pass
    spans.end(top, t=10 ** 18)
    recs = spans.records()
    assert [r.name for r in recs] == ["serve.call", "decode.launch",
                                      "decode.sync"]
    assert [r.parent for r in recs] == [spans.NO_PARENT, 0, 1]
    assert [r.rid for r in recs] == [("s0", 5), ("s0", 5), "other"]
    assert recs[0].start_ns == 100 and recs[0].end_ns == 10 ** 18
    assert all(0 < r.start_ns <= r.end_ns < 10 ** 18 for r in recs[1:])
    spans.clear()
    assert spans.records() == []


def test_off_the_decoder_and_the_step_record_nothing():
    _serve(_model("gemma3-1b"), REQUESTS[:1])
    _train(1)
    assert spans.records() == []


def test_off_a_profiled_decode_shows_no_range_of_the_programs_names():
    model = _model("gemma3-1b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(model, REQUESTS[:2])
    assert _host_ranges(prof) == []
    assert spans.records() == []


def test_on_every_span_appears_nested_under_its_parent():
    spans.enable()
    _, decoder = _serve(_model("gemma3-1b"))
    _train(2)
    recs = spans.records()
    assert {r.name for r in recs} == set(PARENT)
    for r in recs:
        parent = recs[r.parent].name if r.parent != spans.NO_PARENT else None
        assert parent == PARENT[r.name], r
        assert r.start_ns <= r.end_ns
        if parent:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    calls = [i for i, r in enumerate(recs) if r.name == "serve.call"]
    assert len(calls) == 3 * len(REQUESTS) == len(decoder.timings)
    for i, (_, prefill_s, decode_s) in zip(calls, decoder.timings):
        kids = [r for r in recs if r.parent == i]
        n = len(kids[1:]) // 2
        assert [k.name for k in kids] == (["serve.prefill"]
                                          + ["decode.launch",
                                             "decode.sync"] * n)
        # the timings are the spans' own clock reads
        call, first = recs[i], kids[0]
        assert prefill_s == (first.end_ns - first.start_ns) / 1e9
        assert decode_s == (call.end_ns - first.end_ns) / 1e9
        assert call.start_ns == first.start_ns
    steps = [i for i, r in enumerate(recs) if r.name == "train.step"]
    assert len(steps) == 2
    for i in steps:
        assert [r.name for r in recs if r.parent == i] == [
            "train.forward", "train.backward", "train.adamw", "train.attest"]


def test_each_request_id_is_shared_by_exactly_its_three_replica_calls():
    spans.enable()
    _serve(_model("gemma3-1b"))
    rids = [r.rid for r in spans.records() if r.name == "serve.call"]
    hist = {}
    want = []
    for sid, prompt, n in REQUESTS:
        h = hist.setdefault(sid, [])
        h.extend(prompt)
        want.append((sid, len(h)))
        h.extend([0] * n)
    assert len(set(want)) == len(want)
    assert sorted(rids) == sorted(w for w in want for _ in range(3))
    # a call's children carry its id
    recs = spans.records()
    assert all(r.rid == recs[r.parent].rid for r in recs
               if r.parent != spans.NO_PARENT)


def test_align_fits_the_profilers_clock():
    model = _model("gemma3-1b")
    spans.enable()
    _serve(model, REQUESTS[:1])          # spans outside the session
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(model, REQUESTS[1:])
    events = prof.profiler.kineto_results.events()
    offset = spans.align(events)
    ranges = {}
    for e in _host_ranges(prof):
        ranges.setdefault(e.name(), []).append(e.start_ns())
    recs = spans.records()
    residuals = []
    for name, starts in ranges.items():
        mine = [r.start_ns for r in recs if r.name == name]
        assert len(mine) > len(starts)
        mine = mine[-len(starts):]
        residuals += [abs(b - (a + offset))
                      for a, b in zip(mine, sorted(starts))]
    assert set(ranges) == {"serve.call", "serve.prefill", "decode.launch",
                           "decode.sync"}
    assert statistics.median(residuals) < 50_000


def test_align_refuses_events_without_the_spans_ranges():
    spans.enable()
    with spans.span("train.step"):
        pass
    with pytest.raises(ValueError):
        spans.align([])


def test_tokens_and_digests_are_the_same_bits_with_spans_on():
    model = _model("gemma3-1b")
    toks_off, _ = _serve(model)
    steps_off = _train(2)
    spans.enable()
    t = time.perf_counter_ns()
    toks_on, _ = _serve(model)
    steps_on = _train(2)
    assert spans.records() and spans.records()[0].start_ns >= t
    assert toks_on == toks_off
    assert steps_on == steps_off
