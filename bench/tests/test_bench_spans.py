"""The program's spans seen from the benchmark: ``trace.reduce_events``
keeps every key's value on a fixed event list with the program's ranges
in it; ``program_spans.reduce`` charges device time, launches, syncs and
idle gaps to those ranges; a traced smoke run reports the new host-clock
metric and leaves the new device one out; the span tool runs a cell."""

import json
import os
import subprocess
import sys

import pytest
from torch.autograd import DeviceType

from bench import harness, program_spans, trace
from bench.tests.helpers import SEED, run_smoke


class Ev:
    def __init__(self, name, a, b, corr=0, link=0, cuda=False,
                 annotation=False):
        self._v = (name, a, b, corr, link, cuda, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def linked_correlation_id(self):
        return self._v[4]

    def device_type(self):
        return DeviceType.CUDA if self._v[5] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[6]


# a request holding one decode step: two kernels launched in
# decode.launch, a sync in decode.sync, a copy later in the call, a set
# after it; the program's ranges also mirrored on the device
BENCH_EVENTS = [
    Ev("bench.request", 0, 1000, 1), Ev("bench.decode_step", 25, 290, 4),
    Ev("cudaLaunchKernel", 30, 40, 100), Ev("cudaLaunchKernel", 50, 60, 101),
    Ev("aten::_local_scalar_dense", 305, 595, 7),
    Ev("cudaStreamSynchronize", 310, 590, 6),
    Ev("cudaLaunchKernel", 700, 710, 102),
    Ev("cudaLaunchKernel", 950, 960, 103),
    Ev("gemv", 100, 200, link=100, cuda=True),
    Ev("add", 250, 400, link=101, cuda=True),
    Ev("copy", 720, 800, link=102, cuda=True),
    Ev("fill", 970, 990, link=103, cuda=True),
    Ev("bench.decode_step", 100, 400, cuda=True, annotation=True)]
PROGRAM_EVENTS = [
    Ev("serve.call", 10, 900, 2), Ev("decode.launch", 20, 300, 3),
    Ev("decode.sync", 300, 600, 5),
    Ev("serve.call", 100, 800, cuda=True, annotation=True),
    Ev("decode.launch", 100, 400, cuda=True, annotation=True)]


def test_reduce_events_keeps_every_key_beside_the_programs_ranges():
    ns = 1e9
    want = {"window_s": 2.0, "busy_s": 350 / ns,
            "by_kernel": {"gemv": 100 / ns, "add": 150 / ns,
                          "copy": 80 / ns, "fill": 20 / ns},
            "by_span": {"bench.request": 350 / ns,
                        "bench.decode_step": 250 / ns},
            "span_count": {"bench.request": 1, "bench.decode_step": 1},
            "device_events": 4,
            "device_ops": [["add", 150 / ns], ["gemv", 100 / ns],
                           ["copy", 80 / ns], ["fill", 20 / ns]],
            "idle_gaps": [["request", 320 / ns], ["request", 170 / ns],
                          ["decode_step", 100 / ns],
                          ["decode_step", 50 / ns], ["request", 10 / ns]]}
    assert trace.reduce_events(BENCH_EVENTS, 2.0) == want
    assert trace.reduce_events(BENCH_EVENTS + PROGRAM_EVENTS, 2.0) == want


def test_program_reduce_charges_launches_syncs_and_idle_gaps():
    got = program_spans.reduce(BENCH_EVENTS + PROGRAM_EVENTS)
    ns = 1e9
    assert got["device_events"] == 4
    assert got["syncs_by_op"] == {"aten::_local_scalar_dense": 1}
    assert got["by_name"] == {
        "serve.call": {"count": 1, "device_s": 330 / ns,
                       "device_events": 3, "syncs": 1, "sync_s": 280 / ns},
        "decode.launch": {"count": 1, "device_s": 250 / ns,
                          "device_events": 2, "syncs": 0, "sync_s": 0.0},
        "decode.sync": {"count": 1, "device_s": 0.0, "device_events": 0,
                        "syncs": 1, "sync_s": 280 / ns}}
    idle = got["idle_by_span"]
    assert set(idle) == {"decode.launch", "decode.sync", "serve.call",
                         "host"}
    assert idle["decode.launch"] == pytest.approx(150 / ns)
    assert idle["decode.sync"] == pytest.approx(320 / ns)
    assert idle["serve.call"] == pytest.approx(170 / ns)
    assert idle["host"] == pytest.approx(10 / ns)
    host = {"traced": {}, "rest": {
        "decode.launch": {"count": 4, "ms": 3.0},
        "decode.sync": {"count": 4, "ms": 1.0}}}
    assert program_spans.metrics(host, got) == {
        "launch_share": 75.0, "launches_per_step": 2.0,
        "syncs_per_step": 1.0}
    # nothing on a device: the device metrics are left out
    assert program_spans.metrics(host, program_spans.reduce(
        PROGRAM_EVENTS[:3])) == {"launch_share": 75.0}


def test_traced_run_reports_the_host_metric_and_not_the_device_one():
    # past the traced part's 4 s, so that an untraced rest is read
    ctx = run_smoke("qwen3-moe-235b-a22b.decode", seconds=6.0, trace=True)
    got = ctx.result["metrics"]
    assert any(not r["traced"] for r in ctx.records)
    assert 0 < got["smr_host_ms.decode"]["value"] < 1e3 * ctx.window_s
    assert "idle_share.decode" not in got
    ctx = run_smoke("qwen3-8b.train", seconds=1.0, trace=True)
    assert ctx.summary["span_count"]["bench.adamw"] > 0
    assert "adamw_ms.train" not in ctx.result["metrics"]


@pytest.mark.parametrize("cell", ["qwen3-moe-235b-a22b.decode",
                                  "qwen3-8b.train"])
def test_span_tool_runs_a_cell_with_the_programs_spans(cell):
    env = dict(os.environ, PYTHONPATH=f"{harness.ROOT}:{harness.ROOT / 'src'}",
               CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "bench/program_spans.py", "--workload", cell,
         "--seed", str(SEED), "--seconds", "1", "--trace", "0", "--spans",
         "1", "--device", "cpu", "--smoke"], cwd=harness.ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    rest = out["spans"]["host"]["rest"]
    if "decode" in cell:
        assert rest["decode.launch"]["count"] == rest["decode.sync"]["count"]
        assert rest["serve.call"]["count"] == 3 * out["attempted"]
        got = out["spans"]["metrics"]
        assert 0 < got["launch_share"] <= 100
        assert got["smr_host_ms.decode"] > 0
    else:
        assert rest["train.adamw"]["count"] == rest["train.step"]["count"]
        assert rest["train.step"]["count"] == 3 * out["attempted"]
    cost = out["spans"]["cost_us"]
    assert 0 < cost["off"] and 0 < cost["on"]
