"""Every cell through the harness at its smoke widths on the CPU (the
look for a card skipped): the result line's keys, and ``correct`` false
under each fault the cell can have, planted in the timed path."""

import json

import pytest

from bench import harness
from bench.tests.helpers import run_smoke

CELLS = [c["name"] for c in harness.load_benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_prints_the_five_keys(cell):
    ctx = run_smoke(cell)
    out = ctx.result
    assert list(out)[:5] == KEYS and list(out)[-1] == "checks"
    json.dumps(out)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) == 2
    assert set(ctx.limits) >= set(out["checks"])


def test_traced_run_reads_the_trace():
    ctx = run_smoke("qwen3-moe-235b-a22b.decode", seconds=1.0, trace=True)
    assert ctx.summary is not None and ctx.summary["window_s"] > 0
    # nothing ran on a device: the device metrics are left out
    assert "idle_share.decode" not in ctx.result["metrics"]


FAULTS = [(c, "token") for c in CELLS if "train" not in c] + [
    ("qwen3-8b.train", "unchanged"), ("qwen3-8b.train", "half_batch")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault):
    out = run_smoke(cell, fault=fault).result
    assert out["correct"] is False, out["checks"]
