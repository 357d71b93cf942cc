"""On the card, at each cell's own size: the control (the reference in
fp8, one precision below the configuration's bf16, put in the program's
place) comes out not correct on three seeds, and so does a training
cell's planted half-batch fault; the program itself comes out correct.
A window of the benchmark's length at the cell's own load, so that a
serving cell compares as many tokens as a run does (a share of them is
compared).

  PYTHONPATH=src:. python -m pytest -q -m card bench/tests/test_bench_card.py
"""

import time

import pytest

from bench import harness

CELLS = [c["name"] for c in harness.load_benchmark()["workloads"]]
SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)


def _fails(limits, numbers):
    return any(v > limits[k] for k, v in numbers.items() if k in limits)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_and_the_program_passes(cell, card):
    bench = harness.load_benchmark()
    for seed in SEEDS:
        ctx = harness.Context(bench, cell, seed, bench["run_seconds"],
                              False, card, time.perf_counter(), control=True)
        out = harness.run_cell(ctx)
        assert out["correct"], out["checks"]
        if "control_max_logit_gap" in ctx.info:
            assert _fails(ctx.limits, {
                k: ctx.info[f"control_{k}"] for k in ctx.checks
                if f"control_{k}" in ctx.info})
        else:
            assert _fails(ctx.limits, ctx.info["control"])
            assert _fails(ctx.limits, ctx.info["half_batch"])
