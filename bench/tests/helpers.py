"""Running a cell of the benchmark on the CPU at its smoke widths."""

import time

import torch

from bench import harness

SEED = 2 ** 31 + 12345


def run_smoke(cell: str, seconds: float = 2.0, trace: bool = False,
              fault=None, seed: int = SEED) -> harness.Context:
    torch.set_num_threads(2)
    bench = harness.load_benchmark()
    ctx = harness.Context(bench, cell, seed, seconds, trace,
                          torch.device("cpu"), time.perf_counter(),
                          smoke=True, fault=fault)
    ctx.result = harness.run_cell(ctx)
    return ctx
