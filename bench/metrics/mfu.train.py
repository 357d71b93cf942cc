"""Model FLOPs of the agreed steps after the traced part, for every
replica (``work.train_step_flops``: 6 a parameter a token and the causal
attention, no recompute), over the time they span times the bf16
peak."""

from bench import work
from bench.readers import untraced


def read(run):
    recs, span = untraced(run)
    if not recs or not span:
        return None
    mix = run.mix
    flops = len(recs) * mix["replicas"] * work.train_step_flops(
        run.model, mix["batch"], mix["seq"])
    return 100.0 * flops / (span * work.BF16_FLOPS)
