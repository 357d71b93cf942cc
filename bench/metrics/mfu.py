"""Model FLOPs that the requests after the traced part need, for every
replica (``work.serve_request_flops``: new tokens and generated tokens,
attention over their context, the head where a token is picked), over
the time they span times the bf16 peak."""

from bench import work
from bench.readers import untraced


def read(run):
    recs, span = untraced(run)
    if not recs or not span:
        return None
    flops = run.replicas * sum(
        work.serve_request_flops(run.model, r["context"], r["n_prompt"],
                                 r["n"]) for r in recs if r["ok"])
    return 100.0 * flops / (span * work.BF16_FLOPS)
