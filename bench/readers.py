"""What the metric readers share: the records of a run outside its
traced part, and the time they span."""

from __future__ import annotations

from typing import Dict, List, Tuple


def untraced(run) -> Tuple[List[Dict], float]:
    """The records after the traced part, and the seconds from the end of
    that part (the profiler stopped; or the window's start) to the last
    of them."""
    recs = [r for r in run.records if not r["traced"]]
    span = (recs[-1]["t1"] - run.untraced_from) if recs else 0.0
    return recs, span


def calls(recs: List[Dict]):
    """(prefill seconds, decode seconds, decode steps) of every replica's
    model call in ``recs``."""
    for r in recs:
        for p, d in zip(r["prefill_s"], r["decode_s"]):
            yield p, d, r["n"] - 1
