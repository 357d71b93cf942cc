"""Tokens of agreed, attested steps, each step's batch counted once, over
the time from the window's start to the last step's end (host clock)."""


def read(run):
    n = sum(r["tokens"] for r in run.records if r["ok"])
    return n / run.window_s if run.window_s else None
