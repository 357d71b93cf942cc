"""Generated tokens of accepted replies over the time from the window's
start to its last reply (host clock)."""


def read(run):
    n = sum(r["n"] for r in run.records if r["ok"])
    return n / run.window_s if run.window_s else None
