"""AdamW's device ms a replica step: the device time of the kernels
launched inside the traced part's ``bench.adamw`` spans (the program's
``adamw_update``, called once in each replica's step, the call that its
``train.adamw`` span holds) over the number of those spans."""

SPAN = "bench.adamw"


def read(run):
    s = run.summary
    if not s:
        return None
    n, t = s["span_count"].get(SPAN, 0), s["by_span"].get(SPAN, 0.0)
    if not n or not t:
        return None
    return 1e3 * t / n
