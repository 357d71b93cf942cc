"""The share of the traced part with nothing running on the device."""


def read(run):
    s = run.summary
    if not s or not s["busy_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
