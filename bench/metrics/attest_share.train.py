"""Device time of the fingerprint kernel as a share of the traced
part."""


def read(run):
    s = run.summary
    if not s or not s["busy_s"]:
        return None
    t = sum(v for k, v in s["by_kernel"].items() if "fingerprint" in k)
    return 100.0 * t / s["window_s"] if t else None
