"""The fingerprint kernel against its bytes bound: every gradient and
parameter word of every replica, twice a step (``work.digest_bytes``),
over the HBM rate, over the kernel's device time, for the steps of the
traced part."""

from bench import work


def read(run):
    s = run.summary
    if not s:
        return None
    t = sum(v for k, v in s["by_kernel"].items() if "fingerprint" in k)
    steps = sum(1 for r in run.records if r["traced"])
    if not t or not steps:
        return None
    need = steps * run.mix["replicas"] * 2 * work.digest_bytes(
        run.leaf_sizes)
    return 100.0 * need / work.HBM_BYTES_S / t
