"""``smr_host_ms`` of a serving cell that has no reader of its own, read
as the decode cell's reader (``smr_host_ms.decode.py``) reads it."""

from bench.harness import read_metric


def read(run):
    return read_metric("smr_host_ms.decode", run)
