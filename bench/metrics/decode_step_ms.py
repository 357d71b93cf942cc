"""``decode_step_ms`` of a serving cell that has no reader of its own, read
as the decode cell's reader (``decode_step_ms.decode.py``) reads it."""

from bench.harness import read_metric


def read(run):
    return read_metric("decode_step_ms.decode", run)
