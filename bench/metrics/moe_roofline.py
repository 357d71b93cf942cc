"""``moe_roofline`` of a serving cell that has no reader of its own, read
as the decode cell's reader (``moe_roofline.decode.py``) reads it."""

from bench.harness import read_metric


def read(run):
    return read_metric("moe_roofline.decode", run)
