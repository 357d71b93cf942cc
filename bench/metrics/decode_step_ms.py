"""Decode ms a step, in every serving cell: the decode seconds of every
replica's model call (``GreedyDecoder.timings``) over their decode steps,
after the traced part."""

from bench.readers import calls, untraced


def read(run):
    c = list(calls(untraced(run)[0]))
    steps = sum(n for _, _, n in c)
    return 1e3 * sum(d for _, d, _ in c) / steps if steps else None
