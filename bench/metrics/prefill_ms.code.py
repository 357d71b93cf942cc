"""Prefill ms a replica call: the seconds from a call's start to its first
token (``GreedyDecoder.timings``: the prompt prefilled and the first
token read) over every replica's call after the traced part."""

from bench.readers import calls, untraced


def read(run):
    c = list(calls(untraced(run)[0]))
    return 1e3 * sum(p for p, _, _ in c) / len(c) if c else None
