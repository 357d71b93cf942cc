"""Spans: named intervals of the program's own host time.

  from repro_torch.runtime import spans
  spans.enable()
  with spans.span("decode.launch"):
      ...
  recs = spans.records()   # [Record(name, start_ns, end_ns, parent, rid)]

Off by default.  Off, :func:`span` is one flag test that returns a shared
null context, and :func:`begin` returns None: nothing is allocated, no
clock is read, no string is built (callers pass constant names).

On, each span appends ``(name, start_ns, end_ns, parent, rid)`` to an
in-memory list, stamped with ``time.perf_counter_ns()``; ``parent`` is the
index of the enclosing span (-1 at the top), ``rid`` the request the span
belongs to, inherited from the parent where it is not given.  Nothing is
written out: the caller reads :func:`records` and empties the list with
:func:`clear`.  Spans nest on one host thread.

While a ``torch.profiler`` session is active, an open span also holds a
``record_function`` range of its name, so that the device trace shows the
program's spans on its own clock; :func:`align` fits the offset between
that clock and the spans' stamps.
"""

from __future__ import annotations

import statistics
import time
from contextlib import nullcontext
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import record_function

NO_PARENT = -1


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    parent: int
    rid: object


_on = False
_NULL = nullcontext()
_recs: List[list] = []            # [name, start, end, parent, rid], open: end -1
_open: List[int] = []             # indices of the open spans, innermost last
_ranges: Dict[int, record_function] = {}   # open spans' profiler ranges
_ranged: List[int] = []           # spans that opened a range, in order


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def clear() -> None:
    """Empties the records; spans open at the time are dropped too."""
    for rf in _ranges.values():
        rf.__exit__(None, None, None)
    _recs.clear()
    _open.clear()
    _ranges.clear()
    _ranged.clear()


def records() -> List[Record]:
    """The spans, in the order they were opened (a span's ``parent`` is an
    index of this list); one still open, or left open inside a span that
    closed, has ``end_ns`` -1."""
    return [Record(*r) for r in _recs]


def begin(name: str, rid: object = None,
          t: Optional[int] = None) -> Optional[int]:
    """Opens a span at ``t`` (``perf_counter_ns``; now where None) and
    returns its index for :func:`end`; off, returns None."""
    if not _on:
        return None
    if t is None:
        t = time.perf_counter_ns()
    parent = _open[-1] if _open else NO_PARENT
    if rid is None and parent != NO_PARENT:
        rid = _recs[parent][4]
    idx = len(_recs)
    _recs.append([name, t, -1, parent, rid])
    _open.append(idx)
    if torch.autograd._profiler_enabled():
        rf = record_function(name)
        rf.__enter__()
        _ranges[idx] = rf
        _ranged.append(idx)
    return idx


def end(idx: Optional[int], t: Optional[int] = None) -> None:
    """Closes the span that :func:`begin` opened as ``idx`` at ``t``
    (``perf_counter_ns``; now where None), with the ranges of any span
    still open inside it.  None (spans off) does nothing."""
    if idx is None:
        return
    if t is None:
        t = time.perf_counter_ns()
    _recs[idx][2] = t
    while _open:
        j = _open.pop()
        rf = _ranges.pop(j, None)
        if rf is not None:
            rf.__exit__(None, None, None)
        if j == idx:
            break


class _Span:
    __slots__ = ("idx",)

    def __init__(self, idx: int):
        self.idx = idx

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        end(self.idx)
        return False


def span(name: str, rid: object = None):
    """A context that is a span of ``name`` while spans are on."""
    if not _on:
        return _NULL
    return _Span(begin(name, rid))


def align(events: Iterable) -> int:
    """The offset (ns) to add to a span's ``start_ns`` to place it on the
    profiler's clock: the median difference between the start of each
    recorded span that opened a range and the start of that range among
    the host events of ``events`` (a profiler's events, each with
    ``name()``, ``start_ns()`` and ``device_type()``).  Spans and ranges
    are paired by name, in order, the last of each: the ranges of the last
    session profiled belong to the last spans that opened one."""
    spans_by: Dict[str, List[int]] = {}
    for i in _ranged:
        name, start, stop = _recs[i][:3]
        if stop >= 0:
            spans_by.setdefault(name, []).append(start)
    ranges_by: Dict[str, List[int]] = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.name() in spans_by:
            ranges_by.setdefault(e.name(), []).append(e.start_ns())
    diffs: List[int] = []
    for name, starts in spans_by.items():
        got = sorted(ranges_by.get(name, ()))
        n = min(len(starts), len(got))
        diffs += [b - a for a, b in zip(starts[len(starts) - n:],
                                        got[len(got) - n:])]
    if not diffs:
        raise ValueError("no recorded span opened a range among the events")
    return int(statistics.median(diffs))
