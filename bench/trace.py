"""The traced part of a ``--trace 1`` run: spans that the benchmark opens
around calls into the program's layers, ``torch.profiler`` over a bounded
part of the window, and the reduction of its events to what the per-layer
metrics read.

Spans are ``record_function`` ranges named ``bench.<layer>``.  The
benchmark opens them by wrapping, for the traced part only, the functions
that the program looks up by name in its own modules (the decoder's
``prefill`` and ``decode_step``, the routed FFN, the train step's loss,
optimizer and attestation), and puts the originals back when the part
ends; the untraced runs call the program untouched.

The reduction reads the profiler's raw events: device events (kernels,
copies and sets; not the annotations) give the busy time, merged over
the part; each device event is charged to the spans that were open on
the host when the operator that launched it started (by the event's
correlation id); each idle gap is named by the innermost span open on the
host at its middle ("host" where none is).
"""

from __future__ import annotations

import bisect
import importlib
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

Name = Union[str, Callable[..., str]]
Patch = Tuple[str, str, Name]      # module, attribute, span name


def _wrap(fn, name: Name):
    def spanned(*args, **kwargs):
        label = name(*args, **kwargs) if callable(name) else name
        with record_function(label):
            return fn(*args, **kwargs)
    return spanned


class Tracer:
    """Profiles from :meth:`start` to :meth:`stop`, with ``patches``
    applied in between; :meth:`span` opens a span while it profiles."""

    def __init__(self, patches: Sequence[Patch], device: torch.device):
        self.patches = patches
        self.device = device
        self.saved: List[Tuple[object, str, object]] = []
        self.on = False

    def span(self, name: str):
        return record_function(name) if self.on else nullcontext()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        for mod_name, attr, name in self.patches:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            self.saved.append((mod, attr, fn))
            setattr(mod, attr, _wrap(fn, name))
        self._sync()
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.on = True
        self.t0 = time.perf_counter()

    def stop(self) -> Dict:
        self._sync()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        for mod, attr, fn in reversed(self.saved):
            setattr(mod, attr, fn)
        self.saved.clear()
        self.on = False
        return reduce_events(self.prof.profiler.kineto_results.events(),
                             window_s)


def _merge(iv: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _innermost(spans: List[Tuple[int, int, str]], t: int) -> Optional[str]:
    best = None
    for a, b, name in spans:
        if a <= t <= b and (best is None or a >= best[0]):
            best = (a, name)
    return None if best is None else best[1]


def reduce_events(events, window_s: float, top: int = 10) -> Dict:
    launch: Dict[int, int] = {}
    spans: List[Tuple[int, int, str]] = []
    cpu_lo, cpu_hi = None, None
    dev: List[Tuple[str, int, int, int]] = []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            a, b = e.start_ns(), e.end_ns()
            launch[e.correlation_id()] = a
            cpu_lo = a if cpu_lo is None else min(cpu_lo, a)
            cpu_hi = b if cpu_hi is None else max(cpu_hi, b)
            if name.startswith("bench."):
                spans.append((a, b, name))
        elif not (name.startswith("bench.")
                  or getattr(e, "is_user_annotation", lambda: False)()):
            dev.append((name, e.start_ns(), e.end_ns(),
                        e.linked_correlation_id()))
    busy = _merge([(a, b) for _, a, b, _ in dev])
    busy_s = sum(b - a for a, b in busy) / 1e9
    by_kernel: Dict[str, float] = {}
    for name, a, b, _ in dev:
        by_kernel[name] = by_kernel.get(name, 0.0) + (b - a) / 1e9
    # device time charged to each span name, by the launching op's start
    by_span: Dict[str, float] = {}
    count: Dict[str, int] = {}
    per_name: Dict[str, List[Tuple[int, int]]] = {}
    for a, b, name in spans:
        per_name.setdefault(name, []).append((a, b))
        count[name] = count.get(name, 0) + 1
    for name, iv in per_name.items():
        iv.sort()
        starts = [a for a, _ in iv]
        total = 0
        for _, a, b, corr in dev:
            t = launch.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= iv[i][1]:
                total += b - a
        by_span[name] = total / 1e9
    gaps: List[Tuple[float, str]] = []
    if busy and cpu_lo is not None:
        edges = [(cpu_lo, busy[0][0])] + [(busy[i][1], busy[i + 1][0])
                                          for i in range(len(busy) - 1)] \
            + [(busy[-1][1], cpu_hi)]
        longest = sorted((g for g in edges if g[1] > g[0]),
                         key=lambda g: g[0] - g[1])[:top]
        for a, b in longest:
            name = _innermost(spans, (a + b) // 2) or "host"
            gaps.append((name.replace("bench.", ""), (b - a) / 1e9))
    ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": window_s, "busy_s": busy_s, "by_kernel": by_kernel,
            "by_span": by_span, "span_count": count,
            "device_events": len(dev),
            "device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
