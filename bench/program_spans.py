"""The program's own spans (``repro_torch.runtime.spans``) in a run of a
cell, and the reduction of a trace by their names.

  python3 bench/program_spans.py --workload <cell> --seed <n> \\
      --seconds <s> --trace <0|1> --spans <0|1>

runs the cell as ``bench/run.py`` does; with ``--spans 1`` the program's
spans are on for the window (cleared as set-up ends, read as the window
closes).  The result line (standard output's last line) carries one more
key, ``spans``:

* ``host``: by span name, the count and the mean host ms of the spans in
  the traced part and in the rest;
* ``device`` (traced runs): :func:`reduce` of the traced part's events;
* ``metrics``: :func:`metrics`, and the host-clock readers of the cell
  (``decode_step_ms``, ``smr_host_ms``) in untraced runs too;
* ``cost_us``: :func:`cost_per_step` after the window.

:func:`reduce` charges each device event (kernel, copy, set) to the
program's spans open on the host when the runtime call that launched it
started, by correlation id, as ``bench/trace.py`` charges ``bench.*``
spans; counts the host-blocking runtime calls (``SYNCS``) started inside
each span; and sums the device's idle gaps by the innermost program span
open on the host at each gap's middle (``host`` where none is).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
if __name__ == "__main__":
    # as bench/run.py: the checkout's packages, and cuBLAS's fixed
    # workspace set before its first call
    sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
        p for p in sys.path if Path(p or ".").resolve() != BENCH]
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"

from bench import harness, trace  # noqa: E402

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

PROGRAM = ("serve.call", "serve.prefill", "decode.launch", "decode.sync",
           "train.step", "train.forward", "train.backward", "train.adamw",
           "train.attest")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
HOST_READERS = ("decode_step_ms.decode", "smr_host_ms.decode")


def _innermost(ranges: List[Tuple[int, int, str]], ts: List[int]
               ) -> List[str]:
    """The innermost of the nested ``ranges`` open at each of the sorted
    times ``ts`` (``host`` where none is)."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = [], [], 0
    for t in ts:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] < ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host")
    return out


def reduce(events, names=PROGRAM) -> Dict:
    """By span name of ``names`` (``by_name``): ``count``, ``device_s``,
    ``device_events``, ``syncs`` and ``sync_s`` (the host's seconds in
    them); ``idle_by_span``, seconds;
    ``syncs_by_op``, the syncs inside the spans by the innermost ``aten``
    operator that made them; and the number of device events in all."""
    launch: Dict[int, int] = {}
    ranges: Dict[str, List[Tuple[int, int]]] = {}
    ops: List[Tuple[int, int, str]] = []
    syncs: List[Tuple[int, int]] = []
    dev: List[Tuple[int, int, int]] = []
    lo = hi = None
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            a, b = e.start_ns(), e.end_ns()
            launch[e.correlation_id()] = a
            lo = a if lo is None else min(lo, a)
            hi = b if hi is None else max(hi, b)
            if name in names:
                ranges.setdefault(name, []).append((a, b))
            elif name in SYNCS:
                syncs.append((a, b))
            elif name.startswith("aten::"):
                ops.append((a, b, name))
        elif not (name.startswith("bench.") or name in names
                  or getattr(e, "is_user_annotation", lambda: False)()):
            dev.append((e.start_ns(), e.end_ns(), e.linked_correlation_id()))
    syncs.sort()
    by_name: Dict[str, Dict] = {}
    for name, iv in ranges.items():
        iv.sort()
        starts = [a for a, _ in iv]

        def inside(t: Optional[int]) -> bool:
            if t is None:
                return False
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= iv[i][1]

        charged = [b - a for a, b, corr in dev if inside(launch.get(corr))]
        waits = [b - a for a, b in syncs if inside(a)]
        by_name[name] = {"count": len(iv), "device_s": sum(charged) / 1e9,
                         "device_events": len(charged),
                         "syncs": len(waits), "sync_s": sum(waits) / 1e9}
    flat = [(a, b, n) for n, iv in ranges.items() for a, b in iv]
    idle: Dict[str, float] = {}
    busy = trace._merge([(a, b) for a, b, _ in dev])
    if busy:
        edges = [(lo, busy[0][0])] + [(busy[i][1], busy[i + 1][0])
                                      for i in range(len(busy) - 1)] \
            + [(busy[-1][1], hi)]
        gaps = [(a, b) for a, b in edges if b > a]
        for (a, b), name in zip(gaps, _innermost(
                flat, [(a + b) // 2 for a, b in gaps])):
            idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
    starts = [a for a, _ in syncs]
    in_span = [t for t, n in zip(starts, _innermost(flat, starts))
               if n != "host"]
    by_op: Dict[str, int] = {}
    for name in _innermost(ops, in_span):
        by_op[name] = by_op.get(name, 0) + 1
    return {"by_name": by_name, "idle_by_span": idle,
            "syncs_by_op": by_op, "device_events": len(dev)}


def host_ms(recs, split_ns: Optional[int]) -> Dict[str, Dict]:
    """By part (``traced``: spans started before ``split_ns``; ``rest``)
    and span name, the count and the mean host ms of the span records."""
    out: Dict[str, Dict] = {"traced": {}, "rest": {}}
    for r in recs:
        if r.end_ns < 0:
            continue
        part = "traced" if split_ns is not None and r.start_ns < split_ns \
            else "rest"
        c = out[part].setdefault(r.name, {"count": 0, "ms": 0.0})
        c["count"] += 1
        c["ms"] += (r.end_ns - r.start_ns) / 1e6
    for part in out.values():
        for c in part.values():
            c["ms"] /= c["count"]
    return out


def metrics(host: Dict, device: Optional[Dict]) -> Dict[str, float]:
    """``launch_share`` (the rest's ``decode.launch`` host time over its
    ``decode.launch`` and ``decode.sync``), and from the traced part's
    reduction ``launches_per_step`` and ``syncs_per_step`` (a decode step
    or a replica's train step) and ``adamw_ms`` (device ms of the kernels
    launched in ``train.adamw``, a replica step)."""
    out: Dict[str, float] = {}
    rest = host["rest"]
    if "decode.launch" in rest and "decode.sync" in rest:
        la = rest["decode.launch"]["ms"] * rest["decode.launch"]["count"]
        sy = rest["decode.sync"]["ms"] * rest["decode.sync"]["count"]
        out["launch_share"] = 100.0 * la / (la + sy)
    if not (device or {}).get("device_events"):
        return out                    # nothing ran on a device
    by = device["by_name"]
    step = by.get("decode.launch")
    if step and step["count"]:
        out["launches_per_step"] = step["device_events"] / step["count"]
        out["syncs_per_step"] = (step["syncs"] + by.get(
            "decode.sync", {"syncs": 0})["syncs"]) / step["count"]
    step = by.get("train.step")
    if step and step["count"]:
        out["syncs_per_step"] = step["syncs"] / step["count"]
    opt = by.get("train.adamw")
    if opt and opt["count"] and opt["device_s"]:
        out["adamw_ms"] = 1e3 * opt["device_s"] / opt["count"]
    return out


def cost_per_step(device: torch.device, n: int = 20000) -> Dict[str, float]:
    """Host µs of one decode step's two spans (``decode.launch``,
    ``decode.sync``): spans off, on, and on under a profiler of the host
    and the device.  Leaves spans off and their records empty."""
    from repro_torch.runtime import spans

    def loop() -> float:
        t = time.perf_counter_ns()
        for _ in range(n):
            with spans.span("decode.launch"):
                pass
            with spans.span("decode.sync"):
                pass
        return (time.perf_counter_ns() - t) / n / 1e3

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    out = {"off": loop()}
    spans.enable()
    out["on"] = loop()
    with profile(activities=acts):
        out["on_profiled"] = loop()
    spans.disable()
    spans.clear()
    return out


class SpanContext(harness.Context):
    """A run whose window has the program's spans on (``spans_on``)."""

    spans_on = False
    span_records: list = []

    def setup_done(self) -> None:
        super().setup_done()
        if self.spans_on:
            from repro_torch.runtime import spans
            spans.clear()
            spans.enable()

    def window_closed(self) -> None:
        if self.spans_on:
            from repro_torch.runtime import spans
            spans.disable()
            self.span_records = spans.records()
        super().window_closed()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the configuration's smoke widths (CPU tests)")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("program_spans: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1 if dev.type == "cuda" else 2)
    bench = harness.load_benchmark()
    ctx = SpanContext(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), dev, T_START, smoke=args.smoke)
    ctx.spans_on = bool(args.spans)
    stops: List[Tuple[int, Dict]] = []
    base = trace.reduce_events

    def reduce_events(events, window_s, top=10):
        # the profiler has stopped: later spans are the untraced rest
        events = list(events)
        stops.append((time.perf_counter_ns(), reduce(events)))
        return base(events, window_s, top)

    trace.reduce_events = reduce_events
    try:
        out = harness.run_cell(ctx)
    finally:
        trace.reduce_events = base
    split, device = stops[-1] if stops else (None, None)
    host = host_ms(ctx.span_records, split)
    got = metrics(host, device)
    for name in HOST_READERS:
        if name.endswith("." + ctx.cell["traffic"]):
            got[name] = harness.read_metric(name, ctx)
    out["spans"] = {"on": ctx.spans_on, "host": host, "device": device,
                    "metrics": got}
    if ctx.spans_on:
        out["spans"]["cost_us"] = cost_per_step(dev)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
