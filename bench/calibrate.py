"""Readings that the cells' limits are set from, many seeds in one
process: for each seed a run of the cell as ``run.py`` makes it, and
beside the program's numbers the control's (the reference in fp8 put in
the program's place) and, for a training cell, the planted half-batch
fault's, read against the same reference.  For a serving cell,
``--taus`` adds the share of checked tokens whose logit gap passes each
threshold, for the program and for the control (``gap_shares``), from
which a ``gap_share`` limit and its threshold are chosen.

  python bench/calibrate.py --workload <cell> --seeds 1,2,3 --seconds 51 \
      [--taus 0.2,0.3,0.4]

Prints one JSON line a seed.  Needs the card, as ``run.py`` does.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:] = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != BENCH]
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--taus", default="")
    args = ap.parse_args(argv)
    taus = [float(t) for t in args.taus.split(",") if t]

    import torch
    from bench import harness
    from bench.reference import serve as ref_serve

    # the gaps of every checked token, as the serving cell's check reads
    # them, kept for the shares at each threshold
    read: list = []
    gaps = ref_serve.gaps

    def keep_gaps(*a, **k):
        read.append(gaps(*a, **k))
        return read[-1]

    ref_serve.gaps = keep_gaps

    if not torch.cuda.is_available():
        print("bench: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    bench = harness.load_benchmark()
    dev = torch.device("cuda", 0)
    t = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(dev)
        ctx = harness.Context(bench, args.workload, seed, args.seconds, False,
                              dev, t, control=True)
        read.clear()
        out = harness.run_cell(ctx)
        line = {"seed": seed, "correct": out["correct"],
                "metrics": out["metrics"],
                "memory_peak_bytes": ctx.memory_peak,
                "attempted": out["attempted"],
                "checks": out["checks"], "info": ctx.info}
        if read and taus:
            got, ctrl, _ = read[-1]
            line["gap_shares"] = {
                str(t): {"program": ref_serve.gap_share(got, t),
                         "control": ref_serve.gap_share(ctrl, t)}
                for t in taus}
        print(json.dumps(line), flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
