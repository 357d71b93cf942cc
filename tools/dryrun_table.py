"""The port's dry-run records as one markdown table, a row an arch and
shape, each number given as "single pod ; multi-pod".

  PYTHONPATH=src python tools/dryrun_table.py [artifacts/dryrun_torch]

Per device: peak and argument GB (``memory``), TFLOPs and TB moved
(``corrected``), collective operand GB by kind (all-reduce, all-gather,
reduce-scatter, all-to-all, collective-permute), and the trace's seconds.
``*`` marks a count extrapolated by an exact fit.  Skipped cells, cells
that failed or are missing ("…"; a fit whose check is not exact ends
``error``) are listed after the table.  Counts from shapes: nothing in
them was measured on a device.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("pod16x16", "pod2x16x16")


def _numbers(r: dict) -> dict:
    c, m = r["corrected"], r["memory"]
    fit = "*" if "fit_seq" in c else ""
    return {"peak": f"{m['total_hbm_bytes'] / 1e9:.4g}",
            "args": f"{m['argument_size_in_bytes'] / 1e9:.3g}",
            "tflops": f"{c['flops'] / 1e12:.4g}{fit}",
            "tb": f"{c['bytes'] / 1e12:.3g}",
            "coll": "/".join(f"{c['collectives'][k] / 1e9:.3g}"
                             for k in KINDS),
            "s": f"{r['trace_s']:.0f}"}


def main() -> None:
    root = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parents[1] / "artifacts"
                / "dryrun_torch")
    recs = {}
    for p in root.glob("*.json"):
        r = json.loads(p.read_text())
        recs[r["arch"], r["shape"], r["mesh"]] = r
    counts, other = {}, []
    print("| arch, shape | peak GB | args GB | TFLOPs | TB moved | "
          "coll. GB AR/AG/RS/A2A/CP | trace s |")
    print("| --- | --- | --- | --- | --- | --- | --- |")
    for arch in sorted({k[0] for k in recs}):
        for shape in SHAPES:
            pair = [recs.get((arch, shape, m)) for m in MESHES]
            for r in pair:
                if r is not None:
                    counts[r["status"]] = counts.get(r["status"], 0) + 1
            bad = [(m, r) for m, r in zip(MESHES, pair)
                   if r is None or r["status"] != "ok"]
            other += [f"{arch} {shape} {m}: "
                      f"{r['status'] if r else 'missing'}"
                      + (f" ({r.get('reason') or r.get('error', '')})"
                         if r and r["status"] == "error" else "")
                      for m, r in bad]
            if len(bad) == 2:
                continue
            a, b = (_numbers(r) if r is not None and r["status"] == "ok"
                    else dict.fromkeys(("peak", "args", "tflops", "tb",
                                        "coll", "s"), "…")
                    for r in pair)
            cols = " | ".join(f"{a[k]} ; {b[k]}" for k in a)
            print(f"| {arch} `{shape}` | {cols} |")
    print()
    print(f"{counts}; " + "; ".join(other))


if __name__ == "__main__":
    main()
