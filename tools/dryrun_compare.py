"""The JAX package's dry-run beside the port's, cell by cell.

  PYTHONPATH=src python tools/dryrun_compare.py --arch qwen3-8b \
      --shape train_4k [--mesh single|multi] [--no-jax]

Runs the reference's ``repro.launch.dryrun.run_cell`` on the production
mesh with its axes of type ``Auto`` (this JAX makes ``Explicit`` axes by
default, on which the reference's ``with_sharding_constraint`` calls
fail), and prints its per-device numbers (corrected FLOPs, bytes,
collective bytes; compiled memory) beside the port's record of the same
cell in ``artifacts/dryrun_torch`` (``python -m
repro_torch.launch.dryrun``).  The reference writes its record to
``artifacts/dryrun``.  Imports JAX and the reference: a tool beside the
port, not a part of it.
"""

from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=512").strip()

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def jax_cell(arch: str, shape: str, multi: bool) -> dict:
    import jax
    from jax.sharding import AxisType

    from repro.launch import dryrun

    def auto_mesh(*, multi_pod: bool = False):
        dims = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        return jax.make_mesh(dims, axes,
                             axis_types=(AxisType.Auto,) * len(dims))

    dryrun.make_production_mesh = auto_mesh
    return dryrun.run_cell(arch, shape, multi)


def row(name: str, rec: dict) -> str:
    c = rec.get("corrected") or rec["raw"]
    coll = c["collectives"]
    kinds = ", ".join(f"{k} {coll[k] / 1e9:.3f}" for k in
                      ("all-reduce", "all-gather", "reduce-scatter",
                       "all-to-all", "collective-permute") if coll.get(k))
    mem = rec["memory"]
    return (f"{name}: {c['flops'] / 1e12:.2f} TFLOPs, {c['bytes'] / 1e9:.1f} "
            f"GB moved, collectives {coll['total'] / 1e9:.3f} GB ({kinds}); "
            f"memory {mem['total_hbm_bytes'] / 1e9:.2f} GB "
            f"(arguments {mem['argument_size_in_bytes'] / 1e9:.3f} GB, temp "
            f"{mem['temp_size_in_bytes'] / 1e9:.2f} GB)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--no-jax", action="store_true",
                    help="read the reference's record instead of running it")
    args = ap.parse_args()
    multi = args.mesh == "multi"
    mesh = "pod2x16x16" if multi else "pod16x16"
    fname = f"{args.arch}__{args.shape}__{mesh}.json"
    if args.no_jax:
        jrec = json.loads((ROOT / "artifacts" / "dryrun" / fname).read_text())
    else:
        jrec = jax_cell(args.arch, args.shape, multi)
    trec = json.loads((ROOT / "artifacts" / "dryrun_torch" / fname)
                      .read_text())
    print(f"{args.arch} {args.shape} {mesh}, per device")
    print(row("  JAX (XLA, compiled)", jrec))
    print(row("  port (counted)     ", trec))
    jc, tc = (r.get("corrected") or r["raw"] for r in (jrec, trec))
    print(f"  port / JAX: FLOPs {tc['flops'] / jc['flops']:.3f}, bytes "
          f"{tc['bytes'] / jc['bytes']:.3f}, collectives "
          f"{tc['collectives']['total'] / max(jc['collectives']['total'], 1):.3f}"
          f", memory {trec['memory']['total_hbm_bytes'] / jrec['memory']['total_hbm_bytes']:.3f}")


if __name__ == "__main__":
    main()
