"""The collectives of one dry-run cell, the JAX package's compiled program
beside the port's traced one, each by kind, mesh axis and operand size.

  PYTHONPATH=src python tools/dryrun_collectives.py --arch qwen3-8b \
      --shape train_4k [--layers 1] [--mesh single|multi]

Both run the arch's full-width config cut to its first ``--layers``
layers (one repetition of the first group's pattern, so that no layer
scan hides a collective in a loop body) at the cell's shape on the
production mesh: the reference compiled by XLA on a mesh of ``Auto``
axes (as ``tools/dryrun_compare.py`` runs it), its collectives read from
the post-SPMD HLO, each group's mesh axis found from its devices' mesh
coordinates; the port traced on fake tensors by ``launch.dryrun`` under
the costing's counter, each collective's axis from its process group.
Prints one line per (kind, axis, operand bytes) with its count, for each,
and the totals by kind and axis.  A tool beside the port: it imports JAX
and the reference.
"""

from __future__ import annotations

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=512").strip()

import argparse  # noqa: E402
import collections  # noqa: E402
import dataclasses  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
from typing import Dict, List, Tuple  # noqa: E402

import numpy as np  # noqa: E402

Row = Tuple[str, str, float]      # kind, axis, operand bytes

_OP = re.compile(r"=\s*(.*?)\s*(all-reduce|all-gather|reduce-scatter|"
                 r"all-to-all|collective-permute)(-start)?\(")
_SHAPE = re.compile(r"\b(pred|[sub]\d+|bf16|f16|f32|f64)\[([\d,]*)\]")
_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
          "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
          "f64": 8}


def cut(cfg, layers: int):
    """``cfg`` cut to its first ``layers`` layers, one repetition of the
    first group's pattern."""
    pattern = cfg.blocks[0][0][:layers]
    return dataclasses.replace(cfg, n_layers=len(pattern),
                               blocks=((pattern, 1),))


def _groups(line: str, n: int) -> List[List[int]]:
    """The replica groups of an HLO collective: the iota form
    ``[g,s]<=[dims]T(perm)`` or the explicit ``{{...},...}``."""
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\]"
                  r"(?:T\(([\d,]+)\))?", line)
    if m:
        g, s = int(m.group(1)), int(m.group(2))
        dims = [int(d) for d in m.group(3).split(",")]
        ids = np.arange(math.prod(dims)).reshape(dims)
        if m.group(4):
            ids = ids.transpose([int(p) for p in m.group(4).split(",")])
        return ids.reshape(g, s).tolist()
    m = re.search(r"replica_groups=\{(\{[\d,{}]*\})\}", line)
    if m:
        return [[int(d) for d in grp.split(",") if d]
                for grp in re.findall(r"\{([\d,]*)\}", m.group(1))]
    return [list(range(n))]


def _axis(groups: List[List[int]], coords: Dict[int, Tuple[int, ...]],
          names: Tuple[str, ...]) -> str:
    """The mesh axes along which a group's devices differ, joined by
    '+'; 'none' for groups of one device."""
    grp = groups[0]
    varying = [names[i] for i in range(len(names))
               if len({coords[d][i] for d in grp}) > 1]
    return "+".join(varying) or "none"


def _operand(kind: str, result: float, size: int) -> float:
    if kind == "all-gather":
        return result / size
    if kind == "reduce-scatter":
        return result * size
    return result


def jax_rows(arch: str, shape: str, layers: int, multi: bool) -> List[Row]:
    import jax
    from jax.sharding import AxisType, NamedSharding, PartitionSpec as P

    from repro.configs import get_config
    from repro.launch.shapes import SHAPES, input_specs, opt_spec, params_spec
    from repro.optim.adamw import opt_pspecs
    from repro.parallel.sharding import (batch_pspecs, param_pspecs,
                                         shard_ctx_for_mesh)
    from repro.runtime.steps import make_prefill, make_train_step

    dims = (2, 16, 16) if multi else (16, 16)
    names = ("pod", "data", "model") if multi else ("data", "model")
    mesh = jax.make_mesh(dims, names, axis_types=(AxisType.Auto,) * len(dims))
    coords = {int(d.id): c for c, d in np.ndenumerate(mesh.devices)}
    cfg = cut(get_config(arch), layers)
    ctx = shard_ctx_for_mesh(mesh)
    sp = SHAPES[shape]

    def named(tree):
        return jax.tree.map(lambda s: NamedSharding(mesh, s), tree,
                            is_leaf=lambda x: isinstance(x, P))

    ps = params_spec(cfg)
    pspecs = param_pspecs(cfg, ps, mesh)
    if sp.kind == "train":
        jitted = jax.jit(make_train_step(cfg, ctx), in_shardings=(
            named(pspecs), named(opt_pspecs(pspecs)),
            named(batch_pspecs(cfg, mesh))))
        lowered = jitted.lower(ps, opt_spec(cfg, ps), input_specs(cfg, sp))
    elif sp.kind == "prefill":
        jitted = jax.jit(make_prefill(cfg, ctx, max_seq=sp.seq),
                         in_shardings=(named(pspecs),
                                       NamedSharding(mesh, P(ctx.dp_axes))))
        lowered = jitted.lower(ps, input_specs(cfg, sp)["inputs"])
    else:
        raise SystemExit("train and prefill cells only")
    text = lowered.compile().as_text()
    rows = []
    for line in text.splitlines():
        line = line.strip()
        m = _OP.search(line)
        if m is None or "-done(" in line:
            continue
        kind = m.group(2)
        result = float(sum(math.prod(int(d) for d in s.split(",") if d)
                           * _BYTES.get(t, 4)
                           for t, s in _SHAPE.findall(m.group(1))))
        if kind == "collective-permute":
            rows.append((kind, "pairs", result))
            continue
        groups = _groups(line, len(coords))
        rows.append((kind, _axis(groups, coords, names),
                     _operand(kind, result, len(groups[0]))))
    return rows


def port_rows(arch: str, shape: str, layers: int, multi: bool) -> List[Row]:
    from repro_torch.configs import get_config
    from repro_torch.launch import costing, dryrun
    from repro_torch.launch.shapes import SHAPES

    rows: List[Row] = []

    class Logged(costing.Counter):
        def _collective(self, kind, func, args, out):
            before = {k: v for k, v in self.coll.items() if "@" in k}
            super()._collective(kind, func, args, out)
            axis = next(k.split("@")[1] for k, v in self.coll.items()
                        if k.startswith("total@") and v != before[k])
            rows.append((kind, axis, self.coll["total@" + axis]
                         - before["total@" + axis]))

    costing.Counter = Logged
    try:
        name, dims, axes = dryrun.MESHES[multi]
        with dryrun.fake_world(math.prod(dims)):
            mesh = dryrun._mesh(dims, axes, "cpu")
            dryrun.trace(cut(get_config(arch), layers), SHAPES[shape], mesh,
                         "cpu")
    finally:
        costing.Counter = Logged.__mro__[1]
    return rows


def report(title: str, rows: List[Row]) -> None:
    print(title)
    each = collections.Counter(rows)
    for (kind, axis, op), n in sorted(each.items()):
        print(f"  {kind:18s} {axis:12s} {op / 1e6:12.3f} MB x{n}")
    tot: Dict[Tuple[str, str], List[float]] = {}
    for kind, axis, op in rows:
        t = tot.setdefault((kind, axis), [0, 0.0])
        t[0] += 1
        t[1] += op
    print("  totals:")
    for (kind, axis), (n, op) in sorted(tot.items()):
        print(f"    {kind:18s} {axis:12s} {n:4d} calls {op / 1e9:10.3f} GB")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    args = ap.parse_args()
    multi = args.mesh == "multi"
    print(f"{args.arch} {args.shape}, first {args.layers} layer(s), "
          f"{'2x16x16' if multi else '16x16'}, per device, operand bytes")
    report("JAX (XLA, compiled, Auto axes):",
           jax_rows(args.arch, args.shape, args.layers, multi))
    report("port (traced):",
           port_rows(args.arch, args.shape, args.layers, multi))


if __name__ == "__main__":
    main()
