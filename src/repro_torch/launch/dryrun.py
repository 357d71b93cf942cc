"""The multi-pod dry-run, ported from ``repro.launch.dryrun``.

For every (architecture x input shape x mesh) cell, one step
(``make_train_step``, ``make_prefill`` or ``make_serve_step``) runs on
fake tensors (``launch.shapes``) laid out by the port's sharding rules on
the 16x16 single-pod or 2x16x16 multi-pod mesh of a fake process group of
256 or 512 ranks, as rank 0, under the costing's counter
(``launch.costing``).  It records this device's memory, FLOPs, bytes and
collectives into ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``
with the reference's keys (``status``, ``reason``, ``memory``, ``raw``,
``corrected``; ``trace_s`` in place of ``lower_s``/``compile_s``).  Nothing
is computed or allocated: the counts come from shapes.  On a mesh,
``whole_over_model`` counts by site what the sharded program ran whole on
every "model" rank because a size does not divide that axis
(``sharding.count_whole``), and ``reason`` names those sites: such a
cell's per-device counts hold work the rules would cut.

``raw`` is what one trace counted, at the length it traced (``seq``).  It
is exact: eager PyTorch runs every iteration of every loop, so no loop
body is counted once and there is nothing to correct, and ``corrected``
equals ``raw``.  The one exception is time: an arch with sLSTM layers runs
the sLSTM's Python loop over time, millions of operators at 32k tokens.
Its train and prefill cells are traced at two, four and eight
``mlstm_chunk``s, and every count is extrapolated to the cell's length
through the longer two (``corrected``, ``fit_seq``) and checked at the
shortest (the record's ``fit_check``).  The arithmetic of such an arch
(no attention) is affine in S, and on one device so is every count.  On
a mesh too, since the sharded products, attention and scans run on local
shards in layouts that do not change with S; should a layout left to
DTensor change with S, the check is not exact, the cell is traced again
at full length, and ``corrected`` is that trace's exact count
(``reason`` says how far off the check was).  ``--no-correct`` traces
such cells at full length without the fit.

``--device cuda`` (the default) makes fake CUDA tensors.  A train cell
runs autograd, whose engine needs a CUDA build even for fake CUDA tensors;
``--device cpu`` makes fake CPU tensors, which a CPU-only build traces
whole, and counts the same: the kernels' operators and AdamW take the
card's path on fake tensors, and DTensor's all-to-all is kept on a CPU
mesh (``_dtensor_as_run``).  A CPU-only build also cannot index a
DTensor of fake CUDA tensors, so it traces every cell with ``--device
cpu``; the artifact names its device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \
      --shape train_4k --mesh single [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch import costing
from repro_torch.launch.shapes import (SHAPES, ShapeSpec, cell_runnable,
                                       fake_mode, input_specs, opt_spec,
                                       params_spec)
from repro_torch.models.common import ModelConfig

ARTIFACTS = (Path(__file__).resolve().parents[3] / "artifacts"
             / "dryrun_torch")
MESHES = {False: ("pod16x16", (16, 16), ("data", "model")),
          True: ("pod2x16x16", (2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_world(size: int) -> Iterator[None]:
    """A fake process group of ``size`` ranks, this process rank 0: its
    collectives complete at once and move nothing.  Destroyed on exit,
    also on error."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape: Sequence[int], axes: Sequence[str], device: str):
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    if tuple(shape) == (16, 16) and tuple(axes) == ("data", "model"):
        return make_production_mesh(multi_pod=False, device_type=device)
    if tuple(shape) == (2, 16, 16):
        return make_production_mesh(multi_pod=True, device_type=device)
    return make_mesh(shape, axes, device)


def _dtensor_as_run(mesh) -> contextlib.ExitStack:
    """DTensor traced as it runs on the card, on fake tensors:

    * DTensor takes a fake mode for a compiler's trace (``_are_we_tracing``)
      and then bypasses its caches of sharding decisions and issues its
      collectives as in a graph; it is told that nothing compiles.
    * It works out a strided shard's indices with tensors and reads them
      back (``_StridedShard.local_shard_size_and_offset``), which a fake
      tensor cannot; that arithmetic runs outside the fake and counting
      modes, once for each set of arguments (its redistribution search
      asks again and again, at the sizes of whole activations).
    * On a CPU mesh it swaps its all-to-all for an all-gather and a chunk
      (gloo has none); the card's all-to-all operator is issued instead
      (the fake process group moves nothing either way).
    """
    import sys

    from torch.distributed import _functional_collectives
    from torch.distributed.tensor import placement_types

    from repro_torch.kernels.ops import host_side

    stack = contextlib.ExitStack()
    tracing = _functional_collectives._are_we_tracing
    for m in list(sys.modules.values()):
        if (getattr(m, "__name__", "").startswith("torch.distributed")
                and getattr(m, "_are_we_tracing", None) is tracing):
            stack.enter_context(costing.patched(m, "_are_we_tracing",
                                                lambda: False))

    strided = getattr(placement_types, "_StridedShard", None)
    offsets = getattr(strided, "local_shard_size_and_offset", None)
    if offsets is not None:
        known: Dict[Any, Any] = {}

        def outside(self, *args, **kwargs):
            key = (self, args, tuple(sorted(kwargs.items())))
            if key not in known:
                with host_side():
                    known[key] = offsets(self, *args, **kwargs)
            size, offset = known[key]
            return size, list(offset) if isinstance(offset, list) else offset

        stack.enter_context(costing.patched(
            strided, "local_shard_size_and_offset", outside))

    if mesh is not None and mesh.device_type == "cpu":
        def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
            return torch.ops._dtensor.shard_dim_alltoall(
                input, gather_dim, shard_dim,
                mesh.get_group(mesh_dim).group_name)

        stack.enter_context(costing.patched(
            placement_types, "shard_dim_alltoall", alltoall))
    return stack


def _has_slstm(cfg: ModelConfig) -> bool:
    return any(s.kind == "slstm" for s in cfg.layer_list())


def _placed(cfg: ModelConfig, shape: ShapeSpec, mesh, device: str, mode
            ) -> Tuple[Any, Tuple, Any]:
    """(step, its arguments, the arguments' tree for their bytes): the
    model, optimizer state, batch and caches as fake tensors, laid out on
    ``mesh`` (None: one unsharded device)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel import sharding
    from repro_torch.runtime.steps import (make_prefill, make_serve_step,
                                           make_train_step)
    ctx = None if mesh is None else sharding.shard_ctx_for_mesh(mesh)
    with mode:
        model = params_spec(cfg, device)
        data = input_specs(cfg, shape, device)
        if mesh is not None:
            sharding.distribute_tree(mesh, model,
                                     sharding.param_pspecs(cfg, model, mesh))
            dp = sharding.dp_axes(mesh)

            def batch_cut(x):
                spec = sharding._divisible((dp,), tuple(x.shape), mesh)
                return sharding.place(x, mesh, spec)

            for k in ("inputs", "targets", "tokens"):
                if k in data:
                    data[k] = batch_cut(data[k])
            if "caches" in data:
                data["caches"] = sharding.distribute_tree(
                    mesh, data["caches"],
                    sharding.cache_pspecs(cfg, data["caches"], mesh))
        if shape.kind == "train":
            opt = opt_spec(cfg, model)
            batch = {k: data[k] for k in ("inputs", "targets")}
            step = make_train_step(cfg, AdamWConfig(), ctx)
            return step, (model, opt, batch), (list(model.param_leaves()),
                                               opt, batch)
        if shape.kind == "prefill":
            step = make_prefill(cfg, ctx, max_seq=shape.seq)
            return step, (model, data["inputs"]), (
                list(model.param_leaves()), data["inputs"])
        step = make_serve_step(cfg, ctx)
        args = (model, data["caches"], data["tokens"], data["position"])
        return step, args, (list(model.param_leaves()), data["caches"],
                            data["tokens"])


def trace(cfg: ModelConfig, shape: ShapeSpec, mesh=None,
          device: str = "cuda") -> Dict[str, Any]:
    """One step of ``cfg`` at ``shape`` traced on fake tensors on ``mesh``
    (a ``DeviceMesh`` of the open fake process group; None: one unsharded
    device): this device's counts and memory."""
    from repro_torch.parallel import sharding
    mode = fake_mode()
    step, args, held = _placed(cfg, shape, mesh, device, mode)
    t0 = time.perf_counter()
    with mode, _dtensor_as_run(mesh), sharding.count_whole() as whole:
        _, counter = costing.count(step, *args,
                                   axes=costing.mesh_axes(mesh))
    trace_s = time.perf_counter() - t0
    return {"seq": shape.seq, "trace_s": trace_s,
            "whole_over_model": dict(whole),
            "flops": counter.flops, "bytes": counter.bytes,
            "collectives": dict(counter.coll),
            "kernels": dict(counter.kernels),
            "flops_by_op": dict(counter.flops_by_op),
            "memory": costing.memory(counter, costing.local_bytes(held))}


def fit_lengths(cfg: ModelConfig) -> Tuple[int, int, int]:
    """The lengths an sLSTM arch is traced at: two, four and eight chunks.
    A step's costs are affine in the number of chunks from two on (with
    one, no gradient crosses the mLSTM state between chunks), and the
    lengths stay powers of two times the chunk, as the cells' are."""
    c = cfg.mlstm_chunk
    return 2 * c, 4 * c, 8 * c


def fit(cfg: ModelConfig, shape: ShapeSpec, mesh=None,
        device: str = "cuda") -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(the trace at the longest fit length, the counts extrapolated to
    ``shape.seq``) for an arch with sLSTM layers (it has no attention:
    checked): each count taken as affine in S through the traces at the
    two longer ``fit_lengths``, and checked at the shortest.  On a mesh
    the premise holds while no layout changes with S; ``fit_check`` holds
    each count's deviation there, 0 where it holds."""
    if any(s.kind == "attn" for s in cfg.layer_list()):
        raise ValueError(f"{cfg.name}: an attention layer's cost is not "
                         f"affine in S; the fit does not hold")
    s0, s1, s2 = fit_lengths(cfg)
    r0, r1, r2 = (trace(cfg, dataclasses.replace(shape, seq=s), mesh, device)
                  for s in (s0, s1, s2))

    def at(a: float, b: float, S: int) -> float:
        # exact for integer counts: the product before the division
        return a + (b - a) * (S - s1) / (s2 - s1)

    S = shape.seq
    fitted = {"seq": S, "fit_seq": [s0, s1, s2],
              "trace_s": r0["trace_s"] + r1["trace_s"] + r2["trace_s"],
              "whole_over_model": r2["whole_over_model"],
              "flops": at(r1["flops"], r2["flops"], S),
              "bytes": at(r1["bytes"], r2["bytes"], S),
              "collectives": {k: at(r1["collectives"][k],
                                    r2["collectives"][k], S)
                              for k in r1["collectives"]},
              "kernels": {k: at(r1["kernels"].get(k, 0), v, S)
                          for k, v in r2["kernels"].items()},
              "flops_by_op": {k: at(r1["flops_by_op"].get(k, 0), v, S)
                              for k, v in r2["flops_by_op"].items()},
              "memory": {k: at(r1["memory"][k], r2["memory"][k], S)
                         for k in r1["memory"]}}

    def deviation(a: float, b: float, want: float) -> float:
        got = at(a, b, s0)
        return abs(got - want) / max(abs(want), 1.0)

    check = {k: deviation(r1[k], r2[k], r0[k]) for k in ("flops", "bytes")}
    check["collectives"] = deviation(r1["collectives"]["total"],
                                     r2["collectives"]["total"],
                                     r0["collectives"]["total"])
    fitted["fit_check"] = {"seq": s0, "deviation": check}
    return r2, fitted


def _record(r: Dict[str, Any]) -> Dict[str, Any]:
    keys = ("flops", "bytes", "collectives", "kernels", "flops_by_op", "seq",
            "fit_seq", "whole_over_model")
    return {k: r[k] for k in keys if k in r}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             correct: bool = True, cfg: Optional[ModelConfig] = None,
             save: bool = True, device: str = "cuda",
             mesh_shape: Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]]
             = None, shape: Optional[ShapeSpec] = None,
             out_dir: Path = ARTIFACTS) -> Dict[str, Any]:
    """One cell on a fake process group opened for it (``mesh_shape`` =
    (shape, axes) replaces the production mesh, ``shape`` the named
    shape: both for small runs)."""
    shape = shape or SHAPES[shape_name]
    ok, why = cell_runnable(arch, shape_name)
    mesh_name, dims, axes = MESHES[multi_pod]
    if mesh_shape is not None:
        dims, axes = mesh_shape
        mesh_name = "mesh" + "x".join(map(str, dims))
    out: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "device": device,
                           "status": "skipped", "reason": why}
    if not ok:
        return _save(out, out_dir) if save else out
    cfg = cfg or get_config(arch)
    check = None
    with fake_world(math.prod(dims)):
        mesh = _mesh(dims, axes, device)
        if correct and shape.kind != "decode" and _has_slstm(cfg) \
                and shape.seq > fit_lengths(cfg)[2]:
            raw, corr = fit(cfg, shape, mesh, device)
            check = corr["fit_check"]
        if check is None or any(check["deviation"].values()):
            raw = corr = trace(cfg, shape, mesh, device)
    notes = []
    if device == "cpu":
        notes.append("traced on fake CPU tensors: the counts of a CUDA "
                     "trace (shapes alone), on a CPU-only build")
    if check is not None and corr is raw:
        dev = check["deviation"]
        worst = max(dev, key=dev.get)
        notes.append(f"fit not exact: the trace at {check['seq']} tokens is "
                     f"{dev[worst]:.1%} off the line through the longer two "
                     f"in {worst} (DTensor's layouts change with S), so the "
                     f"cell was traced at full length")
    whole = corr["whole_over_model"]
    if whole:
        notes.append("run whole on every \"model\" rank, a size not dividing "
                     "it: " + ", ".join(f"{k} x{v}" for k, v in
                                        sorted(whole.items())))
    out.update({"status": "ok", "reason": "; ".join(notes),
                "trace_s": round(corr["trace_s"], 1),
                "memory": corr["memory"], "raw": _record(raw),
                "corrected": _record(corr)})
    if check is not None:
        out["fit_check"] = check
    return _save(out, out_dir) if save else out


def _save(out: Dict[str, Any], out_dir: Path) -> Dict[str, Any]:
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = f"{out['arch']}__{out['shape']}__{out['mesh']}.json"
    with open(out_dir / fname, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-correct", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's smoke config (tests)")
    ap.add_argument("--mesh-shape", default=None,
                    help="e.g. 2,4 (data, model) or 2,2,2 (pod, data, "
                         "model) in place of the production mesh (tests)")
    ap.add_argument("--seq", type=int, default=None,
                    help="the shape's sequence length replaced (tests)")
    ap.add_argument("--batch", type=int, default=None,
                    help="the shape's global batch replaced (tests)")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)

    archs = list_archs() if args.all or not args.arch else [args.arch]
    shapes = list(SHAPES) if args.all or not args.shape else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    mesh_shape = None
    if args.mesh_shape:
        dims = tuple(int(d) for d in args.mesh_shape.split(","))
        axes = ("data", "model") if len(dims) == 2 else ("pod", "data",
                                                         "model")
        mesh_shape, meshes = (dims, axes), [False]
    out_dir = Path(args.out)

    results, failed = [], 0
    for arch in archs:
        cfg = get_smoke_config(arch) if args.smoke else None
        for shape_name in shapes:
            shape = SHAPES[shape_name]
            if args.seq or args.batch:
                shape = dataclasses.replace(shape, seq=args.seq or shape.seq,
                                            batch=args.batch or shape.batch)
            for mp in meshes:
                mesh_name = MESHES[mp][0]
                if mesh_shape is not None:
                    mesh_name = "mesh" + "x".join(map(str, mesh_shape[0]))
                fname = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
                if args.skip_existing and fname.exists():
                    prev = json.loads(fname.read_text())
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[skip] {arch} {shape_name} {mesh_name} "
                              f"(cached)")
                        continue
                tag = f"{arch} {shape_name} {mesh_name}"
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    r = run_cell(arch, shape_name, mp,
                                 correct=not args.no_correct, cfg=cfg,
                                 device=args.device, mesh_shape=mesh_shape,
                                 shape=shape, out_dir=out_dir)
                    print(f"[done] {tag}: {r['status']} "
                          f"trace={r.get('trace_s')}s", flush=True)
                    results.append(r)
                except Exception as e:
                    traceback.print_exc()
                    failed += 1
                    _save({"arch": arch, "shape": shape_name,
                           "mesh": mesh_name, "device": args.device,
                           "status": "error", "error": str(e)[:2000]},
                          out_dir)
                    print(f"[FAIL] {tag}: {e}", flush=True)
    ok = sum(1 for r in results if r["status"] == "ok")
    skipped = sum(1 for r in results if r["status"] == "skipped")
    print(f"\n{ok} cells ok, {skipped} skipped, {failed} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
