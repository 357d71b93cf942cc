"""The three-term roofline over the dry-run's records, for the H100, ported
from ``benchmarks/roofline.py``.

For every record of ``launch.dryrun`` (``artifacts/dryrun_torch/*.json``,
per device, with the reference's keys), three lower bounds on a step's
time on one card of the mesh:

    compute    = FLOPs / PEAK_FLOPS
    memory     = bytes / HBM_BW
    collective = sum over mesh axes of link bytes on that axis / its link

and the step's bound, the largest of them.  MODEL_FLOPS is 6·N·D for a
train step, 2·N·D for a prefill and 2·N·B for a decode step (N_active
for MoE, as the reference counts it), from the port's
``launch.shapes.params_spec``; ``roofline_fraction`` is the model FLOPs a
device at the peak rate over the bound, the share of the card's peak
that the step could reach at its bound.

**Rates.**  ``PEAK_FLOPS`` and ``HBM_BW`` are NVIDIA's published figures
for the H100 SXM, 989 TFLOP/s dense bf16 and 3.35 TB/s: the pair that
``kernels/work.py`` holds and ``chip_smoke.py`` phase 12b divides a whole
call's counts by, so that the two shares agree.  Beside them, the
attainable line: the rates ``serve/costmodel.py`` carries, measured on
one H100 80GB HBM3 at a 700 W power limit by ``chip_smoke.py`` phase 12a
(716.1 TFLOP/s bf16 matmul, 3.009 TB/s copy), which give
``attainable_bound_s`` and ``attainable_fraction``.

**Links, per mesh axis** (published figures, each way, per H100):
NVLink 4 at 450 GB/s between the 8 cards of a node, NDR InfiniBand at
50 GB/s (one 400 Gb/s port a card) between nodes.  The mesh's ranks are
laid out row-major, (pod, data, model), over 8-card nodes, so a node
holds 8 consecutive ranks.  An axis whose groups stay inside one node
moves its bytes over NVLink; one whose groups span nodes is charged the
network, since a ring runs at the rate of its slowest hop.  On 16x16 and
2x16x16 no axis stays in a node: "model" (16 consecutive ranks) spans two
nodes and its ring crosses the network twice, "data" and "pod" (strides
16 and 256) put every member on its own node.  So every axis is charged
50 GB/s there, and NVLink carries only the hops inside a node, which do
not set a ring's rate.  The per-axis link bytes are the counter's
``total_link@<axis>`` keys; a record without them is charged
``total_link`` at the network's rate.

Writes ``artifacts/roofline_torch.json`` and ``.md`` and prints one row a
cell:
  PYTHONPATH=src python -m repro_torch.launch.roofline [--records DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.kernels.work import BF16_FLOPS, HBM_BYTES_S
from repro_torch.serve.costmodel import HBM_BW as MEASURED_HBM_BW
from repro_torch.serve.costmodel import PEAK_FLOPS as MEASURED_FLOPS

PEAK_FLOPS = BF16_FLOPS          # 989e12, NVIDIA's H100 SXM dense bf16
HBM_BW = HBM_BYTES_S             # 3.35e12, NVIDIA's H100 SXM HBM3
NVLINK_BW = 450e9                # NVLink 4, each way, per H100
NETWORK_BW = 50e9                # NDR InfiniBand 400 Gb/s, each way
NODE = 8                         # cards a node

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts"

_IMPROVE = {
    "compute": "cut recompute (the remat policy) and products run on "
               "every rank of an axis",
    "memory": "fuse the elementwise passes (norms, softmax, the loss, "
              "AdamW) that each read and write whole activations",
    "collective": "cut the bytes on the network axes: overlap the "
                  "weights' gathers with compute, keep the row-cut "
                  "reductions inside a node",
}


def mesh_of(name: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(dims, axis names) of a record's mesh: ``pod16x16``, ``pod2x16x16``
    or ``meshAxB[xC]`` (``dryrun --mesh-shape``)."""
    dims = tuple(int(d) for d in name.replace("pod", "").replace(
        "mesh", "").split("x"))
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return dims, axes


def axis_links(dims: Sequence[int], axes: Sequence[str],
               node: int = NODE, nvlink: float = NVLINK_BW,
               network: float = NETWORK_BW) -> Dict[str, Tuple[str, float]]:
    """Each axis's (link, bytes/s each way) with the ranks laid out
    row-major over nodes of ``node`` cards: NVLink where every group of
    the axis stays inside one node, the network where one spans nodes.
    "other" (a group of no single axis) is charged the network."""
    out = {}
    for i, axis in enumerate(axes):
        stride = math.prod(dims[i + 1:])
        span = (dims[i] - 1) * stride          # first to last member
        inside = all(r // node == (r + span) // node
                     for r in range(math.prod(dims))
                     if (r // stride) % dims[i] == 0)
        out[axis] = ("NVLink 4", nvlink) if inside else (
            "NDR InfiniBand", network)
    out["other"] = ("NDR InfiniBand", network)
    return out


def n_params(arch: str) -> Tuple[float, float]:
    """(N_total, N_active) of ``arch``'s full config, from the port's
    ``params_spec`` on fake tensors: the routed experts' stacked leaves
    (w_gate, w_up, w_down of four dimensions) count top_k / n_experts of
    their size in N_active, as the reference's ``_model_flops``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import fake_mode, params_spec
    cfg = get_config(arch)
    n_total = n_moe = 0
    for path, leaf in params_spec(cfg, "cpu", fake_mode()).leaf_items():
        size = math.prod(leaf.shape)
        n_total += size
        if path[-1] in ("w_gate", "w_up", "w_down") and leaf.ndim == 4:
            n_moe += size
    n_active = float(n_total)
    if cfg.moe is not None and n_moe:
        n_active = n_total - n_moe * (1.0 - cfg.moe.top_k / cfg.moe.n_experts)
    return float(n_total), n_active


def model_flops(arch: str, shape: str,
                n_active: Optional[float] = None) -> float:
    """6·N·D (train), 2·N·D (prefill), 2·N·B (decode: a token a sequence),
    N = N_active, D = batch × sequence."""
    from repro_torch.launch.shapes import SHAPES
    if n_active is None:
        n_active = n_params(arch)[1]
    sp = SHAPES[shape]
    if sp.kind == "train":
        return 6.0 * n_active * sp.batch * sp.seq
    if sp.kind == "prefill":
        return 2.0 * n_active * sp.batch * sp.seq
    return 2.0 * n_active * sp.batch


def row(rec: Dict, mf: float, peak: float = PEAK_FLOPS, hbm: float = HBM_BW,
        links: Optional[Dict[str, Tuple[str, float]]] = None,
        attainable: Tuple[float, float] = (MEASURED_FLOPS,
                                           MEASURED_HBM_BW)) -> Dict:
    """One record's roofline (``status`` ok) with model FLOPs ``mf``, at
    the rates given (``links``: each axis's (link, bytes/s); by default
    ``axis_links`` of the record's mesh)."""
    dims, axes = mesh_of(rec["mesh"])
    chips = math.prod(dims)
    links = links or axis_links(dims, axes)
    c = rec.get("corrected") or rec["raw"]
    coll = c["collectives"]
    by_axis = {a: coll[f"total_link@{a}"] for a in links
               if f"total_link@{a}" in coll}
    if not by_axis:
        by_axis = {"other": coll.get("total_link", 0.0)}
    t_coll_axes = {a: b / links[a][1] for a, b in by_axis.items()}
    t_comp = c["flops"] / peak
    t_mem = c["bytes"] / hbm
    t_coll = sum(t_coll_axes.values())
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dom = max(terms, key=terms.get)
    bound = max(terms.values())
    att = max(c["flops"] / attainable[0], c["bytes"] / attainable[1], t_coll)
    hlo_global = c["flops"] * chips
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "status": "ok", "compute_s": t_comp, "memory_s": t_mem,
        "collective_s": t_coll,
        "collective_s_by_axis": t_coll_axes,
        "links": {a: {"link": links[a][0], "bytes_s": links[a][1]}
                  for a in by_axis},
        "dominant": dom, "bound_s": bound,
        "model_flops": mf, "hlo_flops_global": hlo_global,
        "useful_ratio": mf / hlo_global if hlo_global else 0.0,
        "roofline_fraction": (mf / chips / peak) / bound if bound > 0
        else 0.0,
        "attainable_bound_s": att,
        "attainable_fraction": (mf / chips / attainable[0]) / att if att > 0
        else 0.0,
        "hbm_fit": rec["memory"]["total_hbm_bytes"] < 80e9,
        "note": _IMPROVE[dom],
    }


def run(records: Path = ARTIFACTS / "dryrun_torch",
        out: Path = ARTIFACTS) -> Dict:
    rows: List[Dict] = []
    n_active: Dict[str, float] = {}
    for path in sorted(glob.glob(os.path.join(records, "*.json"))):
        with open(path) as f:
            r = json.load(f)
        if r.get("status") != "ok":
            rows.append({"arch": r["arch"], "shape": r["shape"],
                         "mesh": r["mesh"], "status": r.get("status"),
                         "note": str(r.get("reason") or r.get("error", ""))
                         [:90]})
            continue
        if r["arch"] not in n_active:
            n_active[r["arch"]] = n_params(r["arch"])[1]
        rows.append(row(r, model_flops(r["arch"], r["shape"],
                                       n_active[r["arch"]])))
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "roofline_torch.json", "w") as f:
        json.dump(rows, f, indent=1)
    with open(out / "roofline_torch.md", "w") as f:
        f.write(markdown(rows))
    for r in rows:
        tag = f"roofline.{r['arch']}.{r['shape']}.{r['mesh']}"
        if r["status"] != "ok":
            print(f"{tag},0,{r['status']}:{r['note']}")
            continue
        print(f"{tag},{r['bound_s'] * 1e6:.1f},dom={r['dominant']};"
              f"frac={r['roofline_fraction']:.3f};"
              f"attainable={r['attainable_fraction']:.3f};"
              f"useful={r['useful_ratio']:.2f};"
              f"fit80={'yes' if r['hbm_fit'] else 'no'}")
    return {"rows": rows}


def markdown(rows: List[Dict]) -> str:
    head = ("| arch | shape | mesh | compute s | memory s | collective s "
            "(by axis) | dominant | roofline fraction | attainable | useful "
            "| fits 80 GB |\n| --- | --- | --- | --- | --- | --- | --- | --- "
            "| --- | --- | --- |\n")
    lines = []
    for r in rows:
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                         f"{r['status']}: {r['note']} | | | | | | | |")
            continue
        axes = ", ".join(f"{a} {t:.3g}" for a, t in
                         r["collective_s_by_axis"].items())
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r['compute_s']:.4g} | {r['memory_s']:.4g} | "
            f"{r['collective_s']:.4g} ({axes}) | {r['dominant']} | "
            f"{r['roofline_fraction']:.3f} | {r['attainable_fraction']:.3f} | "
            f"{r['useful_ratio']:.2f} | {'yes' if r['hbm_fit'] else 'no'} |")
    return head + "\n".join(lines) + "\n"


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", default=str(ARTIFACTS / "dryrun_torch"))
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    run(Path(args.records), Path(args.out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
