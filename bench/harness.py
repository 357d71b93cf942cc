"""The harness: finds a cell's configuration, traffic mix, metrics and
limits by their names in ``BENCHMARK.json``, runs the cell (``drive_serve``
or ``drive_train``, by the mix's ``kind``), and builds the result line.

Files found by name, each a file of its own:

* ``configs/<config>.json``: the configuration as run (the port's model
  fields under ``model``; ``smoke`` holds the tiny widths the CPU tests
  use); its layers as ``blocks``, ``[[[<layer>, ...], <reps>], ...]``,
  a layer a kind or an object of the program's ``LayerSpec`` fields, or
  as ``pattern``, one pattern repeated over ``n_layers`` (``smoke`` may
  hold blocks of its own); and ``reference``, the module
  ``reference/<name>.py`` that checks it (default ``model``, Qwen3's;
  ``arch.py``);
* ``traffic/<traffic>.json``: the mix, read by ``traffic/generator.py``;
* ``metrics/<metric>.py``: one reader a metric, ``read(run) -> float or
  None`` (None: nothing to read, the metric is left out of the line).
  A metric named ``<quantity>.<mix>`` without a file of its own is read
  by ``metrics/<quantity>.py``, the reader that its cells share;
* ``limits/<cell>.json``: the limit of each number that ``correct``
  compares (``limits``), and the parameters of those numbers
  (``thresholds``).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch import nn

from bench import arch, weights
from bench.traffic import generator

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
DRIVES = {"sessions": "bench.drive_serve", "train": "bench.drive_train"}
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_benchmark(path: Optional[Path] = None) -> Dict:
    return json.loads((path or ROOT / "BENCHMARK.json").read_text())


def find_cell(bench: Dict, name: str) -> Dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def load_config(bench: Dict, name: str) -> Dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: with ``trace`` the per-layer
    ones, else the end-to-end ones, each where its ``workloads`` name the
    cell or, without the key, everywhere its ``moves`` is reported."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def read_metric(name: str, run: "Context") -> Optional[float]:
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists() and "." in name:
        path = BENCH / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


SEAM = ("blocks", "layers", "reference")   # model keys the harness adds


def model_fields(config: Dict, smoke: bool) -> Dict:
    """The model's fields as run, with the keys of ``arch.py``: its
    ``blocks`` (each layer a dict of ``LayerSpec`` fields), ``layers``
    and ``reference``."""
    m = dict(config["model"])
    if smoke:
        m.update(config["smoke"])
    if "blocks" not in m:                # the smoke section's, if any
        m["blocks"] = config.get("blocks") or [
            [config["pattern"], m["n_layers"] // len(config["pattern"])]]
    m["blocks"] = [[[{"kind": e} if isinstance(e, str) else dict(e)
                     for e in pattern], reps]
                   for pattern, reps in m["blocks"]]
    m["layers"] = arch.layers(m)
    m["reference"] = config.get("reference", arch.DEFAULT)
    return m


def program_config(m: Dict):
    from repro_torch.models.common import LayerSpec, ModelConfig, MoEConfig
    kw = {k: v for k, v in m.items() if k != "moe" and k not in SEAM}
    blocks = tuple((tuple(LayerSpec(**e) for e in pattern), reps)
                   for pattern, reps in m["blocks"])
    return ModelConfig(**kw, blocks=blocks,
                       moe=MoEConfig(**m["moe"]) if m.get("moe") else None)


def build_model(ctx: "Context"):
    """The program's model (``repro_torch.models.common.Transformer``)
    holding the benchmark's weights, drawn on the device from the seed."""
    from repro_torch.models.common import Transformer
    model = Transformer(ctx.cfg, device="meta")
    for path, p in list(model.leaf_items()):
        if path[0] == "groups":
            t = weights.stacked(ctx.model, ctx.seed, path[-1],
                                arch.layer_index(ctx.model, *path[1:3]),
                                ctx.device)
        else:
            t = weights.draw(ctx.model, ctx.seed, path[0], -1, ctx.device)
        if t.shape != p.shape or t.dtype != p.dtype:
            raise RuntimeError(f"leaf {path}: the benchmark draws "
                               f"{tuple(t.shape)} {t.dtype}, the model "
                               f"holds {tuple(p.shape)} {p.dtype}")
        model.set_leaf(path, nn.Parameter(t, requires_grad=False))
    return model


def clone_model(model):
    from repro_torch.models.common import Transformer
    out = Transformer(model.cfg, device="meta")
    for path, p in list(model.leaf_items()):
        out.set_leaf(path, nn.Parameter(p.detach().clone(),
                                        requires_grad=False))
    return out


def load_limits(cell: str, key: str = "limits") -> Dict[str, float]:
    """The cell's limits, or with ``key="thresholds"`` the parameters of
    the numbers compared (a gap share's threshold)."""
    path = BENCH / "limits" / f"{cell}.json"
    return json.loads(path.read_text()).get(key, {}) if path.exists() \
        else {}


def host_probe_ms() -> float:
    """Milliseconds of a fixed piece of pure-Python work (the kind the
    host-bound paths do between launches), the best of three: how fast
    this host runs Python at the moment."""
    best = float("inf")
    for _ in range(3):
        t = time.perf_counter()
        d: Dict[int, int] = {}
        for i in range(200_000):
            d[i & 1023] = d.get(i & 1023, 0) + i
        best = min(best, time.perf_counter() - t)
    return 1e3 * best


class Context:
    """One run of a cell: what ``drive_*.run`` needs and what it leaves for
    the metric readers."""

    def __init__(self, bench: Dict, cell_name: str, seed: int,
                 seconds: float, trace: bool, device: torch.device,
                 t_start: float, smoke: bool = False,
                 fault: Optional[str] = None, control: bool = False):
        self.bench = bench
        self.cell = find_cell(bench, cell_name)
        self.config = load_config(bench, self.cell["config"])
        self.model = model_fields(self.config, smoke)
        self.cfg = program_config(self.model)
        self.mix = generator.load_mix(self.cell["traffic"])
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start, self.smoke = device, t_start, smoke
        self.fault, self.control = fault, control
        self.limits = load_limits(cell_name)
        self.thresholds = load_limits(cell_name, "thresholds")
        self.checks: Dict[str, Dict[str, float]] = {}
        self.info: Dict = {}
        self.summary: Optional[Dict] = None
        self.records: List[Dict] = []
        self.attempted = self.failed = 0
        self.setup_s = self.window_s = 0.0
        self.untraced_from = 0.0     # where the window's untraced part starts
        self.memory_peak = 0
        self.replicas = 0
        self.leaf_sizes: List[int] = []

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup_done(self) -> None:
        """Ends set-up.  The collector is kept out of the window (what set-up
        left is frozen, nothing is collected until the window closes), and
        the host's own speed is read on either side of the window."""
        self.sync()
        self.info["host_probe_ms"] = [host_probe_ms()]
        gc.collect()
        gc.freeze()
        gc.disable()
        self.setup_s = time.perf_counter() - self.t_start

    def window_closed(self) -> None:
        """Reads the peak, and refuses a process that loaded JAX or the
        JAX package."""
        self.sync()
        gc.enable()
        gc.unfreeze()
        self.info["host_probe_ms"].append(host_probe_ms())
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)
        found = sorted({n.split(".")[0] for n in sys.modules}
                       & set(FORBIDDEN))
        if found:
            print(f"bench: modules loaded that the port must not use: "
                  f"{found}", file=sys.stderr)
            raise SystemExit(3)

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, name: str, value: float,
              limit: Optional[float] = None) -> None:
        """A number ``correct`` compares: it passes at or under its limit
        (the cell's limits file, unless given here)."""
        if limit is None:
            limit = self.limits.get(name)
        self.checks[name] = {"value": value, "limit": limit}

    @property
    def correct(self) -> bool:
        return (bool(self.checks) and self.failed == 0
                and all(c["limit"] is not None and c["value"] <= c["limit"]
                        for c in self.checks.values()))


def run_cell(ctx: Context) -> Dict:
    """Drives the cell and returns the result line's object."""
    importlib.import_module(DRIVES[ctx.mix["kind"]]).run(ctx)
    metrics = {}
    for m in cell_metrics(ctx.bench, ctx.cell["name"], ctx.trace):
        value = read_metric(m["name"], ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(ctx.device)
                       if ctx.device.type == "cuda" else "cpu"),
              "count": ctx.cell["chips"],
              "memory_peak_bytes": ctx.memory_peak}
    out = {"correct": ctx.correct, "attempted": ctx.attempted,
           "failed": ctx.failed, "metrics": metrics, "device": device}
    if ctx.trace and ctx.summary is not None:
        device["busy_s"] = ctx.summary["busy_s"]
        device["window_s"] = ctx.summary["window_s"]
        out["breakdown"] = {"device_ops": ctx.summary["device_ops"],
                            "idle_gaps": ctx.summary["idle_gaps"]}
    out["checks"] = ctx.checks
    return out
