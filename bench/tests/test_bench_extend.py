"""A later change adds a traffic mix, a metric and a cell as new files and
entries, without editing a file that is there: here in a copy of the
benchmark, run at the smoke widths on the CPU."""

import json
import os
import shutil
import subprocess
import sys

from bench import harness


def test_new_mix_and_metric_run_from_new_files_alone(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "bench").rglob("*") if p.is_file()}
    bench = harness.load_benchmark()
    mix = json.loads((harness.BENCH / "traffic" / "decode.json").read_text())
    mix.update(first_prompt={"dist": "fixed", "value": 40},
               output={"dist": "fixed", "value": 3}, max_history=43)
    (tmp_path / "bench" / "traffic" / "dummy.json").write_text(
        json.dumps(mix))
    (tmp_path / "bench" / "metrics" / "dummy_tokens.py").write_text(
        "def read(run):\n    return float(sum(r['n'] for r in run.records))\n")
    (tmp_path / "bench" / "limits" / "qwen3-8b.dummy.json").write_bytes(
        (harness.BENCH / "limits" / "qwen3-moe-235b-a22b.decode.json").read_bytes())
    bench["workloads"].append({"name": "qwen3-8b.dummy",
                               "config": "qwen3-8b.l3", "traffic": "dummy",
                               "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "dummy_tokens", "unit": "tokens",
                                "better": "higher", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["qwen3-8b.dummy"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, time, torch; from bench import harness; "
            "torch.set_num_threads(2); "
            "ctx = harness.Context(harness.load_benchmark(), 'qwen3-8b.dummy',"
            " 3, 0.5, False, torch.device('cpu'), time.perf_counter(), "
            "smoke=True); print(json.dumps(harness.run_cell(ctx)))")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}:{harness.ROOT / 'src'}")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["metrics"]["dummy_tokens"]["value"] == 3 * out["attempted"]
    assert out["correct"] is True, out["checks"]
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data


WINDOWED = '''"""A Qwen3 decoder with window layers: in a layer whose
LayerSpec has window w, a query at p reads the keys p - w + 1 .. p."""

from bench import arch
from bench.reference import model as base
from bench.reference.model import (  # noqa: F401  as Qwen3's
    embed, global_specs, head, layer_matmul_params, layer_specs, logits,
    moe_decode_bytes)

keys = base.window_keys


def layer(model, p, x, segments=None, quant=None, index=0):
    window = arch.layers(model)[index].get("window")
    x = base.attention_block(model, p, x, quant, window)
    return base.ffn_block(model, p, x, segments, quant)


def lm_loss(model, leaves, layers, inputs, targets, quant=None):
    return base.lm_loss(model, leaves, layers, inputs, targets, quant,
                        layer)
'''


def _run(root, cell):
    code = ("import json, time, torch; from bench import harness; "
            "torch.set_num_threads(2); "
            f"ctx = harness.Context(harness.load_benchmark(), {cell!r}, 5,"
            " 0.5, False, torch.device('cpu'), time.perf_counter(), "
            "smoke=True); print(json.dumps(harness.run_cell(ctx)))")
    env = dict(os.environ, PYTHONPATH=f"{root}:{harness.ROOT / 'src'}")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_new_architecture_runs_from_new_files_alone(tmp_path):
    """Window layers over a routed FFN, in two groups, with a reference
    module of their own: correct against it, and not correct against the
    default Qwen3 reference, which reads every layer as full attention."""
    bench_dir = tmp_path / "bench"
    shutil.copytree(harness.BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in bench_dir.rglob("*") if p.is_file()}
    bench = harness.load_benchmark()
    moe = json.loads((harness.BENCH / "configs" /
                      "qwen3-moe-235b-a22b.l8.json").read_text())
    w8 = {"kind": "attn", "window": 8}
    config = {"name": "windowed-moe", "model": dict(moe["model"], n_layers=8),
              "reference": "windowed",
              "blocks": [[[w8, w8, "attn"], 2], [[w8], 2]],
              "smoke": dict(moe["smoke"], n_layers=4,
                            blocks=[[[w8, "attn"], 1], [[w8], 2]])}
    (bench_dir / "configs" / "windowed-moe.json").write_text(
        json.dumps(config))
    (bench_dir / "reference" / "windowed.py").write_text(WINDOWED)
    mix = json.loads((harness.BENCH / "traffic" / "decode.json").read_text())
    mix.update(first_prompt={"dist": "fixed", "value": 40},
               output={"dist": "fixed", "value": 3}, max_history=43)
    (bench_dir / "traffic" / "long_prompt.json").write_text(json.dumps(mix))
    (bench_dir / "limits" / "windowed-moe.long_prompt.json").write_bytes(
        (harness.BENCH / "limits" /
         "qwen3-moe-235b-a22b.decode.json").read_bytes())
    bench["configs"].append({"name": "windowed-moe", "source": "a test",
                             "file": "bench/configs/windowed-moe.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "windowed-moe.long_prompt",
                               "config": "windowed-moe",
                               "traffic": "long_prompt", "chips": 1,
                               "why": "40-token prompts past the window"})
    for m in bench["end_to_end"]:
        if m["name"] == "tokens_per_s":
            m["workloads"].append("windowed-moe.long_prompt")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    out = _run(tmp_path, "windowed-moe.long_prompt")
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and "tokens_per_s" in out["metrics"]
    for rel, data in before.items():
        assert (tmp_path / rel).read_bytes() == data

    del config["reference"]          # checked by the default reference
    (bench_dir / "configs" / "windowed-moe.json").write_text(
        json.dumps(config))
    out = _run(tmp_path, "windowed-moe.long_prompt")
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["max_logit_gap"]["value"] > \
        out["checks"]["max_logit_gap"]["limit"]
