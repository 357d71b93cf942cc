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
