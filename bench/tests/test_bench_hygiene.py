"""What the benchmark may load: ``run.py`` refuses to run without a card;
nothing a run loads has ``jax``, ``jaxlib``, ``flax`` or ``repro`` as its
top-level name (compared whole, so ``repro_torch`` passes); the
reference imports nothing of the program."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bench import harness

ROOT = harness.ROOT
ENV = dict(os.environ, PYTHONPATH=f"{ROOT}:{ROOT / 'src'}",
           CUDA_VISIBLE_DEVICES="")


def test_run_exits_nonzero_without_a_card():
    p = subprocess.run([sys.executable, "bench/run.py", "--workload",
                        "qwen3-moe-235b-a22b.decode", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_a_run_loads_no_jax_and_no_reference_package():
    code = ("import sys, json; from bench.tests.helpers import run_smoke; "
            "run_smoke('qwen3-moe-235b-a22b.decode', seconds=0.5); "
            "run_smoke('qwen3-8b.train', seconds=0.5); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(__import__("json").loads(p.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_a_run_refuses_a_process_that_loaded_jax():
    code = ("import sys, types; sys.modules['jax'] = types.ModuleType('jax');"
            "from bench.tests.helpers import run_smoke; "
            "run_smoke('qwen3-moe-235b-a22b.decode', seconds=0.5)")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and "jax" in p.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted((harness.BENCH / "reference")
                                        .glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    # nor through the benchmark's own modules it imports
    for m in _imports(path):
        if m.startswith("bench.") and m.count(".") == 1:
            mod = harness.BENCH / f"{m.split('.')[1]}.py"
            if mod.exists():
                assert not {n.split(".")[0] for n in _imports(mod)} & {
                    "repro_torch", "repro", "jax"}, mod


def test_reference_runs_with_the_program_blocked():
    code = ("import sys; sys.modules['repro_torch'] = None; "
            "from bench.reference import serve, train, model, fingerprint")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
