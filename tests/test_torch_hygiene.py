"""Rules of the PyTorch port: it imports neither JAX, nor ``ml_dtypes``
(which ships with JAX), nor the ``repro`` package, and its copy of the
uBFT protocol stays the same code as the original."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

#: JAX-free modules that the port copies verbatim (imports rewritten): the
#: protocol, fault schedules and the scenario runner, the serving plane, the
#: workload library, the replicated apps, the baselines and the sharded
#: service
COPIED = [f"core/{m}.py" for m in (
    "consensus", "smr", "crypto", "ctbcast", "tbcast", "registers", "node",
    "substrate", "health", "membership")] + [
    "sim/__init__.py", "sim/events.py", "sim/net.py", "sim/faults.py",
    "scenario.py", "runtime/server.py", "runtime/trainer.py",
    "data/__init__.py", "data/pipeline.py", "serve/__init__.py",
    "serve/plane.py"] + [f"workloads/{m}.py" for m in (
    "__init__", "arrivals", "llm", "matching")] + [
    f"apps/{m}.py" for m in ("__init__", "flip", "kvstore", "matching")] + [
    f"baselines/{m}.py" for m in (
        "__init__", "unreplicated", "mu", "minbft", "sgx_counter")] + [
    f"service/{m}.py" for m in ("__init__", "router", "sharded")]

_IMPORT = re.compile(r"^(\s*(?:from|import)\s+)repro(?=[.\s])", re.M)

#: the port's runnable examples, beside the reference's
EXAMPLES = ("torch_serve_replicated", "torch_train_replicated")

_CHECK_IMPORTS = r"""
import importlib, importlib.abc, pkgutil, sys
EXAMPLES = %r

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if (name.startswith(("jax", "ml_dtypes")) or name == "repro"
                or name.startswith("repro.")):
            raise ModuleNotFoundError(f"the port may not import {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import importlib.util
for ex in EXAMPLES:
    spec = importlib.util.spec_from_file_location(ex, f"examples/{ex}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.startswith(("jax", "ml_dtypes")) or m == "repro"
             or m.startswith("repro."))
assert not bad, bad
print(len(names))
""" % (EXAMPLES,)


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    """Every module of the port (``launch/roofline.py`` among them),
    ``chip_smoke.py`` and the examples, imported with JAX, ``ml_dtypes``
    and ``repro`` refused."""
    env = dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{ROOT}")
    res = subprocess.run([sys.executable, "-c", _CHECK_IMPORTS], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20     # every module was imported


def _without_attest_batch(text: str) -> str:
    """The file with ``attest_batch`` cut out: its device branch is the
    port's own (CUDA instead of Pallas)."""
    start = text.index("\ndef attest_batch(")
    end = text.index("\nclass ", start)
    return text[:start] + text[end:]


@pytest.mark.parametrize("rel", COPIED)
def test_protocol_copy_matches_original(rel):
    original = (SRC / "repro" / rel).read_text()
    copy = (SRC / "repro_torch" / rel).read_text()
    expected = _IMPORT.sub(r"\1repro_torch", original)
    if rel == "core/crypto.py":
        expected, copy = _without_attest_batch(expected), _without_attest_batch(copy)
    assert copy == expected


@pytest.mark.parametrize("example", EXAMPLES)
def test_example_runs_on_the_card_unless_asked(example):
    """Without ``--device`` an example runs on the CUDA device and, where
    there is none, stops; it does not fall back to the CPU."""
    import importlib.util

    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = importlib.util.spec_from_file_location(
        example, ROOT / "examples" / f"{example}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main([])
