"""The golden seeded traces on the port's copies of the protocol.

``tests/golden_scenarios.py`` builds eight seeded deployments through the
``repro`` package; ``tests/golden/golden_traces.json`` holds their digests
(every latency as raw float64, every message and byte count).  Here a
subprocess refuses JAX, ``ml_dtypes`` and the reference package, binds the
name ``repro`` and each of its modules to the port's module of the same
path, and runs the same eight scenarios: the port's copies must give the
committed digests bit for bit.

The token server's cost model is the one difference by design: the port's
``serve/costmodel.py`` holds the H100's measured rates, so ``token_server``
is run with the reference's rates put into the port's cost model (as
``ServingCostModel.from_counts`` returns it, through
``dataclasses.replace``) and must then match; with the card's own rates it
must not, which shows that the profile is in use.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from golden_scenarios import GOLDEN_PATH, SCENARIOS

ROOT = Path(__file__).resolve().parents[1]

_RUN_ON_THE_PORT = r"""
import dataclasses, importlib, importlib.abc, json, pkgutil, sys

REF_FLOPS, REF_BW = float(sys.argv[1]), float(sys.argv[2])


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if (name.startswith(("jax", "ml_dtypes")) or name == "repro"
                or name.startswith("repro.")):
            raise ModuleNotFoundError(f"refused: {name}")
        return None


sys.meta_path.insert(0, Refuse())
import repro_torch
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
# ``repro.X`` is the port's ``repro_torch.X``: the very module object, so
# that classes keep one identity whichever name imports them
for name, mod in list(sys.modules.items()):
    if name == "repro_torch" or name.startswith("repro_torch."):
        sys.modules["repro" + name[len("repro_torch"):]] = mod

import golden_scenarios
from repro_torch.serve.costmodel import ServingCostModel

card = golden_scenarios.SCENARIOS["token_server"]()["digest"]
from_counts = ServingCostModel.from_counts.__func__


def with_reference_rates(cls, *args, **kwargs):
    return dataclasses.replace(from_counts(cls, *args, **kwargs),
                               peak_flops=REF_FLOPS, hbm_bw=REF_BW)


ServingCostModel.from_counts = classmethod(with_reference_rates)
digests = {name: fn()["digest"]
           for name, fn in golden_scenarios.SCENARIOS.items()}
assert sys.modules["repro.scenario"] is sys.modules["repro_torch.scenario"]
leaked = sorted(m for m in sys.modules if m.startswith(("jax", "ml_dtypes")))
assert not leaked, leaked
print(json.dumps({"reference_rates": digests, "card_token_server": card}))
"""


@pytest.fixture(scope="module")
def port_digests():
    """The eight digests on the port's copies, in one subprocess (the
    alias must not leak into other tests of this worker)."""
    from repro.serve.costmodel import HBM_BW, PEAK_FLOPS
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    res = subprocess.run(
        [sys.executable, "-c", _RUN_ON_THE_PORT, repr(PEAK_FLOPS),
         repr(HBM_BW)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.splitlines()[-1])


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN_PATH) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_port_reproduces_golden_digest(name, port_digests, golden):
    """Each scenario on the port's copies gives the committed digest;
    ``token_server`` with the reference's cost-model rates."""
    assert port_digests["reference_rates"][name] == golden[name]["digest"]


def test_token_server_runs_on_the_cards_rates(port_digests, golden):
    """With the port's own (H100) rates the token server's digest differs
    from the committed one: the card's profile is what the port charges."""
    assert port_digests["card_token_server"] != golden["token_server"]["digest"]
