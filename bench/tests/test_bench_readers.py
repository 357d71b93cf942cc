"""The serving cells' shared readers (``metrics/decode_step_ms.py``,
``moe_roofline.py``, ``smr_host_ms.py``) read every cell's metric of
that quantity, ``.decode`` and ``.code`` alike, and give the numbers that
the decode cell's own readers gave before they were merged into them.
The run is a recorded traced run of the decode cell on an H100
(``data/recorded_decode_run.json``: each request's record, the traced
part's span counts and device seconds by span); the expected numbers are
what the earlier ``.decode`` readers read from it."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from bench import harness

RECORDED = Path(__file__).resolve().parent / "data" / \
    "recorded_decode_run.json"
BEFORE = {
    "decode_step_ms": 5.582891015594542,
    "moe_roofline": 62.03153438381093,
    "smr_host_ms": 3.4046460000003074,
}


def _recorded_run():
    rec = json.loads(RECORDED.read_text())
    bench = harness.load_benchmark()
    config = harness.load_config(
        bench, harness.find_cell(bench, rec["cell"])["config"])
    return SimpleNamespace(model=harness.model_fields(config, smoke=False),
                           records=rec["records"], summary=rec["summary"],
                           untraced_from=rec["untraced_from"],
                           replicas=rec["replicas"])


@pytest.mark.parametrize("mix", ["decode", "code"])
@pytest.mark.parametrize("quantity", sorted(BEFORE))
def test_shared_readers_read_what_the_decode_readers_read(quantity, mix):
    name = f"{quantity}.{mix}"
    assert not (harness.BENCH / "metrics" / f"{name}.py").exists()
    assert harness.read_metric(name, _recorded_run()) == BEFORE[quantity]
