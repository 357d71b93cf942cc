"""``repro_torch.launch.roofline`` against the reference's
``benchmarks/roofline.py``: the same terms on the same record once the
rates are the same, the same MODEL_FLOPS for every full config, and the
H100's own rates and links by default."""

import importlib.util
import json
import math
from pathlib import Path

import pytest

from repro_torch.configs import PORT_ONLY, list_archs
from repro_torch.launch import roofline

ROOT = Path(__file__).resolve().parents[1]
ARCHS = [a for a in list_archs() if a not in PORT_ONLY]  # held against JAX
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_roofline", ROOT / "benchmarks" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(mesh="pod16x16", **coll):
    """A hand-written dry-run record of qwen3-8b's train cell, its link
    bytes split over the mesh axes as the port's counter splits them."""
    by_axis = {"data": 3.0e10, "model": 9.0e10, "other": 0.0, **coll}
    c = {"total": 1.5e11, "total_link": sum(by_axis.values())}
    for axis, link in by_axis.items():
        c[f"total_link@{axis}"] = link
        c[f"total@{axis}"] = link
        c[f"count@{axis}"] = 1.0
    return {"arch": "qwen3-8b", "shape": "train_4k", "mesh": mesh,
            "status": "ok",
            "memory": {"total_hbm_bytes": 1.2e10,
                       "argument_size_in_bytes": 3.0e8},
            "corrected": {"flops": 2.6e14, "bytes": 3.3e13,
                          "collectives": c}}


def test_terms_equal_the_reference_formulas_at_its_rates(tmp_path,
                                                         monkeypatch):
    """With the reference's rates substituted (and every axis charged its
    one link rate), each term, the dominant one, the model FLOPs and the
    fractions are the reference's on the same record."""
    ref = _reference()
    rec = _record()
    (tmp_path / "dryrun").mkdir()
    (tmp_path / "dryrun" / "cell.json").write_text(json.dumps(rec))
    monkeypatch.setattr(ref, "ARTIFACTS", str(tmp_path))
    want = ref.run()["rows"][0]
    links = {a: ("link", ref.LINK_BW) for a in ("data", "model", "other")}
    got = roofline.row(rec, roofline.model_flops("qwen3-8b", "train_4k"),
                       peak=ref.PEAK_FLOPS, hbm=ref.HBM_BW, links=links)
    for key in ("compute_s", "memory_s", "collective_s", "model_flops",
                "hlo_flops_global", "useful_ratio", "roofline_fraction"):
        assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert got["dominant"] == want["dominant"]
    assert got["hbm_fit"] == want["hbm_fit"]       # 12 GB fits both


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch, shape):
    """6·N·D, 2·N·D or 2·N·B with N_active, from the port's parameter
    shapes, equal to the reference's from JAX's."""
    assert roofline.model_flops(arch, shape) == pytest.approx(
        _reference()._model_flops(arch, shape), rel=1e-12)


def test_h100_rates_and_links_by_default():
    """By default: 989 TFLOP/s and 3.35 TB/s (the pair of phase 12b), the
    measured pair as the attainable line, an 80 GB card, and every axis
    of the production meshes on the network (no axis of 16 x 16 or
    2 x 16 x 16 stays inside an 8-card node), where a small mesh's axes
    stay on NVLink."""
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW) == (989e12, 3.35e12)
    for dims, axes in (((16, 16), ("data", "model")),
                       ((2, 16, 16), ("pod", "data", "model"))):
        links = roofline.axis_links(dims, axes)
        assert {links[a] for a in axes} == {("NDR InfiniBand", 50e9)}
    assert roofline.axis_links((2, 4), ("data", "model"))["model"] == (
        "NVLink 4", 450e9)
    assert roofline.axis_links((4, 4), ("data", "model"))["data"] == (
        "NDR InfiniBand", 50e9)
    rec = _record()
    rec["memory"]["total_hbm_bytes"] = 7.9e10
    got = roofline.row(rec, 1e18)
    assert got["hbm_fit"]
    assert got["compute_s"] == 2.6e14 / 989e12
    assert got["memory_s"] == 3.3e13 / 3.35e12
    assert got["collective_s"] == pytest.approx(1.2e11 / 50e9, rel=1e-12)
    assert set(got["links"]) == {"data", "model", "other"}
    assert got["attainable_bound_s"] > got["bound_s"]
    assert got["roofline_fraction"] == pytest.approx(
        1e18 / 256 / 989e12 / got["bound_s"], rel=1e-12)


def test_cli_writes_a_row_for_every_record(tmp_path):
    """One row per record, ok or skipped, into ``roofline_torch.json``
    and ``.md``."""
    records = tmp_path / "records"
    records.mkdir()
    (records / "a.json").write_text(json.dumps(_record()))
    (records / "b.json").write_text(json.dumps(
        {"arch": "qwen3-8b", "shape": "long_500k", "mesh": "pod16x16",
         "status": "skipped", "reason": "full attention"}))
    assert roofline.main(["--records", str(records), "--out",
                          str(tmp_path)]) == 0
    rows = json.loads((tmp_path / "roofline_torch.json").read_text())
    assert [r["status"] for r in rows] == ["ok", "skipped"]
    md = (tmp_path / "roofline_torch.md").read_text()
    assert md.count("\n| qwen3-8b |") == 2
    assert math.isfinite(rows[0]["roofline_fraction"])
