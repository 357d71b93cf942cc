"""The yardstick of K-EXAONE-236B-A23B's code traffic at its own sizes,
against hand figures: the work counts of the configuration's held share
(``reference/k_exaone.py``), the window kernel's bound
(``metrics/swa_roofline.code.py``), and the shared readers that the code
cell's ``decode_step_ms``, ``moe_roofline`` and ``smr_host_ms`` fall back
to."""

import importlib.util
from types import SimpleNamespace

import pytest

from bench import harness, work

CELL = "k-exaone-236b-a23b.code"
D, H, KV, DH, E, FE, FS, FD = 6144, 64, 8, 128, 128, 2048, 2048, 18432


def _ctx():
    bench = harness.load_benchmark()
    cfg = harness.load_config(bench, harness.find_cell(bench, CELL)["config"])
    return SimpleNamespace(model=harness.model_fields(cfg, smoke=False),
                           mix={"first_prompt": {"value": 1500}})


def test_work_counts_of_the_held_share():
    m = _ctx().model
    attn = D * H * DH + 2 * D * KV * DH + H * DH * D
    one_expert = 3 * D * FE                     # k · held / E = 8 · 16 / 128
    routed = attn + D * E + one_expert + 3 * D * FS
    assert work.layer_matmul_params(m, 0) == attn + 3 * D * FD
    assert work.layer_matmul_params(m, 1) == routed
    assert work.matmul_params(m) == attn + 3 * D * FD + 23 * routed
    assert work.moe_decode_bytes(m) == one_expert * 2 + D * E * 4 + E * 4 \
        + 2 * D * 2
    # a window layer's query reads at most 128 keys, a NoPE global all
    assert work.query_keys(m, 1499) == 18 * 128 + 6 * 1500


def test_window_kernel_bound_is_its_bytes():
    path = harness.BENCH / "metrics" / "swa_roofline.code.py"
    spec = importlib.util.spec_from_file_location("swa_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ctx = _ctx()
    S = 1500
    pairs = sum(min(p + 1, 128) for p in range(S))
    flops_s = 4 * H * DH * pairs / work.BF16_FLOPS
    bytes_s = (2 * H + 2 * KV) * DH * S * 2 / work.HBM_BYTES_S
    assert bytes_s > flops_s
    want = 18 * bytes_s
    assert mod._bound_s(ctx.model, S) == pytest.approx(want, rel=1e-12)
    ctx.summary = {"by_kernel": {"void swa_tc_kernel<bf16>(...)": want * 10,
                                 "nvjet_tst": 1.0},
                   "span_count": {"bench.prefill": 1}}
    assert mod.read(ctx) == pytest.approx(10.0)


@pytest.mark.parametrize("quantity", ["decode_step_ms", "moe_roofline",
                                      "smr_host_ms"])
def test_code_cell_reads_as_the_decode_cell(quantity):
    name = f"{quantity}.code"
    assert not (harness.BENCH / "metrics" / f"{name}.py").exists()
    ctx = _ctx()
    rec = {"t0": 0.0, "t1": 2.0, "n": 13, "traced": False,
           "prefill_s": [0.16] * 3, "decode_s": [0.72] * 3}
    ctx.records, ctx.untraced_from = [rec, dict(rec, t0=2.0, t1=4.1)], 0.0
    ctx.summary = {"span_count": {"bench.moe_ffn.t1": 23 * 12 * 3},
                   "by_span": {"bench.moe_ffn.t1": 2.5}}
    got = harness.read_metric(name, ctx)
    assert got is not None
    assert got == harness.read_metric(f"{quantity}.decode", ctx)
