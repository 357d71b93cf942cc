"""``bench/work.py`` against figures worked by hand."""

import json

from bench import harness, work


def _model(name):
    cfg = json.loads((harness.BENCH / "configs" / f"{name}.json").read_text())
    return cfg["model"]


Q8 = _model("qwen3-8b.l3")
MOE = _model("qwen3-moe-235b-a22b.l8")


def test_qwen3_8b_layer_and_head():
    # q, o: 4096 x 4096; k, v: 4096 x 1024; gate, up, down: 4096 x 12288
    assert work.layer_matmul_params(Q8) == 41_943_040 + 150_994_944
    assert work.head_params(Q8) == 622_329_856


def test_qwen3_8b_train_step():
    # 6 x (3 x 192,937,984 + 622,329,856) x 2048 tokens (the untied head
    # once, as published), and three times 4 x 32 x 128 x (1024 x 1025 / 2)
    # x 3 layers x 2 rows of attention
    assert work.train_step_flops(Q8, 2, 1024) == \
        14_759_655_112_704 + 154_769_817_600


def test_qwen3_8b_request():
    # two new tokens and two generated: three tokens through the layers,
    # attending to 1, 2 and 3 keys, and the head twice
    assert work.serve_request_flops(Q8, 0, 2, 2) == \
        3 * 1_157_627_904 + 49_152 * 6 + 2 * 2 * 622_329_856
    # a later turn attends to the history before it
    assert work.serve_request_flops(Q8, 100, 1, 1) == \
        1_157_627_904 + 49_152 * 101 + 2 * 622_329_856


def test_qwen3_moe_routed_bytes_and_params():
    # eight experts x three 4096 x 1536 bf16 matrices x 8 layers
    assert 8 * (work.moe_decode_bytes(MOE) - 4096 * 128 * 4
                - 2 * 4096 * 2) == 2_415_919_104
    # q, o: 4096 x 8192; k, v: 4096 x 512; the router and 8 experts
    assert work.layer_matmul_params(MOE) == 71_303_168 + 524_288 \
        + 150_994_944


def test_fingerprint_work_and_digest_bytes():
    assert work.fingerprint_work(1000, 2) == (4000.0, 2004.0)
    assert work.digest_bytes([10, 20]) == 24 + 44
    assert work.BF16_FLOPS == 989e12 and work.HBM_BYTES_S == 3.35e12


def test_windowed_layer_reads_its_window(monkeypatch):
    # a module whose layers have windows counts keys by the port's rule;
    # LLLG: three layers of window 128 to one of full attention
    import sys
    import types
    from bench.reference import model as ref
    mod = types.ModuleType("bench.reference.windowed_work")
    mod.__dict__.update({k: v for k, v in vars(ref).items()
                         if not k.startswith("_")}, keys=ref.window_keys)
    monkeypatch.setitem(sys.modules, "bench.reference.windowed_work", mod)
    w = {"kind": "attn", "window": 128}
    m = dict(MOE, n_layers=4, reference="windowed_work",
             blocks=[[[w, w, w, {"kind": "attn"}], 1]])
    # a query at position 300 reads 128 keys in a window layer, not 301
    assert ref.window_keys(m, 0, 300) == 128
    assert ref.window_keys(m, 3, 300) == 301
    assert work.query_keys(m, 300) == 3 * 128 + 301
    # under the window every layer reads all keys up to its own
    assert work.query_keys(m, 99) == 4 * 100
    # the request at position 300: the layers, q.k and p.v over 685 keys
    # (4 x 64 heads x 128), and the head once
    assert work.serve_request_flops(m, 300, 1, 1) == \
        2 * 4 * 222_822_400 + 32_768 * 685 + 2 * 622_329_856
