"""Today's two cells read the same through the architecture seam as they
did before it: on the CPU at the smoke widths in fp32, the digest of the
seed's weights, the reference's logits of a fixed sequence, its checked
gaps with the fp8 control, the reference trainer's first steps, and, at
each cell's own sizes, the work counts.  The expected values were read
from the harness before the seam (one shared Qwen3 layer set, one
group) and are compared to the bit."""

import dataclasses
import hashlib
import json

import pytest
import torch

from bench import harness, weights, work
from bench.reference import model as ref
from bench.reference import serve as ref_serve
from bench.reference import train as ref_train
from bench.traffic import generator

SEED = 2 ** 31 + 77
CELLS = ["qwen3-moe-235b-a22b.decode", "qwen3-8b.train"]

PINNED = {
    "qwen3-moe-235b-a22b.decode": {
        "digest": 9277116,
        "logits_sha": "b02c39a92b10d83e2bb1a4f47e62bc47",
        "check": {
            "max_logit_gap": 6.53938102722168,
            "tokens_checked": 11,
            "tokens_not_argmax": 11,
            "control_max_logit_gap": 0.05337333679199219
        },
        "train": {
            "losses": [
                5.961134910583496,
                5.975139141082764
            ],
            "first_grad": "0efe210a4ed4fcc170695f4c1e332d98",
            "change": "2e3a015aba237b7b2118eb8129622975"
        },
        "work": {
            "layer_matmul_params": 222822400,
            "serve_request_flops": 343909335040.0,
            "serve_later_turn": 45745700864.0,
            "train_step_flops": 30376961507328.0,
            "moe_decode_bytes": 304103424.0
        }
    },
    "qwen3-8b.train": {
        "digest": 2330033697,
        "logits_sha": "c6a0915a859b958c5f33798aa5e3cac2",
        "check": {
            "max_logit_gap": 5.6132588386535645,
            "tokens_checked": 11,
            "tokens_not_argmax": 11,
            "control_max_logit_gap": 0.1669931411743164
        },
        "train": {
            "losses": [
                6.016870498657227,
                5.989685535430908
            ],
            "first_grad": "c3ead9611767a59a7d25fbb2786a5cb9",
            "change": "b5653aba920e24f0132afd4bbf453018"
        },
        "work": {
            "layer_matmul_params": 192937984,
            "serve_request_flops": 160313802752.0,
            "serve_later_turn": 19014516736.0,
            "train_step_flops": 14914424930304.0,
            "moe_decode_bytes": None
        }
    }
}


def _ctx(cell, smoke=True):
    torch.set_num_threads(2)
    ctx = harness.Context(harness.load_benchmark(), cell, SEED, 1.0, False,
                          torch.device("cpu"), 0.0, smoke=smoke)
    if smoke:
        ctx.model = dict(ctx.model, dtype="float32")
        ctx.cfg = dataclasses.replace(ctx.cfg, dtype="float32")
    return ctx


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()[:32]


def _seqs(m):
    gen = torch.Generator().manual_seed(11)
    toks = torch.randint(0, m["vocab"], (40,), generator=gen).tolist()
    segs = [(0, 30)] + [(30 + i, 31 + i) for i in range(10)]
    return [{"tokens": toks, "segments": segs,
             "checks": [(29 + i, toks[30 + i] if i < 10 else 0)
                        for i in range(11) if 29 + i < 40]}]


def read(cell):
    """What the test compares, read through the harness as it stands."""
    ctx = _ctx(cell)
    m = ctx.model
    out = {"digest": ref_serve.weights_digest(m, SEED, "cpu")}
    g = {n: weights.draw(m, SEED, n, -1, "cpu", torch.float32)
         for n in weights.global_specs(m)}
    seq = _seqs(m)[0]
    x = ref.embed(m, g["embed"], torch.tensor(seq["tokens"]))[None]
    for l in range(m["n_layers"]):
        p = {n: weights.draw(m, SEED, n, l, "cpu", torch.float32)
             for n in weights.layer_specs(m)}
        x = ref.layer(m, p, x, seq["segments"])
    out["logits_sha"] = _sha(ref.logits(m, ref.head(m, g), g["out_norm"],
                                        x[0]))
    out["check"] = ref_serve.check(m, SEED, "cpu", _seqs(m), control=True)
    mix = dict(generator.load_mix("train"), seq=32)

    def batch(i):
        b = generator.train_batch(mix, m["vocab"], SEED, i)
        return {k: torch.from_numpy(v) for k, v in b.items()}

    got = ref_train.run(m, mix["optimizer"], SEED, "cpu", batch, 2)
    out["train"] = {
        "losses": got["losses"],
        "first_grad": hashlib.sha256(repr(sorted(got["first_grad"].items()))
                                     .encode()).hexdigest()[:32],
        "change": hashlib.sha256(repr(sorted(got["change"].items()))
                                 .encode()).hexdigest()[:32]}
    full = _ctx(cell, smoke=False).model
    dmix, tmix = generator.load_mix("decode"), generator.load_mix("train")
    out["work"] = {
        "layer_matmul_params": work.layer_matmul_params(full),
        "serve_request_flops": work.serve_request_flops(
            full, 0, dmix["first_prompt"]["value"],
            dmix["output"]["value"]),
        "serve_later_turn": work.serve_request_flops(full, 100, 7, 5),
        "train_step_flops": work.train_step_flops(full, tmix["batch"],
                                                  tmix["seq"]),
        "moe_decode_bytes": (work.moe_decode_bytes(full)
                             if full.get("moe") else None)}
    return out


@pytest.mark.parametrize("part", ["digest", "logits_sha", "check", "train",
                                  "work"])
@pytest.mark.parametrize("cell", CELLS)
def test_cells_read_as_before_the_seam(cell, part):
    assert json.loads(json.dumps(read(cell)[part])) == PINNED[cell][part]


if __name__ == "__main__":
    print(json.dumps({c: read(c) for c in CELLS}, indent=1))
