"""The plain reference against the program at the smoke widths, on the
CPU, in fp32: prefill and decode logits (dense, and routed with tokens
dropped at capacity), one train step's loss and update, the digest."""

import dataclasses

import pytest
import torch

from bench import harness, weights
from bench.reference import fingerprint, model as ref, train as ref_train
from bench.traffic import generator

SEED = 2 ** 31 + 5


def _ctx(cell):
    torch.set_num_threads(2)
    ctx = harness.Context(harness.load_benchmark(), cell, SEED, 1.0, False,
                          torch.device("cpu"), 0.0, smoke=True)
    ctx.model = dict(ctx.model, dtype="float32")
    ctx.cfg = dataclasses.replace(ctx.cfg, dtype="float32")
    return ctx


def _ref_weights(model):
    g = {n: weights.draw(model, SEED, n, -1, "cpu", torch.float32)
         for n in weights.global_specs(model)}
    layers = [{n: weights.draw(model, SEED, n, l, "cpu", torch.float32)
               for n in weights.layer_specs(model)}
              for l in range(model["n_layers"])]
    return g, layers


@pytest.mark.parametrize("cell", ["qwen3-8b.train",
                                  "qwen3-moe-235b-a22b.decode"])
def test_prefill_and_decode_match_the_reference(cell):
    from repro_torch.models.transformer import decode_step, prefill
    ctx = _ctx(cell)
    m = ctx.model
    model = harness.build_model(ctx)
    g, layers = _ref_weights(m)
    if m.get("moe"):
        # in the first layer every router logit ties: experts 0 and 1
        # take every token, and the prefill call drops those past 32
        with torch.no_grad():
            layers[0]["router"].zero_()
            model.groups[0][0]["router"][0].zero_()
    S, n = 48, 4
    toks = torch.randint(0, m["vocab"], (1, S + n - 1),
                         generator=torch.Generator().manual_seed(1))
    lg, caches = prefill(model, toks[:, :S], max_seq=S + n)
    got = [lg[0]]
    for i in range(n - 1):
        lg, caches = decode_step(model, caches, toks[:, S + i], S + i)
        got.append(lg[0])
    x = ref.embed(m, g["embed"], toks[0])[None]
    segs = [(0, S)] + [(S + i, S + i + 1) for i in range(n - 1)]
    if m.get("moe"):     # the first layer's prefill call drops tokens
        h = ref.rms_norm(x[0, :S], layers[0]["ln2"], m["norm_eps"])
        assert not ref.route(m, h, layers[0]["router"], [(0, S)])[2].all()
    for p in layers:
        x = ref.layer(m, p, x, segs)
    want = ref.logits(m, ref.head(m, g), g["out_norm"], x[0, S - 1:])
    torch.testing.assert_close(torch.stack(got), want, rtol=1e-4, atol=1e-4)


def test_moe_capacity_drops_tokens():
    m = _ctx("qwen3-moe-235b-a22b.decode").model
    h = torch.zeros(64, m["d_model"])
    router = torch.zeros(m["d_model"], m["moe"]["n_experts"])
    w, e, kept = ref.route(m, h, router, [(0, 64)])
    # every logit ties: experts 0 and 1 take all 64 tokens, 32 each kept
    assert e[:, 0].eq(0).all() and e[:, 1].eq(1).all()
    assert kept[:32].all() and not kept[32:].any()
    # one token a call: nothing dropped
    _, _, kept1 = ref.route(m, h, router, [(i, i + 1) for i in range(64)])
    assert kept1.all()


def test_train_step_matches_the_reference():
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import make_train_step
    ctx = _ctx("qwen3-8b.train")
    m, mix = ctx.model, dict(ctx.mix, seq=32)
    opt = mix["optimizer"]
    model = harness.build_model(ctx)
    state = adamw_init(model.param_leaves(), AdamWConfig(**opt))
    step = make_train_step(ctx.cfg, AdamWConfig(**opt))

    def batch(i):
        b = generator.train_batch(mix, m["vocab"], SEED, i)
        return {k: torch.from_numpy(v) for k, v in b.items()}

    losses = []
    for i in range(2):
        state, out = step(model, state, batch(i))
        losses.append(float(out["loss"]))
    got = ref_train.run(m, opt, SEED, "cpu", batch, 2)
    assert losses == pytest.approx(got["losses"], rel=1e-5)
    for path, p in model.leaf_items():
        if path[0] == "groups":
            for l in range(p.shape[0]):
                d = p[l].detach() - weights.draw(m, SEED, path[-1], l, "cpu")
                assert float(torch.linalg.vector_norm(d)) == pytest.approx(
                    got["change"][path[-1], l], rel=1e-3, abs=1e-7)


def test_frozen_digest_equals_the_programs():
    from repro_torch.kernels.fingerprint import fingerprint_plain
    from repro_torch.runtime.attest import fingerprint_tree
    gen = torch.Generator().manual_seed(0)
    xs = [torch.randn(1000, generator=gen).to(torch.bfloat16),
          torch.randn(37, 5, generator=gen)]
    assert [fingerprint.digest(x) for x in xs] == \
        [fingerprint_plain(x) for x in xs]
    assert fingerprint.tree_digest(xs) == fingerprint_tree(xs)
