"""K-EXAONE-236B-A23B on the port, held against the benchmark's plain
reference of it (``bench/reference/k_exaone.py``, fp32, written from the
published modeling code) on the CPU, at the smoke widths of the
benchmark's configuration (window 8, one dense layer and an ``LLLG``
period, 4 of 8 experts held) with its seeded weights
(``bench/weights.py``): prefill and decode through the ring and full
caches against the full forward, the graphed step against the eager one,
the sigmoid router against ``transformers``' glm4_moe router, NoPE global
layers, the training loss and gradients, a train step that leaves the
selection bias as it is, and the held share of the experts against the
uncut layer.  The JAX package has no such model."""

import dataclasses
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench import arch, harness, weights  # noqa: E402
from bench.reference import k_exaone as ref  # noqa: E402
from bench.reference import model as base  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.attention import qkv_project  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.runtime import spans, steps  # noqa: E402

from test_torch_decode_graph import GraphStandIn  # noqa: E402

torch.set_num_threads(2)

CONFIG = json.loads((ROOT / "bench" / "configs" /
                     "k-exaone-236b-a23b.ep8.l24.json").read_text())
SEED = 2 ** 31 + 28
CPU = torch.device("cpu")
PROMPT = 40                # five windows of 8: the rings wrap
STEPS = 8
# fp32 program against the fp32 reference: the sums run in other orders
# (the experts' bmm over the capacity buffer, the banded and chunked
# attention against the reference's masked one, the logits' head).
# Reading: the largest logit difference 2.7e-6 over 9 positions, at
# logits up to 4.2; limit about 7 times that.  The fp8 control differs by
# 2.3 (``test_fp8_fails_the_logit_tolerance``), and a bf16 program at these
# widths by 0.09.
LOGIT_TOL = 2e-5
# a gradient leaf's difference over the leaf's norm (sums in another
# order, through the backward of attention and the experts): largest
# reading 8.2e-7 (q_norm of layer 0); limit about 5 times that
GRAD_TOL = 4e-6
LOSS_TOL = 1e-6       # relative; reading 7.9e-8
# one routed layer's FFN, the slices' sum against the uncut layer: each
# expert's products run alike, only the order of the weighted adds may
# differ: reading 0 (the same bits) at outputs up to 4.4; a limit of a
# few fp32 ulps there
SHARE_TOL = 1e-6


def _fields(dtype="float32", **moe):
    """The benchmark configuration's model at its smoke widths."""
    m = harness.model_fields(CONFIG, smoke=True)
    m["dtype"] = dtype
    if moe:
        m["moe"] = dict(m["moe"], **moe)
    return m


def _program(m):
    """The port's model holding the benchmark's seeded weights."""
    ctx = SimpleNamespace(model=m, seed=SEED, device=CPU,
                          cfg=harness.program_config(m))
    return harness.build_model(ctx)


def _ref_leaves(m, requires_grad=False):
    f32 = torch.float32
    g = {name: weights.draw(m, SEED, name, -1, CPU, f32)
         for name in weights.global_specs(m)}
    layers = [{name: weights.draw(m, SEED, name, l, CPU, f32)
               for name in weights.layer_specs(m, l)}
              for l in range(m["n_layers"])]
    if requires_grad:
        for t in list(g.values()) + [t for p in layers for t in p.values()]:
            t.requires_grad_(True)
    return g, layers


def _tokens(n, seed=5):
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, CONFIG["smoke"]["vocab"], (n,), generator=gen)


def _ref_logits(m, g, layers, toks, segments, quant=None):
    x = ref.embed(m, g["embed"], toks)[None]
    for l, p in enumerate(layers):
        x = ref.layer(m, p, x, segments, quant, index=l)
    return ref.logits(m, ref.head(m, g), g["out_norm"], x[0], quant)


def _served_logits(model, toks):
    """Prefill of the prompt, then one decode step a token (the served
    path's calls): the logits at the prompt's last position and each
    step's."""
    logits, caches = ttr.prefill(model, toks[None, :PROMPT],
                                 max_seq=PROMPT + STEPS)
    out = [logits[0]]
    for i in range(STEPS):
        logits, caches = ttr.decode_step(model, caches,
                                         toks[PROMPT + i:PROMPT + i + 1],
                                         PROMPT + i)
        out.append(logits[0])
    return torch.stack(out), caches


SEGMENTS = [(0, PROMPT)] + [(PROMPT + i, PROMPT + i + 1)
                            for i in range(STEPS)]


def test_prefill_then_decode_matches_the_reference_forward():
    """Prefill through the window kernel's plain version and the chunked
    global attention, then decode steps through the 8-slot rings (wrapped)
    and the full caches: the logits of the reference's full forward over
    the same calls."""
    m = _fields()
    model = _program(m)
    toks = _tokens(PROMPT + STEPS)
    got, caches = _served_logits(model, toks)
    g, layers = _ref_leaves(m)
    want = _ref_logits(m, g, layers, toks, SEGMENTS)[PROMPT - 1:]
    assert (got - want).abs().max() < LOGIT_TOL
    # the window layers' caches are rings of 8, the global ones full
    ring = [st["k"].shape[2] for grp in caches for st in grp]
    assert ring == [8, 8, 8, 8, PROMPT + STEPS]


def test_fp8_fails_the_logit_tolerance():
    """The reference in fp8 (every product's operands e4m3), one precision
    below the configuration's, is far outside the tolerance above."""
    m = _fields()
    g, layers = _ref_leaves(m)
    toks = _tokens(PROMPT + STEPS)
    want = _ref_logits(m, g, layers, toks, SEGMENTS)
    got = _ref_logits(m, g, layers, toks, SEGMENTS, quant="fp8")
    assert (got - want).abs().max() > 100 * LOGIT_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_step_equals_the_eager_step(dtype, monkeypatch):
    """``GreedyDecoder`` capturing its step (the stand-in for CUDA graphs,
    cut at each routed layer, the shared expert inside the graphs) serves
    the eager decode's tokens, and leaves its caches, bit for bit."""
    monkeypatch.setattr(serve, "graphs_engage", lambda model: True)
    monkeypatch.setattr(serve, "CUDAGraph", GraphStandIn)
    model = _program(_fields(dtype))
    hist = _tokens(PROMPT).tolist()
    decoder = serve.GreedyDecoder(model, PROMPT + 13)
    got = decoder("s", hist, 13)
    logits, caches = ttr.prefill(model, torch.tensor([hist]),
                                 max_seq=PROMPT + 13)
    tok = torch.argmax(logits, -1)
    want = [int(tok[0])]
    for i in range(12):
        logits, caches = ttr.decode_step(model, caches, tok, PROMPT + i)
        tok = torch.argmax(logits, -1)
        want.append(int(tok[0]))
    assert got == want
    assert len(decoder.graphs.cuts) == 4        # the four routed layers
    assert decoder.replayed_steps == 12
    mine = [t for grp in decoder.graphs.caches for st in grp
            for t in st.values()]
    theirs = [t for grp in caches for st in grp for t in st.values()]
    assert all(torch.equal(a, b) for a, b in zip(mine, theirs))


def _glm4_router(m, router, bias):
    transformers = pytest.importorskip("transformers")
    from transformers.models.glm4_moe.modeling_glm4_moe import \
        Glm4MoeTopkRouter
    moe = m["moe"]
    cfg = transformers.Glm4MoeConfig(
        hidden_size=m["d_model"], n_routed_experts=moe["n_experts"],
        num_experts_per_tok=moe["top_k"], n_group=1, topk_group=1,
        norm_topk_prob=True, routed_scaling_factor=moe["routed_scale"])
    r = Glm4MoeTopkRouter(cfg)
    with torch.no_grad():
        r.weight.copy_(router.T)
        r.e_score_correction_bias.copy_(bias)
    return r


def test_sigmoid_router_is_the_glm4_moe_router():
    """The port's router against ``transformers``' glm4_moe one with the
    same weight and bias: the same experts and weights; the bias changes
    the choice and not the weights, which are the chosen sigmoid scores
    normalised and then times 2.5."""
    m = _fields()
    cfg = harness.program_config(m)
    router = weights.draw(m, SEED, "router", 1, CPU)
    # the benchmark draws the bias zero, as the modeling code starts it
    bias = 0.2 * torch.randn(m["moe"]["n_experts"],
                             generator=torch.Generator().manual_seed(4))
    x = torch.randn(64, m["d_model"], generator=torch.Generator()
                    .manual_seed(3))
    w, e = tmoe.route(cfg, router, x, bias)
    idx, wts = _glm4_router(m, router, bias)(x)
    order = torch.argsort(idx, dim=-1)
    assert torch.equal(torch.sort(e, dim=-1)[0], idx.gather(1, order))
    assert torch.allclose(w.gather(1, torch.argsort(e, dim=-1)),
                          wts.gather(1, order), rtol=1e-6, atol=0)
    assert torch.allclose(w.sum(-1), torch.full((64,), 2.5))
    # without the bias: other choices for some tokens; where a token's
    # choice is the same, its weights are the same
    w0, e0 = tmoe.route(cfg, router, x, torch.zeros_like(bias))
    same = (torch.sort(e, -1)[0] == torch.sort(e0, -1)[0]).all(-1)
    assert 0 < int(same.sum()) < 64

    def by_expert(w, e):
        return w.gather(1, torch.argsort(e, dim=-1))

    assert torch.equal(by_expert(w, e)[same], by_expert(w0, e0)[same])


def test_nope_layer_scores_ignore_a_shift_of_positions():
    """In a global layer (NoPE) q and k, and so the scores, are the same
    at positions shifted by any amount; in a window layer (RoPE) they
    are not."""
    m = _fields()
    model = _program(m)
    cfg = model.cfg
    specs = cfg.layer_list()
    assert [s.rope for s in specs] == [True, True, True, True, False]
    p = {k: t[0] for k, t in model.groups[1][3].items()}
    x = torch.randn(1, 12, m["d_model"], generator=torch.Generator()
                    .manual_seed(4))
    pos = torch.arange(12)[None]

    def scores(shift, use_rope):
        q, k, _ = qkv_project(cfg, p, x, pos + shift, use_rope=use_rope)
        return torch.einsum("bqhd,bkhd->bhqk", q[:, :, :2], k)

    assert torch.equal(scores(0, False), scores(1000, False))
    assert not torch.allclose(scores(0, True), scores(1000, True))


def test_training_loss_and_gradients_match_the_reference():
    """One fp32 training forward and backward (the train step's
    ``lm_loss``, through the same ``_ffn_part``): the loss and every
    gradient leaf of the reference's, layer by layer; the selection bias
    takes no gradient on either side."""
    m = _fields()
    model = _program(m)
    model.requires_grad_(True)
    toks = _tokens(PROMPT + 1, seed=9)[None]
    loss = ttr.lm_loss(model, toks[:, :-1], toks[:, 1:])
    loss.backward()
    g, layers = _ref_leaves(m, requires_grad=True)
    want = ref.lm_loss(m, g, layers, toks[:, :-1], toks[:, 1:])
    want.backward()
    assert abs(float(loss.detach()) - float(want.detach())) < \
        LOSS_TOL * float(want.detach())
    worst = 0.0
    for path, leaf in model.leaf_items():
        if path[0] != "groups":
            pairs = [(leaf.grad, g[path[0]].grad)]
        elif path[3] == "router_bias":
            assert leaf.grad is None
            assert all(layers[l]["router_bias"].grad is None
                       for l in arch.layer_index(m, path[1], path[2]))
            continue
        else:
            idx = arch.layer_index(m, path[1], path[2])
            pairs = [(leaf.grad[r], layers[l][path[3]].grad)
                     for r, l in enumerate(idx)]
        for a, b in pairs:
            worst = max(worst, float((a - b).norm() / b.norm()))
    assert worst < GRAD_TOL


def test_held_slices_add_up_to_the_uncut_layer():
    """The share test: with every expert of a routed layer (8) in the
    reference, and on the port the two cards' slices of 4 (each routing
    over all 8 and computing its own experts' part), the slices' parts,
    plus the shared expert counted once, are the uncut layer's FFN.  One
    expert is favoured by a large bias so that its capacity (32 of the 40
    tokens) drops routes.  The port's unsharded layer is the first slice,
    and the reference cut to it agrees."""
    m_cut = _fields()                             # held 4 of 8
    m_all = _fields(held=8)
    cfg = harness.program_config(m_cut)
    layer = 1
    p = {name: weights.draw(m_all, SEED, name, layer, CPU, torch.float32)
         for name in weights.layer_specs(m_all, layer)}
    p["router_bias"][1] = 5.0                    # every token picks expert 1
    x = torch.randn(PROMPT, m_all["d_model"],
                    generator=torch.Generator().manual_seed(6))
    want = ref.ffn_out(m_all, p, x[None], None, None, layer)[0]
    held = cfg.moe.n_held
    parts = []
    for e0 in range(0, 8, held):
        ps = dict(p, **{k: p[k][e0:e0 + held]
                        for k in ("w_gate", "w_up", "w_down")})
        parts.append(tmoe.moe_ffn_local(cfg, ps, x, e0, held))
    got = sum(parts) + tmoe.shared_ffn(p, x)
    assert (got - want).abs().max() < SHARE_TOL
    # the unsharded port holds the first slice; the reference cut alike
    p0 = dict(p, **{k: p[k][:held] for k in ("w_gate", "w_up", "w_down")})
    mine = tmoe.moe_ffn(cfg, p0, x[None])[0]
    assert torch.equal(mine, parts[0])
    cut = ref.routed_ffn(m_cut, p0, x, [(0, PROMPT)], None)
    assert (mine - cut).abs().max() < SHARE_TOL


def test_routed_span():
    """With spans on, each routed call is a ``moe.routed`` span; off,
    nothing is recorded."""
    m = _fields()
    cfg = harness.program_config(m)
    p = {name: weights.draw(m, SEED, name, 1, CPU, torch.float32)
         for name in weights.layer_specs(m, 1)}
    x = torch.randn(1, PROMPT, m["d_model"],
                    generator=torch.Generator().manual_seed(8))
    spans.clear()
    try:
        tmoe.moe_ffn(cfg, p, x)
        assert spans.records() == []
        spans.enable()
        tmoe.moe_ffn(cfg, p, x)
        tmoe.moe_ffn(cfg, p, x)
        assert [r.name for r in spans.records()] == ["moe.routed"] * 2
    finally:
        spans.disable()
        spans.clear()


def test_train_step_leaves_the_selection_bias_as_it_is(monkeypatch):
    """One train step (AdamW, weight decay 0.1) moves every trained leaf
    and leaves the selection bias, which no gradient sets, bit for bit as
    it was, its moments and master too; a trained leaf that the loss does
    not reach is an error."""
    m = _fields()
    model = _program(m)
    opt_cfg = AdamWConfig()
    opt = adamw_init(model.param_leaves(), opt_cfg)
    step = steps.make_train_step(model.cfg, opt_cfg)
    toks = _tokens(PROMPT + 1, seed=11)[None]
    batch = {"inputs": toks[:, :-1], "targets": toks[:, 1:]}
    before = [p.detach().clone() for p in model.param_leaves()]
    opt, metrics = step(model, opt, batch)
    n_bias = 0
    for j, ((path, leaf), old) in enumerate(zip(model.leaf_items(), before)):
        if path[-1] == "router_bias":
            n_bias += 1
            assert not leaf.requires_grad and leaf.grad is None
            assert torch.equal(leaf.detach(), old)
            assert torch.equal(opt["master"][j], old)
            assert not opt["mu"][j].any() and not opt["nu"][j].any()
        else:
            assert leaf.requires_grad and not torch.equal(leaf.detach(), old)
    assert n_bias == 4 and int(opt["count"]) == 1   # the LLLG period's 4
    assert isinstance(metrics["grad_fp"], int)
    # a loss that reaches the embedding alone
    monkeypatch.setattr(steps, "lm_loss",
                        lambda model, *_: model.embed.float().sum())
    with pytest.raises(RuntimeError, match="no gradient of a trained leaf"):
        step(model, opt, batch)


def test_benchmark_config_is_the_published_one_cut():
    """The benchmark's configuration is the port's published one with
    only its depth (24 of 48 layers, the first of them) and its held
    experts (16 of 128) cut."""
    full = get_config("k-exaone-236b-a23b")
    m = harness.model_fields(CONFIG, smoke=False)
    got = harness.program_config(m)
    layers = full.layer_list()[:24]
    want = dataclasses.replace(
        full, n_layers=24, max_seq=got.max_seq, remat=got.remat,
        moe=dataclasses.replace(full.moe, held=16), blocks=got.blocks)
    assert got == want
    assert got.layer_list() == layers
    assert CONFIG["num_hidden_layers"] == 24 and CONFIG["num_experts"] == 16
    windows = [s.window or 0 for s in layers]
    assert windows == CONFIG["sliding_windows"][:24]
    assert [s.ffn or "sparse" for s in layers] == \
        CONFIG["mlp_layer_types"][:24]
