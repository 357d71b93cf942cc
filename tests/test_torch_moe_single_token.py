"""The routed FFN's few-token path (``models.moe.moe_ffn_local`` through
``kernels.ops.routed_experts``) on the CPU, where it runs the kernel's plain
version (``kernels.routed.routed_plain``): against the buffer path it
replaces, at the smoke configs of the three MoE archs (softmax and sigmoid
routing, the selection bias, a held share, the routed scale); slots routed
to experts not held; the order in which a token's slots are added; the
rule that chooses the path; the decode step replayed between graphs; and
the operator's fake implementation.  The kernel itself runs on the card
only (``chip_smoke.py``'s phase 15).

The buffer path is taken at the same shapes by asking for a gradient (x
requires grad with grad mode on), which the few-token path leaves to it."""

import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, routed
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models.common import MoEConfig, init_params

from test_torch_decode_graph import GraphStandIn
from test_torch_moe import FFN_TOL

torch.set_num_threads(2)

MOE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e",
             "k-exaone-236b-a23b")


def _layer(model):
    """The first routed layer's parameters."""
    cfg = model.cfg
    for group, (pattern, _reps) in zip(model.groups, cfg.blocks):
        for params, spec in zip(group, pattern):
            if cfg.routed(spec):
                return {k: t[0] for k, t in params.items()}
    raise AssertionError(f"{cfg.name} has no routed layer")


def _setup(arch, dtype="bfloat16", **moe_fields):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    if moe_fields:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_fields))
    model = init_params(cfg, torch.Generator().manual_seed(0))
    return cfg, _layer(model)


def _x(T, cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(T, cfg.d_model, generator=gen).to(cfg.tdtype())


@pytest.fixture
def calls(monkeypatch):
    """The shapes of x at each call of ``ops.routed_experts``, and whether
    grad mode was on."""
    seen = []
    inner = ops.routed_experts

    def spy(x, *args):
        seen.append((tuple(x.shape), torch.is_grad_enabled()))
        return inner(x, *args)

    monkeypatch.setattr(ops, "routed_experts", spy)
    return seen


def _buffer(cfg, p, x, e0, e_local):
    """The buffer path at x's shape: a gradient asked for."""
    return moe.moe_ffn_local(cfg, p, x.clone().requires_grad_(), e0,
                             e_local).detach()


def _few(cfg, p, x, e0, e_local):
    with torch.no_grad():
        return moe.moe_ffn_local(cfg, p, x, e0, e_local)


def _err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("T", [1, 2, "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_few_tokens_match_the_buffer_path(arch, dtype, T, calls):
    """T = 1, 2 and T·k = the experts held.  bf16: the same bits (the
    products of one row round alike in both paths on the CPU).  fp32: the
    same bits at T = 1, where the buffer's product has one row an expert
    too; at more rows its product sums in another order, within
    ``test_torch_moe.py``'s fp32 limit."""
    cfg, p = _setup(arch, dtype)
    m = cfg.moe
    T = m.n_held // m.top_k if T == "full" else T
    x = _x(T, cfg, seed=T)
    want = _buffer(cfg, p, x, 0, m.n_held)
    assert calls == []
    got = _few(cfg, p, x, 0, m.n_held)
    assert calls == [((T, cfg.d_model), False)]
    assert got.dtype == x.dtype and got.shape == x.shape
    if dtype == "bfloat16" or T == 1:
        assert torch.equal(got, want), _err(got, want)
    else:
        assert _err(got, want) <= FFN_TOL[dtype]


@pytest.mark.parametrize("e0", [0, 2, 4])
def test_a_slice_of_the_experts_matches_the_buffer_path(e0, calls):
    """The expert-parallel local call: experts [e0, e0 + 4) of 8, their
    weights a slice; routes to the others add nothing in both paths."""
    cfg, p = _setup("qwen3-moe-235b-a22b")
    local = dict(p, **{k: p[k][e0:e0 + 4] for k in ("w_gate", "w_up",
                                                     "w_down")})
    x = _x(2, cfg, seed=e0)
    got = _few(cfg, local, x, e0, 4)
    assert len(calls) == 1
    assert torch.equal(got, _buffer(cfg, local, x, e0, 4))


def _slot_rows(x, top_e, top_w, p, e0, e_local):
    """Each held slot's weighted row, computed alone, by token."""
    rows = {}
    for t in range(top_e.shape[0]):
        for j in range(top_e.shape[1]):
            e = int(top_e[t, j]) - e0
            if 0 <= e < e_local:
                h = x[t:t + 1] @ p["w_gate"][e]
                u = x[t:t + 1] @ p["w_up"][e]
                y = (torch.nn.functional.silu(h) * u) @ p["w_down"][e]
                rows.setdefault(t, []).append(
                    (int(top_e[t, j]), y[0] * top_w[t, j].to(x.dtype)))
    return rows


@pytest.mark.parametrize("e0", [0, 3])
def test_slots_not_held_add_nothing(e0):
    """Routes outside [e0, e0 + e_local) add nothing: each token's output
    is the sum of its held slots' rows alone, and a token with none gets
    exact zeros."""
    cfg, p = _setup("qwen3-moe-235b-a22b", "float32")
    e_local = 3
    w = {k: p[k][e0:e0 + e_local] for k in ("w_gate", "w_up", "w_down")}
    top_e = torch.tensor([[e0 + 1, 7 if e0 == 0 else 0],
                          [e0 + 2, e0],
                          [6, 7 if e0 == 3 else 5]])
    top_w = torch.tensor([[0.6, 0.4], [0.3, 0.7], [0.5, 0.5]])
    x = _x(3, cfg)
    got = routed.routed_plain(x, top_e, top_w, w["w_gate"], w["w_up"],
                              w["w_down"], e0, e_local)
    rows = _slot_rows(x, top_e, top_w, w, e0, e_local)
    assert set(rows) == {0, 1}
    for t, held in rows.items():
        want = torch.zeros(cfg.d_model)
        for _e, row in sorted(held, key=lambda r: r[0]):
            want = want + row
        torch.testing.assert_close(got[t], want, rtol=1e-6, atol=1e-7)
    assert torch.equal(got[2], torch.zeros(cfg.d_model))


def _ordered_case():
    """bf16 experts whose rows are exactly 1 (expert 1) and 2^-8 (experts
    3 and 5) in every column, routed in the slot order (3, 5, 1) at
    weight 1.  In ascending expert order 1 + 2^-8 rounds to 1 (a tie, to
    even) and the second 2^-8 too: the sum is 1.  In slot order the two
    small rows add to 2^-7 first and the sum is 1 + 2^-7."""
    E, D, F = 8, 8, 8
    x = torch.zeros(1, D, dtype=torch.bfloat16)
    x[0, 0] = 1.0
    w_gate = torch.zeros(E, D, F, dtype=torch.bfloat16)
    w_up = torch.zeros(E, D, F, dtype=torch.bfloat16)
    w_gate[:, 0] = 16.0            # h = 16, and silu(16) rounds to 16
    w_up[:, 0] = 1.0
    w_down = torch.zeros(E, F, D, dtype=torch.bfloat16)
    w_down[1] = 2.0 ** -7          # 8 x 16 x 2^-7 = 1
    w_down[3] = w_down[5] = 2.0 ** -15
    top_e = torch.tensor([[3, 5, 1]])
    top_w = torch.ones(1, 3)
    return x, top_e, top_w, w_gate, w_up, w_down


def test_slots_add_in_ascending_expert_order(monkeypatch):
    x, top_e, top_w, w_gate, w_up, w_down = _ordered_case()
    got = routed.routed_plain(x, top_e, top_w, w_gate, w_up, w_down, 0, 8)
    assert torch.equal(got, torch.ones_like(got))
    small = torch.tensor(2.0 ** -8, dtype=torch.bfloat16)
    assert small + small + 1 == 1 + 2.0 ** -7   # slot order would differ
    # the buffer path adds them in the same order
    cfg = dataclasses.replace(
        get_smoke_config("qwen3-moe-235b-a22b"), d_model=8,
        moe=MoEConfig(n_experts=8, top_k=3, d_expert=8))
    monkeypatch.setattr(moe, "route", lambda cfg, w, x: (top_w, top_e))
    p = {"router": torch.zeros(8, 8), "w_gate": w_gate, "w_up": w_up,
         "w_down": w_down}
    assert torch.equal(_buffer(cfg, p, x, 0, 8), got)
    assert torch.equal(_few(cfg, p, x, 0, 8), got)


@pytest.mark.parametrize("case,engages", [
    ("one token", True),
    ("T·k = e_local", True),
    ("T·k > e_local", False),
    ("T = 32", True),
    ("T = 33", False),
    ("x requires grad", False),
    ("experts require grad", False),
    ("grad mode, nothing requires grad", True),
    ("x requires grad, no grad mode", True),
])
def test_rule_that_chooses_the_path(case, engages, calls):
    """The few-token path takes T·k <= e_local, T within the capacity
    (T <= 32 here) and no gradient asked for; every other call keeps the
    buffer."""
    if case.startswith("T = 3"):
        cfg, p = _setup("llama4-scout-17b-a16e", n_experts=64, top_k=1)
    else:
        cfg, p = _setup("qwen3-moe-235b-a22b")
    m = cfg.moe
    T = {"one token": 1, "T·k = e_local": m.n_held // m.top_k,
         "T·k > e_local": m.n_held // m.top_k + 1, "T = 32": 32,
         "T = 33": 33}.get(case, 1)
    x = _x(T, cfg)
    grad = True
    if case == "x requires grad":
        x.requires_grad_()
    elif case == "experts require grad":
        p = dict(p, w_up=p["w_up"].clone().requires_grad_())
    elif case == "x requires grad, no grad mode":
        x.requires_grad_()
        grad = False
    with torch.set_grad_enabled(grad):
        out = moe.moe_ffn_local(cfg, p, x, 0, m.n_held)
    assert out.shape == x.shape
    assert len(calls) == int(engages)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_replayed_decode_step_takes_the_few_token_path(arch, calls,
                                                       monkeypatch):
    """``StepGraphs.replay`` calls the routed FFN outside ``decode_step``'s
    ``no_grad``, so grad mode is on there; the parameters are frozen and
    the input needs no gradient, so every routed layer of every replayed
    step takes the few-token path.  On the CPU it runs the plain version
    and counts no launch."""
    monkeypatch.setattr(serve, "graphs_engage", lambda model: True)
    monkeypatch.setattr(serve, "CUDAGraph", GraphStandIn)
    cfg = get_smoke_config(arch)
    model = init_params(cfg, torch.Generator().manual_seed(0))
    n_layers = sum(map(cfg.routed, cfg.layer_list()))
    decoder = serve.GreedyDecoder(model, 40)
    prompt = [5, 6, 7, 8, 9]           # prefills of T·k > e_local
    decoder("s", prompt, 4)            # captures, then replays 3 steps
    calls.clear()
    ops.reset_launches()
    decoder("s", prompt, 6)
    decoder("s", prompt + [3], 4)
    steps = 5 + 3
    assert calls == [((1, cfg.d_model), True)] * (steps * n_layers)
    assert decoder.replayed_steps == 3 + steps
    assert ops.launches["routed"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fake_gives_the_output_shape_and_dtype(dtype):
    """On fake tensors (the dry-run's trace) the operator gives a (T, D)
    tensor of x's dtype and runs nothing; its work counts every slot's
    three products."""
    T, k, E, D, F = 3, 2, 8, 64, 48
    with FakeTensorMode():
        x = torch.empty(T, D, dtype=dtype)
        top_e = torch.empty(T, k, dtype=torch.int64)
        top_w = torch.empty(T, k)
        w_gate = torch.empty(E, D, F, dtype=dtype)
        w_down = torch.empty(E, F, D, dtype=dtype)
        args = (x, top_e, top_w, w_gate, w_gate, w_down, 0, E)
        out = ops.routed_experts(*args)
        assert out.shape == (T, D) and out.dtype == dtype
        work = ops.op_work(ops.ROUTED, args)
    assert work.flops == 6 * T * k * D * F
    assert work.bytes >= T * k * 3 * D * F * x.element_size()
    assert ops.launches["routed"] == 0


@pytest.mark.parametrize("bad", ["fp16", "slots", "routes"])
def test_fake_refuses_what_the_kernel_does_not_take(bad):
    T, k, E, D, F = 2, 2, 8, 64, 48
    dtype = torch.float16 if bad == "fp16" else torch.bfloat16
    k = routed.KMAX + 1 if bad == "slots" else k
    with FakeTensorMode():
        args = [torch.empty(T, D, dtype=dtype),
                torch.empty(T, k, dtype=torch.int64), torch.empty(T, k),
                torch.empty(E, D, F, dtype=dtype),
                torch.empty(E, D, F, dtype=dtype),
                torch.empty(E, F, D, dtype=dtype), 0, E]
        if bad == "routes":
            args[2] = torch.empty(T, k, dtype=torch.bfloat16)
        with pytest.raises((TypeError, ValueError)):
            routed.routed_fake(*args)
