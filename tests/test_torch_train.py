"""The port's training path against the JAX package on smoke configs:
parameters converted from the JAX init by ``bridge.params_from_jax``, AdamW
state by ``bridge.opt_state_from_jax``, batches from the copied
``TokenPipeline``.  One train step runs in both frameworks (JAX jitted, as
``tests/test_system.py`` runs it); AdamW alone runs JAX op by op, where
XLA fuses no multiply into an add, so the two agree bit for bit.  Then the
replicated-training tests of ``tests/test_system.py`` run on the port's
stack."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import TokenPipeline as JaxTokenPipeline
from repro.models.common import init_params as jax_init_params
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import adamw as jadamw
from repro.runtime import attest as jattest
from repro.runtime.steps import make_train_step as jax_make_train_step

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.core.consensus import ConsensusConfig
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.models import transformer as ttr
from repro_torch.kernels import ops
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.attest import fingerprint_tree
from repro_torch.runtime.steps import (make_prefill, make_serve_step,
                                       make_train_step)
from repro_torch.runtime.trainer import CoordinatorApp, ReplicatedTrainer

torch.set_num_threads(2)

ARCHS = ("qwen3-8b", "gemma3-1b", "recurrentgemma-2b", "xlstm-1.3b")
LR = 1e-3
# fp32: the frameworks differ in the order of their sums
FP32_TOL = {"loss": 1e-5, "grad": 1e-4, "state": 1e-2 * LR}
# An element whose gradient is below this share of its leaf's largest
# gradient is left out of the fp32 state comparison and counted: Adam
# divides the gradient by its own magnitude plus eps = 1e-8, so where |g|
# is near eps a difference of 1e-7 of the leaf's largest gradient in the
# sum order moves the step by a sizeable part of lr (one element of
# qwen3-8b-smoke's, |g| = 1.7e-7 of its leaf's largest, moves 0.075 lr).
TINY_GRAD = 1e-6
# bf16: the frameworks round at other places (XLA keeps fusions in fp32),
# so a gradient near 0 can change sign and move its element by 2 lr.
# Largest readings over both archs (gemma3-1b-smoke's but the loss):
# loss 2.25e-4 relative, gradient 2.68e-2 of the leaf's largest, mu 2.70e-2
# and nu 2.72e-2 of the leaf's largest, new weights 2.44 lr, master 2.0 lr;
# each limit is about twice its reading.
BF16_TOL = {"loss": 5e-4, "grad": 6e-2, "mu": 6e-2, "nu": 6e-2,
            "param": 5 * LR, "master": 4 * LR}
# The recurrent archs: JAX scans (``associative_scan`` for the RG-LRU,
# ``lax.scan`` for the sLSTM) where the port loops in sequence, so fp32
# sums come in another order.  Readings, the largest over each arch's
# leaves: recurrentgemma-2b-smoke gradient 1.31e-6 of the leaf's largest;
# xlstm-smoke gradient 3.16e-6, new state 1.27e-2 lr (the sLSTM's
# forget-gate weights ``wf``, where Adam divides a gradient near TINY_GRAD
# by its own size).  Each limit is about 4x its reading; their other
# readings are within FP32_TOL.
FP32_TOL_ARCH = {"recurrentgemma-2b": {"grad": 5e-6},
                 "xlstm-1.3b": {"grad": 1.2e-5, "state": 4e-2 * LR}}
# bf16, the sLSTM's gate input weights ``wi`` and ``wf``: the stabiliser
# m_t = max(f_t + m_{t-1}, i_t) sends the gradient to one side, or half to
# each on a tie, and bf16 gate pre-activations tie or swap order with
# rounding, so some elements' gradients change by a large part.  Readings
# on xlstm-smoke: gradient 0.223 (wi) and 0.206 (wf) of the leaf's
# largest, mu 0.224, nu 0.171 (8% and 7% of the leaf's norm; its fp32
# gradients agree within 3.2e-6); limits about twice the readings.  Every
# other leaf keeps BF16_TOL (its readings: at most 0.043).
BF16_SLSTM_GATE_TOL = {"grad": 0.45, "mu": 0.45, "nu": 0.35}
SLSTM_GATES = ("wi", "wf")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _bits(x):
    """The raw words of a JAX array or a tensor, bf16 as int16."""
    if isinstance(x, torch.Tensor):
        return bridge.numpy_from_tensor(x)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _batch(cfg, step=0, seed=1):
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=24,
                                    global_batch=4, seed=seed))
    return pipe.global_batch(step)


@pytest.fixture(scope="module")
def jax_inits():
    """Each arch's JAX init (bf16), as numpy, made once."""
    return {arch: jax.tree.map(np.asarray, jax_init_params(
        jax_smoke_config(arch), jax.random.PRNGKey(0))) for arch in ARCHS}


@pytest.fixture(scope="module")
def step_runs():
    """``step_runs(arch, dtype)``: :func:`_step_run`, made once per module."""
    runs = {}

    def get(arch: str, dtype: str):
        if (arch, dtype) not in runs:
            runs[arch, dtype] = _step_run(arch, dtype)
        return runs[arch, dtype]

    return get


def _step_run(arch: str, dtype: str):
    """One train step of ``arch`` in ``dtype`` in both frameworks from the
    same parameters, AdamW state and batch."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    jopt = jadamw.adamw_init(jparams, jadamw.AdamWConfig(lr=LR))
    b = _batch(tcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jstep = jax.jit(jax_make_train_step(jcfg, opt_cfg=jadamw.AdamWConfig(lr=LR)))
    jnew, jnew_opt, jm = jstep(jparams, jopt, jb)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(jcfg, p, jb["inputs"], jb["targets"])))(jparams)

    model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    opt = bridge.opt_state_from_jax(jax.tree.map(np.asarray, jopt), model)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    opt, tm = make_train_step(tcfg, AdamWConfig(lr=LR))(model, opt, tb)
    return dict(jgrads=jax.tree.leaves(jgrads), jloss=float(jloss),
                jnew=jax.tree.leaves(jnew), jopt=jnew_opt, jm=jm,
                model=model, opt=opt, tm=tm)


def _leaf_kinds(model):
    """(layer kind, leaf name) of each parameter, in ``param_leaves()``
    order; ``embed`` and ``out_norm`` have kind None."""
    out = [(None, "embed")]
    for (pattern, _), group in zip(model.cfg.blocks, model.groups):
        for spec, pos in zip(pattern, group):
            out += [(spec.kind, k) for k in sorted(pos.keys())]
    return out + [(None, "out_norm")]


def _bf16_tol(kind_name, key):
    kind, name = kind_name
    if kind == "slstm" and name in SLSTM_GATES:
        return BF16_SLSTM_GATE_TOL[key]
    return BF16_TOL[key]


def _rel_to_max(got, want):
    """Largest difference as a share of the reference leaf's largest value."""
    got, want = _f32(got), _f32(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_fp32_train_step_matches_jax(arch, step_runs):
    r = step_runs(arch, "float32")
    model, opt = r["model"], r["opt"]
    tol = {**FP32_TOL, **FP32_TOL_ARCH.get(arch, {})}
    # the port's loss against the step's; the gradients against JAX's
    # value_and_grad of the same loss (the step returns no gradients)
    assert float(r["tm"]["loss"]) == pytest.approx(float(r["jm"]["loss"]),
                                                   rel=tol["loss"])
    assert r["jloss"] == pytest.approx(float(r["jm"]["loss"]), rel=1e-6)
    params = list(model.param_leaves())
    for i, (p, jg) in enumerate(zip(params, r["jgrads"])):
        assert tuple(p.grad.shape) == jg.shape
        assert _rel_to_max(p.grad, jg) <= tol["grad"], f"grad {i}"
    n_tiny = 0
    for name, mine, theirs in (
            ("param", params, r["jnew"]),
            ("mu", opt["mu"], jax.tree.leaves(r["jopt"]["mu"])),
            ("nu", opt["nu"], jax.tree.leaves(r["jopt"]["nu"])),
            ("master", opt["master"], jax.tree.leaves(r["jopt"]["master"]))):
        for i, (t, j, g) in enumerate(zip(mine, theirs, r["jgrads"])):
            g = np.abs(_f32(g))
            keep = g >= TINY_GRAD * g.max()
            if name == "param":
                n_tiny += int((~keep).sum())
            err = np.abs(_f32(t) - _f32(j))[keep]
            assert err.max() <= tol["state"], f"{name} {i}: {err.max()}"
    assert int(r["opt"]["count"]) == int(r["jopt"]["count"]) == 1
    # the elements left out: a handful of the thousands
    total = sum(p.numel() for p in params)
    assert n_tiny <= total * 1e-3, (n_tiny, total)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_train_step_matches_jax(arch, step_runs):
    r = step_runs(arch, "bfloat16")
    model, opt = r["model"], r["opt"]
    assert model.embed.dtype == torch.bfloat16
    assert float(r["tm"]["loss"]) == pytest.approx(float(r["jm"]["loss"]),
                                                   rel=BF16_TOL["loss"])
    params = list(model.param_leaves())
    kinds = _leaf_kinds(model)
    for i, (p, jg) in enumerate(zip(params, r["jgrads"])):
        assert p.grad.dtype == p.dtype
        assert _rel_to_max(p.grad, jg) <= _bf16_tol(kinds[i], "grad"), \
            f"grad {i}"
    for name, mine, theirs in (
            ("mu", opt["mu"], jax.tree.leaves(r["jopt"]["mu"])),
            ("nu", opt["nu"], jax.tree.leaves(r["jopt"]["nu"]))):
        for i, (t, j) in enumerate(zip(mine, theirs)):
            assert t.dtype == torch.bfloat16
            assert _rel_to_max(t, j) <= _bf16_tol(kinds[i], name), \
                f"{name} {i}"
    for name, mine, theirs in (
            ("param", params, r["jnew"]),
            ("master", opt["master"], jax.tree.leaves(r["jopt"]["master"]))):
        for i, (t, j) in enumerate(zip(mine, theirs)):
            err = float(np.abs(_f32(t) - _f32(j)).max())
            assert err <= BF16_TOL[name], f"{name} {i}: {err / LR} lr"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_digests_of_converted_trees_match_jax(arch, dtype, step_runs):
    """The port's fingerprint of JAX's gradients and of JAX's new
    parameters, crossed over, equals JAX's digests bit for bit."""
    r = step_runs(arch, dtype)
    jgrads = r["jgrads"]
    want = int(jax.jit(jattest.fingerprint_tree)(jgrads))
    assert fingerprint_tree(bridge.tensor_from_numpy(np.asarray(g))
                            for g in jgrads) == want
    assert fingerprint_tree(bridge.tensor_from_numpy(np.asarray(p))
                            for p in r["jnew"]) == int(r["jm"]["param_fp"])


@pytest.mark.parametrize("arch", ARCHS)
def test_digest_of_converted_init_matches_jax(arch, jax_inits):
    model = bridge.params_from_jax(jax_inits[arch], get_smoke_config(arch))
    want = int(jax.jit(jattest.fingerprint_tree)(jax_inits[arch]))
    assert fingerprint_tree(model.param_leaves()) == want
    # and back: the port's leaves as numpy carry JAX's bits
    for t, a in zip(model.param_leaves(), bridge.tree_leaves(jax_inits[arch])):
        np.testing.assert_array_equal(bridge.numpy_from_tensor(t), _bits(a))


# ---------------------------------------------------------------------------
# AdamW alone
# ---------------------------------------------------------------------------
_SHAPES = [(256, 64), (2, 16), (2, 64, 128), (64,), (3, 100)]


def _adamw_inputs(dtype, grad_scale, seed):
    rng = np.random.default_rng(seed)
    bf16 = jnp.bfloat16

    def draw(scale, dt):
        return [np.asarray(jnp.asarray(rng.standard_normal(s) * scale, dt))
                for s in _SHAPES]

    params = draw(0.1, dtype)
    grads = draw(grad_scale, dtype)
    mu = draw(grad_scale, bf16)
    nu = [np.abs(x) for x in draw(grad_scale ** 2, bf16)]
    master = [np.asarray(p, np.float32)
              + (rng.standard_normal(p.shape) * 1e-4).astype(np.float32)
              for p in params]
    return params, grads, {"mu": mu, "nu": nu, "master": master,
                           "count": np.int32(6)}


def _adamw_both(dtype, grad_scale, seed, **cfg):
    params, grads, state = _adamw_inputs(dtype, grad_scale, seed)
    # JAX op by op: each operation rounds on its own, as the port's do
    jp, jstate = jadamw.adamw_update(
        [jnp.asarray(p) for p in params], [jnp.asarray(g) for g in grads],
        jax.tree.map(jnp.asarray, state), jadamw.AdamWConfig(lr=LR, **cfg))
    tp = [bridge.tensor_from_numpy(p) for p in params]
    tstate = {k: [bridge.tensor_from_numpy(x) for x in v]
              for k, v in state.items() if k != "count"}
    tstate["count"] = torch.tensor(state["count"])
    tstate = adamw.adamw_update(tp, [bridge.tensor_from_numpy(g)
                                     for g in grads], tstate,
                                AdamWConfig(lr=LR, **cfg))
    assert int(tstate["count"]) == int(jstate["count"]) == 7
    return ([("param", jp, tp)]
            + [(k, jstate[k], tstate[k]) for k in ("mu", "nu", "master")])


@pytest.mark.parametrize("compress", [None, "int8"])
@pytest.mark.parametrize("grad_clip,grad_scale", [(0.0, 1e-1), (1.0, 1e-4)],
                         ids=["no-clip", "norm-below-clip"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_bit_for_bit_without_clipping(dtype, grad_clip,
                                                        grad_scale, compress):
    groups = _adamw_both(jnp.dtype(dtype), grad_scale, 3, grad_clip=grad_clip,
                         compress=compress)
    for name, theirs, mine in groups:
        for i, (j, t) in enumerate(zip(theirs, mine)):
            np.testing.assert_array_equal(_bits(t), _bits(j),
                                          err_msg=f"{name} {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax_with_clipping_active(dtype):
    """The global norm sums in another order, so the clip scale may differ
    in its last bit: 1e-6 relative."""
    groups = _adamw_both(jnp.dtype(dtype), 1e-1, 4, grad_clip=0.5)
    for name, theirs, mine in groups:
        for i, (j, t) in enumerate(zip(theirs, mine)):
            if name == "param" and dtype == "bfloat16":
                # bf16 weights: a 1e-6 change may cross a rounding boundary
                tol = dict(rtol=2 ** -8, atol=0)
            else:
                tol = dict(rtol=1e-6, atol=1e-12)
            np.testing.assert_allclose(_f32(t), _f32(j), **tol,
                                       err_msg=f"{name} {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_int8_matches_jax_bit_for_bit(dtype):
    rng = np.random.default_rng(5)
    for shape in ((8, 300), (4, 64), (1000,), (10, 20)):   # last two: < 256
        g = np.asarray(jnp.asarray(rng.standard_normal(shape) * 3e-3,
                                   jnp.dtype(dtype)))
        got = adamw._compress_int8(bridge.tensor_from_numpy(g))
        want = jadamw._compress_int8(jnp.asarray(g))     # op by op
        np.testing.assert_array_equal(_bits(got), _bits(want))


def test_adamw_slices_change_no_bit(monkeypatch):
    """Updating a leaf slice by slice gives the same bits as in one go."""
    params, grads, state = _adamw_inputs(np.float32, 1e-1, 6)

    def run():
        tp = [bridge.tensor_from_numpy(p) for p in params]
        st = {k: [bridge.tensor_from_numpy(x) for x in v]
              for k, v in state.items() if k != "count"}
        st["count"] = torch.tensor(state["count"])
        st = adamw.adamw_update(tp, [bridge.tensor_from_numpy(g)
                                     for g in grads], st, AdamWConfig(lr=LR))
        return [_bits(t) for t in tp + st["mu"] + st["nu"] + st["master"]]

    whole = run()
    monkeypatch.setattr(adamw, "SLICE", 1000)     # 17 slices of the embed
    for a, b in zip(whole, run()):
        np.testing.assert_array_equal(a, b)


def test_adamw_init_matches_jax(jax_inits):
    cfg = get_smoke_config("qwen3-8b")
    model = bridge.params_from_jax(jax_inits["qwen3-8b"], cfg)
    mine = adamw_init(model.param_leaves(), AdamWConfig())
    theirs = jadamw.adamw_init(jax.tree.map(jnp.asarray,
                                            jax_inits["qwen3-8b"]),
                               jadamw.AdamWConfig())
    for k in ("mu", "nu", "master"):
        for t, j in zip(mine[k], jax.tree.leaves(theirs[k])):
            assert str(t.dtype)[6:] == str(j.dtype)
            np.testing.assert_array_equal(_bits(t), _bits(j))
    assert int(mine["count"]) == int(theirs["count"]) == 0
    # the master is a copy, not the weights themselves
    mine["master"][0].add_(1.0)
    assert not torch.equal(mine["master"][0], model.embed.float())


# ---------------------------------------------------------------------------
# Train path details
# ---------------------------------------------------------------------------
_FORWARD_ONLY = ("sliding_window_attention", "rglru_scan",
                 "mlstm_chunkwise_state")


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_path_calls_no_forward_only_kernel(arch, remat, jax_inits,
                                                 monkeypatch):
    """The train step of every arch, with and without remat, reaches none
    of the forward-only kernels' wrappers: the recurrent layers' training
    forms call the plain versions by name."""
    def refuse(*args, **kwargs):
        raise AssertionError("the train path called a forward-only kernel")

    for name in _FORWARD_ONLY:
        monkeypatch.setattr(ops, name, refuse)
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    model = bridge.params_from_jax(jax_inits[arch], cfg)
    opt = adamw_init(model.param_leaves(), AdamWConfig())
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    _, m = make_train_step(cfg)(model, opt, batch)
    assert np.isfinite(float(m["loss"]))
    # the prefill of the same layers does go through the wrappers
    kinds = {spec.kind for spec in cfg.layer_list()}
    if kinds & {"rglru", "mlstm"} or any(
            spec.window for spec in cfg.layer_list()):
        with pytest.raises(AssertionError, match="forward-only"):
            ttr.prefill(model, batch["inputs"][:1])


def test_forward_only_wrappers_refuse_inputs_that_require_grad(monkeypatch):
    """On CUDA inputs the SWA, RG-LRU and mLSTM wrappers raise before
    launching when autograd would differentiate the call, and launch when
    it would not (here the device test and the kernels' operators are
    stand-ins)."""
    launched = []
    monkeypatch.setattr(ops, "_on_cuda", lambda *xs: True)
    for name in ("SWA", "RGLRU", "MLSTM"):
        monkeypatch.setattr(ops, name, lambda *a, name=name: (
            launched.append(name), None, None, None))
    x = torch.zeros(1, 16, 2, 8, requires_grad=True)
    g = torch.zeros(1, 16, 2, requires_grad=True)
    a = torch.zeros(1, 16, 8, requires_grad=True)
    calls = {"swa": lambda: ops.sliding_window_attention(x, x, x, 4),
             "rglru": lambda: ops.rglru_scan(a, a),
             "mlstm": lambda: ops.mlstm_chunkwise_state(x, x, x, g, g, 16)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"the {name} kernel is "
                                               f"forward only"):
            call()
    assert launched == []
    with torch.no_grad():
        for call in calls.values():
            call()
    assert launched == ["SWA", "RGLRU", "MLSTM"]


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_bit(arch, remat, jax_inits):
    """The loss and every gradient are bit-identical with remat "dots" or
    "full" and without it."""
    out = {}
    for mode in ("none", remat):
        cfg = dataclasses.replace(get_smoke_config(arch), remat=mode)
        model = bridge.params_from_jax(jax_inits[arch], cfg)
        model.requires_grad_(True)
        b = _batch(cfg)
        loss = ttr.lm_loss(model, torch.from_numpy(b["inputs"]),
                           torch.from_numpy(b["targets"]))
        loss.backward()
        out[mode] = [loss.detach()] + [p.grad for p in model.param_leaves()]
    for i, (a, b) in enumerate(zip(out["none"], out[remat])):
        assert torch.equal(a, b), f"leaf {i - 1}" if i else "loss"


def test_remat_recomputes_what_its_policy_says(jax_inits):
    """In the backward, "full" runs the forward's products again and "dots"
    keeps the products without batch dimensions (``aten.mm``), as JAX's
    ``checkpoint_dots_with_no_batch_dims`` does, but recomputes batched
    ones (``aten.bmm``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = {"mm": 0, "bmm": 0}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in self.n:
                self.n[name] += 1
            return func(*args, **(kwargs or {}))

    counts = {}
    for mode in ("none", "dots", "full"):
        cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), remat=mode)
        model = bridge.params_from_jax(jax_inits["qwen3-8b"], cfg)
        model.requires_grad_(True)
        b = _batch(cfg)
        loss = ttr.lm_loss(model, torch.from_numpy(b["inputs"]),
                           torch.from_numpy(b["targets"]))
        with Count() as c:
            loss.backward()
        counts[mode] = c.n
    assert counts["dots"]["mm"] == counts["none"]["mm"]
    assert counts["dots"]["bmm"] > counts["none"]["bmm"]
    assert counts["full"]["mm"] > counts["none"]["mm"]
    assert counts["full"]["bmm"] == counts["dots"]["bmm"]


def test_remat_refuses_an_unknown_policy(jax_inits):
    cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), remat="some")
    model = bridge.params_from_jax(jax_inits["qwen3-8b"], cfg)
    b = _batch(cfg)
    with pytest.raises(ValueError, match="remat"):
        ttr.lm_loss(model, torch.from_numpy(b["inputs"]),
                    torch.from_numpy(b["targets"]))


def test_train_step_leaves_grads_and_refuses_another_config(jax_inits):
    cfg = get_smoke_config("qwen3-8b")
    model = bridge.params_from_jax(jax_inits["qwen3-8b"], cfg)
    opt = adamw_init(model.param_leaves(), AdamWConfig())
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    opt, m = make_train_step(cfg)(model, opt, batch)
    assert set(m) == {"loss", "grad_fp", "param_fp"}
    grads = [p.grad for p in model.param_leaves()]
    assert all(g is not None and g.dtype == torch.bfloat16 for g in grads)
    assert fingerprint_tree(grads) == m["grad_fp"]
    assert fingerprint_tree(model.param_leaves()) == m["param_fp"]
    with pytest.raises(ValueError, match="built for"):
        make_train_step(get_smoke_config("gemma3-1b"))(model, opt, batch)
    silent = dataclasses.replace(cfg, attest=False)
    model = bridge.params_from_jax(jax_inits["qwen3-8b"], silent)
    opt = adamw_init(model.param_leaves(), AdamWConfig())
    _, m = make_train_step(silent)(model, opt, batch)
    assert set(m) == {"loss"}


def test_prefill_and_serve_step_wrappers(jax_inits):
    cfg = get_smoke_config("qwen3-8b")
    model = bridge.params_from_jax(jax_inits["qwen3-8b"], cfg)
    toks = torch.from_numpy(_batch(cfg)["inputs"][:1, :10])
    logits, caches = make_prefill(cfg, max_seq=16)(model, toks)
    want, _ = ttr.prefill(model, toks, max_seq=16)
    assert torch.equal(logits, want)
    tok = torch.argmax(logits, -1)
    got, _ = make_serve_step(cfg)(model, caches, tok, 10)
    assert got.shape == (1, cfg.vocab) and bool(torch.isfinite(got.float()).all())


# ---------------------------------------------------------------------------
# The system tests of tests/test_system.py on the port's stack
# ---------------------------------------------------------------------------
def _make_training_rig(jax_inits, arch="qwen3-8b", n=3, lr=1e-3):
    cfg = get_smoke_config(arch)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=24,
                                    global_batch=4, seed=1))
    opt_cfg = AdamWConfig(lr=lr)
    step_fn = make_train_step(cfg, opt_cfg=opt_cfg)
    replicas = []
    for _ in range(n):
        model = bridge.params_from_jax(jax_inits[arch], cfg)
        replicas.append({"model": model,
                         "opt": adamw_init(model.param_leaves(), opt_cfg)})

    def train_one(idx, step, data_epoch):
        batch = {k: torch.from_numpy(v)
                 for k, v in pipe.global_batch(step).items()}
        r = replicas[idx]
        r["opt"], m = step_fn(r["model"], r["opt"], batch)
        return m["grad_fp"], m["param_fp"], {"loss": float(m["loss"])}

    return replicas, train_one


def test_replicated_training_steps_agree(jax_inits):
    replicas, train_one = _make_training_rig(jax_inits)
    rt = ReplicatedTrainer.build(train_one)
    recs = rt.run_steps(4)
    assert [r["step"] for r in recs] == [0, 1, 2, 3]
    for rec in recs:
        fps = set(rec["fps"].values())
        assert len(fps) == 1, "honest replicas must produce identical state"
        assert rec["flagged"] == []


def test_byzantine_training_replica_flagged(jax_inits):
    replicas, train_one = _make_training_rig(jax_inits)
    rt = ReplicatedTrainer.build(train_one)
    recs = rt.run_steps(3, byzantine_replica=1)
    assert "t1" in recs[-1]["flagged"]
    assert "t0" not in recs[-1]["flagged"]


def test_coordinator_survives_leader_crash(jax_inits):
    replicas, train_one = _make_training_rig(jax_inits)
    rt = ReplicatedTrainer.build(
        train_one, cfg=ConsensusConfig(view_timeout_us=2000.0))
    rt.run_steps(2)
    rt.cluster.replicas[0].crash()
    recs = rt.run_steps(2)
    assert [r["step"] for r in recs] == [2, 3]


def test_gradient_compression_preserves_training(jax_inits):
    cfg = get_smoke_config("qwen3-8b")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=24,
                                    global_batch=4, seed=2))
    losses = {}
    for compress in (None, "int8"):
        oc = AdamWConfig(lr=3e-3, compress=compress)
        model = bridge.params_from_jax(jax_inits["qwen3-8b"], cfg)
        opt = adamw_init(model.param_leaves(), oc)
        step = make_train_step(cfg, opt_cfg=oc)
        for i in range(10):
            b = {k: torch.from_numpy(v) for k, v in pipe.global_batch(i).items()}
            opt, m = step(model, opt, b)
        losses[compress] = float(m["loss"])
    # int8 all-reduce compression costs < 5% loss difference here
    assert abs(losses["int8"] - losses[None]) < 0.05 * abs(losses[None])


def test_data_pipeline_deterministic_and_shardable():
    g = TokenPipeline(DataConfig(vocab=1000, seq_len=16, global_batch=8,
                                 seed=42, n_shards=1))
    s = TokenPipeline(DataConfig(vocab=1000, seq_len=16, global_batch=8,
                                 seed=42, n_shards=4))
    for step in (0, 5, 99):
        gb = g.batch(step, 0)
        sb = s.global_batch(step)
        assert gb["inputs"].shape == sb["inputs"].shape
        # replay determinism
        again = s.global_batch(step)
        np.testing.assert_array_equal(sb["inputs"], again["inputs"])


@pytest.mark.parametrize("n_shards", [1, 4])
def test_pipeline_batches_match_jax(n_shards):
    kw = dict(vocab=151936, seq_len=32, global_batch=8, seed=7,
              n_shards=n_shards)
    mine = TokenPipeline(DataConfig(**kw))
    theirs = JaxTokenPipeline(JaxDataConfig(**kw))
    for step in (0, 3, 1000):
        a, b = mine.global_batch(step), theirs.global_batch(step)
        for k in ("inputs", "targets"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])


def test_coordinator_app_is_deterministic_state_machine():
    a, b = CoordinatorApp(), CoordinatorApp()
    reqs = [json.dumps({"op": "step"}).encode(),
            json.dumps({"op": "attest", "step": 0, "who": "t0",
                        "grad_fp": 1, "param_fp": 2}).encode(),
            json.dumps({"op": "attest", "step": 0, "who": "t1",
                        "grad_fp": 1, "param_fp": 2}).encode(),
            json.dumps({"op": "checkpoint", "step": 0,
                        "param_fp": 2}).encode()]
    for r in reqs:
        assert a.apply(r) == b.apply(r)
    assert a.snapshot() == b.snapshot()
