"""The port's routed MoE, the embedding-input frontend and the configs of
all ten archs against the JAX package on the smoke configs.  Parameters
are converted from the JAX init by ``bridge.params_from_jax``; inputs are
made with numpy from a seed.  The routing is compared first wherever a
layer is, so that an expert chosen differently shows as a routing flip
and not as a numerical difference."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_train as train_parity
from test_torch_train import step_runs  # noqa: F401  (a fixture)

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import list_archs as jax_list_archs
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models.scan_utils import cost_mode
from repro.models import transformer as jtr
from repro.optim import adamw as jadamw
from repro.runtime import attest as jattest

from repro_torch import bridge
from repro_torch.configs import (LONG_CONTEXT_OK, PORT_ONLY, get_config,
                                 get_smoke_config, list_archs)
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.runtime.attest import fingerprint_tree

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

MOE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e")
FRONTEND_ARCHS = ("musicgen-large", "chameleon-34b", "llama4-scout-17b-a16e")
PORTED_BEFORE = ("gemma3-1b", "qwen3-8b", "recurrentgemma-2b", "xlstm-1.3b")
# One MoE layer: fp32 differs in the order of the products' sums (largest
# reading 1.4e-6 at outputs up to 3.6); bf16 rounds at other places (XLA
# keeps silu(h)·u in fp32 inside its fusion): largest reading 1.3e-2 of
# the output's largest value, two bf16 ulps; limits about twice those.
FFN_TOL = {"float32": 3e-6, "bfloat16": 3e-2}
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)   # through the whole stack in fp32
# bf16 training: JAX's own choice of experts may differ from the port's
# only where two logits nearly tie.  Readings on qwen3-moe-smoke with the
# port's choices pinned: 1 of the 384 (token, slot) choices of a step's two
# layers, logit gap 0.0117 at logits near 0.7 (llama4-scout-smoke: none);
# limits about twice the gap and four times the share
FLIP_GAP = 0.025
MAX_FLIPS = 0.01
#: reference config fields the port lacks: none since the dry-run slice
#: brought ``tie_embeddings``, ``max_seq``, ``kv_chunk`` and ``logits_fp32``
NOT_PORTED = set()
#: fields of the port alone (its own archs' layers, norms and routers), by
#: the dataclass that holds them, with the defaults at which they compute
#: the reference's model
PORT_FIELDS = {"model": {"post_norm": False},
               "layer": {"ffn": None, "rope": True},
               "moe": {"scoring": "softmax", "routed_scale": 1.0,
                       "d_shared": 0, "held": None}}


def _reference_fields(cfg: dict) -> dict:
    """A port config as a dict of the reference's fields: each field of
    the port alone taken out, after checking it holds its default."""
    def strip(d, kind):
        for k, default in PORT_FIELDS[kind].items():
            assert d.pop(k) == default, k
        return d

    cfg = strip(dict(cfg), "model")
    cfg["blocks"] = tuple(
        (tuple(strip(dict(spec), "layer") for spec in pattern), reps)
        for pattern, reps in cfg["blocks"])
    if cfg["moe"] is not None:
        cfg["moe"] = strip(dict(cfg["moe"]), "moe")
    return cfg


def _np(x):
    return np.asarray(x, np.float32)


def _configs(arch, dtype):
    return (dataclasses.replace(jax_smoke_config(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


def _models(arch, dtype):
    jcfg, tcfg = _configs(arch, dtype)
    jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(0))
    model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, model


def _as_jax(x: np.ndarray, dtype: str):
    """``x`` rounded to ``dtype`` in JAX, and the same bits as a tensor."""
    jx = jnp.asarray(x, jnp.dtype(dtype))
    return jx, bridge.tensor_from_numpy(np.asarray(jx))


# ---------------------------------------------------------------------------
# Routing and the MoE layer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [1, 2, 3])
def test_route_breaks_ties_as_jax_top_k(k):
    """Logits with many equal values: the same experts in the same order
    as ``jax.lax.top_k`` (the lower index first on a tie), and the same
    weights.  The router is the identity, so the logits are the inputs."""
    E = 8
    cfg = dataclasses.replace(
        get_smoke_config("qwen3-moe-235b-a22b"),
        moe=tcommon.MoEConfig(n_experts=E, top_k=k, d_expert=16))
    jcfg = dataclasses.replace(
        jax_smoke_config("qwen3-moe-235b-a22b"),
        moe=jcommon.MoEConfig(n_experts=E, top_k=k, d_expert=16))
    rng = np.random.default_rng(7)
    logits = rng.integers(0, 4, size=(64, E)).astype(np.float32)
    logits[0, :5] = [1, 3, 3, 0, 3]
    logits[1] = 2.0                                  # all equal
    eye = np.eye(E, dtype=np.float32)
    # ties at the cut: the k-th and the (k+1)-th largest are equal
    srt = -np.sort(-logits, axis=1)
    assert (srt[:, k - 1] == srt[:, k]).sum() >= 10
    tw, te = tmoe.route(cfg, torch.from_numpy(eye), torch.from_numpy(logits))
    jw, je = jmoe.route(jcfg, jnp.asarray(eye), jnp.asarray(logits))
    _, top_e = jax.lax.top_k(jnp.asarray(logits), k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(top_e))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), _np(jw), rtol=1e-6, atol=1e-7)
    if k == 2:
        assert te[0].tolist() == [1, 2]


def _layer_inputs(arch, case, dtype):
    """The first MoE layer's parameters in both frameworks and inputs
    (B 2, S 24).  "overflow": the first input feature is large and the
    router's first row sends it to expert 1, so more tokens choose expert
    1 than it has room for."""
    jcfg, tcfg, jparams, model = _models(arch, dtype)
    names = ("router", "w_gate", "w_up", "w_down")
    jp = {k: jparams["groups"][0][0][k][0] for k in names}
    if case == "overflow":
        jp["router"] = jp["router"].at[0].set(0.0).at[0, 1].set(1.0)
    tp = {k: bridge.tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    x = np.random.default_rng(11).standard_normal((2, 24, tcfg.d_model))
    if case == "overflow":
        x[..., 0] = 40.0
    jx, tx = _as_jax(x.astype(np.float32), dtype)
    return jcfg, tcfg, jp, tp, jx, tx


@pytest.mark.parametrize("case", ["random", "overflow"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax(arch, dtype, case):
    jcfg, tcfg, jp, tp, jx, tx = _layer_inputs(arch, case, dtype)
    m = tcfg.moe
    T = tx.shape[0] * tx.shape[1]
    tw, te = tmoe.route(tcfg, tp["router"], tx.reshape(T, -1))
    jw, je = jmoe.route(jcfg, jp["router"], jx.reshape(T, -1))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), _np(jw), rtol=1e-5, atol=1e-6)
    # tokens past an expert's capacity are dropped
    C = tmoe._capacity(T, m.top_k, m.n_experts, m.capacity_factor)
    assert C == jmoe._capacity(T, m.top_k, m.n_experts, m.capacity_factor)
    load = np.bincount(te.numpy().reshape(-1), minlength=m.n_experts)
    dropped = int(np.maximum(load - C, 0).sum())
    assert (dropped > 0) == (case == "overflow"), (load, C)

    want = _np(jax.jit(lambda p, x: jmoe.moe_ffn(jcfg, p, x))(jp, jx))
    got = tmoe.moe_ffn(tcfg, tp, tx)
    assert got.dtype == tx.dtype and tuple(got.shape) == want.shape
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= FFN_TOL[dtype], err
    if case == "overflow":
        # a dropped token gets nothing from the expert it chose: with
        # top-1 routing its output is exactly zero, in both frameworks
        if m.top_k == 1:
            zero = (want.reshape(T, -1) == 0).all(axis=1)
            assert zero.sum() == dropped
            assert (got.reshape(T, -1) == 0).all(dim=1).numpy().tolist() \
                == zero.tolist()


def _check_caches(tcaches, jcaches):
    jflat = jax.tree.leaves(jcaches)
    tflat = [pos[k] for group in tcaches for pos in group for k in sorted(pos)]
    assert len(tflat) == len(jflat)
    for t, j in zip(tflat, jflat):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.float().numpy(), _np(j), **MODEL_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_and_decode_match_jax(arch):
    jcfg, tcfg, jparams, model = _models(arch, "float32")
    S, max_seq = 40, 48
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, size=(1, S))
    jprefill = jax.jit(lambda p, t: jtr.prefill(jcfg, p, t, max_seq=max_seq))
    jdecode = jax.jit(lambda p, c, t, pos: jtr.decode_step(jcfg, p, c, t, pos))
    jlogits, jcaches = jprefill(jparams, jnp.asarray(toks, jnp.int32))
    tlogits, tcaches = ttr.prefill(model, torch.from_numpy(toks),
                                   max_seq=max_seq)
    np.testing.assert_allclose(tlogits.numpy(), _np(jlogits), **MODEL_TOL)
    _check_caches(tcaches, jcaches)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ttok = torch.argmax(tlogits, -1)
    for i in range(4):
        assert int(ttok[0]) == int(jtok[0])
        jlogits, jcaches = jdecode(jparams, jcaches, jtok, jnp.int32(S + i))
        tlogits, tcaches = ttr.decode_step(model, tcaches, ttok, S + i)
        np.testing.assert_allclose(tlogits.numpy(), _np(jlogits), **MODEL_TOL)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        ttok = torch.argmax(tlogits, -1)
    _check_caches(tcaches, jcaches)


def _pin_routing(monkeypatch, pins, seen):
    """Both frameworks route the n-th MoE layer they call to the experts in
    ``pins[n % len(pins)]``, weighed by the softmax of their own logits at
    those experts.  ``seen`` collects, for each JAX call as it runs, JAX's
    own choice, the pinned one and JAX's logits."""
    calls = {"jax": 0, "torch": 0}

    def next_pin(who):
        calls[who] += 1
        return pins[(calls[who] - 1) % len(pins)]

    def jax_route(cfg, w, x):
        e = jnp.asarray(next_pin("jax"))
        logits = x.astype(jnp.float32) @ w
        own = jax.lax.top_k(logits, cfg.moe.top_k)[1]
        jax.debug.callback(
            lambda *a: seen.append(tuple(np.asarray(v) for v in a)),
            own, e, logits)
        return jax.nn.softmax(jnp.take_along_axis(logits, e, -1), -1), e

    def torch_route(cfg, w, x):
        e = torch.from_numpy(next_pin("torch"))
        logits = x.float() @ w
        return torch.softmax(torch.gather(logits, -1, e), -1), e

    monkeypatch.setattr(jmoe, "route", jax_route)
    monkeypatch.setattr(tmoe, "route", torch_route)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_step_matches_jax(arch, dtype, step_runs,  # noqa: F811
                                    monkeypatch):
    """One train step against the jitted JAX step, with the limits of
    ``test_torch_train.py``: loss, every gradient leaf, the new state, and
    the digests of the crossed gradients and parameters.

    In bf16 the two frameworks round activations at other places, and a
    token whose k-th and (k+1)-th logits nearly tie can pick another
    expert (qwen3-moe-smoke: 3 of 96 tokens' second choices in layer 1,
    logit gaps up to 0.012), which moves its output by a whole expert's
    share.  So the bf16 step runs with each layer's experts pinned, in
    both frameworks, to those the port chose, JAX's layers unrolled
    (``cost_mode``) so that each traces its own route; and JAX's own
    choices must differ from the pinned ones only at such near-ties."""
    if dtype == "float32":
        train_parity.test_fp32_train_step_matches_jax(arch, step_runs)
        train_parity.test_digests_of_converted_trees_match_jax(
            arch, dtype, step_runs)
        return
    _, tcfg, _, model = _models(arch, dtype)
    b = train_parity._batch(tcfg)
    pins, seen = [], []
    real = tmoe.route

    def record(cfg, w, x):
        out = real(cfg, w, x)
        pins.append(out[1].numpy())
        return out

    monkeypatch.setattr(tmoe, "route", record)
    ttr.lm_loss(model, torch.from_numpy(b["inputs"]),
                torch.from_numpy(b["targets"]))
    assert len(pins) == tcfg.n_layers
    _pin_routing(monkeypatch, pins, seen)
    with cost_mode():
        run = train_parity._step_run(arch, dtype)
    train_parity.test_bf16_train_step_matches_jax(arch, lambda *_: run)
    train_parity.test_digests_of_converted_trees_match_jax(
        arch, dtype, lambda *_: run)

    assert len(seen) == 2 * tcfg.n_layers   # the step and value_and_grad
    k = tcfg.moe.top_k
    flips = 0
    for own, pinned, logits in seen:
        for row, a, p in zip(logits, own, pinned):
            if set(a.tolist()) != set(p.tolist()):
                flips += 1
                gap = row[a].min() - row[np.setdiff1d(p, a)].max()
                assert 0 <= gap <= FLIP_GAP, (a, p, row)
    assert flips <= MAX_FLIPS * len(seen) * len(own) * k


# ---------------------------------------------------------------------------
# The embedding-input frontend
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_frontend_prefill_and_loss_match_jax(arch):
    """(B, S, D) embeddings in place of tokens: prefill's logits and
    caches, and the loss, against JAX in fp32.  On the port, a prefill
    from ``embed(tokens)`` equals the prefill from the tokens bit for
    bit."""
    jcfg, tcfg, jparams, model = _models(arch, "float32")
    assert tcfg.frontend is not None
    rng = np.random.default_rng(5)
    B, S = 2, 24
    emb = (rng.standard_normal((B, S, tcfg.d_model)) * 0.5).astype(np.float32)
    targets = rng.integers(0, tcfg.vocab, size=(B, S))
    jlogits, jcaches = jax.jit(lambda p, e: jtr.prefill(jcfg, p, e))(
        jparams, jnp.asarray(emb))
    tlogits, tcaches = ttr.prefill(model, torch.from_numpy(emb))
    np.testing.assert_allclose(tlogits.numpy(), _np(jlogits), **MODEL_TOL)
    _check_caches(tcaches, jcaches)
    jloss = jax.jit(lambda p, e, t: jtr.lm_loss(jcfg, p, e, t))(
        jparams, jnp.asarray(emb), jnp.asarray(targets, jnp.int32))
    tloss = ttr.lm_loss(model, torch.from_numpy(emb),
                        torch.from_numpy(targets))
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)

    toks = torch.from_numpy(rng.integers(0, tcfg.vocab, size=(1, S)))
    by_tok, c_tok = ttr.prefill(model, toks)
    by_emb, c_emb = ttr.prefill(model, ttr.embed(model, toks))
    assert torch.equal(by_tok, by_emb)
    for g_tok, g_emb in zip(c_tok, c_emb):
        for p_tok, p_emb in zip(g_tok, g_emb):
            assert all(torch.equal(p_tok[k], p_emb[k]) for k in p_tok)


# ---------------------------------------------------------------------------
# Configs, parameters, crossing
# ---------------------------------------------------------------------------
def test_registry_lists_the_reference_archs():
    assert [a for a in list_archs() if a not in PORT_ONLY] == jax_list_archs()
    assert len(list_archs()) == 10 + len(PORT_ONLY)
    assert not PORT_ONLY & set(jax_list_archs())
    from repro.configs import LONG_CONTEXT_OK as jax_long
    assert LONG_CONTEXT_OK == jax_long


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jax_list_archs())
def test_config_matches_reference_field_by_field(arch, smoke):
    t = _reference_fields(dataclasses.asdict(
        (get_smoke_config if smoke else get_config)(arch)))
    j = dataclasses.asdict((jax_smoke_config if smoke else jax_config)(arch))
    assert set(j) - set(t) == NOT_PORTED and set(t) <= set(j)
    assert j["tie_embeddings"]
    assert t == {k: j[k] for k in t}


@pytest.mark.parametrize("arch", jax_list_archs())
def test_converted_init_fingerprints_as_jax(arch):
    jparams = jax.tree.map(np.asarray, jcommon.init_params(
        jax_smoke_config(arch), jax.random.PRNGKey(0)))
    model = bridge.params_from_jax(jparams, get_smoke_config(arch))
    assert [tuple(p.shape) for p in model.param_leaves()] == \
        [a.shape for a in jax.tree.leaves(jparams)]
    want = int(jax.jit(jattest.fingerprint_tree)(jparams))
    assert fingerprint_tree(model.param_leaves()) == want


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bridge_carries_moe_leaves_both_ways(arch):
    """The fp32 router and the stacked (reps, E, ., .) experts cross to
    the port and back, in parameters and in AdamW state, bit for bit."""
    cfg = get_smoke_config(arch)
    jparams = jcommon.init_params(jax_smoke_config(arch),
                                  jax.random.PRNGKey(1))
    jopt = jadamw.adamw_init(jparams, jadamw.AdamWConfig())
    jopt = jax.tree.map(lambda a: a + 1 if a.ndim else a, jopt)  # non-zero
    model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    pos = model.groups[0][0]
    m = cfg.moe
    assert pos["router"].dtype == torch.float32
    assert tuple(pos["w_gate"].shape) == (2, m.n_experts, cfg.d_model,
                                          m.d_expert)
    assert tuple(pos["w_down"].shape) == (2, m.n_experts, m.d_expert,
                                          cfg.d_model)
    opt = bridge.opt_state_from_jax(jax.tree.map(np.asarray, jopt), model)
    for want, got in ((jparams, bridge.params_to_jax(model)),
                      ({k: jopt[k] for k in ("mu", "nu", "master")},
                       {k: v for k, v in bridge.opt_state_to_jax(
                           opt, model).items() if k != "count"})):
        assert jax.tree.structure(want) == jax.tree.structure(got)
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(train_parity._bits(a), b)


def _draw_two_temporaries(cfg, gen):
    """``init_params`` as it drew before it scaled in place: the noise,
    then a second fp32 tensor ``noise * scale``."""
    model = tcommon.Transformer(cfg)
    with torch.no_grad():
        def draw(p, scale):
            noise = torch.randn(p.shape, generator=gen, dtype=torch.float32)
            p.copy_(noise * scale)

        draw(model.embed, cfg.d_model ** -0.5)
        for (pattern, _), group in zip(cfg.blocks, model.groups):
            for spec, pos in zip(pattern, group):
                for name, leaf in tcommon.layer_leaves(cfg, spec).items():
                    if leaf.scale is not None:
                        draw(pos[name], leaf.scale)
                    elif leaf.fill:
                        pos[name].fill_(leaf.fill)
    return model


def _digest(model):
    h = hashlib.sha256()
    for p in model.param_leaves():
        h.update(bridge.numpy_from_tensor(p).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", PORTED_BEFORE)
def test_init_params_scaled_in_place_keeps_every_bit(arch, dtype):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    got = tcommon.init_params(cfg, torch.Generator().manual_seed(0))
    want = _draw_two_temporaries(cfg, torch.Generator().manual_seed(0))
    assert _digest(got) == _digest(want)
