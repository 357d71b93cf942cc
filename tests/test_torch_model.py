"""The port's gemma3 model against the JAX package on the smoke config:
parameters converted from the JAX init by ``bridge.params_from_jax``, inputs
made with numpy from a seed.  Everything but the bf16 fingerprint runs in
fp32, where the two frameworks differ only in the order of their sums."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jatt
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.runtime import attest as jattest

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as tatt
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.runtime import attest

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

ARCH = "gemma3-1b"
TOL = dict(rtol=2e-5, atol=2e-5)        # one layer's primitives
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)  # through the whole stack


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def fp32():
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(0))
    model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, model


def _layer0(jparams):
    """The first layer's parameters (a window layer) in both frameworks."""
    jp = jax.tree.map(lambda a: a[0], jparams["groups"][0][0])
    return jp, {k: _t(v) for k, v in jp.items()}


def test_fingerprint_tree_of_converted_bf16_params_matches_jax():
    jcfg = jax_smoke_config(ARCH)
    jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(0))
    model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                   get_smoke_config(ARCH))
    assert model.embed.dtype == torch.bfloat16
    leaves = list(model.param_leaves())
    jleaves = jax.tree.leaves(jparams)
    assert [tuple(t.shape) for t in leaves] == [x.shape for x in jleaves]
    want = int(jax.jit(jattest.fingerprint_tree)(jparams))
    assert attest.fingerprint_tree(leaves) == want


def test_norm_rope_ffn_match_jax(fp32):
    jcfg, tcfg, jparams, _ = fp32
    jp, tp = _layer0(jparams)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, tcfg.d_model)).astype(np.float32)
    scale = rng.standard_normal(tcfg.d_model).astype(np.float32)
    np.testing.assert_allclose(
        tcommon.rms_norm(_t(x), _t(scale)).numpy(),
        _np(jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale))), **TOL)
    heads = rng.standard_normal((2, 24, 3, 10)).astype(np.float32)
    pos = rng.integers(0, 1000, size=(2, 24))
    for fraction in (1.0, 0.5):
        np.testing.assert_allclose(
            tcommon.rope(_t(heads), torch.from_numpy(pos), 10_000.0,
                         fraction).numpy(),
            _np(jcommon.rope(jnp.asarray(heads), jnp.asarray(pos, jnp.int32),
                             10_000.0, fraction)), **TOL)
    np.testing.assert_allclose(tmoe.dense_ffn(tp, _t(x)).numpy(),
                               _np(jmoe.dense_ffn(jp, jnp.asarray(x))), **TOL)


def test_attention_paths_match_jax(fp32):
    jcfg, tcfg, jparams, _ = fp32
    jp, tp = _layer0(jparams)
    rng = np.random.default_rng(2)
    B, S = 2, 40
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S))
    jq, jk, jv = jatt.qkv_project(jcfg, jp, jnp.asarray(x),
                                  jnp.asarray(pos, jnp.int32))
    tq, tk, tv = tatt.qkv_project(tcfg, tp, _t(x), torch.from_numpy(pos.copy()))
    for a, b in ((tq, jq), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(a.numpy(), _np(b), **TOL)
    q, k, v = (_t(_np(a)) for a in (jq, jk, jv))
    np.testing.assert_allclose(
        tatt.banded_window_attention(q, k, v, 16).numpy(),
        _np(jatt.banded_window_attention(jq, jk, jv, 16)), **TOL)
    for chunk in (16, 64):     # several chunks with a short last one; one
        np.testing.assert_allclose(
            tatt.full_attention_chunked(q, k, v, chunk).numpy(),
            _np(jatt.full_attention_chunked(jq, jk, jv, chunk)), **TOL)


def _check_caches(tcaches, jcaches):
    jflat = jax.tree.leaves(jcaches)
    tflat = [pos[k] for group in tcaches for pos in group for k in sorted(pos)]
    assert len(tflat) == len(jflat)
    for t, j in zip(tflat, jflat):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.float().numpy(), _np(j), **MODEL_TOL)


def test_prefill_and_decode_match_jax(fp32):
    jcfg, tcfg, jparams, model = fp32
    S, max_seq = 40, 48            # S > the window of 16: the ring rolls
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
    for i in range(3):
        assert int(ttok[0]) == int(jtok[0])
        jlogits, jcaches = jdecode(jparams, jcaches, jtok, jnp.int32(S + i))
        tlogits, tcaches = ttr.decode_step(model, tcaches, ttok, S + i)
        np.testing.assert_allclose(tlogits.numpy(), _np(jlogits), **MODEL_TOL)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        ttok = torch.argmax(tlogits, -1)
    _check_caches(tcaches, jcaches)


def test_init_caches_match_jax():
    cfg, jcfg = get_smoke_config(ARCH), jax_smoke_config(ARCH)
    tcaches = ttr.init_caches(cfg, batch=2, max_seq=24)
    jcaches = jtr.init_caches(jcfg, batch=2, max_seq=24)
    _check_caches(tcaches, jcaches)
    assert tcaches[0][0]["k"].dtype == torch.bfloat16


def test_init_params_scales_and_leaf_order():
    cfg = get_smoke_config(ARCH)
    model = tcommon.init_params(cfg, torch.Generator().manual_seed(0))
    jparams = jcommon.init_params(jax_smoke_config(ARCH), jax.random.PRNGKey(0))
    for t, j in zip(model.param_leaves(), jax.tree.leaves(jparams)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.bfloat16
        jstd, tstd = float(jnp.std(j.astype(jnp.float32))), float(t.float().std())
        assert (jstd == 0) == (tstd == 0)
        assert tstd == pytest.approx(jstd, rel=0.1)
