"""The reference's per-arch coverage (``tests/test_archs_smoke.py``) on the
port, the serving half: for all ten archs' smoke configs, a prefill and
three greedy decode steps held against JAX (logits and caches within
``test_torch_model.py``'s whole-stack limit, the same tokens).
Parameters are converted from the JAX init (``bridge``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.common import init_params as jax_init_params
from repro.models import transformer as jtr

from repro_torch import bridge
from repro_torch.configs import PORT_ONLY, get_smoke_config, list_archs
from repro_torch.models import transformer as ttr

torch.set_num_threads(2)

ARCHS = [a for a in list_archs() if a not in PORT_ONLY]  # held against JAX
B, S = 2, 24                       # the reference's smoke shapes
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)   # test_torch_model.py's


def _np(x):
    return np.asarray(x, np.float32)


def _inputs(cfg):
    """Tokens, or for a modality frontend (B, S, D) embeddings, as the
    reference's smoke test feeds them; drawn with numpy from a seed."""
    rng = np.random.default_rng(7)
    if cfg.frontend:
        return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    return rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches_jax(arch):
    """A prefill of S positions (tokens, or embeddings for a frontend) and
    three greedy decode steps in fp32: each step's logits and the caches
    against JAX's, and the same greedy tokens."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    inputs = _inputs(tcfg)
    max_seq = S + 8
    jlogits, jcaches = jax.jit(lambda p, i: jtr.prefill(
        jcfg, p, i, max_seq=max_seq))(jparams, jnp.asarray(inputs))
    tlogits, tcaches = ttr.prefill(model, torch.from_numpy(inputs),
                                   max_seq=max_seq)
    assert tuple(tlogits.shape) == (B, tcfg.vocab)
    np.testing.assert_allclose(tlogits.numpy(), _np(jlogits), **MODEL_TOL)
    jdecode = jax.jit(lambda p, c, t, pos: jtr.decode_step(jcfg, p, c, t,
                                                           pos))
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ttok = torch.argmax(tlogits, -1)
    for i in range(3):
        assert ttok.tolist() == np.asarray(jtok).tolist()
        jlogits, jcaches = jdecode(jparams, jcaches, jtok, jnp.int32(S + i))
        tlogits, tcaches = ttr.decode_step(model, tcaches, ttok, S + i)
        assert np.isfinite(tlogits.numpy()).all()
        np.testing.assert_allclose(tlogits.numpy(), _np(jlogits),
                                   **MODEL_TOL)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        ttok = torch.argmax(tlogits, -1)
    jflat = jax.tree.leaves(jcaches)
    tflat = [pos[k] for group in tcaches for pos in group
             for k in sorted(pos)]
    assert len(tflat) == len(jflat)
    for t, j in zip(tflat, jflat):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.float().numpy(), _np(j), **MODEL_TOL)
