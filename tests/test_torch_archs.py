"""The reference's per-arch coverage (``tests/test_archs_smoke.py``) on the
port, held against JAX, for all ten archs' smoke configs: one train step
(within ``test_torch_train.py``'s limits) and the reference's
loss-decrease run.  ``test_torch_archs_decode.py`` holds the prefill and
decode steps.  Parameters are converted from the JAX init (``bridge``)."""

import jax
import numpy as np
import pytest
import torch

import test_torch_train as train_parity
from test_torch_train import step_runs  # noqa: F401  (a fixture)

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.common import init_params as jax_init_params

from repro_torch import bridge
from repro_torch.configs import PORT_ONLY, get_smoke_config, list_archs
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.steps import make_train_step

torch.set_num_threads(2)

ARCHS = [a for a in list_archs() if a not in PORT_ONLY]  # held against JAX
# The new state of an element whose gradient is just above TINY_GRAD of
# its leaf's largest moves with Adam's eps (the comment at TINY_GRAD in
# test_torch_train.py).  Readings: gemma3-4b-smoke 1.36e-2 lr (an element
# of |g| 1.0e-7, 3.3e-6 of its leaf's largest, whose gradients differ by
# 8%: 2.7e-7 of the leaf's largest), musicgen-large-smoke 1.02e-2 lr (|g|
# 7.1e-8, 2.1e-6 of the largest, 5% apart); limits about twice the
# readings.  Every other arch keeps test_torch_train.py's limits.
FP32_TOL_ARCH = {"gemma3-4b": {"state": 3e-2 * train_parity.LR},
                 "musicgen-large": {"state": 2e-2 * train_parity.LR}}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, step_runs, monkeypatch):  # noqa: F811
    """One fp32 train step: the loss, every gradient leaf and the new
    parameters and AdamW state, as ``test_torch_train.py`` holds them."""
    for a, tol in FP32_TOL_ARCH.items():
        monkeypatch.setitem(train_parity.FP32_TOL_ARCH, a, tol)
    train_parity.test_fp32_train_step_matches_jax(arch, step_runs)


def test_train_loss_decreases_small_model():
    """The reference's run: qwen3-8b's smoke config from the JAX init,
    ``TokenPipeline`` seed 3 (8 × 32 tokens a step), AdamW at lr 3e-3,
    30 steps; the loss falls by at least 0.2."""
    cfg = get_smoke_config("qwen3-8b")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=8, seed=3))
    jparams = jax_init_params(jax_smoke_config("qwen3-8b"),
                              jax.random.PRNGKey(0))
    model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    opt_cfg = AdamWConfig(lr=3e-3)
    opt = adamw_init(model.param_leaves(), opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    losses = []
    for i in range(30):
        b = {k: torch.from_numpy(v) for k, v in pipe.global_batch(i).items()}
        opt, m = step(model, opt, b)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.2, losses[:3] + losses[-3:]
