"""Elastic scaling across the packages, ``tests/test_elastic.py``'s idea on
the port: the JAX package writes an unsharded checkpoint of the qwen3-8b
smoke model; 8 gloo ranks of the port load it, ``reshard`` it onto the
(2, 4) mesh and compute the loss there; the placed model is saved again,
and the JAX package's ``load_checkpoint`` reads that back."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.common import init_params as jax_init_params
from repro.models.transformer import lm_loss as jax_lm_loss

B, S = 4, 16
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    cfg = dataclasses.replace(jax_smoke_config("qwen3-8b"), dtype="float32")
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    inputs = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    targets = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    loss = float(jax.jit(lambda p: jax_lm_loss(cfg, p, inputs, targets))(
        params))
    fp = jax_save_checkpoint(str(d / "ckpt"), 3, params)
    torch.save({"ckpt": str(d / "ckpt"), "out": str(d / "resharded"),
                "fp": fp, "inputs": torch.from_numpy(inputs).long(),
                "targets": torch.from_numpy(targets).long()},
               d / "inputs.pt")
    out, _ = run_ranks("elastic", 8, d, timeout=300)
    return dict(d=d, params=params, loss=loss, fp=fp, out=out)


def test_resharded_checkpoint_keeps_its_fingerprint(run):
    assert run["out"]["step"] == 3
    assert run["out"]["fp"] == run["fp"]


def test_resharded_loss_matches_unsharded_jax(run):
    assert run["out"]["loss"] == pytest.approx(run["loss"], rel=LOSS_RTOL)


def test_sharded_save_loads_in_jax(run):
    """The placed model is written whole by rank 0: JAX's loader reads it,
    its fingerprint checks out, and every leaf has the original bits."""
    assert run["out"]["saved_fp"] == run["fp"]
    step, params, _ = jax_load_checkpoint(str(run["d"] / "resharded"),
                                          expect_fp=run["fp"])
    assert step == 4
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(run["params"])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
