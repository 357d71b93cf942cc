"""The port's serving cost model, serving plane and workload library
against the JAX package's (``repro.serve``, ``repro.workloads``), and the
last four config fields (``tie_embeddings``, ``logits_fp32``, ``max_seq``,
``kv_chunk``) against the reference's model on the smoke configs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as jserve
from repro import workloads as jworkloads
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import list_archs as jax_list_archs
from repro.core.consensus import AdmissionConfig as JAdmission
from repro.core.consensus import ConsensusConfig as JConsensus
from repro.models import common as jcommon
from repro.models import transformer as jtr

from repro_torch import bridge, serve, workloads
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.consensus import AdmissionConfig, ConsensusConfig
from repro_torch.models import transformer as ttr
from repro_torch.serve import costmodel

torch.set_num_threads(2)

MODEL_TOL = dict(rtol=1e-4, atol=1e-4)  # test_torch_model.py's stack limit
RECURRENT = {"xlstm-1.3b", "recurrentgemma-2b"}


# ---------------------------------------------------------------------------
# The cost model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", jax_list_archs())
def test_from_arch_matches_reference(arch):
    if arch in RECURRENT:
        for build in (jserve.ServingCostModel.from_arch,
                      serve.ServingCostModel.from_arch):
            with pytest.raises(ValueError, match="attention stacks"):
                build(arch)
        return
    j = jserve.ServingCostModel.from_arch(arch, batch=8)
    t = serve.ServingCostModel.from_arch(arch, batch=8)
    for key in ("param_bytes", "active_params", "kv_bytes_per_token",
                "batch"):
        assert getattr(t, key) == getattr(j, key), key


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen3-moe-235b-a22b"])
def test_request_us_matches_reference_with_its_constants(arch):
    """The formulas are the reference's: with the reference's chip
    constants the port prices every request as it does."""
    j = jserve.ServingCostModel.from_arch(arch)
    t = dataclasses.replace(serve.ServingCostModel.from_arch(arch),
                            peak_flops=jserve.PEAK_FLOPS,
                            hbm_bw=jserve.HBM_BW)
    for n_prompt, n_decode, ctx in ((16, 8, 0), (384, 8, 1024),
                                    (4096, 64, 32768)):
        assert t.request_us(n_prompt, n_decode, ctx) == \
            j.request_us(n_prompt, n_decode, ctx)
        assert t.decode_step_us(ctx) == j.decode_step_us(ctx)


def test_profile_is_the_cards_own():
    """The default constants are the H100's, not the TPU's, and lie within
    30–105% of its data sheet (989 TFLOP/s bf16, 3.35 TB/s)."""
    assert costmodel.PEAK_FLOPS != jserve.PEAK_FLOPS
    assert costmodel.HBM_BW != jserve.HBM_BW
    assert 0.30 * 989e12 <= costmodel.PEAK_FLOPS <= 1.05 * 989e12
    assert 0.30 * 3.35e12 <= costmodel.HBM_BW <= 1.05 * 3.35e12
    assert serve.ServingCostModel.from_counts("x", 1e9, 0).peak_flops == \
        costmodel.PEAK_FLOPS


# ---------------------------------------------------------------------------
# Workloads
# ---------------------------------------------------------------------------
def test_llm_session_traces_match_reference():
    for seed in (0, 7):
        kw = dict(session_rate_rps=3_000.0, mean_turns=2.0, think_us=1_000.0,
                  first_prompt_tokens=8, next_prompt_tokens=4,
                  decode_tokens=4)
        assert workloads.llm_session_trace(seed, 20_000.0, **kw) == \
            jworkloads.llm_session_trace(seed, 20_000.0, **kw)


@pytest.mark.parametrize("name,kw", [
    ("poisson_times", dict(rate_rps=50_000.0, duration_us=20_000.0)),
    ("ramp_times", dict(rate0_rps=10_000.0, rate1_rps=90_000.0,
                        duration_us=20_000.0)),
    ("flash_crowd_times", dict(base_rps=5_000.0, peak_rps=80_000.0,
                               t_start_us=5_000.0, ramp_us=2_000.0,
                               hold_us=5_000.0, decay_us=8_000.0,
                               duration_us=40_000.0)),
    ("diurnal_times", dict(mean_rps=20_000.0, amplitude=0.5,
                           period_us=20_000.0, duration_us=40_000.0)),
])
def test_arrivals_match_reference(name, kw):
    got = getattr(workloads, name)(np.random.default_rng(3), **kw)
    want = getattr(jworkloads, name)(np.random.default_rng(3), **kw)
    np.testing.assert_array_equal(got, want)


def test_auction_day_trace_matches_reference():
    kw = dict(seed=5, duration_us=20_000.0, base_rps=5_000.0,
              open_peak_rps=40_000.0, close_peak_rps=30_000.0)
    assert workloads.auction_day_trace(**kw) == \
        jworkloads.auction_day_trace(**kw)


# ---------------------------------------------------------------------------
# The serving plane
# ---------------------------------------------------------------------------
def _flash_report(pkg, consensus, admission):
    """One flash-crowd trace through ``pkg``'s plane (``test_serving.py``'s
    overloaded configuration, priced with the reference's constants): the
    SLO report."""
    cm = dataclasses.replace(
        pkg.ServingCostModel.from_counts("toy-1b", n_params=1e9,
                                         kv_bytes_per_token=26_624, batch=32),
        peak_flops=jserve.PEAK_FLOPS, hbm_bw=jserve.HBM_BW)
    cfg = consensus(t=16, window=32, max_batch=4, pipeline_depth=8,
                    view_timeout_us=50_000.0, max_request_bytes=4096)
    plane = pkg.InferencePlane.build(
        cm, pkg.SLOSpec(deadline_us=3_000.0),
        admission=admission(queue_high=3, queue_accept=1), cfg=cfg)
    wl = workloads if pkg is serve else jworkloads
    trace = wl.llm_session_trace(7, 20_000.0, session_rate_rps=3_000.0,
                                 mean_turns=2.0, think_us=1_000.0,
                                 first_prompt_tokens=8, next_prompt_tokens=4,
                                 decode_tokens=4)
    plane.run_trace(trace)
    return plane.slo_report()


def test_plane_report_matches_reference_on_a_flash_crowd():
    got = _flash_report(serve, ConsensusConfig, AdmissionConfig)
    want = _flash_report(jserve, JConsensus, JAdmission)
    assert got["shed"] > 0 and got["served"] > 0
    assert got == want


# ---------------------------------------------------------------------------
# The config fields
# ---------------------------------------------------------------------------
def _pair(arch, **fields):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               **fields)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               **fields)
    jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(0))
    model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, model


@pytest.mark.parametrize("fields", [dict(tie_embeddings=False),
                                    dict(logits_fp32=True),
                                    dict(tie_embeddings=False,
                                         logits_fp32=True)],
                         ids=["untied", "logits_fp32", "both"])
@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-1b"])
def test_config_fields_give_reference_logits_and_loss(arch, fields):
    jcfg, tcfg, jparams, model = _pair(arch, **fields)
    assert (model.lm_head is None) == tcfg.tie_embeddings
    if not tcfg.tie_embeddings:
        # drawn in the reference's key order, carried by the bridge, and
        # in ``jax.tree.leaves`` order: groups, lm_head, out_norm
        np.testing.assert_array_equal(model.lm_head.numpy(),
                                      np.asarray(jparams["lm_head"]))
        paths = [p for p, _ in model.leaf_items()]
        assert paths[-2:] == [("lm_head",), ("out_norm",)]
        assert [tuple(p.shape) for p in model.param_leaves()] == \
            [a.shape for a in jax.tree.leaves(jparams)]
        back = bridge.params_to_jax(model)
        np.testing.assert_array_equal(back["lm_head"],
                                      np.asarray(jparams["lm_head"]))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tcfg.vocab, size=(2, 24)).astype(np.int32)
    targets = rng.integers(0, tcfg.vocab, size=(2, 24)).astype(np.int32)
    jlogits = jtr.forward_train(jcfg, jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tlogits = ttr.forward_train(model, torch.from_numpy(tokens))
    want_dtype = torch.float32
    assert tlogits.dtype == want_dtype
    np.testing.assert_allclose(tlogits.numpy(),
                               np.asarray(jlogits, np.float32), **MODEL_TOL)
    jloss = float(jtr.lm_loss(jcfg, jparams, jnp.asarray(tokens),
                              jnp.asarray(targets)))
    with torch.no_grad():
        tloss = float(ttr.lm_loss(model, torch.from_numpy(tokens),
                                  torch.from_numpy(targets)))
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)


def test_logits_fp32_casts_bf16_logits():
    """In a bf16 model the flag makes the logits fp32, as the reference's
    ``logits_fn`` casts them; without it they keep the model's dtype."""
    for flag, want in ((True, torch.float32), (False, torch.bfloat16)):
        jcfg, tcfg = (dataclasses.replace(c, logits_fp32=flag) for c in
                      (jax_smoke_config("qwen3-8b"),
                       get_smoke_config("qwen3-8b")))
        jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(0))
        model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                       tcfg)
        tokens = np.arange(16, dtype=np.int32).reshape(1, 16)
        with torch.no_grad():
            got = ttr.forward_train(model, torch.from_numpy(tokens))
        jgot = jtr.forward_train(jcfg, jparams, jnp.asarray(tokens))
        assert got.dtype == want
        assert str(jgot.dtype) == str(want)[6:]


@pytest.mark.parametrize("arch", jax_list_archs())
def test_sequence_limit_and_kv_chunk_are_the_references(arch):
    """``max_seq`` and ``kv_chunk``: fields the model code of neither
    package reads, equal to the reference's on every full config."""
    from repro.configs import get_config as jax_config
    t, j = get_config(arch), jax_config(arch)
    assert (t.max_seq, t.kv_chunk) == (j.max_seq, j.kv_chunk)
