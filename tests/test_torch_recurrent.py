"""The port's recurrent families (recurrentgemma's RG-LRU, xLSTM's mLSTM and
sLSTM) against the JAX package on the smoke configs: the mLSTM kernel's
plain version and its final state inside ``mlstm_train``, the blocks and
their decode steps, whole-model prefill and decode, the weight fingerprint,
and the replicated token server (the kernels' plain versions against the
Pallas kernels are in ``test_torch_kernels.py``).  Parameters are converted
from the JAX init by ``bridge.params_from_jax``; inputs are made with numpy
from a seed.  Everything but the bf16 fingerprint runs in fp32, where the two frameworks differ only in the order of their
sums (and the RG-LRU scan: sequential here, log-depth in JAX)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import common as jcommon
from repro.models import recurrent as jrec
from repro.models import transformer as jtr
from repro.runtime import attest as jattest
from repro.runtime.server import ReplicatedServer as JaxReplicatedServer

from repro_torch import bridge
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.mlstm import mlstm_plain
from repro_torch.launch import serve
from repro_torch.models import common as tcommon
from repro_torch.models import recurrent as trec
from repro_torch.models import transformer as ttr
from repro_torch.runtime import attest
from repro_torch.runtime.server import ReplicatedServer

torch.set_num_threads(2)
torch.backends.cuda.matmul.allow_tf32 = False

ARCHS = ("recurrentgemma-2b", "xlstm-1.3b")
TOL = dict(rtol=2e-5, atol=2e-5)         # one block's primitives in fp32
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)   # through the whole stack in fp32
#: a chunk shorter than the test's 40 tokens: the mLSTM input is padded
#: from 40 to 48, so the final m carries the padding quirk
CHUNK = 16


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _configs(arch):
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               mlstm_chunk=CHUNK)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               mlstm_chunk=CHUNK)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=ARCHS)
def fp32(request):
    jcfg, tcfg = _configs(request.param)
    jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(0))
    model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    return jcfg, tcfg, jparams, model


def _layer(jparams, group, pos):
    jp = jax.tree.map(lambda a: a[0], jparams["groups"][group][pos])
    return jp, {k: _t(v) for k, v in jp.items()}


def _check_tree(tree, jtree, tol):
    """A dict (or nested tuples of dicts) of tensors against the JAX pytree,
    leaf by leaf in ``jax.tree.leaves`` order."""
    jflat = jax.tree.leaves(jtree)
    tflat = [d[k] for d in _dicts(tree) for k in sorted(d)]
    assert len(tflat) == len(jflat)
    for t, j in zip(tflat, jflat):
        assert tuple(t.shape) == j.shape
        np.testing.assert_allclose(t.float().numpy(), _np(j), **tol)


def _dicts(tree):
    if isinstance(tree, dict):
        return [tree]
    return [d for sub in tree for d in _dicts(sub)]


# ---------------------------------------------------------------------------
# The mLSTM kernel's plain version inside the model
# ---------------------------------------------------------------------------
def test_mlstm_plain_state_matches_mlstm_train():
    """The plain version's final (C, n, m) on the gates of zero-padded input
    equals ``mlstm_train``'s, padding quirk included: S = 40 pads to 48 with
    q = k = v = 0, input gate 0 and forget gate bf = 3."""
    jcfg, tcfg = _configs("xlstm-1.3b")
    jparams = jcommon.init_params(jcfg, jax.random.PRNGKey(0))
    jp, tp = _layer(jparams, 0, 0)
    x = np.random.default_rng(4).standard_normal((2, 40, tcfg.d_model)
                                                 ).astype(np.float32)
    jh, jstate = jrec.mlstm_train(jcfg, jp, jnp.asarray(x), chunk=CHUNK)
    th, tstate = trec.mlstm_train(tcfg, tp, _t(x), chunk=CHUNK)
    np.testing.assert_allclose(th.numpy(), _np(jh), **TOL)
    _check_tree(tstate, jstate, TOL)
    xp = torch.nn.functional.pad(_t(x), (0, 0, 0, 8))
    h, (C, n, m) = mlstm_plain(*trec._mlstm_gates(tcfg, tp, xp), CHUNK)
    _check_tree({"C": C, "n": n, "m": m}, jstate, TOL)
    # without the padding the stabiliser differs: the quirk is real
    _, unpadded = jrec.mlstm_train(jcfg, jp, jnp.asarray(x), chunk=40)
    assert not np.allclose(_np(unpadded["m"]), m.numpy(), atol=1e-2)


# ---------------------------------------------------------------------------
# Blocks, steps and the whole model in fp32
# ---------------------------------------------------------------------------
_BLOCKS = {
    "rglru": (trec.rglru_block, trec.rglru_step, jrec.rglru_block,
              jrec.rglru_step),
    "mlstm": (trec.mlstm_block, trec.mlstm_step, jrec.mlstm_block,
              jrec.mlstm_step),
    "slstm": (trec.slstm_block, trec.slstm_step, jrec.slstm_block,
              jrec.slstm_step),
}


def test_recurrent_blocks_and_steps_match_jax(fp32):
    jcfg, tcfg, jparams, _ = fp32
    rng = np.random.default_rng(6)
    kinds = set()
    for pos, spec in enumerate(tcfg.blocks[0][0]):
        if spec.kind == "attn" or spec.kind in kinds:
            continue
        kinds.add(spec.kind)
        block, step, jblock, jstep = _BLOCKS[spec.kind]
        jp, tp = _layer(jparams, 0, pos)
        x = rng.standard_normal((2, 40, tcfg.d_model)).astype(np.float32)
        jout, jstate = jblock(jcfg, jp, jnp.asarray(x), return_state=True)
        out, state = block(tcfg, tp, _t(x))
        np.testing.assert_allclose(out.numpy(), _np(jout), **TOL)
        _check_tree(state, jstate, TOL)
        for _ in range(3):
            x1 = rng.standard_normal((2, 1, tcfg.d_model)).astype(np.float32)
            jout, jstate = jstep(jcfg, jp, jnp.asarray(x1), jstate)
            out, state = step(tcfg, tp, _t(x1), state)
            np.testing.assert_allclose(out.numpy(), _np(jout), **TOL)
            _check_tree(state, jstate, TOL)
    assert kinds == {"rglru"} or kinds == {"mlstm", "slstm"}


def test_prefill_and_decode_match_jax(fp32):
    """S = 40 with an mLSTM chunk of 16 (padded to 48), and beyond the
    recurrentgemma smoke window of 16 (the ring rolls)."""
    jcfg, tcfg, jparams, model = fp32
    S, max_seq = 40, 48
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, size=(1, S))
    jprefill = jax.jit(lambda p, t: jtr.prefill(jcfg, p, t, max_seq=max_seq))
    jdecode = jax.jit(lambda p, c, t, pos: jtr.decode_step(jcfg, p, c, t, pos))
    jlogits, jcaches = jprefill(jparams, jnp.asarray(toks, jnp.int32))
    tlogits, tcaches = ttr.prefill(model, torch.from_numpy(toks),
                                   max_seq=max_seq)
    np.testing.assert_allclose(tlogits.numpy(), _np(jlogits), **MODEL_TOL)
    _check_tree(tcaches, jcaches, MODEL_TOL)
    jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
    ttok = torch.argmax(tlogits, -1)
    for i in range(3):
        assert int(ttok[0]) == int(jtok[0])
        jlogits, jcaches = jdecode(jparams, jcaches, jtok, jnp.int32(S + i))
        tlogits, tcaches = ttr.decode_step(model, tcaches, ttok, S + i)
        np.testing.assert_allclose(tlogits.numpy(), _np(jlogits), **MODEL_TOL)
        jtok = jnp.argmax(jlogits, -1).astype(jnp.int32)
        ttok = torch.argmax(tlogits, -1)
    _check_tree(tcaches, jcaches, MODEL_TOL)
    _check_tree(ttr.init_caches(tcfg, 2, max_seq),
                jtr.init_caches(jcfg, 2, max_seq), MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_fingerprint_tree_of_converted_bf16_params_matches_jax(arch):
    jparams = jcommon.init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))
    model = bridge.params_from_jax(jax.tree.map(np.asarray, jparams),
                                   get_smoke_config(arch))
    leaves = list(model.param_leaves())
    jleaves = jax.tree.leaves(jparams)
    assert [(tuple(t.shape), str(t.dtype)[6:]) for t in leaves] == [
        (x.shape, str(x.dtype)) for x in jleaves]
    want = int(jax.jit(jattest.fingerprint_tree)(jparams))
    assert attest.fingerprint_tree(leaves) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_leaves_match_jax(arch):
    """Shapes, per-leaf dtypes (``lam`` fp32 in a bf16 model), the forget
    bias constant and the init scales.  A sample std of n normal draws is
    off by about 1/sqrt(2n) relative, so two independent draws differ by
    about 1/sqrt(n): five times that, or 10%, whichever is larger."""
    cfg = get_smoke_config(arch)
    model = tcommon.init_params(cfg, torch.Generator().manual_seed(0))
    jparams = jcommon.init_params(jax_smoke_config(arch), jax.random.PRNGKey(0))
    for t, j in zip(model.param_leaves(), jax.tree.leaves(jparams)):
        assert tuple(t.shape) == j.shape and str(t.dtype)[6:] == str(j.dtype)
        jf = np.asarray(j.astype(jnp.float32))
        if jf.std() == 0:        # norms (zeros) and the forget bias (3.0)
            assert torch.equal(t.float(), _t(jf))
        else:
            rel = max(0.1, 5 / np.sqrt(jf.size))
            assert float(t.float().std()) == pytest.approx(float(jf.std()),
                                                           rel=rel)
    pos = model.groups[0][0]
    if arch == "recurrentgemma-2b":
        assert pos["lam"].dtype == torch.float32
    else:
        assert torch.all(pos["bf"] == 3.0)


# ---------------------------------------------------------------------------
# The replicated token server
# ---------------------------------------------------------------------------
def _jax_decode_fn(cfg, params, max_seq):
    pf = jax.jit(lambda p, i: jtr.prefill(cfg, p, i, max_seq=max_seq))
    ds = jax.jit(lambda p, c, t, pos: jtr.decode_step(cfg, p, c, t, pos))

    def decode_fn(session, hist, n):
        logits, caches = pf(params, jnp.asarray([hist], jnp.int32))
        out = []
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        for i in range(n):
            out.append(int(tok[0]))
            logits, caches = ds(params, caches, tok, jnp.int32(len(hist) + i))
            tok = jnp.argmax(logits, -1).astype(jnp.int32)
        return out

    return decode_fn


def _serve_turns(server, turns):
    clients = {s: server.cluster.new_client() for s, _, _ in turns}
    return [server.generate(clients[s], s, prompt, n) for s, prompt, n in turns]


def test_token_streams_and_smr_latencies_match_jax_server(fp32):
    """fp32, one session, three turns; the histories (20, 30, 40 tokens)
    pad the mLSTM input on every prefill and cross recurrentgemma's window
    of 16."""
    jcfg, tcfg, jparams, model = fp32
    max_seq = 48
    rng = np.random.default_rng(5)
    turns = [("s0", rng.integers(0, tcfg.vocab, size=20 if i == 0 else 6
                                 ).tolist(), 4) for i in range(3)]
    want = _serve_turns(JaxReplicatedServer.build(
        _jax_decode_fn(jcfg, jparams, max_seq)), turns)
    got = _serve_turns(ReplicatedServer.build(
        serve.GreedyDecoder(model, max_seq)), turns)
    assert [len(t) for t, _ in got] == [4] * 3
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_main_runs_on_cpu(arch):
    was = torch.are_deterministic_algorithms_enabled()
    try:
        out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--requests", "3", "--batch", "2", "--gen", "3"])
    finally:
        torch.use_deterministic_algorithms(was)
    assert [len(t) for t in out["tokens"]] == [3] * 3
    assert len(out["latencies_us"]) == 3
    assert 0 <= out["weights_fingerprint"] < 2 ** 32
