"""The port's checkpoints and train launcher against the JAX package's on
smoke configs: the reference's round trip and corruption test on the
port, checkpoints crossing both ways (also in a process where
``ml_dtypes``, which numpy's bf16 arrays pickle through, cannot be
imported), a resumed run against an uninterrupted one, and a run of the
JAX launcher resumed by the port's."""

import json
import os
import pickle
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load_checkpoint
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch import train as jax_train
from repro.models.common import init_params as jax_init_params
from repro.optim import adamw as jadamw
from repro.runtime import attest as jattest
from repro.runtime.steps import make_train_step as jax_make_train_step

from repro_torch import bridge
from repro_torch.checkpoint import (latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import train
from repro_torch.models.common import init_params
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.attest import fingerprint_tree

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# the bf16 loss limit of tests/test_torch_train.py (BF16_TOL["loss"])
BF16_LOSS_TOL = 5e-4
# an arch with an fp32 leaf (the RG-LRU's lam) beside its bf16 ones
CROSS_ARCH = "recurrentgemma-2b"


def _bits(x):
    """The raw words of a JAX or numpy array or a tensor, bf16 as int16."""
    if isinstance(x, torch.Tensor):
        return bridge.numpy_from_tensor(x)
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _port_leaves(model, opt):
    """Parameters, then mu, nu, master and the count, as the JAX trees'
    leaves are ordered below."""
    return (list(model.param_leaves()) + opt["mu"] + opt["nu"]
            + opt["master"] + [opt["count"]])


def _jax_leaves(params, opt):
    return (jax.tree.leaves(params) + jax.tree.leaves(opt["mu"])
            + jax.tree.leaves(opt["nu"]) + jax.tree.leaves(opt["master"])
            + [opt["count"]])


@pytest.fixture(scope="module")
def jax_state():
    """JAX parameters and AdamW state after one jitted train step (so that
    mu, nu, master and the count are not their initial values)."""
    cfg = jax_smoke_config(CROSS_ARCH)
    params = jax_init_params(cfg, jax.random.PRNGKey(0))
    ocfg = jadamw.AdamWConfig(lr=1e-3)
    opt = jadamw.adamw_init(params, ocfg)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 17),
                                             dtype=np.int32)
    batch = {"inputs": jnp.asarray(toks[:, :-1]),
             "targets": jnp.asarray(toks[:, 1:])}
    params, opt, _ = jax.jit(jax_make_train_step(cfg, opt_cfg=ocfg))(
        params, opt, batch)
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt)


def test_bridge_way_back_inverts_the_way_in(jax_state):
    """``params_to_jax`` and ``opt_state_to_jax`` give back JAX's trees:
    the same nesting and leaf order, every leaf's bits."""
    params, opt = jax_state
    model = bridge.params_from_jax(params, get_smoke_config(CROSS_ARCH))
    state = bridge.opt_state_from_jax(opt, model)
    for back, want in ((bridge.params_to_jax(model), params),
                       (bridge.opt_state_to_jax(state, model), opt)):
        assert jax.tree.structure(back) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, _bits(w))


def test_checkpoint_roundtrip_and_corruption_detection(tmp_path):
    """``tests/test_system.py``'s test of the same name, on the port."""
    cfg = get_smoke_config("gemma3-1b")
    model = init_params(cfg, torch.Generator().manual_seed(0))
    opt = adamw_init(model.param_leaves(), AdamWConfig())
    fp = save_checkpoint(str(tmp_path), 7, model, opt)
    step, m2, o2 = load_checkpoint(str(tmp_path), cfg, expect_fp=fp)
    assert step == 7
    for a, b in zip(_port_leaves(model, opt), _port_leaves(m2, o2)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # corrupt the file on disk — the fingerprint must catch it
    blob_path = tmp_path / "ckpt_7.pkl"
    state = pickle.loads(blob_path.read_bytes())
    leaves, treedef = jax.tree.flatten(state["params"])
    arr = np.array(leaves[0], copy=True)
    arr.flat[0] = arr.flat[0] + 1.0
    leaves[0] = arr
    state["params"] = jax.tree.unflatten(treedef, leaves)
    blob_path.write_bytes(pickle.dumps(state))
    with pytest.raises(ValueError, match="fingerprint"):
        load_checkpoint(str(tmp_path), cfg)


def test_load_refuses_another_agreed_fingerprint_and_finds_the_latest(
        tmp_path):
    cfg = get_smoke_config("qwen3-8b")
    model = init_params(cfg, torch.Generator().manual_seed(0))
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), cfg)
    fp3 = save_checkpoint(str(tmp_path), 3, model, meta={"why": "test"})
    with torch.no_grad():
        model.embed.add_(1.0)
    fp12 = save_checkpoint(str(tmp_path), 12, model)
    assert fp3 != fp12 and latest_step(str(tmp_path)) == 12
    step, m, opt = load_checkpoint(str(tmp_path), cfg)
    assert (step, opt) == (12, None)
    assert fingerprint_tree(m.param_leaves()) == fp12
    with pytest.raises(ValueError, match="fingerprint"):
        load_checkpoint(str(tmp_path), cfg, step=3, expect_fp=fp12)
    manifest = json.loads((tmp_path / "ckpt_3.json").read_text())
    assert manifest == {"step": 3, "fingerprint": fp3,
                        "meta": {"why": "test"}}


def test_the_reader_refuses_other_globals(tmp_path):
    """The reader unpickles numpy arrays and nothing else: a pickle that
    names another callable is refused, not run."""
    cfg = get_smoke_config("qwen3-8b")
    (tmp_path / "ckpt_1.pkl").write_bytes(pickle.dumps(
        {"step": 1, "params": os.getcwd, "opt_state": None}, protocol=4))
    (tmp_path / "ckpt_1.json").write_text(json.dumps(
        {"step": 1, "fingerprint": 0, "meta": {}}))
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd"):
        load_checkpoint(str(tmp_path), cfg)


# ---------------------------------------------------------------------------
# Crossing between the packages
# ---------------------------------------------------------------------------
_BLOCKED = r"""
import json, sys
sys.modules["ml_dtypes"] = None        # numpy's bf16 cannot be imported
import numpy as np
from repro_torch import bridge
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
src, dst, out = sys.argv[1:4]
cfg = get_smoke_config(sys.argv[4])
step, model, opt = load_checkpoint(src, cfg)
leaves = (list(model.param_leaves()) + opt["mu"] + opt["nu"]
          + opt["master"] + [opt["count"]])
np.savez(out, *[bridge.numpy_from_tensor(t) for t in leaves])
fp = save_checkpoint(dst, step, model, opt)
assert sys.modules["ml_dtypes"] is None
print(json.dumps({"step": step, "fp": fp}))
"""


@pytest.fixture(scope="module")
def crossed(jax_state, tmp_path_factory):
    """A JAX checkpoint, loaded by the port and written back by it: in
    this process, and in one where ``ml_dtypes`` cannot be imported."""
    root = tmp_path_factory.mktemp("crossed")
    params, opt = jax_state
    fp_jax = jax_save_checkpoint(str(root / "jax"), 5, params, opt)
    cfg = get_smoke_config(CROSS_ARCH)
    step, model, topt = load_checkpoint(str(root / "jax"), cfg)
    fp_port = save_checkpoint(str(root / "port"), step, model, topt)
    res = subprocess.run(
        [sys.executable, "-c", _BLOCKED, str(root / "jax"),
         str(root / "blocked"), str(root / "blocked.npz"), CROSS_ARCH],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    blocked = json.loads(res.stdout.strip().splitlines()[-1])
    with np.load(root / "blocked.npz") as z:
        blocked_leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    return dict(root=root, fp_jax=fp_jax, fp_port=fp_port,
                model=model, opt=topt, step=step, blocked=blocked,
                blocked_leaves=blocked_leaves)


@pytest.mark.parametrize("where", ["in_process", "without_ml_dtypes"])
def test_jax_checkpoint_loads_in_the_port(where, crossed, jax_state):
    want = [_bits(a) for a in _jax_leaves(*jax_state)]
    if where == "in_process":
        assert crossed["step"] == 5
        got = [_bits(t) for t in _port_leaves(crossed["model"],
                                              crossed["opt"])]
        assert (fingerprint_tree(crossed["model"].param_leaves())
                == crossed["fp_jax"])
    else:
        assert crossed["blocked"]["step"] == 5
        got = crossed["blocked_leaves"]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")


@pytest.mark.parametrize("where", ["in_process", "without_ml_dtypes"])
def test_port_checkpoint_loads_in_jax(where, crossed, jax_state):
    path = crossed["root"] / ("port" if where == "in_process" else "blocked")
    fp = (crossed["fp_port"] if where == "in_process"
          else crossed["blocked"]["fp"])
    # the port's digest of the tree is JAX's
    assert fp == crossed["fp_jax"] == int(jattest.fingerprint_tree(
        jax.tree.map(jnp.asarray, jax_state[0])))
    step, params, opt = jax_load_checkpoint(str(path), expect_fp=fp)
    assert step == 5
    assert jax.tree.structure(params) == jax.tree.structure(jax_state[0])
    for i, (g, w) in enumerate(zip(_jax_leaves(params, opt),
                                   _jax_leaves(*jax_state))):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, i
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f"leaf {i}")


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
_RUN = dict(batch=2, seq=16, lr=1e-3, ckpt_every=2, device="cpu")


@pytest.mark.parametrize("arch", ["qwen3-8b", "xlstm-1.3b"])
def test_resumed_run_equals_an_uninterrupted_one(arch, tmp_path):
    cfg = get_smoke_config(arch)
    a = train(cfg, steps=4, ckpt_dir=str(tmp_path / "a"), **_RUN)
    b1 = train(cfg, steps=2, ckpt_dir=str(tmp_path / "b"), **_RUN)
    b2 = train(cfg, steps=2, resume=True, ckpt_dir=str(tmp_path / "b"),
               **_RUN)
    assert len(b2["loads"]) == 3 and not b1["loads"]
    assert a["losses"] == b1["losses"] + b2["losses"]
    assert [s[:2] for s in a["saves"]] == [s[:2] for s in
                                           b1["saves"] + b2["saves"]]
    assert a["records"][-1]["fps"] == b2["records"][-1]["fps"]
    assert (a["coordinator_checkpoints"] == b1["coordinator_checkpoints"]
            + b2["coordinator_checkpoints"])
    assert ((tmp_path / "a" / "ckpt_4.pkl").read_bytes()
            == (tmp_path / "b" / "ckpt_4.pkl").read_bytes())


def test_port_launcher_resumes_a_jax_launcher_run(tmp_path, monkeypatch,
                                                  capsys):
    """``repro.launch.train`` takes 2 steps and checkpoints; the JAX
    launcher and the port's each resume from that checkpoint for a step,
    on the same batch: the first losses agree within the bf16 limit."""
    args = ["--arch", "qwen3-8b", "--smoke", "--batch", "2", "--seq", "16",
            "--lr", "1e-3"]
    monkeypatch.setattr(sys, "argv", ["train"] + args + [
        "--steps", "2", "--ckpt-every", "2", "--ckpt-dir", str(tmp_path / "j")])
    jax_train.main()
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    monkeypatch.setattr(sys, "argv", ["train"] + args + [
        "--steps", "1", "--ckpt-every", "1", "--ckpt-dir", str(tmp_path / "j"),
        "--resume"])
    capsys.readouterr()
    jax_train.main()
    out = capsys.readouterr().out
    assert "[resume] from attested checkpoint @ step 2" in out
    jax_loss = float(re.search(r"\[step 3\] loss=([0-9.]+)", out)[1])
    run = train(get_smoke_config("qwen3-8b"), steps=1, resume=True,
                ckpt_dir=str(tmp_path / "t"), batch=2, seq=16, lr=1e-3,
                ckpt_every=1, device="cpu")
    assert run["losses"][0] == pytest.approx(jax_loss, rel=BF16_LOSS_TOL)
    assert len(run["loads"]) == 3


def test_launcher_main_runs_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    out = main(["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
                "--steps", "2", "--ckpt-every", "1", "--batch", "2",
                "--seq", "16", "--byzantine", "1",
                "--ckpt-dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "[step 1]" in printed and "[step 2]" in printed
    assert "flagged=['t1']" in printed
    assert [s[0] for s in out["saves"]] == [1, 2]
    assert latest_step(str(tmp_path)) == 2
