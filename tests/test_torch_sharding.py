"""The port's multi-device layer against the JAX package.

* The rules: for all ten archs' smoke and full configs on the (2, 4) and
  (2, 2, 2) meshes, the port's parameter, cache, batch and compute specs
  equal ``repro.parallel.sharding``'s, which are called with a
  ``jax.sharding.AbstractMesh`` (they read only its shape and names).
* On 8 gloo ranks (``tests/torch_ranks.py``, spawned once for the module):
  sharded losses on the (2, 4) mesh against JAX's jitted *unsharded* loss
  (the JAX package's own sharded path does not run on this JAX, ROADMAP
  §3), with ``fsdp_gather`` and ``attn_head_shard`` off and on (only the
  second changes the port's program: K/V repeated to H heads); sharded
  train steps against the port's unsharded step; AdamW on placed leaves
  bit for bit; digests of every placement kind; the pod-major layout;
  greedy serving with caches laid out by ``cache_pspecs``.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

import test_torch_train as train_parity
from torch_ranks import run_ranks

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import list_archs as jax_list_archs
from repro.models.common import init_params as jax_init_params
from repro.models.transformer import init_caches as jax_init_caches
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.parallel import sharding as jsharding

from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttr
from repro_torch.models.common import Transformer
from repro_torch.parallel import sharding

torch.set_num_threads(2)

LOSS_ARCHS = ("qwen3-8b", "qwen3-moe-235b-a22b", "recurrentgemma-2b",
              "gemma3-1b", "xlstm-1.3b")
MOE = "qwen3-moe-235b-a22b"
TRAIN = [(a, False) for a in LOSS_ARCHS] + [("qwen3-8b", True)]
SERVE = ("gemma3-1b", "recurrentgemma-2b", "xlstm-1.3b")
B, S = 4, 16
LOSS_RTOL = 1e-5
LR = train_parity.LR
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


class _Mesh:
    """A mesh stand-in with what the port's rules read."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = tuple(shape), tuple(names)


def _norm(spec):
    """A spec as a tuple, a one-axis tuple as its axis (as JAX's
    ``PartitionSpec`` keeps it)."""
    return tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
                 for a in tuple(spec))


def _dict_values(tree):
    """The specs of a nest of tuples of dicts of specs, in
    ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [tree[k] for k in sorted(tree)]
    return [s for sub in tree for s in _dict_values(sub)]


def _specs(tree):
    return [_norm(s) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, P))]


# ---------------------------------------------------------------------------
# The rules, against JAX's
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_shapes(arch, size):
    """The JAX config, parameter shapes and cache shapes (B 4, 64
    positions) of ``arch``'s smoke or full config."""
    jcfg = (jax_smoke_config if size == "smoke" else jax_config)(arch)
    return (jcfg, jax.eval_shape(lambda: jax_init_params(
                jcfg, jax.random.PRNGKey(0))),
            jax.eval_shape(lambda: jax_init_caches(jcfg, 4, 64)))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", jax_list_archs())
def test_specs_match_jax(arch, size, mesh_name):
    shape, names = MESHES[mesh_name]
    jmesh, tmesh = AbstractMesh(shape, names), _Mesh(shape, names)
    tcfg = (get_smoke_config if size == "smoke" else get_config)(arch)
    jcfg, jparams, jcaches = _jax_shapes(arch, size)
    model = Transformer(tcfg, device="meta")
    assert [tuple(p.shape) for p in model.param_leaves()] == \
        [a.shape for a in jax.tree.leaves(jparams)]
    assert sharding.param_pspecs(tcfg, model, tmesh) == \
        _specs(jsharding.param_pspecs(jcfg, jparams, jmesh))
    for (path, p) in model.leaf_items():
        if p.ndim - (path[0] == "groups") >= 2:
            one = tuple(p.shape[1:] if path[0] == "groups" else p.shape)
            assert sharding.weight_compute_spec(path[-1], one, tmesh) == \
                _norm(jsharding.weight_compute_spec(path[-1], one, jmesh))
    tcaches = ttr.init_caches(tcfg, 4, 64, device="meta")
    assert [_norm(s) for s in _dict_values(
        sharding.cache_pspecs(tcfg, tcaches, tmesh))] == \
        _specs(jsharding.cache_pspecs(jcfg, jcaches, jmesh))
    assert {k: _norm(v) for k, v in sharding.batch_pspecs(
        tcfg, tmesh).items()} == {k: _norm(v) for k, v in
                                  jsharding.batch_pspecs(jcfg, jmesh).items()}


def test_placements_put_pod_before_data():
    """P(("pod", "data")) splits a dimension pod-major, as JAX does: both
    mesh dimensions shard it, in mesh order (rank (p, d, m) holds block
    p·n_data + d; the gloo run checks that on the local shards)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _Mesh((2, 2, 2), ("pod", "data", "model"))
    assert sharding.placements((("pod", "data"), None), mesh) == \
        (Shard(0), Shard(0), Replicate())
    assert sharding.placements((None, "model"), mesh) == \
        (Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements((("data", "pod"),), mesh)


# ---------------------------------------------------------------------------
# 8 gloo ranks on the (2, 4) mesh
# ---------------------------------------------------------------------------
def _jax_case(arch):
    """``arch``'s smoke config in fp32: JAX's init and a batch, and the
    function that gives JAX's jitted unsharded loss on it."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    inputs = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    targets = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)

    def reference():
        loss = jax.jit(lambda p, i, t: jax_lm_loss(jcfg, p, i, t))
        if arch == MOE:   # capacity per data shard: the mean of the halves'
            return (float(loss(jparams, inputs[:2], targets[:2]))
                    + float(loss(jparams, inputs[2:], targets[2:]))) / 2
        return float(loss(jparams, inputs, targets))

    params = jax.tree.map(lambda a: bridge.tensor_from_numpy(np.asarray(a)),
                          jparams)
    prompt = rng.integers(0, jcfg.vocab, (B, 20))
    return reference, dict(params=params,
                           inputs=torch.from_numpy(inputs).long(),
                           targets=torch.from_numpy(targets).long(),
                           prompt=torch.from_numpy(prompt))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' results, with JAX's losses computed while they run."""
    d = tmp_path_factory.mktemp("sharding")
    refs, archs = {}, {}
    for arch in LOSS_ARCHS:
        refs[arch], archs[arch] = _jax_case(arch)
    torch.save({"archs": archs, "train": TRAIN, "serve": SERVE, "lr": LR},
               d / "inputs.pt")
    out, losses = run_ranks("sharding", 8, d, timeout=400, meanwhile=lambda: {
        arch: ref() for arch, ref in refs.items()})
    return losses, archs, out


@pytest.mark.parametrize("flags", [False, True], ids=["plain", "fsdp-heads"])
@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_sharded_loss_matches_unsharded_jax(arch, flags, ranks):
    refs, _, out = ranks
    assert out["loss"][arch, flags] == pytest.approx(refs[arch],
                                                     rel=LOSS_RTOL)


def _dropped(arch, case, rows):
    """Tokens the MoE layers drop on ``rows`` of the batch at their
    capacity (the port's unsharded loss, its routes recorded)."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = bridge.params_from_jax(case["params"], cfg)
    seen, real = [], tmoe.route

    def spy(c, w, x):
        got = real(c, w, x)
        seen.append((x.shape[0], got[1]))
        return got

    tmoe.route = spy
    try:
        ttr.lm_loss(model, case["inputs"][rows], case["targets"][rows])
    finally:
        tmoe.route = real
    m, drops = cfg.moe, 0
    for T, top_e in seen:
        C = tmoe._capacity(T, m.top_k, m.n_experts, m.capacity_factor)
        counts = torch.bincount(top_e.reshape(-1), minlength=m.n_experts)
        drops += int((counts - C).clamp(min=0).sum())
    return drops


def test_moe_capacity_is_per_data_shard(ranks):
    """Inside the reference's ``shard_map`` the capacity sees a data
    shard's T = B/dp · S = 32 tokens, where no expert can overflow
    (C = min(T, 32) at least); the whole batch's T = 64 gives C = 32 too,
    and on this batch no expert of either layer gets more than 32 of its
    128 routes, so the sharded loss equals the unsharded one as well."""
    _, archs, out = ranks
    case = archs[MOE]
    assert _dropped(MOE, case, slice(0, 2)) == 0
    assert _dropped(MOE, case, slice(2, 4)) == 0
    assert _dropped(MOE, case, slice(0, 4)) == 0


@pytest.mark.parametrize("arch,flags", TRAIN,
                         ids=[f"{a}-{'fsdp-heads' if f else 'plain'}"
                              for a, f in TRAIN])
def test_sharded_train_step_matches_unsharded(arch, flags, ranks):
    """The port's train step on the (2, 4) mesh against its unsharded step
    from the same parameters and batch, within ``test_torch_train.py``'s
    fp32 limits; the digest of the placed tree equals the whole one's."""
    r = ranks[2]["train"][arch, flags]
    tol = {**train_parity.FP32_TOL, **train_parity.FP32_TOL_ARCH.get(arch, {})}
    assert r["fp"][0] == r["fp"][1]
    assert r["loss"][0] == pytest.approx(r["loss"][1], rel=tol["loss"])
    for i, (g, rg) in enumerate(zip(r["grads"], r["ref_grads"])):
        assert train_parity._rel_to_max(g, rg) <= tol["grad"], f"grad {i}"
    for name, mine, theirs in (
            ("param", r["params"], r["ref_params"]),
            *((k, r["opt"][k], r["ref_opt"][k]) for k in ("mu", "nu",
                                                          "master"))):
        for i, (t, w, g) in enumerate(zip(mine, theirs, r["ref_grads"])):
            g = np.abs(g.numpy())
            keep = g >= train_parity.TINY_GRAD * g.max()
            err = np.abs(t.float().numpy() - w.float().numpy())[keep]
            assert err.max() <= tol["state"], f"{name} {i}: {err.max()}"


@pytest.mark.parametrize("compress", [None, "int8"])
def test_adamw_on_placed_leaves_is_bit_exact(compress, ranks):
    """Without clipping, the same gradients give the same bits placed on
    the mesh as whole: weights, moments and master; with int8
    compression too, its row max taken over the ranks that cut a row."""
    assert ranks[2]["adamw_equal"][compress]


@pytest.mark.parametrize("kind", ["replicated", "one axis",
                                  "two axes on one dim",
                                  "stacked leading None", "pod-major",
                                  "partial"])
def test_digest_of_placed_tensor_is_whole_digest(kind, ranks):
    got, want = ranks[2]["digest"][kind]
    assert got == want


@pytest.mark.parametrize("kernel", ["swa", "rglru", "mlstm", "fingerprint"])
def test_kernel_wrappers_refuse_dtensors(kernel, ranks):
    assert ranks[2]["refused"].get(kernel)


def test_pod_major_local_shards(ranks):
    assert ranks[2]["pod_major"]


@pytest.mark.parametrize("arch", SERVE)
def test_sharded_serving_gives_unsharded_tokens(arch, ranks):
    sharded, whole = ranks[2]["serve"][arch]
    assert torch.equal(sharded, whole)


# ---------------------------------------------------------------------------
# Per-device work against the reference's compiled program
# ---------------------------------------------------------------------------
#: the smoke cells held against XLA: (kind, S, global batch) on a (2, 4)
#: mesh, S at most one attention query chunk (the reference's
#: ``full_attention_chunked`` scans its chunks, and XLA counts a loop body
#: once)
_SMALL_CELLS = [(arch, kind) for arch in ("qwen3-8b", "gemma3-1b")
                for kind in ("train", "prefill")]
_SMALL_S, _SMALL_B = 256, 16

_JAX_SMALL = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from jax.sharding import AxisType
from repro.configs import get_smoke_config
from repro.launch import dryrun, shapes

dryrun.make_production_mesh = lambda multi_pod=False: jax.make_mesh(
    (2, 4), ("data", "model"), axis_types=(AxisType.Auto,) * 2)
out = {}
for arch, kind in CELLS:
    spec = shapes.ShapeSpec(kind + "_s", kind, S, B)
    shapes.SHAPES[spec.name] = dryrun.SHAPES[spec.name] = spec
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    rec = dryrun.run_cell(arch, spec.name, False, cfg=cfg, save=False)
    out[f"{arch}/{kind}"] = rec["corrected"]["flops"]
json.dump(out, sys.stdout)
"""

_PORT_SMALL = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(2)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import ShapeSpec

out = {}
for arch, kind in CELLS:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    rec = dryrun.run_cell(arch, "train_4k", False, cfg=cfg, save=False,
                          device="cpu", mesh_shape=((2, 4), ("data", "model")),
                          shape=ShapeSpec("s", kind, S, B))
    out[f"{arch}/{kind}"] = rec["corrected"]["flops"]
json.dump(out, sys.stdout)
"""


@pytest.fixture(scope="module")
def small_counts():
    """The reference's compiled FLOPs a device (XLA on 8 CPU devices, a
    (2, 4) mesh of ``Auto`` axes, as ``tools/dryrun_compare.py`` runs it)
    and the port's traced ones, for ``_SMALL_CELLS``."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    head = f"CELLS = {_SMALL_CELLS!r}\nS, B = {_SMALL_S}, {_SMALL_B}\n"
    procs = [subprocess.Popen([sys.executable, "-c", head + prog], env=env,
                              cwd=root, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for prog in (_JAX_SMALL, _PORT_SMALL)]
    got = []
    for proc in procs:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err[-4000:]
        got.append(json.loads(out.strip().splitlines()[-1]))
    return got


@pytest.mark.parametrize("arch,kind", _SMALL_CELLS)
def test_per_device_flops_at_most_the_compiled_reference(arch, kind,
                                                         small_counts):
    """On a (2, 4) mesh the port's FLOPs a device (its products and
    attention) are at most XLA's count of the reference's compiled program
    (which adds the elementwise operations): the sharded program runs no
    product whole that the reference cuts."""
    jax_flops, port_flops = small_counts
    key = f"{arch}/{kind}"
    assert 0 < port_flops[key] <= jax_flops[key], (port_flops[key],
                                                  jax_flops[key])
