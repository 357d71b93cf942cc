"""The port's dry-run and costing tools (``repro_torch.launch.{shapes,
costing,dryrun}``) and its kernels as operators (``kernels.ops``,
``kernels.work``) against the JAX package's dry-run.

Whatever opens a process group (the fake 256- and 512-rank meshes, the
small meshes, the CLI) runs in a subprocess, so that no group is left in
the test process.  Traces here use fake CPU tensors (``--device cpu``): a
CPU-only build cannot run autograd or index a DTensor on fake CUDA
tensors, and the counts depend on shapes alone."""

import collections
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import list_archs as jax_list_archs
from repro.launch import costing as jcosting
from repro.launch import shapes as jshapes
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro.models import recurrent as jrec
from repro.models.transformer import init_caches as jinit_caches
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as jadamw_init
from repro.parallel.sharding import param_pspecs as jparam_pspecs
from repro.runtime import steps as jsteps

from repro_torch import bridge
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import ops, work
from repro_torch.kernels.mlstm import mlstm_plain
from repro_torch.kernels.rglru import rglru_plain
from repro_torch.kernels.swa import swa_plain
from repro_torch.launch import costing, dryrun, shapes
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.models import recurrent as trec
from torch._subclasses.fake_tensor import is_fake

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = jax_list_archs()
KERNELS = ("swa", "rglru", "mlstm", "fingerprint", "routed")


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _jpath(path) -> tuple:
    return tuple(getattr(e, "key", getattr(e, "idx", None)) for e in path)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_shapes_match_reference_leaf_by_leaf(arch):
    """SHAPES, cell_runnable, params_spec, opt_spec and input_specs give
    the reference's names, shapes and dtypes, as fake tensors."""
    assert {k: dataclasses.astuple(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jshapes.SHAPES.items()}
    jcfg, tcfg = jax_config(arch), get_config(arch)
    for name in shapes.SHAPES:
        assert shapes.cell_runnable(arch, name) == \
            jshapes.cell_runnable(arch, name)
    mode = shapes.fake_mode()
    model = shapes.params_spec(tcfg, "cpu", mode)
    jparams = jshapes.params_spec(jcfg)
    jflat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = [(path, tuple(p.shape), _dtype(p)) for path, p in model.leaf_items()]
    want = [(_jpath(path), a.shape, str(a.dtype)) for path, a in jflat]
    assert got == want
    assert all(is_fake(p) for p in model.param_leaves())

    opt = shapes.opt_spec(tcfg, model, mode)
    jopt = jshapes.opt_spec(jcfg, jparams)
    for key in ("mu", "nu", "master"):
        assert [(tuple(t.shape), _dtype(t)) for t in opt[key]] == \
            [(a.shape, str(a.dtype)) for a in jax.tree.leaves(jopt[key])]
    assert (tuple(opt["count"].shape), _dtype(opt["count"])) == \
        (jopt["count"].shape, str(jopt["count"].dtype))

    for name, shape in shapes.SHAPES.items():
        specs = shapes.input_specs(tcfg, shape, "cpu", mode)
        jspecs = jshapes.input_specs(jcfg, jshapes.SHAPES[name])
        assert set(specs) == set(jspecs)
        for key, jv in jspecs.items():
            if key == "position":      # a Python int: the last slot
                assert specs[key] == shape.seq - 1 and jv.shape == ()
                continue
            tl, jl = bridge.tree_leaves(specs[key]), jax.tree.leaves(jv)
            assert [(tuple(t.shape), _dtype(t)) for t in tl] == \
                [(a.shape, str(a.dtype)) for a in jl], (name, key)
            assert all(is_fake(t) for t in tl)


# ---------------------------------------------------------------------------
# The collective table
# ---------------------------------------------------------------------------
_HLO_OP = {"all-reduce": "all-reduce", "all-gather": "all-gather",
           "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
           "collective-permute": "collective-permute"}


@pytest.mark.parametrize("group", [1, 2, 16, 512])
@pytest.mark.parametrize("kind", costing.COLLECTIVES)
def test_collective_table_matches_reference(kind, group):
    line = (f"  %x = bf16[8,128]{{1,0}} {_HLO_OP[kind]}(bf16[8,128]{{1,0}} "
            f"%y), replica_groups=[1,{group}]<=[{group}]")
    ref = jcosting.collective_bytes(line)
    op, link = costing.collective_cost(kind, 8 * 128 * 2, group)
    assert (op, link) == (ref[kind], ref[kind + "_link"])


# ---------------------------------------------------------------------------
# FLOPs against the reference's jaxpr
# ---------------------------------------------------------------------------
def _jax_products(jaxpr, mult=1) -> int:
    """FLOPs of the matrix products (``dot_general`` with a contracting
    dimension; one without is an elementwise product, which
    FlopCounterMode counts as none) of a jaxpr, scan bodies times their
    length."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, rc), (lb, rb) = eqn.params["dimension_numbers"]
            a, b = (v.aval.shape for v in eqn.invars[:2])
            free = math.prod(d for i, d in enumerate(b)
                             if i not in rc and i not in rb)
            total += mult * 2 * math.prod(a) * free if lc else 0
        m = mult * (eqn.params["length"] if eqn.primitive.name == "scan"
                    else 1)
        for sub in eqn.params.values():
            for s in sub if isinstance(sub, (list, tuple)) else [sub]:
                inner = getattr(s, "jaxpr", s)
                if hasattr(inner, "eqns"):
                    total += _jax_products(inner, m)
    return total


B, S = 2, 32


def _jax_count(jcfg, kind) -> int:
    params = jax.eval_shape(lambda: jcommon.init_params(
        jcfg, jax.random.PRNGKey(0)))
    if jcfg.frontend:
        inputs = jax.ShapeDtypeStruct((B, S, jcfg.d_model), jnp.float32)
    else:
        inputs = jax.ShapeDtypeStruct((B, S), jnp.int32)
    if kind == "train":
        opt = jax.eval_shape(lambda p: jadamw_init(p, JAdamWConfig()), params)
        batch = {"inputs": inputs,
                 "targets": jax.ShapeDtypeStruct((B, S), jnp.int32)}
        jp = jax.make_jaxpr(jsteps.make_train_step(jcfg))(params, opt, batch)
    elif kind == "prefill":
        jp = jax.make_jaxpr(jsteps.make_prefill(jcfg, max_seq=S))(params,
                                                                   inputs)
    else:
        caches = jax.eval_shape(lambda: jinit_caches(jcfg, B, S))
        jp = jax.make_jaxpr(jsteps.make_serve_step(jcfg))(
            params, caches, jax.ShapeDtypeStruct((B,), jnp.int32), S - 1)
    return _jax_products(jp.jaxpr)


def _port_count(tcfg, kind):
    r = dryrun.trace(tcfg, ShapeSpec("s", kind, S, B), None, "cpu")
    products = sum(v for k, v in r["flops_by_op"].items() if k not in KERNELS)
    return products, r


def _banded_flops(cfg) -> int:
    """The reference's banded window attention at prefill
    (``banded_window_attention``, chunk = window): each query chunk of c
    against [previous chunk ‖ own chunk], QK^T and P.V, over the padded
    length, in every windowed layer."""
    total = 0
    for spec in cfg.layer_list():
        if spec.kind == "attn" and spec.window is not None:
            c = spec.window
            Sp = -(-S // c) * c
            total += 2 * (2 * B * cfg.n_heads * Sp * 2 * c * cfg.dh)
    return total


def _mlstm_stubbed(monkeypatch):
    """Both packages' mLSTM chunk bodies replaced by an elementwise stand-in
    that keeps the gate projections, so that the rest of the model can be
    counted apart from them."""
    def jax_stub(cfg, p, x, chunk=256):
        B_, S_, _ = x.shape
        q, k, v, it, ft = jrec._mlstm_gates(cfg, p, x)
        h = (q * k * v * (it + ft)[..., None]).astype(x.dtype)
        H, dh = cfg.n_heads, cfg.dh
        return h.reshape(B_, S_, H * dh), {
            "C": jnp.zeros((B_, H, dh, dh)), "n": jnp.zeros((B_, H, dh)),
            "m": jnp.zeros((B_, H))}

    def port_stub(cfg, p, x, chunk=256, train=False, ctx=None):
        B_, S_, _ = x.shape
        q, k, v, it, ft = trec._mlstm_gates(cfg, p, x)
        h = (q * k * v * (it + ft)[..., None]).to(x.dtype)
        H, dh = cfg.n_heads, cfg.dh
        return h.reshape(B_, S_, H * dh), {
            "C": x.new_zeros((B_, H, dh, dh)), "n": x.new_zeros((B_, H, dh)),
            "m": x.new_zeros((B_, H))}

    monkeypatch.setattr(jrec, "mlstm_train", jax_stub)
    monkeypatch.setattr(trec, "mlstm_train", port_stub)


FLOP_ARCHS = ["gemma3-1b", "qwen3-8b", "recurrentgemma-2b", "xlstm-1.3b",
              "qwen3-moe-235b-a22b", "musicgen-large"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FLOP_ARCHS)
def test_products_match_reference_jaxpr(arch, kind, monkeypatch):
    """Smoke configs, unsharded, fp32, remat "none" on both sides: the
    port's FLOPs of matrix products equal the reference's jaxpr, but where
    a product is named below, with its reason:

    * prefill of a windowed layer: the SWA kernel counts only the pairs in
      the band (its operator's own formula), the reference's banded path
      2c keys for each chunk of c queries; the port's products leave the
      kernel out, so they equal the reference's less its banded products;
    * training through an sLSTM layer: the gradient of the first step's
      zero state, one (B, H, hd) x (H, hd, hd) product a layer, which the
      reference's jaxpr computes and PyTorch's autograd skips;
    * the mLSTM's chunk body: the reference writes its normalizer as a
      product with ones (``recurrent.py:88``) and other products through
      three-operand einsums; the port's plain version sums.  Both bodies
      are swapped for one elementwise stand-in, and the rest is held equal;
    * decode of a routed layer (B·k <= the experts, B <= the capacity):
      the port runs the routed, held experts' products alone through the
      routed kernel (its operator's own formula), the reference every
      expert's over its (E, C, D) buffer; the port's products leave the
      kernel out, so they equal the reference's less its buffer products.
    """
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32",
                               remat="none")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               remat="none")
    n_mlstm = sum(1 for s in tcfg.layer_list() if s.kind == "mlstm")
    stub = kind != "decode" and n_mlstm
    if stub:
        jfull, (tfull, rfull) = _jax_count(jcfg, kind), _port_count(tcfg,
                                                                    kind)
        _mlstm_stubbed(monkeypatch)
    want = _jax_count(jcfg, kind)
    got, r = _port_count(tcfg, kind)
    if stub:        # each side's chunk bodies counted some; at prefill the
        assert jfull > want              # port's are the kernel's operator
        if kind == "train":
            assert tfull > got
        else:
            assert tfull == got and rfull["kernels"]["mlstm"] == n_mlstm
    if kind == "prefill":
        want -= _banded_flops(tcfg)
        n_window = sum(1 for s in tcfg.layer_list()
                       if s.kind == "attn" and s.window is not None)
        assert r["kernels"].get("swa", 0) == n_window
    if kind == "train":
        hd = tcfg.d_model // tcfg.n_heads
        n_slstm = sum(1 for s in tcfg.layer_list() if s.kind == "slstm")
        want -= n_slstm * 2 * B * tcfg.n_heads * hd * hd
    if kind == "decode" and tcfg.moe is not None:
        m = tcfg.moe
        n_routed = sum(map(tcfg.routed, tcfg.layer_list()))
        C = jmoe._capacity(B, m.top_k, m.n_experts, m.capacity_factor)
        assert B * m.top_k <= m.n_experts and B <= C
        want -= n_routed * 3 * 2 * m.n_experts * C * tcfg.d_model * m.d_expert
        assert r["kernels"].get("routed", 0) == n_routed
    assert got == want


# ---------------------------------------------------------------------------
# The kernels as operators
# ---------------------------------------------------------------------------
def _kernel_cases(mode):
    with mode:
        bf = dict(dtype=torch.bfloat16)
        q = torch.empty(1, 1168, 4, 256, **bf)
        kv = torch.empty(1, 1168, 1, 256, **bf)
        a = torch.empty(1, 1168, 2560)
        mq = torch.empty(1, 1024, 4, 512, **bf)
        g = torch.empty(1, 1024, 4)
        words = torch.empty(262144, 1152, **bf)
    return [("swa", ops.sliding_window_attention, swa_plain, (q, kv, kv, 512)),
            ("rglru", ops.rglru_scan, rglru_plain, (a, a)),
            ("mlstm", ops.mlstm_chunkwise_state, mlstm_plain,
             (mq, mq, mq, g, g, 256)),
            ("fingerprint", ops.fingerprint, None, (words,))]


def test_fake_implementations_give_plain_shapes_and_dtypes():
    """Each wrapper, given fake tensors, traces its operator (no launch,
    no plain version): the plain version's output shapes and dtypes, and
    FlopCounterMode counts the operator's formula."""
    from torch.utils.flop_counter import FlopCounterMode
    mode = shapes.fake_mode()
    ops.reset_launches()
    for name, wrapper, plain, args in _kernel_cases(mode):
        with mode, FlopCounterMode(display=False) as fc:
            got = wrapper(*args)
            want = plain(*args) if plain is not None else None
        if name == "fingerprint":
            assert got == 0                 # a trace reads no value
        else:
            flat_got = bridge.tree_leaves(got)
            flat_want = bridge.tree_leaves(want)
            assert [(t.shape, t.dtype) for t in flat_got] == \
                [(t.shape, t.dtype) for t in flat_want]
            assert all(is_fake(t) for t in flat_got)
        with mode, FlopCounterMode(display=False) as fc:
            wrapper(*args)
        counts = fc.get_flop_counts()["Global"]
        (packet, flops), = counts.items()
        assert packet is getattr(torch.ops.repro_torch, name)
        func = next(f for f in ops.KERNEL_OPS if f.name().endswith(name))
        assert flops == ops.op_work(func, args).flops
    assert all(n == 0 for n in ops.launches.values())


def test_formulas_give_the_bounds_chip_smoke_printed():
    """The bounds of PERF.md's kernel table (``chip_smoke.py`` phases 2–5),
    now read from ``kernels.work``, in ms to the table's four places."""
    cases = [(work.swa_work(1, 1168, 4, 1, 256, 512, 2), 0.0019,
              "operations"),
             (work.swa_work(1, 1168, 10, 1, 256, 2048, 2), 0.0071,
              "operations"),
             (work.rglru_work(1, 1168, 2560), 0.0107, "bytes"),
             (work.rglru_work(1, 776, 2560), 0.0071, "bytes"),
             (work.rglru_work(2, 1168, 2560), 0.0214, "bytes"),
             (work.mlstm_work(1, 1024, 4, 512, 256, 2), 0.0063, "bytes"),
             (work.mlstm_work(1, 512, 4, 512, 256, 2), 0.0038, "bytes"),
             (work.fingerprint_work(262144 * 1152, 2), 0.1803, "bytes")]
    for w, ms, by in cases:
        got_ms, got_by = w.bound()
        assert (round(got_ms, 4), got_by) == (ms, by)


def test_kernel_operators_count_their_formulas():
    """A traced call of each operator: FLOPs and bytes of its formula, and
    one call of its kernel counted by name."""
    mode = shapes.fake_mode()
    for name, wrapper, _, args in _kernel_cases(mode):
        with mode:
            _, c = costing.count(wrapper, *args)
        func = next(f for f in ops.KERNEL_OPS if f.name().endswith(name))
        w = ops.op_work(func, args)
        assert (c.flops, c.bytes, c.kernels) == (w.flops, w.bytes, {name: 1})


# ---------------------------------------------------------------------------
# What needs a process group: one subprocess for the module
# ---------------------------------------------------------------------------
_RANKS = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(2)
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.launch import costing, dryrun, shapes
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.parallel import sharding
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

out = {"param_bytes": {}}
for multi, (name, dims, axes) in dryrun.MESHES.items():
    with dryrun.fake_world(512 if multi else 256):
        mesh = dryrun._mesh(dims, axes, "cpu")
        for arch in list_archs():
            cfg = get_config(arch)
            mode = shapes.fake_mode()
            with mode:
                model = shapes.params_spec(cfg, "cpu")
                sharding.distribute_tree(
                    mesh, model, sharding.param_pspecs(cfg, model, mesh))
            out["param_bytes"][f"{arch}/{name}"] = costing.local_bytes(
                list(model.param_leaves()))

# each product's FLOPs in call order, with the model function that made it
import traceback
products = []


class Logged(costing.Counter):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = super().__torch_dispatch__(func, types, args, kwargs)
        name = func._overloadpacket.__name__
        sites = [f.name for f in traceback.extract_stack()
                 if "repro_torch/models" in f.filename]
        if name in ("mm", "bmm") and sites and self.flops > before:
            products.append((sites[-1], self.flops - before))
        return out


costing.Counter = Logged
cfg = dataclasses.replace(get_smoke_config("qwen3-8b"), dtype="float32",
                          remat="none")
shape = ShapeSpec("s", "prefill", 64, 8)
out["unsharded"] = dryrun.trace(cfg, shape, None, "cpu")["flops_by_op"]
out["products"] = {"unsharded": products[:]}
for dims in ((8, 1), (2, 4)):
    products.clear()
    with dryrun.fake_world(8):
        mesh = dryrun._mesh(dims, ("data", "model"), "cpu")
        out[f"{dims}"] = dryrun.trace(cfg, shape, mesh, "cpu")["flops_by_op"]
        out["products"][f"{dims}"] = products[:]
        if dims == (2, 4):
            mode = shapes.fake_mode()
            with mode:
                x = torch.empty(64, 32)
                w = torch.empty(32, 48)
                xs = distribute_tensor(x, mesh, [Shard(0), Replicate()],
                                       src_data_rank=None)
                ws = distribute_tensor(w, mesh, [Replicate(), Shard(1)],
                                       src_data_rank=None)
                xr = distribute_tensor(x, mesh, [Replicate(), Replicate()],
                                       src_data_rank=None)
                wr = distribute_tensor(w, mesh, [Replicate(), Replicate()],
                                       src_data_rank=None)
                _, c = costing.count(torch.mm, xs, ws)
                _, r = costing.count(torch.mm, xr, wr)
            out["mm_sharded"], out["mm_replicated"] = c.flops, r.flops
            out["kv_heads"] = cfg.n_kv_heads

# a train step of qwen3-8b's and gemma3-1b's smoke configs, unsharded and
# on the (2, 4) and (2, 2, 2) meshes: every product, the backward's too
# (their site "-": no model function is on the stack in the backward)
everything = []


class LoggedAll(Logged):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        before = self.flops
        out_ = super().__torch_dispatch__(func, types, args, kwargs)
        name = func._overloadpacket.__name__
        sites = [f.name for f in traceback.extract_stack()
                 if "repro_torch/models" in f.filename]
        if name in ("mm", "bmm") and self.flops > before:
            everything.append((sites[-1] if sites else "-",
                               self.flops - before))
        return out_


costing.Counter = LoggedAll
tshape = ShapeSpec("s", "train", 64, 8)
for arch in ("qwen3-8b", "gemma3-1b"):
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               remat="none")
    everything.clear()
    dryrun.trace(tcfg, tshape, None, "cpu")
    res = {"unsharded": everything[:]}
    for dims, axes in (((2, 4), ("data", "model")),
                       ((2, 2, 2), ("pod", "data", "model"))):
        everything.clear()
        with dryrun.fake_world(8):
            mesh = dryrun._mesh(dims, axes, "cpu")
            res[f"{dims}"] = {"products": everything[:0], "total":
                              dryrun.trace(tcfg, tshape, mesh, "cpu")["flops"]}
        res[f"{dims}"]["products"] = everything[:]
    out[f"train_{arch}"] = res
costing.Counter = Logged.__mro__[1]

# a train step on a mesh whose "model" axis cuts the attention's output
# width but not its heads: gemma3-1b at full width (4 heads), one layer,
# on the 16 x 16 mesh
from repro_torch.models.common import default_blocks
gcfg = dataclasses.replace(get_config("gemma3-1b"), n_layers=1,
                           blocks=default_blocks(1))
with dryrun.fake_world(256):
    mesh = dryrun._mesh((16, 16), ("data", "model"), "cpu")
    step = dryrun.trace(gcfg, ShapeSpec("s", "train", 64, 16), mesh, "cpu")
out["uneven_heads_train"] = {"heads": gcfg.n_heads, "flops": step["flops"],
                             "whole": step["whole_over_model"]}

# a prefill whose recurrent cells' heads do not divide "model": xlstm's
# smoke config (2 heads) on a (2, 4) mesh
xcfg = dataclasses.replace(get_smoke_config("xlstm-1.3b"), dtype="float32")
with dryrun.fake_world(8):
    mesh = dryrun._mesh((2, 4), ("data", "model"), "cpu")
    out["whole_xlstm"] = dryrun.trace(xcfg, ShapeSpec("s", "prefill", 64, 8),
                                      mesh, "cpu")["whole_over_model"]

# the sLSTM fit from two, four and eight chunks: a prefill on a (2, 2)
# mesh to S = 512 (chunk 32), a train step on one device to S = 256
# (chunk 16)
for kind, S, c, dims in (("prefill", 512, 32, (2, 2)),
                         ("train", 256, 16, None)):
    xcfg = dataclasses.replace(get_smoke_config("xlstm-1.3b"),
                               dtype="float32", mlstm_chunk=c)
    shape = ShapeSpec("s", kind, S, 4)
    with dryrun.fake_world(4):
        mesh = dims and dryrun._mesh(dims, ("data", "model"), "cpu")
        direct = dryrun.trace(xcfg, shape, mesh, "cpu")
        _, fitted = dryrun.fit(xcfg, shape, mesh, "cpu")
    out[f"fit_{kind}"] = {"direct": direct, "fit": fitted}
json.dump(out, sys.stdout)
"""


# an sLSTM fit whose check is not exact: a train step of xlstm's smoke
# config on a (2, 2) mesh to S = 64 (chunk 4), through ``run_cell``, with
# one FLOP added to the trace at the shortest fit length (the sharded
# program's counts are affine in S, so the check would hold), and the same
# cell traced at full length (``--no-correct``)
_FALLBACK = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(1)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import ShapeSpec

traced = dryrun.trace


def off_the_line(cfg, shape, mesh=None, device="cuda"):
    r = traced(cfg, shape, mesh, device)
    if shape.seq == dryrun.fit_lengths(cfg)[0]:
        r["flops"] += 1.0
    return r


dryrun.trace = off_the_line

xcfg = dataclasses.replace(get_smoke_config("xlstm-1.3b"), dtype="float32",
                           mlstm_chunk=4)
kw = dict(cfg=xcfg, save=False, device="cpu",
          mesh_shape=((2, 2), ("data", "model")),
          shape=ShapeSpec("s", "train", 64, 4))
json.dump({"fit": dryrun.run_cell("xlstm-1.3b", "train_4k", False, **kw),
           "whole": dryrun.run_cell("xlstm-1.3b", "train_4k", False,
                                    correct=False, **kw)}, sys.stdout)
"""


def _start(program: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", program], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module", autouse=True)
def processes():
    """Started with the module's first test, so that they run while the
    tests that need no process group do."""
    procs = {"ranks": _start(_RANKS), "fallback": _start(_FALLBACK)}
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.communicate()


def _result(proc: subprocess.Popen) -> dict:
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out)


@pytest.fixture(scope="module")
def ranks(processes):
    return _result(processes["ranks"])


@pytest.fixture(scope="module")
def fallback(processes):
    return _result(processes["fallback"])


@pytest.mark.parametrize("multi", [False, True], ids=["pod16x16",
                                                      "pod2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_parameter_bytes_match_reference(ranks, arch, multi):
    """The local shards that the port's rules give one rank of the
    production mesh hold exactly the bytes of JAX's shard shapes of the
    reference's ``param_pspecs`` on an ``AbstractMesh``."""
    name, dims, axes = dryrun.MESHES[multi]
    mesh = AbstractMesh(dims, axes)
    jparams = jshapes.params_spec(jax_config(arch))
    specs = jparam_pspecs(jax_config(arch), jparams, mesh)
    want = sum(math.prod(NamedSharding(mesh, s).shard_shape(a.shape))
               * a.dtype.itemsize for a, s in
               zip(jax.tree.leaves(jparams), jax.tree.leaves(
                   specs, is_leaf=lambda x: isinstance(
                       x, jax.sharding.PartitionSpec))))
    assert ranks["param_bytes"][f"{arch}/{name}"] == want


def test_counts_are_per_device(ranks):
    """Every product of qwen3-8b's smoke prefill counts exactly its share
    of the unsharded count, product by product.  On a (8, 1) mesh (data
    parallel) each counts 1/8.  On a (2, 4) mesh each also counts 1/8: the
    projection and FFN products that the rules cut over both axes run on
    local shards (the layer's FSDP-cut weights gathered over "data", its
    row-cut products reduced over "model" before the residual add, so
    that the first layer's FFN gate and up take whole inputs and count
    1/8, not 1/2), and the attention products are cut by batch and by
    heads (the two KV heads, which do not divide by 4, repeated to the
    four query heads, as the reference's program cuts them).  A product
    of hand-placed shards counts 1/8 of the global product and a
    replicated one counts it whole."""
    whole = ranks["unsharded"]
    assert set(whole) == {"mm", "bmm"}
    assert {k: v * 8 for k, v in ranks["(8, 1)"].items()} == whole
    assert ranks["kv_heads"] % 4
    unsharded = ranks["products"]["unsharded"]
    for dims in ("(8, 1)", "(2, 4)"):
        got = ranks["products"][dims]
        assert [s for s, _ in got] == [s for s, _ in unsharded]
        ffn = 0
        for (site, f), (_, want) in zip(got, unsharded):
            share = 8
            if site == "dense_ffn":
                ffn += 1
                if dims == "(2, 4)" and ffn in (1, 2):
                    share = 8          # layer 0's gate and up: cut
            assert f * share == want, (dims, site, ffn)
    assert ranks["mm_sharded"] == 2 * 64 * 32 * 48 / 8
    assert ranks["mm_replicated"] == 2 * 64 * 32 * 48


#: the model functions whose products multiply by the weights that the
#: rules cut over both axes (the attention's own products are not among them)
_WEIGHT_SITES = ("qkv_project", "apply_layer_train", "dense_ffn", "logits_fn")


@pytest.mark.parametrize("arch", ["qwen3-8b", "gemma3-1b"])
def test_train_step_counts_are_per_device(ranks, arch):
    """A smoke train step on the (2, 4) and the (2, 2, 2) "pod" mesh: each
    forward product of a weight that the rules cut over both axes counts
    1/8 of the unsharded count, on either mesh ("pod" cuts the batch as
    "data" does).  For qwen3-8b every product, forward and backward,
    counts 1/8, and the two meshes' counts are equal.  gemma3-1b's two
    heads do not divide the (2, 4) mesh's 4 "model" ranks: its attention
    is cut there by query positions, which a rank's share of the causal
    keys makes other than 1/8."""
    got = ranks[f"train_{arch}"]
    whole = collections.defaultdict(list)
    for site, f in got["unsharded"]:
        whole[site].append(f)
    assert set(_WEIGHT_SITES) <= set(whole)
    for dims in ("(2, 4)", "(2, 2, 2)"):
        mine = collections.defaultdict(list)
        for site, f in got[dims]["products"]:
            mine[site].append(f)
        sites = set(whole) if arch == "qwen3-8b" else set(_WEIGHT_SITES)
        for site in sites:
            assert [f * 8 for f in mine[site]] == whole[site], (dims, site)
    if arch == "qwen3-8b":
        assert got["(2, 4)"]["total"] == got["(2, 2, 2)"]["total"] == sum(
            f for _, f in got["unsharded"]) / 8


def test_train_step_shards_when_heads_do_not_divide(ranks):
    """A sharded train step whose heads the "model" axis does not divide
    (gemma3-1b's 4 on 16 ranks): the gradient of the merged heads arrives
    cut over "model", and ``sharding.flatten`` splits it back through
    ``unflatten`` (a plain reshape there fails in DTensor's sharding
    propagation: "Cannot unflatten unevenly sharded tensor")."""
    got = ranks["uneven_heads_train"]
    assert got["heads"] % 16 and got["flops"] > 0


def test_trace_records_what_runs_whole_over_model(ranks):
    """xlstm's smoke prefill on a (2, 4) mesh: its 2 heads do not divide
    the 4 "model" ranks, so each of its three mLSTM cells and its sLSTM
    cell runs whole on every "model" rank, and the trace counts them by
    site; gemma3-1b's step on 16 x 16, whose heads are cut by query
    positions and whose products all divide, records none."""
    assert ranks["whole_xlstm"] == {"mlstm": 3, "slstm": 1}
    assert ranks["uneven_heads_train"]["whole"] == {}


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_slstm_fit_equals_the_direct_trace(ranks, kind):
    """xlstm's smoke config: the fit through four and eight chunks,
    checked at two, equals the direct trace, a prefill on a (2, 2) mesh at
    512 tokens (chunk 32) and a train step on one device at 256 (chunk
    16: its sLSTM loop under autograd is the slow trace); FLOPs, bytes
    and collective bytes exactly, peak memory within 1%."""
    direct, fitted = (ranks[f"fit_{kind}"][k] for k in ("direct", "fit"))
    assert fitted["fit_seq"] == ([64, 128, 256] if kind == "prefill"
                                 else [32, 64, 128])
    assert not any(fitted["fit_check"]["deviation"].values())
    assert fitted["flops"] == direct["flops"] > 0
    assert fitted["bytes"] == direct["bytes"]
    assert fitted["collectives"] == direct["collectives"]
    if kind == "prefill":
        assert direct["collectives"]["total"] > 0
    assert fitted["kernels"] == direct["kernels"]
    for key in ("temp_size_in_bytes", "argument_size_in_bytes"):
        want = direct["memory"][key]
        assert abs(fitted["memory"][key] - want) <= 0.01 * want, key


def test_slstm_fit_that_is_not_exact_gives_the_full_trace(fallback):
    """Where the fit's check is not exact (here one FLOP off the line at
    the shortest length), the record holds the check, says so, and counts
    the cell traced at full length: the counts of ``--no-correct``, not
    the fit's."""
    rec, whole = fallback["fit"], fallback["whole"]
    assert rec["status"] == whole["status"] == "ok"
    assert any(rec["fit_check"]["deviation"].values())
    assert "traced at full length" in rec["reason"]
    assert "fit_seq" not in rec["corrected"]
    assert rec["corrected"]["seq"] == 64
    for key in ("flops", "bytes", "collectives", "kernels"):
        assert rec["corrected"][key] == whole["corrected"][key], key
    assert rec["corrected"]["flops"] > 0
    assert rec["memory"] == whole["memory"]
    assert "fit_check" not in whole


def test_cli_writes_an_ok_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma3-1b", "--shape", "decode_32k", "--smoke", "--mesh-shape",
         "2,4", "--seq", "64", "--batch", "8", "--device", "cpu", "--out",
         str(tmp_path)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    rec = json.loads((tmp_path / "gemma3-1b__decode_32k__mesh2x4.json")
                     .read_text())
    assert rec["status"] == "ok" and rec["device"] == "cpu"
    assert set(rec) >= {"status", "reason", "memory", "raw", "corrected",
                        "trace_s"}
    assert rec["corrected"]["flops"] > 0
    assert rec["memory"]["total_hbm_bytes"] > rec["memory"][
        "argument_size_in_bytes"] > 0


def test_cli_traces_a_sharded_rglru_prefill(tmp_path):
    """recurrentgemma-2b's smoke prefill on a (2, 4) mesh through the CLI:
    the RG-LRU gates come out of a reduce-scatter over "model" cut by
    lanes, and the kernel's operator (its fake implementation) takes them
    only contiguous."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "recurrentgemma-2b", "--shape", "prefill_32k", "--smoke",
         "--mesh-shape", "2,4", "--seq", "64", "--batch", "8", "--device",
         "cpu", "--out", str(tmp_path)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    rec = json.loads((tmp_path / "recurrentgemma-2b__prefill_32k__mesh2x4"
                      ".json").read_text())
    assert rec["status"] == "ok"
    assert rec["corrected"]["kernels"]["rglru"] > 0
    assert rec["corrected"]["collectives"]["reduce-scatter_count"] > 0
