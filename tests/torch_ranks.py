"""Rank programs of the port's multi-process tests, and their launcher.

  python tests/torch_ranks.py TASK RANK WORLD PORT DIR

runs one rank of TASK on a gloo process group of WORLD CPU ranks (one
thread each) that meets at 127.0.0.1:PORT.  A task reads its inputs from
``DIR/inputs.pt`` (written by the test) and rank 0 writes what it found to
``DIR/result.pt``.  Only torch and the port are imported here: the tests
compute their JAX references in their own process.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[1]


def run_ranks(task: str, world: int, workdir: Path, timeout: float,
              meanwhile=None):
    """Run ``task`` on ``world`` rank processes and return rank 0's result
    and what ``meanwhile()`` returned, called while the ranks run (the
    test's own references); raises with the failing ranks' output if any
    rank fails or the ranks outlast ``timeout`` seconds."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, task, str(r), str(world), str(port),
         str(workdir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    failed = []
    try:
        mine = meanwhile() if meanwhile is not None else None
        for r, p in enumerate(procs):
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                failed.append(f"rank {r} exit {p.returncode}:\n{out[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    return torch.load(workdir / "result.pt", weights_only=False), mine


# ---------------------------------------------------------------------------
# Tasks
# ---------------------------------------------------------------------------
def _model(cfg, params):
    from repro_torch import bridge
    return bridge.params_from_jax(params, cfg)


def _cfg(arch, flags=False):
    """``arch``'s smoke config in fp32; with ``flags``, ``fsdp_gather`` and
    ``attn_head_shard`` set.  Only ``attn_head_shard`` changes the port's
    program (K/V repeated to H heads): ``fsdp_gather`` is the reference's
    field, and the port's products gather every weight in any case."""
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               fsdp_gather=flags, attn_head_shard=flags)


def task_sharding(rank: int, world: int, d: Path) -> dict:
    """On the (2, 4) mesh: sharded losses, train steps, AdamW, digests,
    serving; on the (2, 2, 2) mesh: the pod-major layout."""
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.parallel import sharding
    from repro_torch.runtime.attest import fingerprint_array, fingerprint_tree
    from repro_torch.runtime.steps import (make_prefill, make_serve_step,
                                           make_train_step)
    from repro_torch.models.transformer import lm_loss

    inp = torch.load(d / "inputs.pt", weights_only=False)
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    ctx = sharding.shard_ctx_for_mesh(mesh)
    out = {"loss": {}, "train": {}, "serve": {}, "digest": {}}

    def placed(cfg, params):
        model = _model(cfg, params)
        return sharding.distribute_tree(
            mesh, model, sharding.param_pspecs(cfg, model, mesh))

    for arch, case in inp["archs"].items():
        for flags in (False, True):
            cfg = _cfg(arch, flags)
            loss = lm_loss(placed(cfg, case["params"]), case["inputs"],
                           case["targets"], ctx)
            out["loss"][arch, flags] = float(loss.full_tensor())

    oc = AdamWConfig(lr=inp["lr"])
    for arch, flags in inp["train"]:
        case = inp["archs"][arch]
        cfg = _cfg(arch, flags)
        batch = {"inputs": case["inputs"], "targets": case["targets"]}
        ref = _model(cfg, case["params"])
        ref_opt = adamw_init(ref.param_leaves(), oc)
        ref_opt, ref_m = make_train_step(cfg, oc)(ref, ref_opt, batch)
        model = _model(cfg, case["params"])
        fp_init = fingerprint_tree(model.param_leaves())
        sharding.distribute_tree(mesh, model,
                                 sharding.param_pspecs(cfg, model, mesh))
        fp_placed = fingerprint_tree(model.param_leaves())
        opt = adamw_init(model.param_leaves(), oc)
        opt, m = make_train_step(cfg, oc, ctx)(model, opt, batch)
        out["train"][arch, flags] = dict(
            fp=(fp_init, fp_placed), loss=(float(m["loss"]),
                                           float(ref_m["loss"])),
            grads=[sharding.whole(p.grad) for p in model.param_leaves()],
            ref_grads=[p.grad for p in ref.param_leaves()],
            params=[sharding.whole(p).detach() for p in model.param_leaves()],
            ref_params=[p.detach() for p in ref.param_leaves()],
            opt={k: [sharding.whole(t) for t in opt[k]]
                 for k in ("mu", "nu", "master")},
            ref_opt={k: ref_opt[k] for k in ("mu", "nu", "master")})

    # AdamW alone on the same gradients, placed and whole, no clipping;
    # also with int8 compression, whose row max spans the cut rows
    case = inp["archs"]["qwen3-8b"]
    cfg = _cfg("qwen3-8b")
    out["adamw_equal"] = {}
    for compress in (None, "int8"):
        noclip = AdamWConfig(lr=inp["lr"], grad_clip=0.0, compress=compress)
        plain = _model(cfg, case["params"])
        grads = [torch.randn(p.shape,
                             generator=torch.Generator().manual_seed(i))
                 for i, p in enumerate(plain.param_leaves())]
        w_opt = adamw_init(plain.param_leaves(), noclip)
        w_opt = adamw_update(list(plain.param_leaves()), grads, w_opt, noclip)
        sh = placed(cfg, case["params"])
        specs = sharding.param_pspecs(cfg, sh, mesh)
        s_opt = adamw_init(sh.param_leaves(), noclip)
        s_grads = [sharding.place(g, mesh, s) for g, s in zip(grads, specs)]
        s_opt = adamw_update(list(sh.param_leaves()), s_grads, s_opt, noclip)
        out["adamw_equal"][compress] = all(
            torch.equal(sharding.whole(a), b) for a, b in
            [*zip(sh.param_leaves(), plain.param_leaves()),
             *((x, y) for k in ("mu", "nu", "master")
               for x, y in zip(s_opt[k], w_opt[k]))])

    # digests of every placement kind the rules produce
    mesh3 = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    gen = torch.Generator().manual_seed(5)
    flat = torch.randn(8, 12, generator=gen).to(torch.bfloat16)
    stack = torch.randn(3, 8, 12, generator=gen)
    kinds = {"replicated": (mesh, flat, (None, None)),
             "one axis": (mesh, flat, ("model", None)),
             "two axes on one dim": (mesh, flat, (("data", "model"), None)),
             "stacked leading None": (mesh, stack, (None, "data", "model")),
             "pod-major": (mesh3, flat, (("pod", "data"), "model"))}
    for kind, (m, full, spec) in kinds.items():
        out["digest"][kind] = (fingerprint_array(sharding.place(full, m, spec)),
                               fingerprint_array(full))
    # a partial sum: rank 0 holds the tensor, the others zeros
    part = DTensor.from_local(flat if rank == 0 else torch.zeros_like(flat),
                              mesh, [Partial(), Partial()])
    out["digest"]["partial"] = (fingerprint_array(part),
                                fingerprint_array(flat))
    # the kernels' wrappers refuse DTensors (a kernel takes raw pointers)
    dt = sharding.place(stack, mesh, (None, "data", None))
    calls = {"swa": lambda: ops.sliding_window_attention(dt, dt, dt, 4),
             "rglru": lambda: ops.rglru_scan(dt, dt),
             "mlstm": lambda: ops.mlstm_chunkwise_state(dt, dt, dt, dt, dt, 4),
             "fingerprint": lambda: ops.fingerprint(dt)}
    out["refused"] = {}
    for name, call in calls.items():
        try:
            call()
        except TypeError as e:
            out["refused"][name] = "DTensor" in str(e)
    # pod-major: rank (p, d, m) holds block p * 2 + d of the rows
    p, dd, _ = mesh3.get_coordinate()
    local = sharding.place(flat, mesh3, (("pod", "data"), None)).to_local()
    pod_major = torch.equal(local, flat[(p * 2 + dd) * 2:(p * 2 + dd + 1) * 2])
    got = [None] * world
    dist.all_gather_object(got, pod_major)
    out["pod_major"] = all(got)

    # serving: sharded prefill and decode with cache_pspecs
    for arch in inp["serve"]:
        case = inp["archs"][arch]
        cfg = _cfg(arch)
        prompt = case["prompt"]
        toks = {}
        for c in (None, ctx):
            model = placed(cfg, case["params"]) if c else _model(
                cfg, case["params"])
            logits, caches = make_prefill(cfg, c, max_seq=32)(model, prompt)
            if c is not None:
                caches = sharding.distribute_tree(
                    mesh, caches, sharding.cache_pspecs(cfg, caches, mesh))
            tok = torch.argmax(sharding.whole(logits), -1)
            seq = [tok]
            for i in range(6):
                logits, caches = make_serve_step(cfg, c)(
                    model, caches, tok, prompt.shape[1] + i)
                tok = torch.argmax(sharding.whole(logits), -1)
                seq.append(tok)
            toks[c is not None] = torch.stack(seq, 1)
        out["serve"][arch] = (toks[True], toks[False])
    return out


def task_pipeline(rank: int, world: int, d: Path) -> dict:
    """``pipeline_apply`` on S = 4 ("stage" of (4,)), S = 2 ((2, 2)) and
    S = 1 ((1, 4)), the same inputs on every rank."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import comm
    from repro_torch.parallel.pipeline import pipeline_apply

    inp = torch.load(d / "inputs.pt", weights_only=False)
    ws, x = inp["ws"], inp["x"]
    out = {}
    for S, shape, axes in ((4, (4,), ("stage",)),
                           (2, (2, 2), ("stage", "data")),
                           (1, (1, 4), ("stage", "data"))):
        mesh = make_mesh(shape, axes, "cpu")
        comm.reset_collectives()
        got = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws[:S], x, mesh)
        same = [None] * world
        dist.all_gather_object(same, got)
        out[S] = dict(out=got, all_equal=all(torch.equal(g, got)
                                             for g in same),
                      collectives=dict(comm.collectives))
    return out


def task_elastic(rank: int, world: int, d: Path) -> dict:
    """A checkpoint the JAX package wrote, loaded, placed on the (2, 4)
    mesh and saved again from there."""
    from repro_torch.checkpoint import (load_checkpoint, reshard,
                                        save_checkpoint)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import lm_loss
    from repro_torch.parallel import sharding
    from repro_torch.runtime.attest import fingerprint_tree

    inp = torch.load(d / "inputs.pt", weights_only=False)
    cfg = _cfg("qwen3-8b")
    step, model, _ = load_checkpoint(inp["ckpt"], cfg, expect_fp=inp["fp"])
    mesh = make_mesh((2, 4), ("data", "model"), "cpu")
    ctx = sharding.shard_ctx_for_mesh(mesh)
    model = reshard(model, mesh, sharding.param_pspecs(cfg, model, mesh))
    fp = fingerprint_tree(model.param_leaves())
    loss = float(lm_loss(model, inp["inputs"], inp["targets"],
                         ctx).full_tensor())
    saved = save_checkpoint(inp["out"], step + 1, model)
    return dict(step=step, fp=fp, loss=loss, saved_fp=saved)


TASKS = {"sharding": task_sharding, "pipeline": task_pipeline,
         "elastic": task_elastic}


def main() -> None:
    task, rank, world, port, workdir = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    # DTensor warns of every multi-step redistribution
    logging.disable(logging.WARNING)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = TASKS[task](rank, world, Path(workdir))
        if rank == 0:
            torch.save(out, Path(workdir) / "result.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    main()
