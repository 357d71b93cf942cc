#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

  python3 chip_smoke.py

1. prints the card and builds the four CUDA kernels of ``src/repro_torch``
   with ``nvcc`` (one process per source, all at once);
2. holds the fingerprint kernel against its plain version, bit for bit;
3. holds the sliding-window-attention kernel against its plain version at
   gemma3-1b's and recurrentgemma-2b's shapes (bf16, fp16 and fp32), bit
   for bit against itself on a repeat, and times it at both archs' longest
   prefill beside the plain version and ``F.scaled_dot_product_attention``
   with a banded mask;
4. holds the RG-LRU scan kernel (a segmented scan over time) against its
   plain version at recurrentgemma-2b's width, at batch 1 and 2, the served
   lengths, the lengths around a super-chunk's and a decay near 1: within
   1e-5, its first segment bit for bit, bit for bit against itself on a
   repeat; and times it at the three served lengths and at batch 2, with
   its inputs in L2 (warm) and read from HBM (cold), beside ``torch.add``
   on the same bytes;
5. holds the chunkwise mLSTM kernel (h and the final state) against its
   plain version at xlstm-1.3b's head shape, bit for bit against itself,
   and times it at the three padded lengths the xlstm-1.3b path runs;
6. checks full-width layers (one group of each arch: gemma3-1b's 5:1,
   recurrentgemma-2b's RG-LRU, RG-LRU, attention, xlstm-1.3b's three mLSTM
   and one sLSTM): in fp32 on the card against the same layers on the
   CPU, and in bf16 (the tensor-core kernels the served paths run) against
   the same layers on the card with the plain versions in the kernels'
   place;
7. serves each arch at full width and depth (bf16, random weights from
   seed 0) through the 3-replica uBFT token server: gemma3-1b,
   recurrentgemma-2b and xlstm-1.3b.  Each path's launch counts are reset
   just before it and read just after; the script checks that the path
   launched each of its kernels and no other (the fingerprint once per
   leaf, at set-up), that the replicas agree, and that a decode outside
   the server gives the same tokens; (b) then, with the same checks,
   gemma3-4b (one repetition of its five window layers and one global
   layer) and chatglm3-6b (4 of 28 layers), at full width, cut in depth,
   one session of two turns;
8. trains qwen3-8b at full width, 4 of its 36 layers (bf16, random weights
   from seed 0, AdamW with bf16 moments and an fp32 master, the config's
   remat "full"), through the port's uBFT-replicated trainer: three
   replicas, each with its own model and optimizer state on the card, take
   3 honest steps and one with a Byzantine replica, 2 x 1024 tokens a
   step.  It checks that the forward-only kernels refuse inputs that
   require grad, that honest fingerprints agree on every step and the
   Byzantine replica is flagged, that every loss is finite, that the
   fingerprint kernel ran exactly twice per leaf per replica per step and
   no other kernel ran, and that on step 0's gradients it equals its plain
   version; then holds a one-layer full-width fp32 loss and its gradients
   on the card against the CPU;
9. trains the recurrent archs: (a) recurrentgemma-2b at full width, one
   (RG-LRU, RG-LRU, local attention) group of its 26 layers, through the
   same three replicas and checks (2 x 1024 tokens a step, remat "full");
   then the first step from seed 0 with remat "none" and "full" must give
   the same loss and digests (peak memory of each printed); (b) xlstm-1.3b
   at full width, 8 of its 48 blocks, 2 x 512 tokens a step, through the
   train launcher (``launch.train.train``): 4 steps with a checkpoint every
   2, against 2 steps, a drop of every model and a resume for 2 more.  The
   step-4 checkpoint files, digests, final fingerprints and losses must be
   equal, the coordinators' agreed cuts too; a flipped byte in the last
   checkpoint must fail its load; the fingerprint kernel must have run
   exactly twice per leaf per replica per step, once per leaf per save and
   once per leaf per load, and no other kernel; save and load GB/s are
   printed; (c) one full-width group of each recurrent arch in fp32: the
   loss and every gradient on the card against the CPU;
10. serves the routed-MoE archs at full width, depth cut to 8 layers
   (bf16, random weights from seed 0), through the same 3-replica token
   server and checks as phase 7: qwen3-moe-235b-a22b (128 experts, top-8)
   and llama4-scout-17b-a16e (16 experts, top-1), the routed-experts
   kernel launched once a routed layer a decode step; the peak memory after
   set-up and while serving, below 80 GB; the fingerprint kernel bit for
   bit against its plain version on qwen3-moe's largest stacked expert
   leaf (more than 2^32 words), and timed there; llama4-scout's prefill
   from (1, 384, D) embeddings equal to ``embed(tokens)`` against the
   prefill from those tokens, logits and caches bit for bit; the same
   check for musicgen-large and chameleon-34b at full width, 4 layers each;
11. runs the multi-device layer (``parallel.sharding``, ``launch.mesh``,
   ``parallel.pipeline``, ``checkpoint.reshard``) on a mesh of one rank
   through NCCL (the script runs on one card, and NCCL takes one rank a
   device), where every collective is an identity, so every sharded path
   must give the unsharded bits: (a) qwen3-8b at full width, 4 of 36
   layers, phase 8's traffic: an unsharded replica saves a checkpoint and
   takes 2 steps; three replicas of the port's ``ReplicatedTrainer`` each
   load it, ``reshard`` it onto the (1, 1) ("data", "model") mesh (its
   digest there equal to the manifest's) and take the same 2 steps through
   ``make_train_step(cfg, opt_cfg, ctx)``: losses and digests equal bit
   for bit; then step 0 on the (1, 1, 1) mesh with "pod" and both
   ``fsdp_gather`` and ``attn_head_shard``, within phase 6's bf16 limit
   (only ``attn_head_shard`` changes the program: ``fsdp_gather`` is kept
   for the reference's config, and the products gather every weight);
   (b) gemma3-1b and recurrentgemma-2b at full width and depth, a prompt
   of 384 tokens and 8 greedy tokens through ``make_prefill`` and
   ``make_serve_step`` with caches laid out by ``cache_pspecs``: tokens,
   logits and kernel launches equal to the unsharded path's (the SWA and
   RG-LRU kernels ran on local shards); (c) qwen3-moe-235b-a22b at full
   width, 2 of 94 layers: the expert-parallel prefill of 384 tokens equal
   to the unsharded one, logits and caches bit for bit; (d)
   ``pipeline_apply`` over a one-rank "stage" mesh equal to the stage
   applied in sequence.  It prints the step and decode times on the mesh
   beside the unsharded ones and the port's explicit collectives by kind,
   and checks that the MoE sum, the digest sum and the pipeline's
   broadcast ran;
12. measures what the costing counts and the card does: (a) the card's
   profile, a bf16 ``torch.matmul`` at 8192^3 and a 2 GiB device copy, each
   the median of 5 timed with CUDA events, within 30-105% of the data sheet
   and printed beside ``serve/costmodel.py``'s constants; (b) four whole
   calls counted on the card by ``launch.costing.Counter`` (gemma3-1b's
   prefill of 1168 tokens, recurrentgemma-2b's of 384, xlstm-1.3b's of 300,
   and phase 8's qwen3-8b train step): the FLOPs, bytes and kernel calls
   equal the dry-run's count of the same call on fake tensors
   (``launch.dryrun.trace``), the counter changes no launch and no bit of
   the output, and each call's time (CUDA events) gives its roofline share
   and its model-FLOP share; (c) three dry-run cells through the CLI on
   this torch, started with the script on the host's CPU: qwen3-8b
   ``train_4k`` on the 16x16 mesh, xlstm-1.3b ``prefill_32k`` (the sLSTM
   fit, whose check must be exact) and qwen3-moe-235b-a22b ``decode_32k``
   (expert parallelism) on the 2x16x16 one, each ending ``ok``, with
   per-device peak GB, TFLOPs and
   collective GB; the first and the last also traced on fake CPU tensors,
   as a CPU-only build traces them, must give the same counts; the
   qwen3-8b cell's FLOPs and collective bytes within 2% of torch 2.13's
   count (``TORCH_2_13_QWEN3_TRAIN``), both printed with the operator
   whose FLOPs differ most; (d) ``launch/roofline.py`` over (c)'s records
   on fake CUDA tensors: each cell's compute, memory and collective terms
   at the H100's published rates and links, finite, the bound their
   largest;
13. serves gemma3-1b at full width and depth (bf16, random weights from
   seed 0, one weight copy attested by the fingerprint kernel, one
   ``GreedyDecoder`` shared by every replica) as one of three apps on one
   disaggregated-memory substrate of two pools (``scenario.run_scenario``):
   the token server (7 requests of four sessions, roofline-costed on the
   card's profile), a closed-loop KV store and an open-loop matching
   engine, under a fault schedule: a token-server replica crashed while its
   decode engine is busy and recovered, a memory node crashed and its pool
   reconfigured, another token-server replica crashed and replaced between
   turns (the joiner from the same app factory adopts the sessions through
   the pools).  It checks that every app's replicas agree (the recovered
   one and the joiner included), that no budget overran, that every reply
   equals a direct decode of its history, that the path launched the SWA
   kernel once per window layer of every model call and the fingerprint
   once per leaf, and nothing else; then runs the same requests through
   the unreplicated baseline (same tokens) and prints each request's
   virtual µs both ways and their difference, the consensus cost at equal
   serial service time.
14. holds ``GreedyDecoder``'s decode steps, replays of CUDA graphs cut at
   the routed FFN (``serve.StepGraphs``), against the eager steps: (a) for
   every arch's smoke config in fp32, three calls, the first past the 16-slot
   window rings; (b) qwen3-moe-235b-a22b at full width, 8 layers, three
   requests of 19 prompt tokens and 58 generated: tokens and caches bit for
   bit, one capture, every decode step a replay; then one call each way
   under the benchmark's tracer (``bench/trace.py``): the device busy time
   a decode step within 10% of the eager step's, and the routed FFN's
   kernels charged to the span around ``moe_ffn``; and each way's
   untraced time a call.
15. holds the routed-experts kernel (``csrc/routed.cu``) against its plain
   version in bf16 at the serving cells' widths: qwen3-moe-235b-a22b (128
   experts held, top-8; T 1 and 16) and K-EXAONE-236B-A23B (16 of 128
   held; a token's slots held 0, 1, 3 and 8 of 8, and T 2), repeats bit
   for bit, and times it at T = 1 beside the held slots' bytes bound, the
   plain version and three ``torch.bmm`` over the gathered experts.

Any failure raises.  ``--only 3,10,12,13,14,15`` runs the build and those phases
alone and prints no result.  The line before the last is a JSON object of
per-kernel numbers (a kernel timed at several shapes lists them under
``shapes``; its top-level numbers are those of the first).  Each time is
given two ways, measured in one go (``time_ms``): ``ms``, ``plain_ms`` and
``library_ms`` are back-to-back calls, the host's cost of a call included
wherever it exceeds the device's; ``device_ms``, ``plain_device_ms`` and
``library_device_ms`` are the same calls queued behind a spin kernel, the
device's time alone.  Phase 12's numbers are a JSON line before it.  The
last line is ``{"ok": true, "device": ...}``.
Without a GPU, or without the repository's ``src/`` beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import itertools
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# cuBLAS is deterministic only with a fixed workspace configuration, read
# when the first handle is made
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.distributed.tensor import DTensor  # noqa: E402

try:
    from repro_torch.checkpoint import (load_checkpoint, reshard,  # noqa: E402
                                        save_checkpoint)
    from repro_torch.configs import (get_config,  # noqa: E402
                                     get_smoke_config, list_archs)
    from repro_torch.apps.kvstore import KVStoreApp, set_req  # noqa: E402
    from repro_torch.apps.matching import (MatchingEngineApp,  # noqa: E402
                                           order_req)
    from repro_torch.baselines.unreplicated import (  # noqa: E402
        build_unreplicated)
    from repro_torch.core import crypto  # noqa: E402
    from repro_torch.core.consensus import ConsensusConfig  # noqa: E402
    from repro_torch.data import DataConfig, TokenPipeline  # noqa: E402
    from repro_torch.kernels import cuda, ops, rglru, work  # noqa: E402
    from repro_torch.kernels.fingerprint import (fingerprint_cuda,  # noqa: E402
                                                 fingerprint_plain)
    from repro_torch.kernels.mlstm import mlstm_plain  # noqa: E402
    from repro_torch.kernels.rglru import rglru_plain  # noqa: E402
    from repro_torch.kernels.routed import routed_plain  # noqa: E402
    from repro_torch.kernels.swa import swa_cuda, swa_plain  # noqa: E402
    from repro_torch.launch import costing, dryrun, serve  # noqa: E402
    from repro_torch.launch.mesh import make_host_mesh, make_mesh  # noqa: E402
    from repro_torch.launch.shapes import ShapeSpec  # noqa: E402
    from repro_torch.launch.train import train as train_launcher  # noqa: E402
    from repro_torch.models.common import (Transformer,  # noqa: E402
                                           default_blocks, init_params)
    from repro_torch.models.transformer import (embed, lm_loss,  # noqa: E402
                                                prefill)
    from repro_torch.optim import (AdamWConfig, adamw_init,  # noqa: E402
                                   adamw_update)
    from repro_torch.parallel import comm  # noqa: E402
    from repro_torch.parallel.pipeline import pipeline_apply  # noqa: E402
    from repro_torch.parallel.sharding import (cache_pspecs,  # noqa: E402
                                               param_pspecs,
                                               shard_ctx_for_mesh, whole)
    from repro_torch.runtime.attest import fingerprint_tree  # noqa: E402
    from repro_torch.runtime.steps import (make_prefill,  # noqa: E402
                                           make_serve_step, make_train_step)
    from repro_torch.runtime.server import TokenServerApp  # noqa: E402
    from repro_torch.runtime.trainer import ReplicatedTrainer  # noqa: E402
    from repro_torch.scenario import (AppSpec, ScenarioSpec,  # noqa: E402
                                      Workload, run_scenario)
    from repro_torch.serve import ServingCostModel  # noqa: E402
    from repro_torch.sim.faults import FaultSchedule  # noqa: E402
    from repro_torch.workloads import llm_session_trace  # noqa: E402
except ImportError as e:
    sys.exit(f"chip_smoke: the port is not importable from {ROOT / 'src'}: {e}")

# H100 SXM data sheet (dense), from the port's work formulas
# (``kernels.work``): HBM rate, bf16 tensor-core rate, and the CUDA cores'
# fp32 rate, which fp32 and integer word operations run at
HBM_BYTES_S, BF16_FLOPS, CORE_OPS = (work.HBM_BYTES_S, work.BF16_FLOPS,
                                     work.CORE_OPS)
# input bytes a cold timing rotates over: four times the H100's 50 MB L2
ROTATE_BYTES = 200_000_000
# fp16: about four times the largest error read on the card (9.8e-4)
SWA_TOL = {torch.bfloat16: 2e-2, torch.float16: 4e-3, torch.float32: 2e-5}
RGLRU_TOL = 1e-5                       # tests/test_kernels.py's rtol = atol
# h: tests/test_kernels.py's rtol = atol; the fp32 state differs from the
# plain version's only in the order of fp32 sums, whatever the input type
MLSTM_TOL = {torch.bfloat16: 5e-2, torch.float32: 2e-4}
MLSTM_STATE_TOL = 2e-4
# the routed kernel against its plain version in bf16, as a share of the
# output's largest value: the plain version's cuBLAS products sum their D
# (or F) terms in another order, so h, u and y may round to the
# neighbouring bf16 value; test_torch_moe.py's bf16 limit of one MoE layer
ROUTED_TOL = 3e-2
# phase 8: qwen3-8b's depth cut to fit three replicas' state on one card;
# two sequences of 1024 tokens a step; the launcher's learning rate
TRAIN_LAYERS = 4
TRAIN_BATCH, TRAIN_SEQ = 2, 1024
TRAIN_LR = 1e-3
# phase 9: recurrentgemma-2b cut to one (RG-LRU, RG-LRU, local attention)
# group, 2 x 1024 tokens a step; xlstm-1.3b cut to two (3 mLSTM, sLSTM)
# groups, 2 x 512 tokens a step
RG_BATCH, RG_SEQ = 2, 1024
XLSTM_GROUPS = 2
XLSTM_BATCH, XLSTM_SEQ = 2, 512
# phase 10: the MoE archs' depth cut so that one model's bf16 weights and
# its init's fp32 draw of one stacked expert leaf fit the card
MOE_LAYERS = 8
# phase 10's frontend checks: musicgen-large's and chameleon-34b's depth
FRONTEND_LAYERS = 4
# the card's memory: a path's peak allocation must stay below it
CARD_BYTES = 80e9


#: the per-shape numbers of a kernel's JSON entry
TIMES = ("ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
         "bound_by", "library_ms", "library_device_ms")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip()


_SPIN = {}


def _spin_cycles_per_ms() -> float:
    """Clock cycles a millisecond of ``torch.cuda._sleep`` takes, measured
    once."""
    if not _SPIN:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1000)
        start.record()
        torch.cuda._sleep(20_000_000)
        end.record()
        end.synchronize()
        _SPIN["cycles_per_ms"] = 20_000_000 / start.elapsed_time(end)
    return _SPIN["cycles_per_ms"]


def time_ms(fn, iters: int, warmup: int = 2) -> tuple:
    """Mean time of ``fn`` over ``iters`` calls, in ms, measured two ways
    in one go: (back to back, device).  Back to back, the calls are issued
    one after another as a caller does, so the host's cost of a call
    (Python, allocation, the launch) is in the time wherever it exceeds the
    device's.  For the device time the same calls are queued behind a spin
    kernel that outlasts their issue, so the device runs them with no gap."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    back_to_back = start.elapsed_time(end) / iters
    torch.cuda._sleep(int((2 * host_ms + 1) * _spin_cycles_per_ms()))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return back_to_back, start.elapsed_time(end) / iters


def timed(fn, plain, library, iters: int, plain_iters: int) -> dict:
    """The kernel's, its plain version's and (where there is one) the
    library call's times, each both ways (``time_ms``)."""
    out = {}
    for key, f, n in (("", fn, iters), ("plain_", plain, plain_iters),
                      ("library_", library, iters)):
        if f is None:
            out[f"{key}ms"] = out[f"{key}device_ms"] = None
        else:
            out[f"{key}ms"], out[f"{key}device_ms"] = time_ms(f, n)
    return out


def phase_build() -> None:
    t0 = time.perf_counter()
    cuda.build()
    secs = time.perf_counter() - t0
    for name, log in cuda.build_log.items():
        for line in log.splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  ptxas {name}: {line.strip()}")
    print(f"[1] built {', '.join(cuda.SOURCES)} for sm_90a in {secs:.1f} s")


def _words(n: int, dtype: torch.dtype, gen: torch.Generator) -> torch.Tensor:
    if dtype in (torch.int32, torch.uint32):
        x = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), dtype=torch.int32,
                          device="cuda", generator=gen)
        return x.view(dtype)
    return (torch.randn(n, device="cuda", generator=gen) * 100).to(dtype)


def phase_fingerprint(full_model: Transformer) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_checked = 0
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int32,
                  torch.uint32):
        for n in (1, 100, 4096, 5000, 12345, 2 ** 24 + 3):
            x = _words(n + 1, dtype, gen)
            # the whole (16-byte aligned) tensor and an unaligned view
            for view in (x[:n], x[1:]):
                got, want = ops.fingerprint(view), fingerprint_plain(view)
                check(got == want, f"fingerprint {dtype} n={n}: {got} != {want}")
                n_checked += 1
    leaves = list(full_model.param_leaves())
    t0 = time.perf_counter()
    tree_gpu = fingerprint_tree(leaves)
    tree_gpu_s = time.perf_counter() - t0
    tree_cpu = fingerprint_tree(p.cpu() for p in leaves)
    check(tree_gpu == tree_cpu, f"fingerprint_tree {tree_gpu} != {tree_cpu}")
    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, 2 ** 32, size=n, dtype=np.uint32)
              for n in (0, 1, 4096, 5000, 2 ** 20 + 7)]
    arrays.append(rng.integers(0, 1000, size=999).astype(np.float64))
    check(crypto.attest_batch(arrays, backend="cuda")
          == crypto.attest_batch(arrays, backend="numpy"),
          "attest_batch cuda != numpy")

    # time the main path's largest launch: the embedding table
    emb = full_model.embed
    t = timed(lambda: fingerprint_cuda(emb), lambda: fingerprint_plain(emb),
              None, iters=20, plain_iters=3)
    fp_work = work.fingerprint_work(emb.numel(), emb.element_size())
    n_bytes = fp_work.bytes
    bound_ms, bound_by = fp_work.bound()
    print(f"[2] fingerprint: {n_checked} digests bit-exact; gemma3-1b tree "
          f"{tree_gpu:#010x} on card == CPU ({len(leaves)} leaves, "
          f"{tree_gpu_s * 1e3:.2f} ms); attest_batch cuda == numpy")
    print(f"    embed table {tuple(emb.shape)} bf16: kernel {t['ms']:.4f} ms "
          f"(device {t['device_ms']:.4f}), plain {t['plain_ms']:.3f} ms, bound "
          f"{bound_ms:.4f} ms ({n_bytes / t['device_ms'] / 1e6:.0f} GB/s)")
    shape = dict(shape=f"gemma3-1b embed {tuple(emb.shape)} bf16", **t,
                 bound_ms=bound_ms, bound_by=bound_by)
    return {"name": "fingerprint", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fingerprint.cu",
            "replaces": "src/repro/kernels/fingerprint.py:25",
            "max_abs_err": 0, **{k: shape[k] for k in TIMES},
            "shapes": [shape]}


def _close(name: str, got: torch.Tensor, want: torch.Tensor,
           tol: float) -> float:
    """Fail unless |got - want| <= tol + tol |want| everywhere; returns the
    largest absolute difference."""
    got, want = got.float(), want.float()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{name}: shape {tuple(got.shape)} or non-finite values")
    err = (got - want).abs()
    check(not bool((err > tol + tol * want.abs()).any()),
          f"{name}: max abs err {float(err.max())} (tol {tol})")
    return float(err.max())


def phase_swa() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    worst = 0.0
    # (arch, H, KV, dh, w, S, strided): gemma3-1b, then recurrentgemma-2b
    # (G = 10, a window longer than every prompt of the main path)
    cases = [("gemma3-1b", 4, 1, 256, 512, S, False)
             for S in (300, 512, 1168, 2048)]
    cases += [("gemma3-1b", 4, 2, 256, 512, 1168, False),
              ("gemma3-1b", 4, 1, 256, 512, 1168, True)]
    cases += [("recurrentgemma-2b", 10, 1, 256, 2048, S, False)
              for S in (1168, 3000)]
    runs = [(dtype, case) for dtype in (torch.bfloat16, torch.float32)
            for case in cases]
    runs += [(torch.float16, case) for case in cases[:3]]
    for dtype, (arch, H, KV, dh, w, S, strided) in runs:
        tol = SWA_TOL[dtype]
        q = torch.randn(1, S, H, dh, device="cuda", generator=gen).to(dtype)
        if strided:     # k and v as views into one packed tensor
            kv = torch.randn(1, S, 2 * KV, dh, device="cuda",
                             generator=gen).to(dtype)
            k, v = kv[:, :, :KV], kv[:, :, KV:]
        else:
            k, v = (torch.randn(1, S, KV, dh, device="cuda",
                                generator=gen).to(dtype) for _ in range(2))
        got = ops.sliding_window_attention(q, k, v, w)
        again = ops.sliding_window_attention(q, k, v, w)
        want = swa_plain(q, k, v, w)
        torch.cuda.synchronize()
        what = f"swa {arch} {dtype} S={S} KV={KV} strided={strided}"
        check(torch.equal(got, again), f"{what}: a repeat gave other bits")
        err = _close(what, got, want, tol)
        worst = max(worst, err)
        print(f"    swa {arch} {str(dtype)[6:]} S={S} H={H} KV={KV} w={w}"
              f"{' strided' if strided else ''}: max abs err {err:.3g} "
              f"(tol {tol}); repeat bit-identical")

    # time at the main paths' longest prefill: S = 3 * (384 + 8) - 8 = 1168
    shapes = []
    for arch, H, w in (("gemma3-1b", 4, 512), ("recurrentgemma-2b", 10, 2048)):
        S, KV, dh = 1168, 1, 256
        q = torch.randn(1, S, H, dh, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        k, v = (torch.randn(1, S, KV, dh, device="cuda", generator=gen,
                            dtype=torch.bfloat16) for _ in range(2))
        pos = torch.arange(S, device="cuda")
        delta = pos[:, None] - pos[None, :]
        band = (delta >= 0) & (delta < w)
        qt = q.transpose(1, 2)
        kt, vt = (x.transpose(1, 2).repeat_interleave(H // KV, dim=1)
                  for x in (k, v))
        sdpa = F.scaled_dot_product_attention   # timed only; the port never calls it
        t = timed(lambda: ops.sliding_window_attention(q, k, v, w),
                  lambda: swa_plain(q, k, v, w),
                  lambda: sdpa(qt, kt, vt, attn_mask=band),
                  iters=50, plain_iters=10)
        # the launcher called directly, without the wrapper's checks and
        # the registered operator that the wrapper calls
        t["direct_ms"], t["direct_device_ms"] = time_ms(
            lambda: swa_cuda(q, k, v, w), 50)
        lib_err = float((sdpa(qt, kt, vt, attn_mask=band).transpose(1, 2).float()
                         - ops.sliding_window_attention(q, k, v, w).float()
                         ).abs().max())
        bound_ms, bound_by = work.swa_work(1, S, H, KV, dh, w, 2).bound()
        print(f"[3] swa {arch} (H={H}, KV={KV}, w={w}): kernel == plain at "
              f"every shape; at S={S} bf16, back to back (device): kernel "
              f"{t['ms']:.4f} ({t['device_ms']:.4f}) ms, plain "
              f"{t['plain_ms']:.4f} ({t['plain_device_ms']:.4f}) ms, "
              f"sdpa+banded mask {t['library_ms']:.4f} "
              f"({t['library_device_ms']:.4f}) ms (max diff to kernel "
              f"{lib_err:.3g}), bound {bound_ms:.4f} ms ({bound_by}); the "
              f"launcher called directly {t['direct_ms']:.4f} "
              f"({t['direct_device_ms']:.4f}) ms: back to back the wrapper "
              f"(its checks and the operator's dispatch) adds "
              f"{(t['ms'] - t['direct_ms']) * 1e3:.1f} us a call")
        shapes.append(dict(shape=f"{arch}: S {S}, H {H}, KV {KV}, dh {dh}, "
                                 f"w {w}, bf16",
                           **t, bound_ms=bound_ms, bound_by=bound_by))
    return {"name": "swa", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/swa.cu",
            "replaces": "src/repro/kernels/swa.py:27", "max_abs_err": worst,
            **{k: shapes[0][k] for k in TIMES}, "shapes": shapes}


def phase_rglru() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4)
    W = 2560                                   # recurrentgemma-2b's lru width
    lanes, segments, steps = rglru.layout()
    chunk = segments * steps                   # steps of a super-chunk
    worst, bitexact = 0.0, True
    lengths = (1, 384, 776, 1168, chunk - 1, chunk, chunk + 1, 4096)
    cases = [(B, S, "uniform") for B in (1, 2) for S in lengths]
    cases.append((1, 4096, "near 1"))
    for B, S, decay in cases:
        if decay == "uniform":
            a = torch.rand(B, S, W, device="cuda", generator=gen)   # in (0, 1)
            x = torch.randn(B, S, W, device="cuda", generator=gen)
        else:       # a = 1 - 1e-3 u; x scaled by the model's sqrt(1 - a²)
            a = 1 - 1e-3 * torch.rand(B, S, W, device="cuda", generator=gen)
            x = (torch.randn(B, S, W, device="cuda", generator=gen)
                 * torch.sqrt(1 - a * a))
        got = ops.rglru_scan(a, x)
        again = ops.rglru_scan(a, x)
        want = rglru_plain(a, x)
        torch.cuda.synchronize()
        what = f"rglru B={B} S={S} a {decay}"
        check(torch.equal(got, again), f"{what}: a repeat gave other bits")
        check(torch.equal(got[:, :steps], want[:, :steps]),
              f"{what}: the first segment differs from the plain version")
        err = _close(what, got, want, RGLRU_TOL)
        worst = max(worst, err)
        bitexact = bitexact and torch.equal(got, want)
        print(f"    {what}: max abs err {err:.3g} (tol {RGLRU_TOL}, max "
              f"|y| {float(want.abs().max()):.3g}); first {steps} steps "
              f"bit-exact; repeat bit-identical")
    print(f"[4] rglru ({lanes} lanes x {segments} segments x {steps} steps a "
          f"block): kernel == plain within {RGLRU_TOL} at W={W}, B in (1, 2), "
          f"S in {lengths} and a near 1 at S 4096 (max abs err {worst:.3g}); "
          f"first {steps} steps bit-exact; repeats bit-identical; whole "
          f"output bit for bit: {bitexact} (information only)")
    # time at the main path's prefill lengths (prompts of 384 tokens, three
    # turns), and at batch 2.  Warm: every call reads the same a and x,
    # which stay in the 50 MB L2 where they fit (36 MB at B 1, S 1168).
    # Cold: the calls rotate over input sets of at least 200 MB in all, so
    # each reads a and x from HBM.  torch.add(a, x, out=y) moves the same
    # 12 bytes an element: the floor a copy reaches, timed both ways too.
    shapes = []
    for B, S in ((1, 1168), (1, 776), (1, 384), (2, 1168)):
        n_sets = max(4, -(-ROTATE_BYTES // (2 * B * S * W * 4)))
        sets = [(torch.rand(B, S, W, device="cuda", generator=gen),
                 torch.randn(B, S, W, device="cuda", generator=gen))
                for _ in range(n_sets)]
        a, x = sets[0]
        y = torch.empty_like(a)
        rotate = itertools.cycle(sets)
        t = timed(lambda: ops.rglru_scan(a, x), lambda: rglru_plain(a, x),
                  None, iters=100, plain_iters=3)
        t["cold_ms"], t["cold_device_ms"] = time_ms(
            lambda: ops.rglru_scan(*next(rotate)), 100)
        t["add_ms"], t["add_device_ms"] = time_ms(
            lambda: torch.add(a, x, out=y), 100)
        t["add_cold_ms"], t["add_cold_device_ms"] = time_ms(
            lambda: torch.add(*next(rotate), out=y), 100)
        bound_ms, bound_by = work.rglru_work(B, S, W).bound()
        blocks = B * -(-W // lanes)
        print(f"[4] rglru at B={B} S={S} W={W} fp32, back to back (device): "
              f"kernel {t['ms']:.4f} ({t['device_ms']:.4f}) ms warm, "
              f"{t['cold_ms']:.4f} ({t['cold_device_ms']:.4f}) ms cold over "
              f"{n_sets} input sets ({blocks} blocks of {lanes * segments} "
              f"threads), plain {t['plain_ms']:.3f} ms; torch.add of the "
              f"same bytes {t['add_ms']:.4f} ({t['add_device_ms']:.4f}) ms "
              f"warm, {t['add_cold_ms']:.4f} ({t['add_cold_device_ms']:.4f}) "
              f"ms cold; bound {bound_ms:.4f} ms ({bound_by}; device share "
              f"{bound_ms / t['device_ms']:.0%} warm, "
              f"{bound_ms / t['cold_device_ms']:.0%} cold); kernel against "
              f"torch.add, device: {t['add_device_ms'] / t['device_ms']:.0%} "
              f"warm, {t['add_cold_device_ms'] / t['cold_device_ms']:.0%} "
              f"cold")
        shapes.append(dict(shape=f"recurrentgemma-2b: B {B}, S {S}, W {W}, "
                                 f"fp32",
                           **t, bound_ms=bound_ms, bound_by=bound_by))
        del sets, rotate
    return {"name": "rglru", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rglru.cu",
            "replaces": "src/repro/kernels/rglru.py:21", "max_abs_err": worst,
            **{k: shapes[0][k] for k in TIMES}, "shapes": shapes}


def _routes(T: int, k: int, E: int, e_held: int, held: int, scale: float,
            gen: torch.Generator):
    """T tokens, each routed to k distinct experts of E, ``held`` of them in
    [0, e_held), in a shuffled slot order; positive weights summing to
    ``scale``."""
    rows = []
    for _ in range(T):
        mine = torch.randperm(e_held, device="cuda", generator=gen)[:held]
        rest = e_held + torch.randperm(E - e_held, device="cuda",
                                       generator=gen)[:k - held]
        e = torch.cat([mine, rest])
        rows.append(e[torch.randperm(k, device="cuda", generator=gen)])
    w = torch.rand(T, k, device="cuda", generator=gen) + 0.1
    return torch.stack(rows), w / w.sum(-1, keepdim=True) * scale


def phase_routed() -> dict:
    """Phase 15: the routed-experts kernel at the serving cells' widths in
    bf16 against its plain version: Qwen3-235B-A22B (128 experts held,
    top-8) and K-EXAONE-236B-A23B (16 of 128 held, top-8, weights x 2.5)
    with 0, 1, 3 and 8 of a token's slots held, and T·k = the experts held;
    two launches give the same bits; a token with no held slot gets zeros.
    Times at T = 1 beside the bytes bound of the held slots, the plain
    version's, and three ``torch.bmm`` over the held slots' experts
    gathered beforehand (``library_ms``; the port never calls it)."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    worst, shapes = 0.0, []
    for arch, e_held, E, D, Fe, k, scale, cases in (
            ("qwen3-moe-235b-a22b", 128, 128, 4096, 1536, 8, 1.0,
             ((1, 8), (16, 8))),
            ("k-exaone-236b-a23b", 16, 128, 6144, 2048, 8, 2.5,
             ((1, 0), (1, 1), (1, 3), (1, 8), (2, 3)))):
        gc.collect()
        torch.cuda.empty_cache()
        w_gate, w_up = (torch.randn(e_held, D, Fe, device="cuda",
                                    dtype=torch.bfloat16,
                                    generator=gen).mul_(D ** -0.5)
                        for _ in range(2))
        w_down = torch.randn(e_held, Fe, D, device="cuda",
                             dtype=torch.bfloat16,
                             generator=gen).mul_(Fe ** -0.5)
        for T, held in cases:
            top_e, top_w = _routes(T, k, E, e_held, held, scale, gen)
            x = torch.randn(T, D, device="cuda", dtype=torch.bfloat16,
                            generator=gen)
            args = (x, top_e, top_w, w_gate, w_up, w_down, 0, e_held)
            before = ops.launches["routed"]
            got = ops.routed_experts(*args)
            again = ops.routed_experts(*args)
            want = routed_plain(*args)
            torch.cuda.synchronize()
            what = f"routed {arch} T={T}, {held} of {k} slots held"
            check(ops.launches["routed"] - before == 2,
                  f"{what}: {ops.launches['routed'] - before} launches "
                  f"counted for two calls")
            check(torch.equal(got, again), f"{what}: a repeat gave other "
                                           f"bits")
            if held == 0:
                check(not bool(got.any()), f"{what}: not zero")
                print(f"    {what}: zeros, repeat bit-identical")
                continue
            err = float((got.float() - want.float()).abs().max())
            top = float(want.float().abs().max())
            check(bool(torch.isfinite(got).all()) and err <= ROUTED_TOL * top,
                  f"{what}: max abs err {err:.4g} against {ROUTED_TOL} x "
                  f"max |y| {top:.4g}")
            worst = max(worst, err / top)
            print(f"    {what}: max abs err {err:.4g} = {err / top:.4f} of "
                  f"max |y| {top:.4g} (tol {ROUTED_TOL}); bits equal the "
                  f"plain version's: {torch.equal(got, want)}; repeat "
                  f"bit-identical")
            if T != 1:
                continue
            sel = top_e[0][top_e[0] < e_held]
            xs = x.expand(held, 1, D)
            gg, gu, gd = w_gate[sel], w_up[sel], w_down[sel]
            t = timed(lambda: ops.routed_experts(*args),
                      lambda: routed_plain(*args),
                      lambda: torch.bmm(F.silu(torch.bmm(xs, gg))
                                        * torch.bmm(xs, gu), gd),
                      iters=50, plain_iters=10)
            bound_ms, bound_by = work.routed_work(1, held, D, Fe, 2).bound()
            print(f"[15] routed {arch} T=1, {held} held: kernel {t['ms']:.4f} "
                  f"({t['device_ms']:.4f}) ms back to back (device), plain "
                  f"{t['plain_ms']:.4f} ({t['plain_device_ms']:.4f}), three "
                  f"bmm over the gathered experts {t['library_ms']:.4f} "
                  f"({t['library_device_ms']:.4f}); bound {bound_ms:.4f} ms "
                  f"({bound_by}; device share "
                  f"{bound_ms / t['device_ms']:.1%}, "
                  f"{held * 3 * D * Fe * 2 / t['device_ms'] / 1e6:.0f} GB/s)")
            shapes.append(dict(shape=f"{arch}: T 1, {held} of {k} slots "
                                     f"held, D {D}, F {Fe}, bf16",
                               **t, bound_ms=bound_ms, bound_by=bound_by))
        del w_gate, w_up, w_down
    print(f"[15] routed: kernel == plain within {ROUTED_TOL} of the largest "
          f"output (worst {worst:.4f}); repeats bit-identical; one launch "
          f"counted a call")
    return {"name": "routed", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/routed.cu",
            "replaces": "none: new to the port (the reference's routed FFN "
                        "is XLA's)", "max_abs_err": worst,
            **{k: shapes[0][k] for k in TIMES}, "shapes": shapes}


def _mlstm_inputs(S: int, dtype: torch.dtype, gen: torch.Generator):
    """xlstm-1.3b's head shape (H 4, dh 512) at batch 1; q.k of unit
    scale, as the model's dh**-0.5 scaling of both gives."""
    H, dh = 4, 512
    q, k = ((torch.randn(1, S, H, dh, device="cuda", generator=gen)
             * dh ** -0.25).to(dtype) for _ in range(2))
    v = torch.randn(1, S, H, dh, device="cuda", generator=gen).to(dtype)
    it = torch.randn(1, S, H, device="cuda", generator=gen)
    ft = torch.randn(1, S, H, device="cuda", generator=gen) + 2.0
    return q, k, v, it, ft


def phase_mlstm() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(5)
    chunk = 256                                # xlstm-1.3b's mlstm_chunk
    worst = {"h": 0.0, "state": 0.0}
    for dtype in (torch.bfloat16, torch.float32):
        for S in (64, 256, 300, 1168):
            q, k, v, it, ft = _mlstm_inputs(S, dtype, gen)
            # h through the JAX package's wrapper (pads ft with 30)...
            got = ops.mlstm_chunkwise(q, k, v, it, ft, chunk)
            # ...and h and the state through the model's entry, on inputs
            # padded with zeros
            c = min(chunk, S)
            pad = (-S) % c
            padded = [F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (q, k, v)]
            padded += [F.pad(g, (0, 0, 0, pad)) for g in (it, ft)]
            h, state = ops.mlstm_chunkwise_state(*padded, c)
            h2, state2 = ops.mlstm_chunkwise_state(*padded, c)
            hp, statep = mlstm_plain(*padded, c)
            want = mlstm_plain(*(F.pad(x, (0, 0, 0, 0, 0, pad))
                                 for x in (q, k, v)),
                               F.pad(it, (0, 0, 0, pad)),
                               F.pad(ft, (0, 0, 0, pad), value=30.0), c)[0]
            torch.cuda.synchronize()
            check(torch.equal(h, h2) and all(torch.equal(x, y) for x, y
                                             in zip(state, state2)),
                  f"mlstm {dtype} S={S}: a repeat gave other bits")
            tol = MLSTM_TOL[dtype]
            errs = [_close(f"mlstm h (ft pad 30) {dtype} S={S}", got,
                           want[:, :S], tol),
                    _close(f"mlstm h {dtype} S={S}", h, hp, tol)]
            state_errs = [_close(f"mlstm {name} {dtype} S={S}", x, y,
                                 MLSTM_STATE_TOL)
                          for name, x, y in zip("Cnm", state, statep)]
            worst["h"] = max(worst["h"], *errs)
            worst["state"] = max(worst["state"], *state_errs)
            print(f"    mlstm {str(dtype)[6:]} S={S} (chunk {c}, pad {pad}): "
                  f"h max abs err {max(errs):.3g} (tol {tol}), C/n/m "
                  f"{', '.join(f'{e:.3g}' for e in state_errs)} (tol "
                  f"{MLSTM_STATE_TOL}); repeat bit-identical")
    # time at the padded lengths of the main path's prefills: 300, 608 and
    # 916 tokens pad to 512, 768 and 1024
    shapes = []
    for S in (1024, 768, 512):
        q, k, v, it, ft = _mlstm_inputs(S, torch.bfloat16, gen)
        t = timed(lambda: ops.mlstm_chunkwise_state(q, k, v, it, ft, chunk),
                  lambda: mlstm_plain(q, k, v, it, ft, chunk), None,
                  iters=50, plain_iters=10)
        bound_ms, bound_by = work.mlstm_work(1, S, 4, 512, chunk, 2).bound()
        # blocks: (plane, 64 rows, 128 columns of C); (plane, chunk, 64
        # query rows, 128 value columns)
        state_blocks = 4 * (512 // 64) * (512 // 128)
        out_blocks = 4 * (S // chunk) * (chunk // 64) * (512 // 128)
        print(f"[5] mlstm at S={S} (H=4, dh=512, chunk {chunk}, bf16), back "
              f"to back (device): kernel {t['ms']:.4f} ({t['device_ms']:.4f}) "
              f"ms (state pass {state_blocks} blocks, output pass "
              f"{out_blocks}), plain {t['plain_ms']:.4f} "
              f"({t['plain_device_ms']:.4f}) ms, bound {bound_ms:.4f} ms "
              f"({bound_by})")
        shapes.append(dict(shape=f"xlstm-1.3b: S {S}, H 4, dh 512, chunk "
                                 f"{chunk}, bf16",
                           **t, bound_ms=bound_ms, bound_by=bound_by))
    print(f"[5] mlstm: kernel == plain (h and C, n, m) at H=4, dh=512, chunk "
          f"{chunk}, S in (64, 256, 300, 1168), bf16 and fp32; repeats "
          f"bit-identical")
    return {"name": "mlstm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/mlstm.cu",
            "replaces": "src/repro/kernels/mlstm.py:24",
            "max_abs_err": max(worst.values()),
            **{k: shapes[0][k] for k in TIMES}, "shapes": shapes}


@contextlib.contextmanager
def plain_kernels():
    """The model layers call the kernels' plain versions in their place, on
    the tensors' own device."""
    names = ("sliding_window_attention", "rglru_scan", "mlstm_chunkwise_state")
    saved = [getattr(ops, name) for name in names]
    for name, plain in zip(names, (swa_plain, rglru_plain, mlstm_plain)):
        setattr(ops, name, plain)
    try:
        yield
    finally:
        for name, fn in zip(names, saved):
            setattr(ops, name, fn)


def compare_layers(arch: str, S: int, tol: float, expect: dict,
                   dtype: str) -> None:
    """One group of ``arch`` at full width: the kernel path on the card
    against a reference, logits and every layer's cache or state.  In fp32
    the reference is the plain path on the CPU; in bf16 it is the same
    layers on the card with the plain versions in the kernels' place, so
    that the two differ only in the kernels, which get the main path's
    strides and padding.  ``expect`` is the kernel launches the group
    makes."""
    cfg = dataclasses.replace(first_group(arch), dtype=dtype)
    gpu = init_params(cfg, torch.Generator(device="cuda").manual_seed(2),
                      device="cuda")
    max_seq = S + 8
    toks = torch.randint(0, cfg.vocab, (1, S),
                         generator=torch.Generator().manual_seed(3))
    ops.reset_launches()
    logits_g, caches_g = prefill(gpu, toks.cuda(), max_seq=max_seq)
    torch.cuda.synchronize()
    got = {k: n for k, n in ops.launches.items() if n}
    check(got == expect, f"{arch} group launched {got}, expected {expect}")
    if dtype == "float32":
        ref = "CPU"
        cpu = Transformer(cfg, device="cpu")
        cpu.load_state_dict(gpu.state_dict())
        logits_r, caches_r = prefill(cpu, toks, max_seq=max_seq)
    else:
        ref = "card with plain versions"
        ops.reset_launches()
        with plain_kernels():
            logits_r, caches_r = prefill(gpu, toks.cuda(), max_seq=max_seq)
        torch.cuda.synchronize()
        check(not any(ops.launches.values()),
              f"{arch} plain group launched {dict(ops.launches)}")
    pairs = {"logits": (logits_g.cpu(), logits_r.cpu())}
    for i, (cg, cr) in enumerate(zip(caches_g[0], caches_r[0])):
        for k in sorted(cg):
            pairs[f"state[{i}].{k}"] = (cg[k].cpu(), cr[k].cpu())
    err = {name: _close(f"{arch} {dtype} {name}", g, r, tol)
           for name, (g, r) in pairs.items()}
    # the least tol under which every pair would pass
    least = max(float(((g.float() - r.float()).abs()
                       / (1 + r.float().abs())).max())
                for g, r in pairs.values())
    worst = max(err, key=lambda k: err[k] if k != "logits" else -1)
    print(f"    {arch} {cfg.n_layers} layers {dtype}, S={S}: card == {ref} "
          f"within {tol} (least passing tol {least:.3g}; logits max abs err "
          f"{err['logits']:.3g}; worst state {worst} {err[worst]:.3g}); "
          f"launches {got}")


def phase_layers() -> None:
    # fp32: sums in another order over a few layers at full width, and fp32
    # sin/cos at angles up to about 1.2e3 rad in RoPE.  bf16: about 2.5
    # times the least passing tolerance read on the card (0.0358, 0.0068 and
    # 0.0885; xlstm-1.3b's is its sLSTM's stabiliser m, one layer on from the
    # mLSTM outputs, which differ from the plain version's in bf16 rounding)
    groups = (("gemma3-1b", 1168, {"swa": 5}, 0.1),
              ("recurrentgemma-2b", 600, {"rglru": 2, "swa": 1}, 2e-2),
              # 300 tokens pad to 512: the padding quirk runs on the card
              ("xlstm-1.3b", 300, {"mlstm": 3}, 0.2))
    fp32_tol = 1e-3
    for arch, S, expect, _ in groups:
        compare_layers(arch, S, fp32_tol, expect, "float32")
    for arch, S, expect, bf16_tol in groups:
        compare_layers(arch, S, bf16_tol, expect, "bfloat16")
    print(f"[6] full-width layers, one group of each arch: card == CPU in fp32 "
          f"within {fp32_tol}; kernels == plain versions on the card in bf16 "
          f"within {', '.join(str(g[3]) for g in groups)}")


def phase_serve(card_line: str, arch: str, sessions: int, turns: int,
                prompt_len: int, gen_len: int, kernels, profile_turn: int,
                layers: int = 0, check_model=None, tag: str = "[7]",
                pattern_reps: int = 0) -> dict:
    """Serves ``arch`` at full width through 3 replicas, at full depth or
    cut to ``layers`` (a uniform stack) or to ``pattern_reps`` repetitions
    of its first group's pattern; returns the kernel launch counts
    of this path, which must be the ``kernels`` named and the fingerprint
    once per leaf (the weights' attestation at set-up).  ``check_model(
    model, max_seq)`` runs after the path's checks, its launches
    uncounted."""
    full = get_config(arch)
    cfg = full if not layers else dataclasses.replace(
        full, n_layers=layers, blocks=default_blocks(layers))
    if pattern_reps:
        pattern = full.blocks[0][0]
        cfg = dataclasses.replace(full, n_layers=len(pattern) * pattern_reps,
                                  blocks=((pattern, pattern_reps),))
    depth = (f"{cfg.n_layers} of {full.n_layers} layers"
             if layers or pattern_reps
             else f"{cfg.n_layers} layers (full depth)")
    max_seq = turns * (prompt_len + gen_len) + 8
    serve.set_deterministic()
    rng = np.random.default_rng(0)
    prompts = [[rng.integers(0, cfg.vocab, size=prompt_len).tolist()
                for _ in range(sessions)] for _ in range(turns)]

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    server, decoder, digest = serve.build_server(cfg, torch.device("cuda"),
                                                 max_seq)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    clients = [server.cluster.new_client() for _ in range(sessions)]
    reqs = []
    for t in range(turns):
        for s in range(sessions):
            t1 = time.perf_counter()
            toks, lat = server.generate(clients[s], f"s{s}", prompts[t][s],
                                        gen_len)
            wall = time.perf_counter() - t1
            check(toks is not None and len(toks) == gen_len
                  and all(0 <= x < cfg.vocab for x in toks),
                  f"{arch} turn {t} session {s}: bad tokens {toks}")
            reqs.append({"turn": t, "session": s, "tokens": toks,
                         "smr_latency_us": lat, "wall_ms": wall * 1e3})
    launches = dict(ops.launches)
    torch.cuda.synchronize()
    serve_peak = torch.cuda.max_memory_allocated()
    calls = list(decoder.timings)

    check(all(launches[k] > 0 for k in kernels),
          f"{arch}: the main path skipped a kernel: {launches}")
    if "routed" in kernels:
        # one launch a routed layer a decode step: every replica's replayed
        # steps and the eager step before each capture; no prefill
        steps = len(calls) * (gen_len - 1) + decoder.captures
        n_routed = sum(map(cfg.routed, cfg.layer_list()))
        check(launches["routed"] == n_routed * steps,
              f"{arch}: {launches['routed']} routed launches, "
              f"{n_routed} routed layers x {steps} decode steps expected")
    n_leaves = len(list(decoder.model.param_leaves()))
    check(launches["fingerprint"] == n_leaves
          and all(n == 0 for k, n in launches.items() if k not in kernels),
          f"{arch}: launches {launches}, expected {kernels} and the "
          f"fingerprint {n_leaves} times")
    check(setup_peak < CARD_BYTES and serve_peak < CARD_BYTES,
          f"{arch}: peak {setup_peak / 1e9:.2f} GB at set-up, "
          f"{serve_peak / 1e9:.2f} GB serving")
    snaps = [r.app.snapshot() for r in server.cluster.replicas]
    check(snaps[0] == snaps[1] == snaps[2], f"{arch}: replica snapshots differ")
    hist = dict(snaps[0])
    check(all(len(h) == turns * (prompt_len + gen_len) for h in hist.values()),
          f"{arch}: session histories have the wrong length")
    # the same greedy decode outside the replicas gives the same tokens
    check(decoder("s0", prompts[0][0], gen_len) == reqs[0]["tokens"],
          f"{arch}: decode outside the server disagrees with the replicas")
    if check_model is not None:
        check_model(decoder.model, max_seq)

    n_prof = profile_turn * (prompt_len + gen_len) + prompt_len
    prof_hist = list(hist["s0"])[:n_prof]
    busy = profile_call(lambda: decoder("profile", prof_hist, gen_len))
    prefill_ms = {}
    for n_prompt, pf_s, _ in calls:
        prefill_ms.setdefault(n_prompt, []).append(pf_s * 1e3)
    decode_tok_s = [(gen_len - 1) / dec_s for _, _, dec_s in calls]
    for r in reqs:
        print(f"    {arch} turn {r['turn']} s{r['session']}: smr_latency "
              f"{r['smr_latency_us']:.1f} us (virtual), wall "
              f"{r['wall_ms']:.1f} ms [{card_line}]")
    for n_prompt, v in sorted(prefill_ms.items()):
        print(f"    {arch} prefill of {n_prompt} tokens: median "
              f"{np.median(v):.2f} ms over {len(v)} calls [{card_line}]")
    print(f"    {arch} decode: median {np.median(decode_tok_s):.1f} tokens/s "
          f"(batch 1) [{card_line}]")
    if busy.get("device_ms"):
        print(f"    {arch} one decode_fn call (prefill {n_prof} + "
              f"{gen_len} tokens) under torch.profiler: {busy['kernels']} "
              f"kernels, device busy {busy['device_ms']:.1f} of "
              f"{busy['wall_ms']:.1f} ms wall "
              f"({100 * busy['busy_share']:.1f}%); the most device time by "
              f"operator: "
              + "; ".join(f"{op} x {n}: {ms:.1f} ms"
                          for op, n, ms in busy["top"])
              + f" [{card_line}]")
    else:
        print(f"    {arch} device busy share not measured: {busy}")
    n_params = sum(p.numel() for p in decoder.model.param_leaves())
    print(f"    {arch} peak allocated: {setup_peak / 1e9:.2f} GB at set-up "
          f"({held / 1e9:.2f} GB held after it), {serve_peak / 1e9:.2f} GB "
          f"while serving [{card_line}]")
    print(f"{tag} {arch} {depth} bf16 ({n_params / 1e9:.3f} B params, "
          f"{n_leaves} leaves) served by 3 replicas: {len(reqs)} requests, "
          f"replicas identical, weights {digest:#010x}, launches {launches}, "
          f"set-up {setup_s:.1f} s")
    del server, decoder
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def profile_call(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: the summed device time
    of its kernels against its wall time (the profiler's own host cost
    included, so the share is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    except RuntimeError as e:    # the profiler could not trace the card
        return {"error": str(e)}
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3
    # the device time of the kernels each PyTorch operator launched itself
    by_op = sorted((e for e in prof.key_averages()
                    if e.device_type == DeviceType.CPU
                    and e.self_device_time_total > 0),
                   key=lambda e: -e.self_device_time_total)[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "kernels": sum(e.count for e in dev),
            "top": [(e.key, e.count, e.self_device_time_total / 1e3)
                    for e in by_op]}


def check_forward_only() -> None:
    """The SWA, RG-LRU and mLSTM wrappers refuse CUDA inputs that autograd
    would differentiate, and launch nothing."""
    before = dict(ops.launches)
    x = torch.zeros(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    g = torch.zeros(1, 64, 2, device="cuda", requires_grad=True)
    a = torch.zeros(1, 64, 128, device="cuda", requires_grad=True)
    calls = {"swa": lambda: ops.sliding_window_attention(x, x, x, 16),
             "rglru": lambda: ops.rglru_scan(a, a),
             "mlstm": lambda: ops.mlstm_chunkwise_state(x, x, x, g, g, 64)}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            check("forward only" in str(e), f"{name}: {e}")
        else:
            raise RuntimeError(f"chip_smoke: the {name} wrapper took inputs "
                               f"that require grad")
    check(ops.launches == before, f"a refused call launched: {ops.launches}")


@contextlib.contextmanager
def recorded_digests(out: list):
    """Records every digest ``ops.fingerprint`` returns (the kernel's)."""
    real = ops.fingerprint

    def record(x):
        out.append(real(x))
        return out[-1]

    ops.fingerprint = record
    try:
        yield out
    finally:
        ops.fingerprint = real


def phase_train(card_line: str) -> int:
    """qwen3-8b at full width, ``TRAIN_LAYERS`` layers, trained by three
    replicas through the port's ``ReplicatedTrainer``; returns the
    fingerprint launches of the run."""
    t_phase = time.perf_counter()
    serve.set_deterministic()
    check_forward_only()
    full = get_config("qwen3-8b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS,
                              blocks=default_blocks(TRAIN_LAYERS))
    n_fp = train_replicated(card_line, "[8]", cfg, full.n_layers, TRAIN_BATCH,
                            TRAIN_SEQ)
    check_fp32_grads("[8]", dataclasses.replace(full, n_layers=1,
                                                blocks=default_blocks(1)))
    print(f"[8] phase 8 took {time.perf_counter() - t_phase:.1f} s "
          f"[{card_line}]")
    return n_fp


def train_replicated(card_line: str, tag: str, cfg, full_layers: int,
                     batch_size: int, seq: int) -> int:
    """``cfg`` trained by three replicas through the port's
    ``ReplicatedTrainer``, each with its own model and optimizer state on
    the card from seed 0: 3 honest steps, then one with replica 1
    Byzantine, ``batch_size`` x ``seq`` tokens a step.  Checks identical
    honest fingerprints, the flag, finite losses, that the fingerprint
    kernel ran exactly twice per leaf per replica per step and no other
    kernel ran, and that it equals its plain version on step 0's
    gradients; returns the fingerprint launches of the run."""
    name = cfg.name
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # each replica its own copy: the same seed gives the same weights
    models = [init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda") for _ in range(3)]
    opts = [adamw_init(m.param_leaves(), opt_cfg) for m in models]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in models[0].param_leaves())
    n_leaves = len(list(models[0].param_leaves()))
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch_size, seed=0))
    step_fn = make_train_step(cfg, opt_cfg)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    steps = {}          # (replica, step) -> (device ms, host ms, loss)

    def batch(step: int) -> dict:
        return {k: torch.from_numpy(v).cuda()
                for k, v in pipe.global_batch(step).items()}

    def train_one(idx: int, step: int, data_epoch: int):
        b = batch(step)
        digests = []
        record = recorded_digests(digests) if (idx, step) == (0, 0) \
            else contextlib.nullcontext()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        start.record()
        with record:
            opts[idx], m = step_fn(models[idx], opts[idx], b)
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t1) * 1e3
        loss = float(m["loss"])
        check(math.isfinite(loss), f"{name} train step {step} replica {idx}: "
                                   f"loss {loss}")
        steps[idx, step] = (start.elapsed_time(end), host_ms, loss)
        if digests:      # the kernel against its plain version, leaf by leaf
            plain = [fingerprint_plain(p.grad)
                     for p in models[0].param_leaves()]
            check(digests[:n_leaves] == plain,
                  f"fingerprint kernel != plain on step 0's gradients: "
                  f"{digests[:n_leaves]} vs {plain}")
        return m["grad_fp"], m["param_fp"], {"loss": loss}

    rt = ReplicatedTrainer.build(train_one)
    ops.reset_launches()
    honest = rt.run_steps(3)
    byzantine = rt.run_steps(1, byzantine_replica=1)
    launches = dict(ops.launches)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_steps = len(honest) + len(byzantine)
    for rec in honest:
        check(len(set(rec["fps"].values())) == 1 and rec["flagged"] == [],
              f"{name} honest step {rec['step']}: fingerprints {rec['fps']}, "
              f"flagged {rec['flagged']}")
    flagged = byzantine[-1]["flagged"]
    check("t1" in flagged and "t0" not in flagged,
          f"{name} Byzantine step: flagged {flagged}")
    fps = byzantine[-1]["fps"]
    check(fps[0] == fps[2] != fps[1],
          f"{name} Byzantine step: fingerprints {fps}")
    expect = {k: 0 for k in launches}
    expect["fingerprint"] = 2 * n_leaves * 3 * n_steps
    check(launches == expect, f"{name} train path launched {launches}, "
                              f"expected {expect}")

    busy = profile_call(lambda: step_fn(models[0], opts[0], batch(n_steps)))
    tokens = batch_size * seq
    for s in range(n_steps):
        print(f"    {name} train step {s}: loss "
              + ", ".join(f"t{i} {steps[i, s][2]:.6f}" for i in range(3))
              + "; device ms "
              + ", ".join(f"{steps[i, s][0]:.1f}" for i in range(3))
              + f" [{card_line}]")
    medians = []
    for i in range(3):     # step 0 warms up cuBLAS and the allocator
        dev = float(np.median([steps[i, s][0] for s in range(1, n_steps)]))
        host = float(np.median([steps[i, s][1] for s in range(1, n_steps)]))
        medians.append(dev)
        print(f"    {name} replica t{i}: median step {dev:.1f} ms (CUDA "
              f"events; host {host:.1f} ms) over steps 1-{n_steps - 1}, "
              f"{tokens / dev * 1e3:.0f} tokens/s [{card_line}]")
    if busy.get("device_ms"):
        print(f"    {name} one profiled train step: {busy['kernels']} "
              f"kernels, device busy {busy['device_ms']:.1f} of "
              f"{busy['wall_ms']:.1f} ms wall "
              f"({100 * busy['busy_share']:.1f}%); the most device time "
              f"by operator: "
              + "; ".join(f"{op} x {n}: {ms:.1f} ms"
                          for op, n, ms in busy["top"])
              + f" [{card_line}]")
    else:
        print(f"    {name} device busy share not measured: {busy}")
    parts = time_step_parts(models[0], opts[0], opt_cfg, batch(n_steps + 1))
    print(f"    {name} step parts, median of 3, CUDA events: "
          + ", ".join(f"{part} {ms:.1f} ms" for part, ms in parts.items())
          + f" [{card_line}]")
    print(f"{tag} {name} {cfg.n_layers} of {full_layers} layers bf16, remat "
          f"{cfg.remat} ({n_params / 1e9:.3f} B params, {n_leaves} leaves) "
          f"trained by 3 replicas, {n_steps} steps of {batch_size} x {seq} "
          f"tokens: honest fingerprints identical, Byzantine t1 flagged, "
          f"losses finite, fingerprint kernel == plain on step 0's "
          f"gradients, launches {launches}; median step "
          f"{np.median(medians):.1f} ms, {3 * tokens * n_steps} tokens in "
          f"all, peak {peak_gb:.2f} GB allocated, set-up {setup_s:.1f} s "
          f"[{card_line}]")
    del rt, models, opts
    torch.cuda.empty_cache()
    return launches["fingerprint"]


def time_step_parts(model: Transformer, opt: dict, opt_cfg: AdamWConfig,
                    b: dict) -> dict:
    """The train step's three parts timed apart on one replica: the loss
    and its backward, the AdamW update, the two fingerprint trees."""
    params = list(model.param_leaves())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def fwd_bwd():
        model.zero_grad(set_to_none=True)
        lm_loss(model, b["inputs"], b["targets"]).backward()

    parts = {"forward+backward": fwd_bwd,
             "AdamW": lambda: adamw_update(params, [p.grad for p in params],
                                           opt, opt_cfg),
             "fingerprints": lambda: (fingerprint_tree(p.grad for p in params),
                                      fingerprint_tree(params))}
    out = {}
    for name, fn in parts.items():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = float(np.median(times))
    return out


def check_fp32_grads(tag: str, cfg) -> None:
    """``cfg`` in fp32 at B 1, S 128: the loss and every gradient leaf on
    the card against the same on the CPU, within phase 6's fp32 limit, also
    of each leaf's largest value."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    gpu = init_params(cfg, torch.Generator(device="cuda").manual_seed(2),
                      device="cuda")
    cpu = Transformer(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    b = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=1,
                                 seed=0)).global_batch(0)
    out = {}
    for name, model in (("card", gpu), ("cpu", cpu)):
        dev = model.embed.device
        model.requires_grad_(True)
        loss = lm_loss(model, torch.from_numpy(b["inputs"]).to(dev),
                       torch.from_numpy(b["targets"]).to(dev))
        loss.backward()
        out[name] = [loss.detach()] + [p.grad for p in model.param_leaves()]
    tol = 1e-3                                   # phase 6's fp32 limit
    worst = 0.0
    for i, (g, c) in enumerate(zip(out["card"], out["cpu"])):
        what = "loss" if i == 0 else f"grad {i - 1}"
        c = c.cuda()               # compared on the card: a few GB a leaf
        _close(f"{cfg.name} fp32 {what}", g, c, tol)
        rel = float((g - c).abs().max() / c.abs().max().clamp_min(1e-30))
        check(rel <= tol, f"{cfg.name} fp32 {what}: {rel} of its largest")
        worst = max(worst, rel)
    kinds = "+".join(spec.kind for spec in cfg.layer_list())
    print(f"{tag} {cfg.name} {cfg.n_layers} layers ({kinds}) fp32, remat "
          f"{cfg.remat}, B 1, S 128: loss {float(out['card'][0]):.6f} on the "
          f"card, {float(out['cpu'][0]):.6f} on the CPU; loss and "
          f"{len(out['card']) - 1} gradient leaves within {tol} (largest "
          f"difference {worst:.3g} of its leaf's largest value)")
    del gpu, cpu, out
    torch.cuda.empty_cache()


def first_group(arch: str, reps: int = 1):
    """``arch`` at full width, cut to ``reps`` repetitions of its first
    group's pattern."""
    full = get_config(arch)
    pattern = full.blocks[0][0]
    return dataclasses.replace(full, n_layers=len(pattern) * reps,
                               blocks=((pattern, reps),))


def phase_recurrent_train(card_line: str) -> int:
    """Phase 9: (a) recurrentgemma-2b through the replicated trainer, and
    remat "none" against "full"; (b) xlstm-1.3b through the train launcher
    with checkpoints and a resume; (c) one full-width group of each
    recurrent arch in fp32 on the card against the CPU.  Returns the
    fingerprint launches of (a) and (b)."""
    t_phase = time.perf_counter()
    full = get_config("recurrentgemma-2b")
    cfg = first_group("recurrentgemma-2b")
    n_fp = train_replicated(card_line, "[9a]", cfg, full.n_layers, RG_BATCH,
                            RG_SEQ)
    check_remat_bits(card_line, cfg)
    print(f"[9a] took {time.perf_counter() - t_phase:.1f} s [{card_line}]")
    n_fp += train_resumed(card_line)
    t_c = time.perf_counter()
    for arch in ("recurrentgemma-2b", "xlstm-1.3b"):
        check_fp32_grads("[9c]", first_group(arch))
    print(f"[9c] took {time.perf_counter() - t_c:.1f} s [{card_line}]")
    print(f"[9] phase 9 took {time.perf_counter() - t_phase:.1f} s "
          f"[{card_line}]")
    return n_fp


def check_remat_bits(card_line: str, cfg) -> None:
    """The first step from seed 0, once with remat "none" and once with
    "full": equal loss and digests; the peak memory of each."""
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=RG_SEQ,
                                    global_batch=RG_BATCH, seed=0))
    b = {k: torch.from_numpy(v).cuda() for k, v in pipe.global_batch(0).items()}
    out = {}
    for remat in ("none", "full"):
        c = dataclasses.replace(cfg, remat=remat)
        model = init_params(c, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
        opt = adamw_init(model.param_leaves(), AdamWConfig(lr=TRAIN_LR))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        opt, m = make_train_step(c, AdamWConfig(lr=TRAIN_LR))(model, opt, b)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        out[remat] = (float(m["loss"]), m["grad_fp"], m["param_fp"])
        print(f"    {cfg.name} remat {remat}: step 0 loss {out[remat][0]:.6f}, "
              f"grad_fp {m['grad_fp']:#010x}, param_fp {m['param_fp']:#010x}; "
              f"peak {peak / 1e9:.2f} GB allocated, {(peak - base) / 1e9:.2f} "
              f"GB above the model and optimizer state; {secs * 1e3:.0f} ms "
              f"wall (first step) [{card_line}]")
        del model, opt, m
        torch.cuda.empty_cache()
    check(out["none"] == out["full"], f"remat changed the step: {out}")
    print(f"[9a] {cfg.name} remat none == full: loss, grad_fp and param_fp "
          f"identical")


def train_resumed(card_line: str) -> int:
    """xlstm-1.3b cut to ``XLSTM_GROUPS`` groups through
    ``launch.train.train``: run A takes 4 steps with a checkpoint every 2;
    run B takes 2, is dropped, and resumes from its checkpoint for 2 more.
    Checks that both end in the same bits, that the coordinators agreed
    the same cuts, that a flipped byte fails the load, and the exact
    fingerprint launches; returns those of A and B."""
    t_b = time.perf_counter()
    full = get_config("xlstm-1.3b")
    cfg = first_group("xlstm-1.3b", XLSTM_GROUPS)
    leaves = list(Transformer(cfg, device="meta").param_leaves())
    n_params, n_leaves = sum(p.numel() for p in leaves), len(leaves)
    ckpt_bytes = 10 * n_params       # bf16 weights, mu, nu; fp32 master
    tmp = Path(tempfile.mkdtemp(prefix=".ckpt_", dir=ROOT))
    try:
        free = shutil.disk_usage(tmp).free
        check(free > 3 * ckpt_bytes, f"{free / 1e9:.1f} GB free under {tmp}, "
              f"{3 * ckpt_bytes / 1e9:.1f} GB needed for two checkpoints and "
              f"a margin")
        kw = dict(batch=XLSTM_BATCH, seq=XLSTM_SEQ, lr=TRAIN_LR,
                  ckpt_every=2, device="cuda")
        ops.reset_launches()
        a = train_launcher(cfg, steps=4, ckpt_dir=str(tmp / "a"), **kw)
        launches_a = dict(ops.launches)
        digest_a = file_digest(tmp / "a" / "ckpt_4.pkl")
        shutil.rmtree(tmp / "a")
        ops.reset_launches()
        b1 = train_launcher(cfg, steps=2, ckpt_dir=str(tmp / "b"), **kw)
        gc.collect()                  # the run's models are gone
        torch.cuda.empty_cache()
        b2 = train_launcher(cfg, steps=2, resume=True,
                            ckpt_dir=str(tmp / "b"), **kw)
        launches_b = dict(ops.launches)
        digest_b = file_digest(tmp / "b" / "ckpt_4.pkl")

        fp_a = [s[1] for s in a["saves"]]
        fp_b = [s[1] for s in b1["saves"] + b2["saves"]]
        check(fp_a == fp_b, f"checkpoint digests: A {fp_a}, B {fp_b}")
        check(digest_a == digest_b, "the step-4 checkpoint files differ")
        final_a = a["records"][-1]["fps"]
        final_b = b2["records"][-1]["fps"]
        check(final_a == final_b and len(set(final_a.values())) == 1,
              f"final fingerprints: A {final_a}, B {final_b}")
        check(a["losses"] == b1["losses"] + b2["losses"],
              f"losses: A {a['losses']}, B {b1['losses'] + b2['losses']}")
        check(all(math.isfinite(x) for x in a["losses"]), f"{a['losses']}")
        agreed_a = a["coordinator_checkpoints"]
        agreed_b = b1["coordinator_checkpoints"] + b2["coordinator_checkpoints"]
        check(agreed_a == agreed_b == [(2, fp_a[0]), (4, fp_a[1])],
              f"agreed checkpoints: A {agreed_a}, B {agreed_b}")
        attest = 2 * n_leaves * 3 * 4
        want_a = attest + 2 * n_leaves                      # two saves
        want_b = attest + 2 * n_leaves + 3 * n_leaves       # and 3 loads
        for run, got, want in (("A", launches_a, want_a),
                               ("B", launches_b, want_b)):
            expect = {k: 0 for k in got}
            expect["fingerprint"] = want
            check(got == expect, f"xlstm run {run} launched {got}, expected "
                                 f"{expect}")

        # one byte flipped in the parameters' data (the first fifth of the
        # file: 2 of the 10 bytes a parameter): the load must refuse it
        pkl = tmp / "b" / "ckpt_4.pkl"
        at = pkl.stat().st_size // 10
        with open(pkl, "r+b") as f:
            f.seek(at)
            byte = f.read(1)
            f.seek(at)
            f.write(bytes([byte[0] ^ 0x01]))
        try:
            load_checkpoint(str(tmp / "b"), cfg, device="cuda")
        except ValueError as e:
            check("fingerprint" in str(e), f"corrupt load: {e}")
        else:
            raise RuntimeError("chip_smoke: a corrupted checkpoint loaded")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    saves = a["saves"] + b1["saves"] + b2["saves"]
    for label, run in (("A", a), ("B", b1), ("B resumed", b2)):
        print(f"    xlstm run {label}: losses "
              + ", ".join(f"{x:.6f}" for x in run["losses"])
              + "; saves " + ", ".join(
                  f"step {st} {sec:.2f} s ({nb / sec / 1e9:.2f} GB/s)"
                  for st, _, sec, nb in run["saves"])
              + (("; loads " + ", ".join(f"{sec:.2f} s ({nb / sec / 1e9:.2f} "
                                         f"GB/s)" for sec, nb in run["loads"]))
                 if run["loads"] else "")
              + f" [{card_line}]")
    print(f"[9b] {cfg.name} {cfg.n_layers} of {full.n_layers} layers bf16, "
          f"remat {cfg.remat} ({n_params / 1e9:.3f} B params, {n_leaves} "
          f"leaves, {saves[0][3] / 1e9:.2f} GB a checkpoint), {XLSTM_BATCH} x "
          f"{XLSTM_SEQ} tokens a step through launch.train: 4 steps == 2 + "
          f"resume + 2 (checkpoint digests {[hex(x) for x in fp_a]}, files "
          f"and final fingerprints identical, losses bit for bit), agreed "
          f"cuts equal, a flipped byte refused; launches A {launches_a}, B "
          f"{launches_b}; took {time.perf_counter() - t_b:.1f} s "
          f"[{card_line}]")
    return launches_a["fingerprint"] + launches_b["fingerprint"]


def check_large_leaf(card_line: str, fp_row: dict):
    """``check_model`` of qwen3-moe's path: the fingerprint kernel on the
    largest stacked expert leaf (more than 2^32 words, above any count a
    32-bit index holds) against its plain version, bit for bit, and timed
    there; the timing joins the kernel's ``shapes``."""
    def check_fn(model: Transformer, max_seq: int) -> None:
        leaf = max(model.param_leaves(), key=lambda p: p.numel())
        n = leaf.numel()
        check(n > 2 ** 32, f"largest leaf has only {n} words")
        got, want = ops.fingerprint(leaf), fingerprint_plain(leaf)
        check(got == want, f"fingerprint of {n} words: {got} != {want}")
        t = timed(lambda: fingerprint_cuda(leaf),
                  lambda: fingerprint_plain(leaf), None, iters=10,
                  plain_iters=1)
        fp_work = work.fingerprint_work(n, leaf.element_size())
        n_bytes = fp_work.bytes
        bound_ms, bound_by = fp_work.bound()
        print(f"    fingerprint of qwen3-moe's stacked leaf "
              f"{tuple(leaf.shape)} bf16 ({n / 2 ** 32:.2f} x 2^32 words): "
              f"kernel == plain ({got:#010x}); kernel {t['ms']:.3f} ms "
              f"(device {t['device_ms']:.3f}), plain {t['plain_ms']:.1f} ms, "
              f"bound {bound_ms:.3f} ms ({n_bytes / t['device_ms'] / 1e6:.0f} "
              f"GB/s; {bound_ms / t['device_ms']:.0%} of the bound) "
              f"[{card_line}]")
        fp_row["shapes"].append(dict(
            shape=f"qwen3-moe stacked experts {tuple(leaf.shape)} bf16",
            **t, bound_ms=bound_ms, bound_by=bound_by))
    return check_fn


def check_frontend(card_line: str):
    """``check_model`` of llama4-scout's path (and of each arch of
    ``check_frontends``): a prefill from (1, 384, D) embeddings equal to
    ``embed(tokens)`` gives the logits and caches of the prefill from those
    tokens, bit for bit."""
    def check_fn(model: Transformer, max_seq: int) -> None:
        toks = torch.randint(0, model.cfg.vocab, (1, 384),
                             generator=torch.Generator().manual_seed(4))
        toks = toks.cuda()
        by_tok, caches_tok = prefill(model, toks, max_seq=max_seq)
        emb = embed(model, toks)
        by_emb, caches_emb = prefill(model, emb, max_seq=max_seq)
        same = torch.equal(by_tok, by_emb) and all(
            torch.equal(a[k], b[k])
            for ga, gb in zip(caches_tok, caches_emb)
            for a, b in zip(ga, gb) for k in a)
        check(same, f"{model.cfg.name}: the prefill from embeddings "
                    f"differs from the prefill from tokens")
        print(f"    {model.cfg.name}: prefill from {tuple(emb.shape)} "
              f"{str(emb.dtype)[6:]} embeddings == prefill from the tokens "
              f"(logits and caches bit for bit) [{card_line}]")
    return check_fn


def check_frontends(card_line: str) -> None:
    """The frontend archs that no phase serves, musicgen-large (audio) and
    chameleon-34b (early-fusion VLM), at full width, cut to
    ``FRONTEND_LAYERS`` layers (bf16, random weights from seed 0): their
    prefill from embeddings against their prefill from tokens, as
    llama4-scout's (``check_frontend``)."""
    for arch in ("musicgen-large", "chameleon-34b"):
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=FRONTEND_LAYERS,
                                  blocks=default_blocks(FRONTEND_LAYERS))
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
        check_frontend(card_line)(model, 384 + 8)
        print(f"    {arch}: {FRONTEND_LAYERS} of {full.n_layers} layers at "
              f"full width (frontend {cfg.frontend!r}, "
              f"{sum(p.numel() for p in model.param_leaves()) / 1e9:.3f} B "
              f"params) [{card_line}]")
        del model
        gc.collect()
        torch.cuda.empty_cache()


def phase_moe(card_line: str, fp_row: dict) -> dict:
    """Phase 10: qwen3-moe-235b-a22b and llama4-scout-17b-a16e at full
    width, ``MOE_LAYERS`` layers, served as phase 7's paths; returns the
    launch counts of both paths."""
    t_phase = time.perf_counter()
    launches = {}
    for arch, check_fn in (("qwen3-moe-235b-a22b",
                            check_large_leaf(card_line, fp_row)),
                           ("llama4-scout-17b-a16e",
                            check_frontend(card_line))):
        got = phase_serve(card_line, arch, 2, 3, 384, 8,
                          ("fingerprint", "routed"), 2, layers=MOE_LAYERS,
                          check_model=check_fn, tag="[10]")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
    check_frontends(card_line)
    print(f"[10] phase 10 took {time.perf_counter() - t_phase:.1f} s "
          f"[{card_line}]")
    return launches


# ---------------------------------------------------------------------------
# Phase 11: the multi-device layout on a mesh of one rank
# ---------------------------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _same_tree(a, b) -> bool:
    """Two nests of caches (or lists of tensors) hold the same bits."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    return torch.equal(whole(a), whole(b))


def mesh_train(card_line: str, ctx, ctx_pod, tmp: Path) -> int:
    """Phase 11a: qwen3-8b at full width, ``TRAIN_LAYERS`` layers, phase
    8's traffic.  An unsharded replica saves its initial state and takes
    two steps; the checkpoint is loaded and placed on the (1, 1) mesh by
    ``reshard`` (its digest there equal to the manifest's) by each of three
    replicas of ``ReplicatedTrainer``, which take the same two steps
    through ``make_train_step(cfg, opt_cfg, ctx)``: losses and digests must
    equal the unsharded replica's bit for bit.  Then step 0 again on the
    (1, 1, 1) pod mesh with ``fsdp_gather`` and ``attn_head_shard`` (only
    the second changes the program: K/V repeated to H heads): the loss and
    gradients against the unsharded step 0 within phase 6's bf16 limit.
    Returns the fingerprint launches."""
    full = get_config("qwen3-8b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS,
                              blocks=default_blocks(TRAIN_LAYERS))
    opt_cfg = AdamWConfig(lr=TRAIN_LR)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0))
    batches = [{k: torch.from_numpy(v).cuda()
                for k, v in pipe.global_batch(s).items()} for s in range(2)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def timed_step(step_fn, model, opt, b):
        torch.cuda.synchronize()
        start.record()
        opt, m = step_fn(model, opt, b)
        end.record()
        end.synchronize()
        return opt, (float(m["loss"]), m["grad_fp"], m["param_fp"]), \
            start.elapsed_time(end)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    n_leaves = len(list(model.param_leaves()))
    t0 = time.perf_counter()
    fp0 = save_checkpoint(str(tmp), 0, model)
    save_s = time.perf_counter() - t0
    opt = adamw_init(model.param_leaves(), opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg)
    want, whole_ms = [], []
    for s, b in enumerate(batches):
        opt, rec, ms = timed_step(step_fn, model, opt, b)
        want.append(rec)
        whole_ms.append(ms)
        if s == 0:       # step 0's gradients, for the check with the flags
            grads0 = [p.grad.clone() for p in model.param_leaves()]
    busy = {"unsharded": profile_call(lambda: step_fn(model, opt,
                                                      batches[1]))}
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()

    # three replicas, each loading the checkpoint and placing it on the mesh
    models, opts = [], []
    sharded_fn = make_train_step(cfg, opt_cfg, ctx)
    t0 = time.perf_counter()
    for _ in range(3):
        _, m, _ = load_checkpoint(str(tmp), cfg, device="cuda")
        m = reshard(m, ctx.mesh, param_pspecs(cfg, m, ctx.mesh))
        check(all(isinstance(p, DTensor) for p in m.param_leaves()),
              "reshard left a plain parameter")
        check(fingerprint_tree(m.param_leaves()) == fp0,
              "the resharded checkpoint's digest differs from the manifest's")
        models.append(m)
        opts.append(adamw_init(m.param_leaves(), opt_cfg))
    load_s = time.perf_counter() - t0
    got, mesh_ms = {}, {}

    def train_one(idx: int, step: int, data_epoch: int):
        opts[idx], rec, mesh_ms[idx, step] = timed_step(
            sharded_fn, models[idx], opts[idx], batches[step])
        got[idx, step] = rec
        return rec[1], rec[2], {"loss": rec[0]}

    rt = ReplicatedTrainer.build(train_one)
    records = rt.run_steps(2)
    for rec in records:
        check(len(set(rec["fps"].values())) == 1 and rec["flagged"] == [],
              f"sharded step {rec['step']}: fingerprints {rec['fps']}")
    for (idx, step), rec in sorted(got.items()):
        check(rec == want[step], f"replica t{idx} step {step} on the mesh "
              f"{rec} != unsharded {want[step]}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    busy["mesh"] = profile_call(lambda: sharded_fn(models[0], opts[0],
                                                   batches[1]))
    del rt, models, opts
    gc.collect()
    torch.cuda.empty_cache()

    # step 0 on the pod mesh with both flags: K/V repeated to H heads
    # (fsdp_gather changes nothing: the products gather every weight)
    flagged = dataclasses.replace(cfg, fsdp_gather=True, attn_head_shard=True)
    _, m, _ = load_checkpoint(str(tmp), flagged, device="cuda")
    m = reshard(m, ctx_pod.mesh, param_pspecs(flagged, m, ctx_pod.mesh))
    opt = adamw_init(m.param_leaves(), opt_cfg)
    _, rec, _ = timed_step(make_train_step(flagged, opt_cfg, ctx_pod), m, opt,
                           batches[0])
    tol = 0.1                       # phase 6's bf16 limit (gemma3-1b's)
    loss_err = abs(rec[0] - want[0][0]) / (1 + abs(want[0][0]))
    grad_err = max(float(((whole(p.grad).float() - g.float()).abs()
                          / (1 + g.float().abs())).max())
                   for p, g in zip(m.param_leaves(), grads0))
    check(loss_err <= tol and grad_err <= tol,
          f"flags on: loss {rec[0]} vs {want[0][0]}, gradient error "
          f"{grad_err}")
    launches = dict(ops.launches)
    del m, opt, grads0
    gc.collect()
    torch.cuda.empty_cache()

    # 1 save, 2 steps unsharded and 1 profiled, 3 loads and placements,
    # 3 x 2 steps on the mesh and 1 profiled, 1 load and 1 step with the
    # flags: 2 digests a leaf a step
    expect = {k: 0 for k in launches}
    expect["fingerprint"] = n_leaves * (1 + 2 * 3 + 3 * 2 + 2 * (3 * 2 + 1)
                                        + 1 + 2)
    check(launches == expect, f"mesh train launched {launches}, expected "
                              f"{expect}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"    {cfg.name} on the (1, 1) mesh: step 1 {mesh_ms[0, 1]:.1f} / "
          f"{mesh_ms[1, 1]:.1f} / {mesh_ms[2, 1]:.1f} ms (replicas t0-t2) "
          f"against {whole_ms[1]:.1f} ms unsharded, {tokens / mesh_ms[0, 1] * 1e3:.0f} "
          f"against {tokens / whole_ms[1] * 1e3:.0f} tokens/s (CUDA events, "
          f"AdamW and digests included) [{card_line}]")
    for name, b in busy.items():
        print(f"    {cfg.name} one profiled step, {name}: "
              + (f"{b['kernels']} kernels, device busy {b['device_ms']:.1f} "
                 f"of {b['wall_ms']:.1f} ms wall "
                 f"({100 * b['busy_share']:.1f}%)" if b.get("device_ms")
                 else f"not measured: {b}") + f" [{card_line}]")
    print(f"    {cfg.name} flags on, (1, 1, 1) pod mesh, step 0: loss "
          f"{rec[0]:.6f} against {want[0][0]:.6f} (error {loss_err:.3g}), "
          f"largest gradient error {grad_err:.3g} of 1 + |g| (limit {tol}); "
          f"digests {rec[1]:#010x}/{rec[2]:#010x} against "
          f"{want[0][1]:#010x}/{want[0][2]:#010x} [{card_line}]")
    print(f"[11a] {cfg.name} {cfg.n_layers} of {full.n_layers} layers bf16, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens a step: checkpoint saved in "
          f"{save_s:.1f} s, loaded and resharded by 3 replicas in "
          f"{load_s:.1f} s (digest == manifest {fp0:#010x}); 2 steps on the "
          f"mesh == unsharded bit for bit (losses "
          f"{', '.join(f'{w[0]:.6f}' for w in want)}, digests equal), "
          f"replicas agree; peak {peak_gb:.2f} GB; launches {launches} "
          f"[{card_line}]")
    return launches["fingerprint"]


def mesh_serve(card_line: str, ctx, arch: str, kernels) -> dict:
    """Phase 11b: ``arch`` at full width and depth served greedily on one
    prompt of 384 tokens, 8 new, unsharded and then placed on the mesh
    through ``make_prefill`` and ``make_serve_step`` with the caches laid
    out by ``cache_pspecs``: tokens, logits and launches must be equal."""
    cfg = get_config(arch)
    prompt = torch.randint(0, cfg.vocab, (1, 384),
                           generator=torch.Generator().manual_seed(6)).cuda()
    max_seq = 384 + 8
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    runs = {}
    for name, c in (("unsharded", None), ("mesh", ctx)):
        if c is not None:
            reshard(model, c.mesh, param_pspecs(cfg, model, c.mesh))
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = make_prefill(cfg, c, max_seq=max_seq)(model, prompt)
        if c is not None:
            caches = reshard(caches, c.mesh, cache_pspecs(cfg, caches, c.mesh))
        out = [whole(logits)]
        tok = torch.argmax(out[-1], -1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for i in range(7):
            logits, caches = make_serve_step(cfg, c)(model, caches, tok,
                                                     384 + i)
            out.append(whole(logits))
            tok = torch.argmax(out[-1], -1)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        runs[name] = dict(logits=out, launches=dict(ops.launches),
                          prefill_ms=(t1 - t0) * 1e3, tok_s=7 / (t2 - t1),
                          tokens=[int(x.argmax(-1)[0]) for x in out],
                          busy=profile_call(lambda: make_prefill(
                              cfg, c, max_seq=max_seq)(model, prompt)))
    u, m = runs["unsharded"], runs["mesh"]
    check(m["tokens"] == u["tokens"], f"{arch}: tokens on the mesh "
          f"{m['tokens']} != unsharded {u['tokens']}")
    check(all(torch.equal(a, b) for a, b in zip(m["logits"], u["logits"])),
          f"{arch}: logits on the mesh differ from the unsharded ones")
    check(m["launches"] == u["launches"]
          and all(m["launches"][k] > 0 for k in kernels),
          f"{arch}: launches on the mesh {m['launches']}, unsharded "
          f"{u['launches']}")
    print(f"    {arch} {cfg.n_layers} layers: prefill of 384 "
          f"{m['prefill_ms']:.1f} ms on the mesh against "
          f"{u['prefill_ms']:.1f} ms unsharded; decode "
          f"{m['tok_s']:.1f} against {u['tok_s']:.1f} tokens/s (batch 1, "
          f"host clock); a profiled prefill: "
          + "; ".join(f"{name} {r['busy']['kernels']} kernels, device busy "
                      f"{r['busy']['device_ms']:.1f} of "
                      f"{r['busy']['wall_ms']:.1f} ms"
                      if r["busy"].get("device_ms") else f"{name} not measured"
                      for name, r in runs.items()) + f" [{card_line}]")
    print(f"[11b] {arch} at full width on the (1, 1) mesh, caches by "
          f"cache_pspecs: 8 greedy tokens {m['tokens']} and every logit == "
          f"unsharded; launches {m['launches']} == unsharded [{card_line}]")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return m["launches"]


def mesh_moe(card_line: str, ctx) -> None:
    """Phase 11c: qwen3-moe-235b-a22b at full width, 2 layers, a prefill of
    384 tokens through the expert-parallel branch on the mesh against the
    unsharded prefill: logits and caches bit for bit."""
    full = get_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(full, n_layers=2, blocks=default_blocks(2))
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    toks = torch.randint(0, cfg.vocab, (1, 384),
                         generator=torch.Generator().manual_seed(7)).cuda()
    logits, caches = prefill(model, toks, max_seq=392)
    reshard(model, ctx.mesh, param_pspecs(cfg, model, ctx.mesh))
    before = comm.collectives.get("moe", 0)
    got, got_caches = make_prefill(cfg, ctx, max_seq=392)(model, toks)
    n_moe = comm.collectives.get("moe", 0) - before
    check(n_moe == cfg.n_layers, f"{n_moe} expert-parallel sums for "
                                 f"{cfg.n_layers} MoE layers")
    check(torch.equal(whole(got), logits) and _same_tree(got_caches, caches),
          "qwen3-moe: the expert-parallel prefill differs from the unsharded "
          "one")
    n_params = sum(p.numel() for p in model.param_leaves())
    print(f"[11c] {cfg.name} {cfg.n_layers} of {full.n_layers} layers bf16 "
          f"({n_params / 1e9:.2f} B params): expert-parallel prefill of 384 "
          f"tokens on the (1, 1) mesh == unsharded, logits and caches bit "
          f"for bit ({n_moe} expert sums) [{card_line}]")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def mesh_pipeline(card_line: str) -> None:
    """Phase 11d: ``pipeline_apply`` over a one-rank "stage" mesh equals
    the stage applied in sequence."""
    mesh = make_mesh((1,), ("stage",), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(8)
    d = 4096
    ws = (torch.randn(1, d, d, generator=gen, device="cuda") / d ** 0.5
          ).to(torch.bfloat16)
    x = torch.randn(4, 2, d, generator=gen, device="cuda").to(torch.bfloat16)
    out = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, x, mesh)
    check(torch.equal(out, torch.tanh(x @ ws[0])),
          "the one-stage pipeline differs from the stage")
    print(f"[11d] pipeline_apply over a one-rank stage mesh (4 microbatches "
          f"of 2 x {d} bf16) == the stage in sequence [{card_line}]")


def phase_mesh(card_line: str) -> dict:
    """Phase 11: the multi-device layer on a mesh of one rank through
    NCCL, where every collective is an identity, so every sharded path must
    give the unsharded bits.  Returns the kernel launches of its paths."""
    t_phase = time.perf_counter()
    serve.set_deterministic()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    launches = {name: 0 for name in cuda.SOURCES}
    tmp = Path(tempfile.mkdtemp(prefix=".ckpt_", dir=ROOT))
    try:
        ctx = shard_ctx_for_mesh(make_host_mesh("cuda"))
        ctx_pod = shard_ctx_for_mesh(make_mesh((1, 1, 1),
                                               ("pod", "data", "model"),
                                               "cuda"))
        comm.reset_collectives()
        launches["fingerprint"] += mesh_train(card_line, ctx, ctx_pod, tmp)
        for arch, kernels in (("gemma3-1b", ("swa",)),
                              ("recurrentgemma-2b", ("rglru", "swa"))):
            for name, n in mesh_serve(card_line, ctx, arch, kernels).items():
                launches[name] += n
        mesh_moe(card_line, ctx)
        mesh_pipeline(card_line)
        issued = dict(comm.collectives)
        check(all(issued.get(k, 0) > 0 for k in ("moe", "digest",
                                                 "pipeline_broadcast")),
              f"an explicit collective did not run: {issued}")
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        dist.destroy_process_group()
    print(f"[11] phase 11 took {time.perf_counter() - t_phase:.1f} s; "
          f"explicit collectives by kind {issued}; launches {launches} "
          f"[{card_line}]")
    return launches


# ---------------------------------------------------------------------------
# Phase 12: the card's profile, counted work on the card, the dry-run
# ---------------------------------------------------------------------------
#: the dry-run cells phase 12c runs through the CLI: (arch, shape, mesh,
#: device): one train cell, the sLSTM fit, expert parallelism, and the
#: first and last again on fake CPU tensors, as a CPU-only build traces
#: them
DRYRUN_CELLS = (("qwen3-8b", "train_4k", "single", "cuda"),
                ("xlstm-1.3b", "prefill_32k", "multi", "cuda"),
                ("qwen3-moe-235b-a22b", "decode_32k", "multi", "cuda"),
                ("qwen3-8b", "train_4k", "single", "cpu"),
                ("qwen3-moe-235b-a22b", "decode_32k", "multi", "cpu"))
DRYRUN_TIMEOUT_S = 900
DRYRUN_OUT = ROOT / "artifacts" / "dryrun_torch_chip"
#: qwen3-8b ``train_4k`` on 16 x 16, per device, as ``python -m
#: repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k --mesh single
#: --device cpu`` counts it on torch 2.13.0+cpu (the CPU sweep of
#: PERF.md §6): phase 12c holds this torch's count to it within
#: ``TORCH_GAP`` in FLOPs and collective bytes, and names the operator
#: whose FLOPs differ most
TORCH_2_13_QWEN3_TRAIN = {
    "flops": 267632297115648.0, "collectives": 102477721004.0,
    "flops_by_op": {"mm": 228049878515712.0, "bmm": 39582418599936.0}}
TORCH_GAP = 0.02
#: processes this script started, stopped on the way out
_CHILDREN: list = []


def start_dryruns() -> dict:
    """Phase 12c's cells, each a CLI process started at once on the host's
    CPU (a dry-run does no device work) at a lower priority, so that they
    trace while the card runs the other phases."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    started = {}
    for arch, shape, mesh, device in DRYRUN_CELLS:
        out = DRYRUN_OUT / device
        out.mkdir(parents=True, exist_ok=True)
        log = open(out / f"{arch}__{shape}__{mesh}.log", "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", mesh, "--device", device,
             "--out", str(out)], env=env, cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(10))
        _CHILDREN.append(proc)
        started[arch, shape, mesh, device] = (proc, time.perf_counter())
    return started


def finish_dryruns(card_line: str, started: dict) -> list:
    """Phase 12c: wait for the dry-run cells; each must end ``ok``."""
    from repro_torch.launch.dryrun import MESHES
    rows, records = [], {}
    for (arch, shape, mesh, device), (proc, t0) in started.items():
        left = DRYRUN_TIMEOUT_S - (time.perf_counter() - t0)
        try:
            rc = proc.wait(timeout=max(left, 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = "timeout"
        name = MESHES[mesh == "multi"][0]
        log = DRYRUN_OUT / device / f"{arch}__{shape}__{mesh}.log"
        check(rc == 0, f"dry-run {arch} {shape} {mesh} {device}: exit {rc}; "
                       f"{log.read_text()[-3000:]}")
        rec = json.loads((DRYRUN_OUT / device / f"{arch}__{shape}__{name}"
                          f".json").read_text())
        check(rec["status"] == "ok", f"dry-run {arch} {shape} {mesh}: {rec}")
        if arch == "xlstm-1.3b":
            # the cell is there for the fit: its premise must hold exactly
            check("fit_seq" in rec["corrected"]
                  and not any(rec["fit_check"]["deviation"].values()),
                  f"dry-run {arch} {shape} {mesh}: the fit is not exact: "
                  f"{rec.get('fit_check')}; {rec['reason']}")
        records[arch, shape, mesh, device] = rec
        c, mem = rec["corrected"], rec["memory"]
        row = {"arch": arch, "shape": shape, "mesh": name, "device": device,
               "peak_gb": mem["total_hbm_bytes"] / 1e9,
               "argument_gb": mem["argument_size_in_bytes"] / 1e9,
               "tflops": c["flops"] / 1e12, "bytes_gb": c["bytes"] / 1e9,
               "collective_gb": c["collectives"]["total"] / 1e9,
               "trace_s": rec["trace_s"],
               "wall_s": time.perf_counter() - t0,
               "fit_check": rec.get("fit_check")}
        rows.append(row)
        print(f"[12c] dry-run {arch} {shape} {name} (torch "
              f"{torch.__version__}, fake {device} tensors, rank 0 of "
              f"{512 if mesh == 'multi' else 256}): ok; per device "
              f"{row['peak_gb']:.2f} GB peak ({row['argument_gb']:.2f} GB "
              f"arguments), {row['tflops']:.2f} TFLOPs, "
              f"{row['bytes_gb']:.1f} GB moved, {row['collective_gb']:.3f} GB "
              f"of collectives; traced in {row['trace_s']} s "
              f"({row['wall_s']:.0f} s in all)"
              + (f"; the fit's check at {row['fit_check']['seq']} tokens, "
                 f"deviation {row['fit_check']['deviation']}"
                 if row["fit_check"] else "")
              + f" [{card_line}]")
    want = TORCH_2_13_QWEN3_TRAIN
    for device in ("cuda", "cpu"):
        c = records["qwen3-8b", "train_4k", "single", device]["corrected"]
        gap = {"flops": c["flops"] / want["flops"] - 1,
               "collectives": c["collectives"]["total"]
               / want["collectives"] - 1}
        by_op = {op: c["flops_by_op"].get(op, 0.0) - f
                 for op, f in want["flops_by_op"].items()}
        worst = max(by_op, key=lambda op: abs(by_op[op]))
        print(f"[12c] qwen3-8b train_4k pod16x16 on fake {device} tensors, "
              f"per device: torch {torch.__version__} {c['flops'] / 1e12:.2f} "
              f"TFLOPs, {c['collectives']['total'] / 1e9:.3f} GB of "
              f"collectives; torch 2.13.0+cpu {want['flops'] / 1e12:.2f} "
              f"TFLOPs, {want['collectives'] / 1e9:.3f} GB; gap "
              f"{100 * gap['flops']:+.3f}% / {100 * gap['collectives']:+.3f}% "
              f"(limit {100 * TORCH_GAP:.0f}%); the operator whose FLOPs "
              f"differ most: {worst} ({by_op[worst] / 1e12:+.3f} TFLOPs) "
              f"[{card_line}]")
        check(all(abs(g) <= TORCH_GAP for g in gap.values()),
              f"qwen3-8b train_4k on torch {torch.__version__} is "
              f"{gap} off torch 2.13's count; {worst} differs by "
              f"{by_op[worst]:.4g} FLOPs")
    same = {}
    for (arch, shape, mesh, device), cpu_rec in records.items():
        if device != "cpu":
            continue
        cuda_rec = records[arch, shape, mesh, "cuda"]
        eq = {k: cuda_rec["corrected"][k] == cpu_rec["corrected"][k]
              for k in ("flops", "bytes", "collectives", "kernels")}
        eq["memory"] = cuda_rec["memory"] == cpu_rec["memory"]
        same[f"{arch} {shape} {mesh}"] = eq
        check(all(eq.values()), f"dry-run {arch} {shape} {mesh}: fake CUDA "
                                f"and fake CPU traces differ: {eq}")
        print(f"[12c] {arch} {shape} {mesh} traced on fake cuda and on fake "
              f"cpu tensors: every count equal [{card_line}]")
    return {"cells": rows, "cuda_equals_cpu": same}


def _median_ms(fn, n: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(n):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_profile(card_line: str) -> dict:
    """Phase 12a: the card's bf16 matrix rate and its memory rate, each the
    median of 5 calls timed with CUDA events, held within 30–105% of the
    data sheet and printed beside the serving cost model's constants."""
    from repro_torch.serve import costmodel
    n = 8192
    gen = torch.Generator(device="cuda").manual_seed(12)
    a, b = (torch.randn(n, n, device="cuda", generator=gen,
                        dtype=torch.bfloat16) for _ in range(2))
    for _ in range(3):
        torch.matmul(a, b)
    mm_ms = _median_ms(lambda: torch.matmul(a, b), 5)
    flops_s = 2 * n ** 3 / (mm_ms / 1e3)
    del a, b
    src = torch.empty(2 ** 31, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    for _ in range(2):
        dst.copy_(src)
    copy_ms = _median_ms(lambda: dst.copy_(src), 5)
    bytes_s = 2 * src.numel() / (copy_ms / 1e3)      # read and written
    del src, dst
    torch.cuda.empty_cache()
    print(f"[12a] bf16 matmul {n}^3: {mm_ms:.3f} ms, {flops_s / 1e12:.1f} "
          f"TFLOP/s ({flops_s / BF16_FLOPS:.0%} of the data sheet's "
          f"{BF16_FLOPS / 1e12:.0f}); copy of 2 GiB: {copy_ms:.3f} ms, "
          f"{bytes_s / 1e12:.3f} TB/s read plus written "
          f"({bytes_s / HBM_BYTES_S:.0%} of {HBM_BYTES_S / 1e12:.2f}); "
          f"serve/costmodel.py: PEAK_FLOPS {costmodel.PEAK_FLOPS / 1e12:.1f} "
          f"TFLOP/s, HBM_BW {costmodel.HBM_BW / 1e12:.3f} TB/s "
          f"[{card_line}]")
    check(0.30 <= flops_s / BF16_FLOPS <= 1.05,
          f"matmul rate {flops_s:.3g} FLOP/s outside 30-105% of the sheet")
    check(0.30 <= bytes_s / HBM_BYTES_S <= 1.05,
          f"copy rate {bytes_s:.3g} B/s outside 30-105% of the sheet")
    return {"matmul_ms": mm_ms, "flops_s": flops_s, "copy_ms": copy_ms,
            "bytes_s": bytes_s, "costmodel_peak_flops": costmodel.PEAK_FLOPS,
            "costmodel_hbm_bw": costmodel.HBM_BW}


def _counted(tag: str, card_line: str, run, traced, n_params: float,
             tokens: int, model_flops_per: int, devices=("cuda",)) -> dict:
    """One call counted on the card against the dry-run's count of the same
    call on fake tensors; ``run(counter)`` makes the call (under the
    counter where one is given) and returns its outputs."""
    ops.reset_launches()
    plain_out = run(None)
    torch.cuda.synchronize()
    plain_launches = dict(ops.launches)
    ops.reset_launches()
    counter = costing.Counter()
    counted_out = run(counter)
    torch.cuda.synchronize()
    check(dict(ops.launches) == plain_launches,
          f"{tag}: launches {ops.launches} under the counter, "
          f"{plain_launches} without")
    check(_same_tree(plain_out, counted_out),
          f"{tag}: the counter changed the output's bits")
    for device in devices:
        t = traced(device)
        got = (counter.flops, counter.bytes, counter.kernels)
        want = (t["flops"], t["bytes"], t["kernels"])
        check(got == want, f"{tag}: the card counts {got}, the dry-run on "
                           f"fake {device} tensors {want}")
    device_ms = _median_ms(lambda: run(None), 3)
    flops_ms = counter.flops / BF16_FLOPS * 1e3
    bytes_ms = counter.bytes / HBM_BYTES_S * 1e3
    bound_ms = max(flops_ms, bytes_ms)
    mfu = model_flops_per * n_params * tokens / BF16_FLOPS / (device_ms / 1e3)
    row = {"call": tag, "flops": counter.flops, "bytes": counter.bytes,
           "kernels": dict(counter.kernels), "launches": plain_launches,
           "ms": device_ms, "bound_ms": bound_ms,
           "bound_by": "operations" if flops_ms >= bytes_ms else "bytes",
           "roofline_share": bound_ms / device_ms, "model_flop_share": mfu,
           "peak_live_gb": counter.peak_bytes / 1e9}
    print(f"[12b] {tag}: counted on the card == the dry-run on fake "
          f"{' and '.join(devices)} tensors: {counter.flops / 1e12:.4f} "
          f"TFLOPs, {counter.bytes / 1e9:.3f} GB, kernel calls "
          f"{dict(counter.kernels)}; launches and output bits unchanged "
          f"under the counter; {device_ms:.2f} ms (CUDA events, median of "
          f"3): roofline share {row['roofline_share']:.1%} (bound "
          f"{bound_ms:.3f} ms by {row['bound_by']}), model-FLOP share "
          f"{mfu:.1%} ({model_flops_per}·N·T, N {n_params / 1e9:.3f} B, T "
          f"{tokens}) [{card_line}]")
    return row


def count_prefill(card_line: str, arch: str, S: int, devices) -> dict:
    cfg = get_config(arch)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    rng = np.random.default_rng(12)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(1, S))
                              ).to(device="cuda", dtype=torch.int32)
    step = make_prefill(cfg, None, max_seq=S)

    def run(counter):
        with counter or contextlib.nullcontext():
            return step(model, tokens)

    n_params = sum(p.numel() for p in model.param_leaves())
    row = _counted(f"{arch} prefill of {S} tokens", card_line, run,
                   lambda device: dryrun.trace(
                       cfg, ShapeSpec("p", "prefill", S, 1), None, device),
                   n_params, S, 2, devices)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return row


def count_train_step(card_line: str) -> dict:
    """qwen3-8b as phase 8 (4 of 36 layers, 2 x 1024 tokens, remat
    "full"): two replicas from seed 0, one step each, one under the
    counter; their losses, digests and new parameters must be equal."""
    full = get_config("qwen3-8b")
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS,
                              blocks=default_blocks(TRAIN_LAYERS))
    opt_cfg = AdamWConfig()
    models = [init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                          device="cuda") for _ in range(2)]
    opts = [adamw_init(m.param_leaves(), opt_cfg) for m in models]
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                    global_batch=TRAIN_BATCH, seed=0))
    batch = {k: torch.from_numpy(v).to(device="cuda", dtype=torch.int32)
             for k, v in pipe.global_batch(0).items()}
    step = make_train_step(cfg, opt_cfg)
    calls = iter(range(2))

    def run(counter):
        i = next(calls, 0)
        with counter or contextlib.nullcontext():
            opts[i], m = step(models[i], opts[i], batch)
        return [m["loss"], torch.tensor([m["grad_fp"], m["param_fp"]]),
                *models[i].param_leaves()]

    n_params = sum(p.numel() for p in models[0].param_leaves())
    row = _counted(f"qwen3-8b train step ({TRAIN_LAYERS} of "
                   f"{full.n_layers} layers, {TRAIN_BATCH} x {TRAIN_SEQ} "
                   f"tokens, remat {cfg.remat})", card_line, run,
                   lambda device: dryrun.trace(
                       cfg, ShapeSpec("t", "train", TRAIN_SEQ, TRAIN_BATCH),
                       None, device),
                   n_params, TRAIN_BATCH * TRAIN_SEQ, 6, ("cuda", "cpu"))
    del models, opts
    gc.collect()
    torch.cuda.empty_cache()
    return row


def phase_costing(card_line: str, started: dict) -> dict:
    """Phase 12: the card's profile (12a), whole calls counted on the card
    against the dry-run and timed (12b), the dry-run's CLI on this torch
    (12c, started with the script)."""
    t_phase = time.perf_counter()
    serve.set_deterministic()
    profile = phase_profile(card_line)
    calls = [count_prefill(card_line, "gemma3-1b", 1168, ("cuda", "cpu")),
             count_prefill(card_line, "recurrentgemma-2b", 384, ("cuda",)),
             count_prefill(card_line, "xlstm-1.3b", 300, ("cuda",)),
             count_train_step(card_line)]
    cells = finish_dryruns(card_line, started)
    cells["roofline"] = phase_roofline(card_line)
    print(f"[12] phase 12 took {time.perf_counter() - t_phase:.1f} s "
          f"[{card_line}]")
    return {"profile": profile, "calls": calls, "dryrun": cells}


def phase_roofline(card_line: str) -> list:
    """Phase 12d: ``launch/roofline.py`` over 12c's records (fake CUDA
    tensors): each cell's three terms at the H100's published rates and
    links, every term finite and the step's bound its largest."""
    from repro_torch.launch import roofline
    rows = roofline.run(DRYRUN_OUT / "cuda", DRYRUN_OUT / "roofline")["rows"]
    check(len(rows) == sum(d == "cuda" for *_, d in DRYRUN_CELLS)
          and all(r["status"] == "ok" for r in rows),
          f"roofline rows {rows}")
    for r in rows:
        terms = (r["compute_s"], r["memory_s"], r["collective_s"])
        check(all(math.isfinite(t) and t >= 0 for t in terms)
              and r["bound_s"] == max(terms) > 0,
              f"roofline {r['arch']} {r['shape']}: {r}")
        links = ", ".join(f"{a} {v['link']} {v['bytes_s'] / 1e9:.0f} GB/s"
                          for a, v in r["links"].items())
        print(f"[12d] roofline {r['arch']} {r['shape']} {r['mesh']}, per "
              f"device: compute {r['compute_s']:.4g} s, memory "
              f"{r['memory_s']:.4g} s, collective {r['collective_s']:.4g} s "
              f"({links}); bound {r['bound_s']:.4g} s ({r['dominant']}), "
              f"roofline fraction {r['roofline_fraction']:.4f} at 989 "
              f"TFLOP/s and 3.35 TB/s, {r['attainable_fraction']:.4f} at "
              f"the measured 716.1 / 3.009; fits 80 GB: {r['hbm_fit']} "
              f"[{card_line}]")
    return rows


# ---------------------------------------------------------------------------
# Phase 13: the served model as one app of a faulted shared-substrate
# deployment
# ---------------------------------------------------------------------------
#: the faults, in virtual µs (tests/test_torch_scenario.py's): tok/r2
#: crashes while its decode engine runs the first turns' backlog, with no
#: register operation in flight (a crash swallows the replies to one), and
#: recovers before the next slot is decided; m1, a memory node of pool0,
#: crashes and its pool reconfigures; tok/r1 crashes and is replaced
#: between turns
CRASH_US, RECOVER_US = 600.0, 1400.0
MEM_CRASH_US, RECONFIGURE_US = 1000.0, 1800.0
STOP_US, REPLACE_US = 2800.0, 3000.0
DEPLOY_APPS = ("tok", "kv", "match")


def _pcts(lats) -> tuple:
    """p50 and p99 as ``tests/golden_scenarios.py`` takes them."""
    s = sorted(lats)
    return s[len(s) // 2], s[min(len(s) - 1, int(len(s) * 0.99))]


def session_trace(vocab: int) -> list:
    """Four sessions whose first turns (about 64 prompt tokens) arrive
    together, then three later turns (about 16): seeded draws, 7 requests,
    about 8 tokens decoded each."""
    return llm_session_trace(9, 8_000.0,
                             session_times=[0.0, 60.0, 120.0, 180.0],
                             mean_turns=2.0, think_us=4_000.0,
                             first_prompt_tokens=64, next_prompt_tokens=16,
                             decode_tokens=8, vocab=vocab)


def deployment(decoder, cost_model, trace: list, probe: dict) -> ScenarioSpec:
    """Three apps on one substrate of two pools (f_m = 1): the token server
    over ``decoder``, a closed-loop KV store and an open-loop matching
    engine, under the faults above; ``probe`` receives what tok/r2 holds in
    flight just before it crashes."""
    def slow():
        return ConsensusConfig(t=16, window=16, slow_mode="always",
                               ctb_fast_enabled=False,
                               view_timeout_us=20_000.0)

    # the golden token_server scenario's consensus: a roofline-costed
    # engine needs a progress timer that outlasts its backlog
    tok_cfg = ConsensusConfig(t=16, window=32, slow_mode="always",
                              ctb_fast_enabled=False,
                              view_timeout_us=200_000.0, max_batch=4,
                              pipeline_depth=4, max_request_bytes=4096)

    def faults(substrate):
        victim = substrate.clusters["tok"].replicas[2]
        substrate.sim.at(CRASH_US - 1e-3, lambda: probe.update(
            engine_slot=victim._exec_inflight,
            register_ops=len(victim.regs._pending)))
        return (FaultSchedule()
                .add(CRASH_US, "crash", "tok/r2")
                .add(RECOVER_US, "recover", "tok/r2")
                .add(MEM_CRASH_US, "crash", "m1")
                .add(RECONFIGURE_US, "reconfigure", ("pool0", "m1"))
                .add(STOP_US, "crash", "tok/r1")
                .add(REPLACE_US, "replace_replica", "tok/r1"))

    return ScenarioSpec(
        n_pools=2, f_m=1, seed=5, faults=faults, drain_us=100_000.0,
        apps=[
            AppSpec(name="tok", cfg=tok_cfg,
                    app=lambda: TokenServerApp(decoder, cost_model=cost_model),
                    # one client a request: client j's latency is request j's
                    workload=Workload(kind="trace", trace=trace,
                                      n_clients=len(trace),
                                      timeout_us=10_000_000.0)),
            AppSpec(name="kv", app=KVStoreApp, cfg=slow(),
                    workload=Workload(kind="closed", n_requests=40,
                                      timeout_us=10_000_000.0,
                                      payload_fn=lambda i: set_req(
                                          b"key%d" % (i % 16),
                                          b"value%d" % i))),
            AppSpec(name="match", app=MatchingEngineApp, cfg=slow(),
                    workload=Workload(kind="open", rate_rps=4_000.0,
                                      duration_us=6_000.0, seed=7,
                                      timeout_us=10_000_000.0,
                                      payload_fn=lambda i: order_req(
                                          "buy" if i % 2 == 0 else "sell", i,
                                          100 + (i * 7) % 11 - 5, 10))),
        ])


def run_unreplicated(decoder, cost_model, trace: list) -> list:
    """The same requests at the same virtual times through the
    unreplicated baseline (one server, the same serial engine): [(tokens,
    latency_us)] in trace order."""
    sim, _server, client = build_unreplicated(
        lambda: TokenServerApp(decoder, cost_model=cost_model))
    out = [None] * len(trace)
    for j, (t, payload) in enumerate(trace):
        def done(raw, lat, j=j):
            out[j] = (json.loads(raw.decode())["tokens"], lat)
        sim.at(t, lambda p=payload, cb=done: client.request(p, cb))
    check(sim.run_until(lambda: all(o is not None for o in out),
                        timeout=10_000_000.0),
          "the unreplicated baseline did not answer every request")
    return out


def replies_from_history(trace: list, hist: dict) -> list:
    """Each request's (session, history before its reply, reply tokens)
    read from the agreed session histories: a session's turns are its
    prompts, each followed by its reply."""
    at = {sid: 0 for sid in hist}
    out = []
    for _t, payload in trace:
        msg = json.loads(payload)
        sid, prompt, n = msg["session"], msg["prompt"], msg["n"]
        full = list(hist[sid])
        check(full[at[sid]:at[sid] + len(prompt)] == prompt,
              f"session {sid}: the agreed history does not hold its prompt")
        at[sid] += len(prompt)
        out.append((sid, full[:at[sid]], full[at[sid]:at[sid] + n]))
        at[sid] += n
    check(all(at[sid] == len(h) for sid, h in hist.items()),
          "the agreed histories hold more than the trace's turns")
    return out


def phase_deployment(card_line: str) -> dict:
    """Phase 13: gemma3-1b at full width and depth (bf16, seed 0) as the
    token-server app of a faulted three-app deployment on one substrate
    (``scenario.run_scenario``), then the same requests through the
    unreplicated baseline; returns the launch counts of both paths."""
    t_phase = time.perf_counter()
    arch = "gemma3-1b"
    cfg = get_config(arch)
    trace = session_trace(cfg.vocab)
    # the longest session history the decoder is called on, replays
    # included: all of a session's prompts and replies
    longest: dict = {}
    for _t, payload in trace:
        msg = json.loads(payload)
        longest[msg["session"]] = (longest.get(msg["session"], 0)
                                   + len(msg["prompt"]) + msg["n"])
    max_seq = max(longest.values()) + 8
    n_window = sum(spec.window is not None for spec in cfg.layer_list())
    serve.set_deterministic()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    decoder, digest = serve.build_decoder(cfg, torch.device("cuda"), max_seq)
    cm = ServingCostModel.from_arch(arch)
    probe: dict = {}
    t0 = time.perf_counter()
    res = run_scenario(deployment(decoder, cm, trace, probe))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(ops.launches)
    calls = len(decoder.timings)
    peak = torch.cuda.max_memory_allocated()

    n_leaves = len(list(decoder.model.param_leaves()))
    expect = {"fingerprint": n_leaves, "swa": n_window * calls}
    check({k: n for k, n in launches.items() if n} == expect,
          f"{arch} deployment launched {launches}, expected {expect} "
          f"({calls} model calls)")
    check(not res.budget_overruns, f"budget overruns {res.budget_overruns}")
    for app in DEPLOY_APPS:
        ar = res.apps[app]
        check(ar.completed == ar.issued > 0, f"{app}: {ar.completed} of "
              f"{ar.issued} requests completed")
        snaps = {repr(r.app.snapshot()) for r in res.clusters[app].replicas}
        check(len(snaps) == 1, f"{app}: replica snapshots differ")
    tok = res.clusters["tok"]
    check([r.pid for r in tok.replicas] == ["tok/r0", "tok/r3", "tok/r2"]
          and all(r.membership.epoch == 1 and not r.joining
                  and not r.crashed for r in tok.replicas),
          f"tok replicas {[(r.pid, r.membership.epoch) for r in tok.replicas]}")
    check(probe.get("engine_slot") is not None
          and probe.get("register_ops") == 0,
          f"tok/r2 was not crashed with a busy engine alone: {probe}")
    took = [action for _t, action, _x in res.injector.log]
    n_replaced, n_reconf = took.count("replace_replica"), took.count(
        "reconfigure")
    check(n_replaced >= 1 and n_reconf >= 1,
          f"faults that took effect: {res.injector.log}, skipped "
          f"{res.injector.skipped}")

    # every reply equals the decoder called directly on the same history
    replies = replies_from_history(trace, dict(tok.replicas[0].app.snapshot()))
    check(all(decoder(sid, prior, len(toks)) == toks
              for sid, prior, toks in replies),
          f"{arch}: a reply differs from a direct decode of its history")

    # the unreplicated baseline on the same requests, its launches counted
    ops.reset_launches()
    calls_before = len(decoder.timings)
    t0 = time.perf_counter()
    base = run_unreplicated(decoder, cm, trace)
    torch.cuda.synchronize()
    base_wall_s = time.perf_counter() - t0
    base_calls = len(decoder.timings) - calls_before
    base_launches = dict(ops.launches)
    check({k: n for k, n in base_launches.items() if n}
          == {"swa": n_window * base_calls},
          f"{arch} baseline launched {base_launches} ({base_calls} calls)")
    check([toks for toks, _lat in base] == [r[2] for r in replies],
          f"{arch}: the unreplicated baseline's tokens differ")

    replicated = [c.latencies[0] for c in tok.clients]
    unrepl = [lat for _toks, lat in base]
    diff = [r - u for r, u in zip(replicated, unrepl)]
    for j, ((_t, payload), r, u) in enumerate(zip(trace, replicated, unrepl)):
        msg = json.loads(payload)
        print(f"    [13] request {j} {msg['session']} ({len(msg['prompt'])} "
              f"prompt, {msg['n']} decoded): replicated {r:.3f} us, "
              f"unreplicated {u:.3f} us, consensus {r - u:.3f} us (virtual) "
              f"[{card_line}]")
    for name, lats in (("replicated", replicated), ("unreplicated", unrepl),
                       ("consensus (difference)", diff)):
        p50, p99 = _pcts(lats)
        print(f"    [13] tok {name}: p50 {p50:.3f} us, p99 {p99:.3f} us "
              f"(virtual) [{card_line}]")
    for app in DEPLOY_APPS:
        p50, p99 = _pcts(res.apps[app].latencies)
        print(f"    [13] app {app}: {res.apps[app].completed} requests, p50 "
              f"{p50:.3f} us, p99 {p99:.3f} us (virtual), memory "
              f"{res.apps[app].memory_by_pool} [{card_line}]")
    prompts, prefill_s, decode_s = zip(*decoder.timings)
    steps = [json.loads(payload)["n"] - 1 for _t, payload in trace]
    print(f"    [13] model calls: median prefill "
          f"{np.median(prefill_s) * 1e3:.1f} ms (histories of "
          f"{min(prompts)}–{max(prompts)} tokens), median decode "
          f"{np.median(decode_s) * 1e3:.1f} ms a call ({min(steps)}–"
          f"{max(steps)} steps) [{card_line}]")
    print(f"    [13] wall: deployment {wall_s:.2f} s "
          f"({wall_s * 1e3 / len(trace):.1f} ms a request, {calls} model "
          f"calls), unreplicated {base_wall_s:.2f} s "
          f"({base_wall_s * 1e3 / len(trace):.1f} ms a request, {base_calls} "
          f"model calls); peak allocated {peak / 1e9:.2f} GB [{card_line}]")
    print(f"[13] {arch} full depth bf16 (weights {digest:#010x}) served as "
          f"one of three apps on one substrate: {len(trace)} requests, "
          f"faults {res.injector.log}, replicas identical (recovered tok/r2 "
          f"and joiner tok/r3 included), {n_replaced} replace_replica and "
          f"{n_reconf} reconfigure took effect, tokens == direct decode == "
          f"unreplicated; launches {expect} deployed, "
          f"{ {k: n for k, n in base_launches.items() if n} } unreplicated; "
          f"{res.msgs_sent} messages, {res.bytes_sent} bytes; took "
          f"{time.perf_counter() - t_phase:.1f} s [{card_line}]")
    del res, decoder
    gc.collect()
    torch.cuda.empty_cache()
    return {k: launches.get(k, 0) + base_launches.get(k, 0)
            for k in set(launches) | set(base_launches)}


# ---------------------------------------------------------------------------
# Phase 14: the decode step as graphs against the eager step
# ---------------------------------------------------------------------------
def eager_decode(model: Transformer, hist: list, n: int, max_seq: int):
    """The eager greedy decode (``GreedyDecoder``'s loop without graphs):
    the tokens and the caches it leaves.  ``serve.prefill`` and
    ``serve.decode_step`` are looked up at the call, as the benchmark's
    spans wrap them."""
    toks = torch.tensor([hist], dtype=torch.int64, device="cuda")
    logits, caches = serve.prefill(model, toks, max_seq=max_seq)
    tok = torch.argmax(logits, -1)
    out = [int(tok[0])]
    for i in range(n - 1):
        logits, caches = serve.decode_step(model, caches, tok, len(hist) + i)
        tok = torch.argmax(logits, -1)
        out.append(int(tok[0]))
    return out, caches


def _cache_leaves(caches) -> list:
    return [st[k] for group in caches for st in group for k in sorted(st)]


def check_graphed(tag: str, model: Transformer, calls: list,
                  max_seq: int) -> serve.GreedyDecoder:
    """A fresh decoder's tokens on ``calls`` ((history, n) each) against
    the eager decode's, and after the last call its static caches against
    the eager caches, bit for bit; one capture, every step a replay."""
    decoder = serve.GreedyDecoder(model, max_seq)
    for hist, n in calls:
        want, caches = eager_decode(model, hist, n, max_seq)
        got = decoder("s", hist, n)
        check(got == want, f"{tag}: graphed tokens {got} against eager {want}")
    same = all(torch.equal(a, b) for a, b in zip(
        _cache_leaves(decoder.graphs.caches), _cache_leaves(caches)))
    check(same, f"{tag}: graphed caches differ from the eager ones")
    steps = sum(n - 1 for _, n in calls)
    check(decoder.captures == 1 and decoder.replayed_steps == steps,
          f"{tag}: captures {decoder.captures}, replayed steps "
          f"{decoder.replayed_steps} of {steps}")
    return decoder


def traced_call(fn) -> dict:
    """One call of ``fn`` under the benchmark's tracer (``bench/trace.py``)
    with its spans around ``prefill`` and the routed FFN, as a ``--trace
    1`` run of the serving cell puts them."""
    from bench import trace as bench_trace
    patches = [("repro_torch.launch.serve", "prefill", "bench.prefill"),
               ("repro_torch.models.transformer", "moe_ffn", "bench.moe_ffn")]
    tracer = bench_trace.Tracer(patches, torch.device("cuda"))
    tracer.start()
    fn()
    return tracer.stop()


def phase_graphs(card_line: str) -> None:
    """Phase 14: ``GreedyDecoder``'s decode steps as CUDA graphs cut at the
    routed FFN (``serve.StepGraphs``) against the eager steps.  (a) Every
    arch's smoke config in fp32: three calls, the first past the 16-slot
    window rings.  (b) qwen3-moe-235b-a22b at full width, ``MOE_LAYERS`` layers:
    three requests of 19 prompt tokens and 58 generated (the serving
    cell's), tokens and caches bit for bit; then one call each way under
    the benchmark's tracer: the device busy time a decode step within 10%
    of the eager step's, and the routed FFN's kernels charged to the span
    around ``moe_ffn`` (within 10% of the eager call's); and each way's
    untraced decode rate."""
    t_phase = time.perf_counter()
    serve.set_deterministic()
    for arch in list_archs():
        # fp32: the tensor-core kernels take no head of the smoke widths
        cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda")
        calls = [([5, 6, 7, 8, 9], 25), ([3, 1, 4], 4),
                 ([5, 6, 7, 8, 9, 2, 7], 9)]
        d = check_graphed(f"[14a] {arch}", model, calls, 40)
        print(f"[14a] {arch} smoke fp32: graphed tokens and caches equal the "
              f"eager ones; {len(d.graphs.graphs)} graphs a step, captures "
              f"{d.captures}, replayed steps {d.replayed_steps}")
        del model, d

    full = get_config("qwen3-moe-235b-a22b")
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS,
                              blocks=default_blocks(MOE_LAYERS))
    gc.collect()
    torch.cuda.empty_cache()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda")
    rng = np.random.default_rng(0)
    prompt_len, n, max_seq = 19, 58, 77
    calls = [(rng.integers(0, cfg.vocab, size=prompt_len).tolist(), n)
             for _ in range(3)]
    t0 = time.perf_counter()
    decoder = check_graphed("[14b] qwen3-moe-235b-a22b", model, calls,
                            max_seq)
    print(f"[14b] qwen3-moe-235b-a22b {MOE_LAYERS} of {full.n_layers} "
          f"layers: graphed tokens and caches equal the eager ones over "
          f"{len(calls)} x {n - 1} decode steps; {len(decoder.graphs.graphs)} "
          f"graphs a step, captures {decoder.captures}, replayed steps "
          f"{decoder.replayed_steps} ({time.perf_counter() - t0:.1f} s with "
          f"the eager runs) [{card_line}]")

    hist = calls[0][0]
    seen = {}
    for way, fn in (("eager", lambda: eager_decode(model, hist, n, max_seq)),
                    ("graphed", lambda: decoder("s", hist, n))):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        call_s = (time.perf_counter() - t) / 3
        s = traced_call(fn)
        steps_busy = s["busy_s"] - s["by_span"].get("bench.prefill", 0.0)
        seen[way] = {"call_s": call_s,
                     "step_busy_ms": 1e3 * steps_busy / (n - 1),
                     "moe_ms": 1e3 * s["by_span"].get("bench.moe_ffn", 0.0),
                     "moe_calls": s["span_count"].get("bench.moe_ffn", 0)}
        print(f"[14b] {way}: a call (19 + 58 tokens) {1e3 * call_s:.1f} ms "
              f"untraced ({(n - 1) / call_s:.2f} tokens/s with the prefill); "
              f"traced: device busy {seen[way]['step_busy_ms']:.3f} ms a "
              f"decode step, routed FFN {seen[way]['moe_ms']:.1f} ms in "
              f"{seen[way]['moe_calls']} calls, {s['device_events']} device "
              f"events, {1e3 * s['window_s']:.1f} ms traced [{card_line}]")
    e, g = seen["eager"], seen["graphed"]
    check(g["moe_calls"] == e["moe_calls"] == MOE_LAYERS * n,
          f"[14b] routed-FFN calls traced: {g['moe_calls']} graphed, "
          f"{e['moe_calls']} eager, {MOE_LAYERS * n} expected")
    check(abs(g["step_busy_ms"] / e["step_busy_ms"] - 1) <= 0.10,
          f"[14b] device busy a step {g['step_busy_ms']:.3f} ms graphed "
          f"against {e['step_busy_ms']:.3f} eager: the profiler missed "
          f"the graphs' kernels or they differ")
    check(g["moe_ms"] > 0 and abs(g["moe_ms"] / e["moe_ms"] - 1) <= 0.10,
          f"[14b] routed FFN's device time {g['moe_ms']:.1f} ms graphed "
          f"against {e['moe_ms']:.1f} eager")
    print(f"[14b] graphed against eager: {e['call_s'] / g['call_s']:.2f}x "
          f"a call untraced; captures {decoder.captures}, replayed steps "
          f"{decoder.replayed_steps}")
    del decoder, model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[14] phase 14 took {time.perf_counter() - t_phase:.1f} s "
          f"[{card_line}]")


def file_digest(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run (3, 10, 12, 13, "
                         "14, 15), "
                         "after the build; a partial run prints no result")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.cuda.set_device(0)
    # fp32 comparisons against the plain versions run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = card()
    print(card_line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    try:
        if args.only:
            return run_only(card_line, args.only.split(","))
        return run_all(card_line, t_start)
    finally:
        for proc in _CHILDREN:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_only(card_line: str, phases) -> int:
    """Some phases alone (for a short run); prints no result."""
    if "3" in phases:
        phase_swa()
    if "10" in phases:
        phase_moe(card_line, {"shapes": []})
    if "12" in phases:
        phase_costing(card_line, start_dryruns())
    if "13" in phases:
        phase_deployment(card_line)
    if "14" in phases:
        phase_graphs(card_line)
    if "15" in phases:
        phase_routed()
    return 0


def run_all(card_line: str, t_start: float) -> int:
    started = start_dryruns()
    full = init_params(get_config("gemma3-1b"),
                       torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    fp = phase_fingerprint(full)
    del full
    rows = [phase_swa(), fp, phase_rglru(), phase_mlstm(), phase_routed()]
    phase_layers()
    # the main paths: (arch, sessions, turns, prompt, generated, kernels,
    # turn whose prefill is profiled)
    paths = [("gemma3-1b", 2, 3, 384, 8, ("swa", "fingerprint"), 2),
             ("recurrentgemma-2b", 2, 3, 384, 8,
              ("rglru", "swa", "fingerprint"), 2),
             ("xlstm-1.3b", 1, 3, 300, 8, ("mlstm", "fingerprint"), 0)]
    launches = {row["name"]: 0 for row in rows}
    for arch, sessions, turns, prompt_len, gen_len, kernels, prof in paths:
        got = phase_serve(card_line, arch, sessions, turns, prompt_len,
                          gen_len, kernels, prof)
        for name, n in got.items():
            launches[name] += n
    # the per-arch coverage's card half: the two dense archs that no other
    # phase serves, at full width, cut in depth (gemma3-4b to one
    # repetition of its five window layers and one global layer)
    for arch, kernels, cut in (("gemma3-4b", ("swa", "fingerprint"),
                                {"pattern_reps": 1}),
                               ("chatglm3-6b", ("fingerprint",),
                                {"layers": 4})):
        got = phase_serve(card_line, arch, 1, 2, 256, 8, kernels, 1,
                          tag="[7b]", **cut)
        for name, n in got.items():
            launches[name] += n
    launches["fingerprint"] += phase_train(card_line)
    launches["fingerprint"] += phase_recurrent_train(card_line)
    for name, n in phase_moe(card_line, fp).items():
        launches[name] += n
    for name, n in phase_mesh(card_line).items():
        launches[name] += n
    for name, n in phase_deployment(card_line).items():
        launches[name] += n
    phase_graphs(card_line)
    check(all(n > 0 for n in launches.values()),
          f"a kernel was never launched on the main paths: {launches}")
    costs = phase_costing(card_line, started)
    kernels = [dict({k: row[k] for k in ("name", "route", "source", "replaces")},
                    launches=launches[row["name"]],
                    **{k: row[k] for k in ("max_abs_err", *TIMES, "shapes")
                       if k in row})
               for row in rows]
    print(f"total {time.perf_counter() - t_start:.1f} s [{card_line}]")
    print(card_line)
    print(json.dumps({"phase12": costs}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
