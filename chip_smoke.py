#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

  python3 chip_smoke.py

1. prints the card and builds the CUDA kernels of ``src/repro_torch`` with
   ``nvcc`` (one process per source, all at once);
2. holds the fingerprint kernel against its plain version, bit for bit;
3. holds the sliding-window-attention kernel against its plain version at
   gemma3-1b's shapes, and times it beside the plain version and
   ``F.scaled_dot_product_attention`` with a banded mask;
4. checks full-width gemma3-1b layers (one 5:1 group, fp32) on the card
   against the same layers on the CPU;
5. serves full-width gemma3-1b (26 layers, bf16, random weights from seed 0)
   through the 3-replica uBFT token server, and checks that this path
   launched every kernel and that the replicas agree.

Any failure raises.  The line before the last is a JSON object of
per-kernel numbers; the last line is ``{"ok": true, "device": ...}``.
Without a GPU, or without the repository's ``src/`` beside it, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# cuBLAS is deterministic only with a fixed workspace configuration, read
# when the first handle is made
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

try:
    from repro_torch.configs import get_config  # noqa: E402
    from repro_torch.core import crypto  # noqa: E402
    from repro_torch.kernels import cuda, ops  # noqa: E402
    from repro_torch.kernels.fingerprint import (fingerprint_cuda,  # noqa: E402
                                                 fingerprint_plain)
    from repro_torch.kernels.swa import swa_plain  # noqa: E402
    from repro_torch.launch import serve  # noqa: E402
    from repro_torch.models.common import Transformer, init_params  # noqa: E402
    from repro_torch.models.transformer import prefill  # noqa: E402
    from repro_torch.runtime.attest import fingerprint_tree  # noqa: E402
except ImportError as e:
    sys.exit(f"chip_smoke: the port is not importable from {ROOT / 'src'}: {e}")

# H100 SXM data sheet (dense): HBM rate, bf16 tensor-core rate, and the
# CUDA cores' fp32 rate, used here for fp32 and integer word operations
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
CORE_OPS = 67e12
SWA_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> None:
    t0 = time.perf_counter()
    cuda.build()
    secs = time.perf_counter() - t0
    for name, log in cuda.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
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
    ms = cuda_ms(lambda: fingerprint_cuda(emb), iters=20)
    plain_ms = cuda_ms(lambda: fingerprint_plain(emb), iters=3, warmup=1)
    n_bytes = emb.numel() * emb.element_size() + 4
    bytes_ms = n_bytes / HBM_BYTES_S * 1e3
    ops_ms = 4 * emb.numel() / CORE_OPS * 1e3    # mul, shift, xor, add a word
    print(f"[2] fingerprint: {n_checked} digests bit-exact; gemma3-1b tree "
          f"{tree_gpu:#010x} on card == CPU ({len(leaves)} leaves, "
          f"{tree_gpu_s * 1e3:.2f} ms); attest_batch cuda == numpy")
    print(f"    embed table {tuple(emb.shape)} bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms, bound {max(bytes_ms, ops_ms):.4f} ms "
          f"({n_bytes / ms / 1e6:.0f} GB/s)")
    return {"name": "fingerprint", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fingerprint.cu",
            "replaces": "src/repro/kernels/fingerprint.py:25",
            "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None}


def swa_bound_ms(S: int, H: int, KV: int, dh: int, w: int, elem: int,
                 flops_per_s: float):
    pairs = sum(min(p + 1, w) for p in range(S))     # (query, key) in band
    flops = 4 * dh * pairs * H                       # QK^T and P.V
    n_bytes = elem * dh * S * (2 * H + 2 * KV)       # q, out; k, v
    bytes_ms = n_bytes / HBM_BYTES_S * 1e3
    ops_ms = flops / flops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def phase_swa() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)
    w, H, dh = 512, 4, 256
    worst = 0.0
    cases = [(S, 1, False) for S in (300, 512, 1168, 2048)]
    cases += [(1168, 2, False), (1168, 1, True)]
    for dtype in (torch.bfloat16, torch.float32):
        tol = SWA_TOL[dtype]
        for S, KV, strided in cases:
            q = torch.randn(1, S, H, dh, device="cuda", generator=gen).to(dtype)
            if strided:     # k and v as views into one packed tensor
                kv = torch.randn(1, S, 2 * KV, dh, device="cuda",
                                 generator=gen).to(dtype)
                k, v = kv[:, :, :KV], kv[:, :, KV:]
            else:
                k, v = (torch.randn(1, S, KV, dh, device="cuda",
                                    generator=gen).to(dtype) for _ in range(2))
            got = ops.sliding_window_attention(q, k, v, w)
            want = swa_plain(q, k, v, w)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            bad = err > tol + tol * want.float().abs()
            check(not bool(bad.any()), f"swa {dtype} S={S} KV={KV} "
                  f"strided={strided}: max err {float(err.max())}")
            worst = max(worst, float(err.max()))
            print(f"    swa {str(dtype)[6:]} S={S} KV={KV}"
                  f"{' strided' if strided else ''}: max abs err "
                  f"{float(err.max()):.3g} (tol {tol})")

    # time at the main path's longest prefill: S = 3 * (384 + 8) - 8 = 1168
    S, KV = 1168, 1
    q = torch.randn(1, S, H, dh, device="cuda", generator=gen,
                    dtype=torch.bfloat16)
    k, v = (torch.randn(1, S, KV, dh, device="cuda", generator=gen,
                        dtype=torch.bfloat16) for _ in range(2))
    ms = cuda_ms(lambda: ops.sliding_window_attention(q, k, v, w), iters=20)
    plain_ms = cuda_ms(lambda: swa_plain(q, k, v, w), iters=10)
    pos = torch.arange(S, device="cuda")
    delta = pos[:, None] - pos[None, :]
    band = (delta >= 0) & (delta < w)
    qt = q.transpose(1, 2)
    kt, vt = (x.transpose(1, 2).repeat_interleave(H // KV, dim=1)
              for x in (k, v))
    sdpa = F.scaled_dot_product_attention     # timed only; the port never calls it
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vt, attn_mask=band), iters=20)
    lib_err = float((sdpa(qt, kt, vt, attn_mask=band).transpose(1, 2).float()
                     - ops.sliding_window_attention(q, k, v, w).float()
                     ).abs().max())
    bound_ms, bound_by = swa_bound_ms(S, H, KV, dh, w, 2, BF16_FLOPS)
    print(f"[3] swa: kernel == plain at every shape; at S={S} bf16 kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa+banded mask "
          f"{library_ms:.4f} ms (max diff to kernel {lib_err:.3g}), bound "
          f"{bound_ms:.4f} ms ({bound_by})")
    return {"name": "swa", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/swa.cu",
            "replaces": "src/repro/kernels/swa.py:27", "max_abs_err": worst,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def phase_layers() -> None:
    """One 5:1 group at full width in fp32: the kernel path on the card
    against the plain path on the CPU, through the ring-buffer roll."""
    full = get_config("gemma3-1b")
    cfg = dataclasses.replace(full, n_layers=6, blocks=((full.blocks[0][0], 1),),
                              dtype="float32")
    gpu = init_params(cfg, torch.Generator(device="cuda").manual_seed(2),
                      device="cuda")
    cpu = Transformer(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    S, max_seq = 1168, 1176
    toks = torch.randint(0, cfg.vocab, (1, S),
                         generator=torch.Generator().manual_seed(3))
    before = ops.launches["swa"]
    logits_g, caches_g = prefill(gpu, toks.cuda(), max_seq=max_seq)
    torch.cuda.synchronize()
    swa_launches = ops.launches["swa"] - before
    check(swa_launches == 5, f"5 window layers launched swa {swa_launches}x")
    logits_c, caches_c = prefill(cpu, toks, max_seq=max_seq)
    tol = 1e-3    # fp32 sums in another order over 6 layers of width 1152
    err = {}
    pairs = [("logits", logits_g, logits_c)] + [
        (f"cache[{i}].{k}", cg[k], cc[k])
        for i, (cg, cc) in enumerate(zip(caches_g[0], caches_c[0]))
        for k in ("k", "v", "pos")]
    for name, g, c in pairs:
        g, c = g.cpu().float(), c.float()
        check(g.shape == c.shape and bool(torch.isfinite(g).all()),
              f"{name}: shape or non-finite values")
        check(torch.allclose(g, c, rtol=tol, atol=tol),
              f"{name}: max abs err {float((g - c).abs().max())}")
        err[name] = float((g - c).abs().max())
    print(f"[4] gemma3-1b 6 layers fp32, S={S}: card == CPU within {tol} "
          f"(logits max abs err {err['logits']:.3g}; worst cache "
          f"{max(v for k, v in err.items() if k != 'logits'):.3g})")


def phase_serve(card_line: str) -> dict:
    """Returns the kernel launch counts of the main path."""
    cfg = get_config("gemma3-1b")
    sessions, turns, prompt_len, gen_len = 2, 3, 384, 8
    max_seq = turns * (prompt_len + gen_len) + 8
    serve.set_deterministic()
    rng = np.random.default_rng(0)
    prompts = [[rng.integers(0, cfg.vocab, size=prompt_len).tolist()
                for _ in range(sessions)] for _ in range(turns)]

    ops.reset_launches()
    t0 = time.perf_counter()
    server, decoder, digest = serve.build_server(cfg, torch.device("cuda"),
                                                 max_seq)
    setup_s = time.perf_counter() - t0
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
                  f"turn {t} session {s}: bad tokens {toks}")
            reqs.append({"turn": t, "session": s, "tokens": toks,
                         "smr_latency_us": lat, "wall_ms": wall * 1e3})
    launches = dict(ops.launches)
    torch.cuda.synchronize()
    calls = list(decoder.timings)

    check(all(n > 0 for n in launches.values()),
          f"the main path skipped a kernel: {launches}")
    snaps = [r.app.snapshot() for r in server.cluster.replicas]
    check(snaps[0] == snaps[1] == snaps[2], "replica snapshots differ")
    hist = dict(snaps[0])
    check(all(len(h) == turns * (prompt_len + gen_len) for h in hist.values()),
          "session histories have the wrong length")
    # the same greedy decode outside the replicas gives the same tokens
    check(decoder("s0", prompts[0][0], gen_len) == reqs[0]["tokens"],
          "decode outside the server disagrees with the replicas")

    busy = profile_decode(decoder, list(hist["s0"])[:2 * (prompt_len + gen_len)
                                                    + prompt_len], gen_len)
    prefill_ms = {}
    for n_prompt, pf_s, _ in calls:
        prefill_ms.setdefault(n_prompt, []).append(pf_s * 1e3)
    decode_tok_s = [(gen_len - 1) / dec_s for _, _, dec_s in calls]
    for r in reqs:
        print(f"    turn {r['turn']} s{r['session']}: smr_latency "
              f"{r['smr_latency_us']:.1f} us (virtual), wall "
              f"{r['wall_ms']:.1f} ms [{card_line}]")
    for n_prompt, v in sorted(prefill_ms.items()):
        print(f"    prefill of {n_prompt} tokens: median {np.median(v):.2f} ms "
              f"over {len(v)} calls [{card_line}]")
    print(f"    decode: median {np.median(decode_tok_s):.1f} tokens/s "
          f"(batch 1) [{card_line}]")
    if busy.get("device_ms"):
        print(f"    one decode_fn call (prefill {busy['prompt']} + {gen_len} "
              f"tokens) under torch.profiler: {busy['kernels']} kernels, device "
              f"busy {busy['device_ms']:.1f} of {busy['wall_ms']:.1f} ms wall "
              f"({100 * busy['busy_share']:.1f}%) [{card_line}]")
    else:
        print(f"    device busy share not measured: {busy}")
    print(f"[5] gemma3-1b 26 layers bf16 served by 3 replicas: {len(reqs)} "
          f"requests, replicas identical, weights {digest:#010x}, launches "
          f"{launches}, set-up {setup_s:.1f} s")
    return launches


def profile_decode(decoder, hist, n: int) -> dict:
    """One ``decode_fn`` call under ``torch.profiler``: the summed device
    time of its kernels against its wall time (the profiler's own host cost
    included, so the share is a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            decoder("profile", hist, n)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        dev = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    except RuntimeError as e:    # the profiler could not trace the card
        return {"error": str(e)}
    device_ms = sum(e.self_device_time_total for e in dev) / 1e3
    return {"prompt": len(hist), "wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms,
            "kernels": sum(e.count for e in dev)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    # fp32 comparisons against the plain versions run in full fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = card()
    print(card_line)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    full = init_params(get_config("gemma3-1b"),
                       torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    fp = phase_fingerprint(full)
    del full
    swa = phase_swa()
    phase_layers()
    launches = phase_serve(card_line)
    kernels = [dict({k: row[k] for k in ("name", "route", "source", "replaces")},
                    launches=launches[row["name"]],
                    **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms")})
               for row in (swa, fp)]
    print(card_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
