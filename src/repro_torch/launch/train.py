"""Training launcher: uBFT-coordinated, checkpoint/restart fault tolerance,
ported from ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b --smoke \\
      --steps 50 --ckpt-dir /tmp/ckpt [--resume] [--byzantine 2] \\
      [--device cpu]

Runs 2f+1 replicated trainers on the in-process harness: every step id and
data range is agreed through uBFT consensus, gradients/params are
fingerprint-attested (a Byzantine replica is flagged), and checkpoint cuts
are consensus-ordered before being written.  ``--resume`` restarts from the
latest attested checkpoint, which each replica loads and verifies on its
own — kill the process mid-run and relaunch to see fault tolerance
end-to-end.  A checkpoint written by the JAX package's launcher resumes
here, and one written here resumes there.  Runs on the GPU unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch.serve import resolve_device, set_deterministic
from repro_torch.models.common import ModelConfig, init_params
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.runtime.steps import make_train_step
from repro_torch.runtime.trainer import ReplicatedTrainer


def train(cfg: ModelConfig, *, steps: int = 50, batch: int = 8, seq: int = 64,
          lr: float = 1e-3, ckpt_dir: str = "/tmp/repro_ckpt",
          ckpt_every: int = 20, resume: bool = False,
          byzantine: Optional[int] = None, device=None) -> Dict:
    """The launcher's run: three replicas, each with its own model and
    AdamW state (fresh from seed 0, or with ``resume`` each loaded from the
    latest attested checkpoint under ``ckpt_dir``), take ``steps`` agreed
    steps; every ``ckpt_every`` steps replica 0's state is saved and the
    cut agreed through the coordinator.  Returns replica 0's losses, the
    step records, the saves as (step, fingerprint, seconds, bytes), the
    loads as (seconds, bytes) and the coordinator's agreed checkpoints."""
    device = resolve_device(device)
    if device.type == "cuda":
        set_deterministic()      # identical replicas must give identical bits
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch))
    opt_cfg = AdamWConfig(lr=lr)

    start_step = latest_step(ckpt_dir) if resume else None
    loads: List = []
    replicas = []
    for _ in range(3):
        if start_step is None:
            gen = torch.Generator(device=device).manual_seed(0)
            model = init_params(cfg, gen, device=device)
            opt = adamw_init(model.param_leaves(), opt_cfg)
        else:
            t0 = time.perf_counter()
            _, model, opt = load_checkpoint(ckpt_dir, cfg, step=start_step,
                                            device=device)
            loads.append((time.perf_counter() - t0, os.path.getsize(
                os.path.join(ckpt_dir, f"ckpt_{start_step}.pkl"))))
        replicas.append({"model": model, "opt": opt})
    if start_step is None:
        start_step = 0
    else:
        print(f"[resume] from attested checkpoint @ step {start_step}")

    step_fn = make_train_step(cfg, opt_cfg=opt_cfg)
    losses: List[float] = []

    def train_one(idx: int, step: int, data_epoch: int):
        b = {k: torch.from_numpy(v).to(device)
             for k, v in pipe.global_batch(start_step + step).items()}
        r = replicas[idx]
        r["opt"], m = step_fn(r["model"], r["opt"], b)
        loss = float(m["loss"])
        if idx == 0:
            losses.append(loss)
        return m["grad_fp"], m["param_fp"], {"loss": loss}

    rt = ReplicatedTrainer.build(train_one)
    saves: List = []
    t0 = time.time()
    done = 0
    while done < steps:
        n = min(ckpt_every, steps - done)
        recs = rt.run_steps(n, byzantine_replica=byzantine)
        done += n
        step = start_step + done
        t1 = time.perf_counter()
        fp = save_checkpoint(ckpt_dir, step, replicas[0]["model"],
                             replicas[0]["opt"])
        saves.append((step, fp, time.perf_counter() - t1, os.path.getsize(
            os.path.join(ckpt_dir, f"ckpt_{step}.pkl"))))
        rt.agree_checkpoint(step, fp)
        flagged = recs[-1]["flagged"]
        print(f"[step {step}] loss={losses[-1]:.4f} "
              f"ckpt_fp={fp} flagged={flagged} "
              f"({(time.time() - t0) / done:.2f}s/step)")
    n_params = sum(p.numel() for p in replicas[0]["model"].param_leaves())
    print(f"params={n_params} "
          f"final_loss={losses[-1]:.4f} "
          f"coordinator_checkpoints={rt.coordinator_state.checkpoints}")
    return {"losses": losses, "records": rt.history, "saves": saves,
            "loads": loads,
            "coordinator_checkpoints": list(rt.coordinator_state.checkpoints)}


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="/tmp/repro_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--byzantine", type=int, default=None,
                    help="index of a replica to corrupt (demo detection)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, resume=args.resume,
                 byzantine=args.byzantine, device=args.device)


if __name__ == "__main__":
    main()
