"""End-to-end replicated training on the PyTorch port.

Trains with the uBFT-replicated coordinator: step ids agreed through
consensus, gradient and parameter fingerprints attested each step (a
corrupted replica is flagged), checkpoints ordered by consensus, then a
restart from the attested checkpoint that keeps training.

    PYTHONPATH=src python examples/torch_train_replicated.py [--device cpu]
        [--steps 40] [--arch qwen3-8b]

Runs on the CUDA device unless ``--device cpu`` is given (it does not fall
back to the CPU), on the arch's smoke config; the checkpoints go to a
temporary directory, removed at the end.
"""

import argparse
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import train as train_mod  # noqa: E402


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    args = ap.parse_args(argv)
    ckpt = tempfile.mkdtemp(prefix="repro_torch_example_ckpt_")
    common = ["--arch", args.arch, "--smoke", "--ckpt-dir", ckpt,
              "--ckpt-every", "10"]
    if args.device:
        common += ["--device", args.device]
    try:
        print("== phase 1: train with a Byzantine replica injected ==")
        first = train_mod.main(common + ["--steps", str(args.steps // 2),
                                         "--byzantine", "2"])
        print("\n== phase 2: simulate a crash; restart from the attested "
              "checkpoint and keep training ==")
        second = train_mod.main(common + ["--steps",
                                          str(args.steps - args.steps // 2),
                                          "--resume"])
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    return [first, second]


if __name__ == "__main__":
    main()
