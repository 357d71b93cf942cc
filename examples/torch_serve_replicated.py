"""Serve a small model with batched requests behind uBFT, on the PyTorch
port: three replicas of the token server, each request ordered by the
protocol and answered by greedy decoding on the card.

    PYTHONPATH=src python examples/torch_serve_replicated.py [--device cpu]
        [--arch gemma3-1b] [--full]

Runs on the CUDA device unless ``--device cpu`` is given (it does not fall
back to the CPU); the arch's smoke config unless ``--full``.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import serve as serve_mod  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, which must exist)")
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config, not its smoke config")
    args = ap.parse_args(argv)
    cli = ["--arch", args.arch, "--requests", "12", "--batch", "4",
           "--gen", "6"]
    if not args.full:
        cli.append("--smoke")
    if args.device:
        cli += ["--device", args.device]
    return serve_mod.main(cli)


if __name__ == "__main__":
    main()
