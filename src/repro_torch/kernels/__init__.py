"""Hand-written CUDA kernels for Hopper, ported from the TPU kernels of
``repro.kernels``:

  swa          — sliding-window attention (gemma3's and recurrentgemma's
                 local layers)
  fingerprint  — hash-reduce state attestation (the paper's §6.1 checksum)
  rglru        — RG-LRU gated linear recurrence (recurrentgemma)
  mlstm        — chunkwise mLSTM with its final state (xLSTM)

and one kernel new to the port, which replaces no TPU kernel:

  routed       — an MoE FFN's routed, held experts for a few tokens

Each kernel ships ``csrc/<name>.cu`` (built by ``cuda.py`` at first use),
a launcher and its plain PyTorch version in ``<name>.py``, and a wrapper in
``ops.py`` that launches the kernel for a CUDA tensor and runs the plain
version for a CPU tensor.  ``ref.py`` holds the oracles of the JAX package.
"""
