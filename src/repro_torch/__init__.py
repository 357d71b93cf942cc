"""PyTorch/CUDA port of the uBFT-replicated data plane.

The protocol (``core``, ``sim``, ``runtime.server``) is a verbatim copy of
``repro``'s; the models and the kernels are ported to PyTorch, with the
kernels written by hand in CUDA for Hopper (``kernels/csrc``).  Nothing
here imports JAX or the ``repro`` package.
"""
