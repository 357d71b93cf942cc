"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
H100: ``python bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout.  ``BENCHMARK.json`` names the
cells; each configuration, architecture's reference module, traffic mix,
per-layer metric and cell's limits is a file of its own under this
folder, found by name."""
