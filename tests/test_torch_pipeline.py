"""The port's GPipe schedule (``repro_torch.parallel.pipeline``) on 4 gloo
ranks, against the sequential stages and against the JAX package's
``pipeline_apply``, which runs on the same inputs in a subprocess with 4
host devices, as ``tests/test_pipeline.py`` runs it.  Same S, n_micro, mb
and d as that test; the inputs come from numpy."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_ranks import run_ranks

S, N_MICRO, MB, D = 4, 8, 2, 16
TOL = 1e-5

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import sys
    sys.path.insert(0, sys.argv[1])
    import jax, jax.numpy as jnp, numpy as np
    from repro.parallel.pipeline import pipeline_apply

    data = np.load(sys.argv[2])
    mesh = jax.make_mesh((4,), ("stage",))
    out = pipeline_apply(lambda w, h: jnp.tanh(h @ w), jnp.asarray(data["ws"]),
                         jnp.asarray(data["x"]), mesh)
    np.save(sys.argv[3], np.asarray(out))
""")


def _sequential(ws, x, n):
    ref = x
    for i in range(n):
        ref = torch.tanh(ref @ ws[i])
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((S, D, D)) / D ** 0.5).astype(np.float32)
    x = rng.standard_normal((N_MICRO, MB, D)).astype(np.float32)
    np.savez(d / "inputs.npz", ws=ws, x=x)
    torch.save({"ws": torch.from_numpy(ws), "x": torch.from_numpy(x)},
               d / "inputs.pt")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    script = d / "jax_pipeline.py"
    script.write_text(JAX_SCRIPT)
    jax_proc = subprocess.Popen(
        [sys.executable, str(script), src, str(d / "inputs.npz"),
         str(d / "jax_out.npy")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        out, _ = run_ranks("pipeline", 4, d, timeout=300)
        _, err = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]
    return (torch.from_numpy(ws), torch.from_numpy(x), out,
            torch.from_numpy(np.load(d / "jax_out.npy")))


@pytest.mark.parametrize("stages", [4, 2, 1])
def test_pipeline_matches_sequential(stages, runs):
    ws, x, out, _ = runs
    r = out[stages]
    assert r["all_equal"]              # every rank holds the outputs
    assert float((r["out"] - _sequential(ws, x, stages)).abs().max()) < TOL
    # the ring's exchanges, one a tick, and the final broadcast
    sends = N_MICRO + stages - 1 if stages > 1 else 0
    assert r["collectives"].get("pipeline_send", 0) == sends
    assert r["collectives"]["pipeline_broadcast"] == 1


def test_pipeline_matches_jax(runs):
    _, _, out, jax_out = runs
    assert float((out[S]["out"] - jax_out).abs().max()) < TOL
