"""The window-attention kernel (``csrc/swa.cu``) against its bound: over
the prefill calls of the traced part (``bench.prefill`` spans, each the
request's prompt, as long as the mix's), in each window layer the larger
of its operations (q.k and p.v over the keys each query reads, the
configuration's reference module's ``keys``) over the bf16 peak and its
bytes (q, k and v read once, the output written once, bf16) over the HBM
rate, summed, over the device time of the kernel's launches."""

from bench import arch, work

SPAN = "bench.prefill"
KERNELS = ("swa_kernel", "swa_tc_kernel")


def _bound_s(model, S: int) -> float:
    mod = arch.module(model)
    H, KV, dh = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    io = (2 * H + 2 * KV) * dh * S * work.BF16_BYTES
    total = 0.0
    for l, spec in enumerate(arch.layers(model)):
        if spec.get("window"):
            pairs = sum(mod.keys(model, l, p) for p in range(S))
            total += max(work.attention_flops(model, pairs) / work.BF16_FLOPS,
                         io / work.HBM_BYTES_S)
    return total


def read(run):
    s = run.summary
    if not s:
        return None
    t = sum(v for k, v in s["by_kernel"].items()
            if any(n in k for n in KERNELS))
    n = s["span_count"].get(SPAN, 0)
    if not t or not n:
        return None
    S = run.mix["first_prompt"]["value"]
    return 100.0 * n * _bound_s(run.model, S) / t
