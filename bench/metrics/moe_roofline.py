"""The routed FFN's single-token calls against their bytes bound, in
every serving cell of a routed model: the bytes those calls need
(``work.moe_decode_bytes``: the top_k experts' three matrices, the
router, the activation) over the HBM rate, over the device time of the
kernels launched inside the calls (the traced part's
``bench.moe_ffn.t1`` spans)."""

from bench import work

SPAN = "bench.moe_ffn.t1"


def read(run):
    s = run.summary
    if not s or not run.model.get("moe"):
        return None
    n, t = s["span_count"].get(SPAN, 0), s["by_span"].get(SPAN, 0.0)
    if not n or not t:
        return None
    need = n * work.moe_decode_bytes(run.model) / work.HBM_BYTES_S
    return 100.0 * need / t
