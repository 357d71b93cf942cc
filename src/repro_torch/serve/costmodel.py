"""Roofline serving-cost model: per-token decode / prefill time in µs,
with the H100's measured profile.

The consensus plane charges each decided request a deterministic service
time (``App.cost_us``, the deferred execution engine); this module turns
an architecture into that charge, with the formulas of
``repro.serve.costmodel``.  The decode roofline (one token for each of B
batched streams):

    t_step = max( 2·N_active·B / PEAK_FLOPS,
                  (param_bytes + B·kv_bytes·ctx) / HBM_BW )

Small-batch decode is HBM-bound on reading the weights, so per-token cost
≈ param_bytes / (HBM_BW·B): the batching amortization.  Prefill is charged
as one compute-bound pass over the prompt, amortized across the same
serving batch.

``PEAK_FLOPS`` and ``HBM_BW`` are the card's own, measured by
``chip_smoke.py`` phase 12a on the card named beside them: the median of
five bf16 ``torch.matmul`` calls at 8192³ (FLOP/s achieved) and of five
device copies of 2 GiB (bytes read plus written a second), each timed with
CUDA events.  ``from_arch`` derives the parameter and KV byte counts
analytically from a :class:`repro_torch.models.common.ModelConfig`
(attention stacks with dense or MoE FFNs); ``from_counts`` takes the
counts directly.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 80GB HBM3, 700.00 W power limit: chip_smoke.py phase 12a
# (bf16 matmul at 8192^3: 1.535 ms; 2 GiB copy: 1.428 ms)
PEAK_FLOPS = 716.1e12
HBM_BW = 3.009e12


@dataclass(frozen=True)
class ServingCostModel:
    name: str
    param_bytes: float           # HBM-resident weight bytes
    active_params: float         # params touched per token (MoE: top-k only)
    kv_bytes_per_token: float    # KV-cache bytes appended per token, all layers
    batch: int = 32              # serving batch size B (streams per step)
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW

    # ------------------------------------------------------------ decode
    def decode_step_us(self, ctx: int = 0) -> float:
        """One batched decode step (B tokens), roofline max of compute
        and memory terms, in µs.  ``ctx`` is the per-stream context."""
        t_compute = 2.0 * self.active_params * self.batch / self.peak_flops
        t_memory = (self.param_bytes +
                    self.batch * self.kv_bytes_per_token * ctx) / self.hbm_bw
        return 1e6 * max(t_compute, t_memory)

    def decode_us_per_token(self, ctx: int = 0) -> float:
        """Per-request share of one decode step."""
        return self.decode_step_us(ctx) / self.batch

    # ----------------------------------------------------------- prefill
    def prefill_us(self, n_prompt: int) -> float:
        """One prompt pass (compute-bound at length, memory-bound floor
        of one weight read), amortized across the serving batch."""
        t_compute = 2.0 * self.active_params * n_prompt / self.peak_flops
        t_memory = self.param_bytes / self.hbm_bw
        return 1e6 * max(t_compute, t_memory) / self.batch

    def request_us(self, n_prompt: int, n_decode: int, ctx: int = 0) -> float:
        """Total service time of one request: prefill the prompt, then
        decode ``n_decode`` tokens at context ``ctx + n_prompt``."""
        return (self.prefill_us(n_prompt) +
                n_decode * self.decode_us_per_token(ctx + n_prompt))

    # ------------------------------------------------------ constructors
    @classmethod
    def from_counts(cls, name: str, n_params: float,
                    kv_bytes_per_token: float,
                    n_active: float = 0.0, batch: int = 32,
                    dtype_bytes: int = 2) -> "ServingCostModel":
        return cls(name=name, param_bytes=n_params * dtype_bytes,
                   active_params=n_active or n_params,
                   kv_bytes_per_token=kv_bytes_per_token, batch=batch)

    @classmethod
    def from_arch(cls, arch: str, batch: int = 32,
                  dtype_bytes: int = 2) -> "ServingCostModel":
        """Analytic counts from the architecture registry; attention
        stacks only (a recurrent layer raises)."""
        from repro_torch.configs.registry import get_config
        cfg = get_config(arch)
        D, dh = cfg.d_model, cfg.dh
        H, KV = cfg.n_heads, cfg.n_kv_heads
        n_total = float(cfg.vocab * D)            # embed
        if not cfg.tie_embeddings:
            n_total += cfg.vocab * D              # lm_head
        n_total += D                              # out_norm
        n_moe_inactive = 0.0
        kv_bytes = 0.0
        for spec in cfg.layer_list():
            if spec.kind != "attn":
                raise ValueError(
                    f"{arch}: serving cost model covers attention stacks "
                    f"(got layer kind {spec.kind!r})")
            n_total += D                          # ln1
            n_total += D * H * dh + 2 * D * KV * dh + H * dh * D
            if cfg.qk_norm:
                n_total += 2 * dh
            kv_bytes += 2.0 * KV * dh * dtype_bytes
            if spec.has_ffn:
                n_total += D                      # ln2
                if cfg.moe is not None:
                    m = cfg.moe
                    expert = 3.0 * D * m.d_expert
                    n_total += D * m.n_experts + m.n_experts * expert
                    n_moe_inactive += expert * (m.n_experts - m.top_k)
                else:
                    n_total += 3.0 * D * cfg.d_ff
        return cls(name=arch, param_bytes=n_total * dtype_bytes,
                   active_params=n_total - n_moe_inactive,
                   kv_bytes_per_token=kv_bytes, batch=batch)
