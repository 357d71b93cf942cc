"""Qwen3-MoE 235B (22B active) — 128 experts, top-8, GQA kv=4, qk-norm.
[hf:Qwen/Qwen3-235B-A22B; hf]

Same configuration as ``repro.configs.qwen3_moe_235b_a22b``;
``smoke_config`` is the reduced same-family config used by the CPU tests.
"""

from repro_torch.models.common import MoEConfig, ModelConfig, default_blocks


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-235b-a22b", family="moe",
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
        d_ff=1536, vocab=151936,
        blocks=default_blocks(94),
        moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536,
                      capacity_factor=1.25),
        qk_norm=True, rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=48, vocab=256,
        blocks=default_blocks(2),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=48),
        qk_norm=True, remat="none",
    )
