"""Llama 4 Scout 17B-active / 16 experts — MoE, early fusion VLM.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Same configuration as ``repro.configs.llama4_scout_17b_a16e``;
``smoke_config`` is the reduced same-family config used by the CPU tests.
"""

from repro_torch.models.common import MoEConfig, ModelConfig, default_blocks


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab=202048,
        blocks=default_blocks(48),
        moe=MoEConfig(n_experts=16, top_k=1, d_expert=8192,
                      capacity_factor=2.0),
        rope_theta=500_000.0, frontend="vlm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=256,
        blocks=default_blocks(2),
        moe=MoEConfig(n_experts=4, top_k=1, d_expert=96, capacity_factor=2.0),
        frontend="vlm", remat="none",
    )
