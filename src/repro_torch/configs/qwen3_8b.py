"""Qwen3-8B — dense, GQA kv=8, qk-norm.
[hf:Qwen/Qwen3-8B; hf]

Same configuration as ``repro.configs.qwen3_8b``; ``smoke_config`` is the
reduced same-family config used by the CPU tests.
"""

from repro_torch.models.common import ModelConfig, default_blocks


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense",
        n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=12288, vocab=151936,
        blocks=default_blocks(36),
        qk_norm=True, rope_theta=1_000_000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, blocks=default_blocks(2),
        qk_norm=True, remat="none",
    )
