"""ChatGLM3-6B — dense, GQA kv=2, 2d (half-dim) RoPE.
[arXiv:2406.12793; hf]

Same configuration as ``repro.configs.chatglm3_6b``; ``smoke_config`` is
the reduced same-family config used by the CPU tests.
"""

from repro_torch.models.common import ModelConfig, default_blocks


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b", family="dense",
        n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
        d_ff=13696, vocab=65024,
        blocks=default_blocks(28),
        rope_fraction=0.5,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256, blocks=default_blocks(2),
        rope_fraction=0.5, remat="none",
    )
