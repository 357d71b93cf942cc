"""MusicGen-Large — decoder-only over EnCodec tokens (audio frontend stub).
[arXiv:2306.05284; hf]

Same configuration as ``repro.configs.musicgen_large``; ``smoke_config`` is
the reduced same-family config used by the CPU tests.
"""

from repro_torch.models.common import ModelConfig, default_blocks


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
        d_ff=8192, vocab=2048,
        blocks=default_blocks(48),
        frontend="audio",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=256, blocks=default_blocks(2),
        frontend="audio", remat="none",
    )
