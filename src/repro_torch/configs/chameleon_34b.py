"""Chameleon-34B — early-fusion VLM over VQ image tokens (frontend stub).
[arXiv:2405.09818; unverified]

Same configuration as ``repro.configs.chameleon_34b``; ``smoke_config`` is
the reduced same-family config used by the CPU tests.
"""

from repro_torch.models.common import ModelConfig, default_blocks


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22016, vocab=65536,
        blocks=default_blocks(48),
        qk_norm=True,     # Chameleon uses qk-norm for training stability
        frontend="vlm",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=160, vocab=256, blocks=default_blocks(2),
        qk_norm=True, frontend="vlm", remat="none",
    )
