"""Gemma 3 1B — dense, 5:1 local(sliding-512):global attention.
[hf:google/gemma-3-1b-pt; unverified]

Same configuration as ``repro.configs.gemma3_1b``; ``smoke_config`` is the
reduced same-family config used by the CPU tests.
"""

from repro_torch.models.common import LayerSpec, ModelConfig


_L = LayerSpec("attn", window=512)
_G = LayerSpec("attn")


def config() -> ModelConfig:
    # 26 layers = 4 x (5 local + 1 global) + 2 local
    return ModelConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
        d_ff=6912, vocab=262144,
        blocks=(((_L, _L, _L, _L, _L, _G), 4), ((_L,), 2)),
        rope_theta=1_000_000.0, max_seq=131_072,
    )


def smoke_config() -> ModelConfig:
    sL = LayerSpec("attn", window=16)
    sG = LayerSpec("attn")
    return ModelConfig(
        name="gemma3-1b-smoke", family="dense",
        n_layers=3, d_model=48, n_heads=2, n_kv_heads=1, head_dim=24,
        d_ff=96, vocab=256,
        blocks=(((sL, sL, sG), 1),), remat="none",
    )
