"""Gemma 3 4B — dense, 5:1 local(sliding-1024):global attention, 128k.
[hf:google/gemma-3-1b-pt; unverified]

Same configuration as ``repro.configs.gemma3_4b``; ``smoke_config`` is the
reduced same-family config used by the CPU tests.
"""

from repro_torch.models.common import LayerSpec, ModelConfig


_L = LayerSpec("attn", window=1024)
_G = LayerSpec("attn")


def config() -> ModelConfig:
    # 34 layers = 5 x (5 local + 1 global) + 4 local
    return ModelConfig(
        name="gemma3-4b", family="dense",
        n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=10240, vocab=262144,
        blocks=(((_L, _L, _L, _L, _L, _G), 5), ((_L,), 4)),
        rope_theta=1_000_000.0, max_seq=131_072,
    )


def smoke_config() -> ModelConfig:
    sL = LayerSpec("attn", window=16)
    sG = LayerSpec("attn")
    return ModelConfig(
        name="gemma3-4b-smoke", family="dense",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=256,
        blocks=(((sL, sL, sG), 1),), remat="none",
    )
