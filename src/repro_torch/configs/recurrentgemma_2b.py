"""RecurrentGemma 2B — RG-LRU : local attention at 2:1 (Griffin).
[arXiv:2402.19427; hf]

Same configuration as ``repro.configs.recurrentgemma_2b``; ``smoke_config``
is the reduced same-family config used by the CPU tests.
"""

from repro_torch.models.common import LayerSpec, ModelConfig


_R = LayerSpec("rglru")
_A = LayerSpec("attn", window=2048)


def config() -> ModelConfig:
    # 26 layers = 8 x (rglru, rglru, local-attn) + 2 rglru
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
        d_ff=7680, vocab=256000,
        blocks=(((_R, _R, _A), 8), ((_R, _R), 1)),
        max_seq=1_048_576,
    )


def smoke_config() -> ModelConfig:
    sR = LayerSpec("rglru")
    sA = LayerSpec("attn", window=16)
    return ModelConfig(
        name="recurrentgemma-smoke", family="hybrid",
        n_layers=3, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
        d_ff=96, vocab=256,
        blocks=(((sR, sR, sA), 1),), remat="none",
    )
