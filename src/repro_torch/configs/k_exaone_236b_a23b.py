"""K-EXAONE 236B (23B active): 48 layers, attention "LLLG" (a window of 128
in three layers of four, the fourth global and without a position encoding),
post-norm layers, layer 0 a dense SwiGLU and layers 1-47 128 experts of
2,048 (top-8, sigmoid scores with a selection bias, normalised, times 2.5)
beside one shared expert; GQA 64/8 of 128 with qk-norm, an untied head.
[hf:LGAI-EXAONE/K-EXAONE-236B-A23B config.json; the layer equations of
``transformers``' exaone4 (attention, norms) and glm4_moe (router)]

The port's own configuration (the JAX package has none); the multi-token
prediction layer is left out.  ``smoke_config`` is the reduced
same-family config used by the CPU tests: window 8, four experts held of
eight.
"""

from repro_torch.models.common import LayerSpec, MoEConfig, ModelConfig

_L = LayerSpec("attn", window=128)
_G = LayerSpec("attn", rope=False)
_DENSE = LayerSpec("attn", window=128, ffn="dense")


def config() -> ModelConfig:
    # 48 layers = layer 0 (dense FFN) + L L G + 11 x (L L L G)
    return ModelConfig(
        name="k-exaone-236b-a23b", family="moe",
        n_layers=48, d_model=6144, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=18432, vocab=153600,
        blocks=(((_DENSE,), 1), ((_L, _L, _G), 1), ((_L, _L, _L, _G), 11)),
        moe=MoEConfig(n_experts=128, top_k=8, d_expert=2048,
                      capacity_factor=1.25, scoring="sigmoid",
                      routed_scale=2.5, d_shared=2048),
        qk_norm=True, rope_theta=1_000_000.0, norm_eps=1e-5,
        tie_embeddings=False, post_norm=True, max_seq=262_144,
    )


def smoke_config() -> ModelConfig:
    sL = LayerSpec("attn", window=8)
    sG = LayerSpec("attn", rope=False)
    sD = LayerSpec("attn", window=8, ffn="dense")
    return ModelConfig(
        name="k-exaone-smoke", family="moe",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab=256,
        blocks=(((sD,), 1), ((sL, sL, sL, sG), 1)),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=32, scoring="sigmoid",
                      routed_scale=2.5, d_shared=32, held=4),
        qk_norm=True, norm_eps=1e-5, tie_embeddings=False, post_norm=True,
        remat="none",
    )
