"""xLSTM 1.3B — sLSTM + mLSTM blocks (attention-free SSM-class).
[arXiv:2405.04517; unverified]

Same configuration as ``repro.configs.xlstm_1_3b``; ``smoke_config`` is the
reduced same-family config used by the CPU tests.
"""

from repro_torch.models.common import LayerSpec, ModelConfig


_M = LayerSpec("mlstm", has_ffn=False)
_S = LayerSpec("slstm", has_ffn=False)


def config() -> ModelConfig:
    # 48 blocks, mLSTM:sLSTM = 3:1 (paper's 1.3B mixes both)
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4, head_dim=512,
        d_ff=0, vocab=50304,
        blocks=(((_M, _M, _M, _S), 12),),
        max_seq=1_048_576,
    )


def smoke_config() -> ModelConfig:
    sM = LayerSpec("mlstm", has_ffn=False)
    sS = LayerSpec("slstm", has_ffn=False)
    return ModelConfig(
        name="xlstm-smoke", family="ssm",
        n_layers=4, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
        d_ff=0, vocab=256,
        blocks=(((sM, sM, sM, sS), 1),), remat="none",
    )
