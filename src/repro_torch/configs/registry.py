"""Architecture registry: ``--arch <id>`` resolution: the ten archs of
``repro.configs.registry`` and the port's own (``PORT_ONLY``), which the
JAX package does not have."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig

ARCHS: Dict[str, str] = {
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "qwen3-moe-235b-a22b": "repro_torch.configs.qwen3_moe_235b_a22b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "musicgen-large": "repro_torch.configs.musicgen_large",
    "chameleon-34b": "repro_torch.configs.chameleon_34b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "k-exaone-236b-a23b": "repro_torch.configs.k_exaone_236b_a23b",
}

#: archs of the port alone: no JAX counterpart to hold them against
PORT_ONLY = {"k-exaone-236b-a23b"}

#: archs with a sub-quadratic (or state-based) path for long_500k decode
LONG_CONTEXT_OK = {"gemma3-4b", "gemma3-1b", "xlstm-1.3b", "recurrentgemma-2b"}


def list_archs() -> List[str]:
    return sorted(ARCHS)


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(ARCHS[arch])
    cfg = mod.config()
    cfg.validate()
    return cfg


def get_smoke_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(ARCHS[arch])
    cfg = mod.smoke_config()
    cfg.validate()
    return cfg
