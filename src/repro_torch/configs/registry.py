"""Architecture registry: ``--arch <id>`` resolution for the archs the port
supports."""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.common import ModelConfig

ARCHS: Dict[str, str] = {
    "gemma3-1b": "repro_torch.configs.gemma3_1b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
}


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
