"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The reference's architectures, all ported: the paper's char-LM and the
model zoo (Gemma2, Qwen2, Mistral-Large, Minitron, PaliGemma,
Phi-3.5-MoE, DeepSeek-V3, RecurrentGemma, xLSTM, SeamlessM4T); an
unknown id raises ``KeyError``.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "paligemma-3b": "paligemma_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "minitron-8b": "minitron_8b",
    "gemma2-9b": "gemma2_9b",
    "xlstm-1.3b": "xlstm_1_3b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "qwen2-72b": "qwen2_72b",
    "mistral-large-123b": "mistral_large_123b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "charlm-shakespeare": "charlm_shakespeare",
}

#: the model zoo's architectures (the char-LM aside), in the reference's
#: order
ARCH_IDS = [a for a in _MODULES if a != "charlm-shakespeare"]


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE


def get_fl_config(arch: str = "charlm-shakespeare"):
    return _module(arch).FL
