"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The reference registers twelve architectures; the port has the paper's
char-LM, Gemma2-9B and the attention-based zoo (Qwen2, Mistral-Large,
Minitron, PaliGemma, Phi-3.5-MoE, DeepSeek-V3). An id the reference
knows but the port lacks (the recurrent and encoder-decoder families)
raises ``NotImplementedError`` (ROADMAP queue 1 item 11b); an id neither
knows raises ``KeyError``.
"""
from __future__ import annotations

import importlib

_MODULES = {
    "paligemma-3b": "paligemma_3b",
    "minitron-8b": "minitron_8b",
    "gemma2-9b": "gemma2_9b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "qwen2-72b": "qwen2_72b",
    "mistral-large-123b": "mistral_large_123b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "charlm-shakespeare": "charlm_shakespeare",
}

#: registered in ``repro.configs.registry``, not ported yet
_NOT_PORTED = ("recurrentgemma-2b", "xlstm-1.3b", "seamless-m4t-medium")

#: the ported architectures (the char-LM aside), in the reference's order
ARCH_IDS = [a for a in _MODULES if a != "charlm-shakespeare"]


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP queue 1 item 11b); "
            f"the port has {sorted(_MODULES)}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(_MODULES) + sorted(_NOT_PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE


def get_fl_config(arch: str = "charlm-shakespeare"):
    return _module(arch).FL
