"""Architecture registry: ``--arch <id>`` -> ModelConfig.

The reference registers twelve architectures; the port has the paper's
char-LM and Gemma2-9B (the serving path). An id the reference knows but
the port lacks raises ``NotImplementedError`` (ROADMAP queue 1 item 11);
an id neither knows raises ``KeyError``.
"""
from __future__ import annotations

import importlib

_MODULES = {"charlm-shakespeare": "charlm_shakespeare",
            "gemma2-9b": "gemma2_9b"}

#: registered in ``repro.configs.registry``, not ported yet
_NOT_PORTED = ("paligemma-3b", "recurrentgemma-2b", "minitron-8b",
               "xlstm-1.3b", "phi3.5-moe-42b-a6.6b", "qwen2-72b",
               "mistral-large-123b", "deepseek-v3-671b", "seamless-m4t-medium")


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP queue 1 item 11); "
            f"the port has {sorted(_MODULES)}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(_MODULES) + sorted(_NOT_PORTED)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_fl_config(arch: str = "charlm-shakespeare"):
    return _module(arch).FL
