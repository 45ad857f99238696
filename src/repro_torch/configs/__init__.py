"""Architecture configurations the port serves (``config()`` is the
published configuration, ``smoke_config()`` a reduced one for CPU tests):
the dense, MoE, SSM (mamba2), hybrid (zamba2), audio (musicgen) and vlm
(paligemma) families.

The registry mirrors ``repro.configs``: :func:`get_config` and
:func:`get_smoke_config` take the JAX registry's ten names, in its
order."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (dbrx_132b, deepseek_moe_16b, gemma3_4b, gemma3_27b,
               mamba2_2p7b, musicgen_large, paligemma_3b, qwen1p5_4b,
               yi_9b, zamba2_1p2b)

__all__ = ["dbrx_132b", "deepseek_moe_16b", "gemma3_4b", "gemma3_27b",
           "mamba2_2p7b", "musicgen_large", "paligemma_3b", "qwen1p5_4b",
           "yi_9b", "zamba2_1p2b", "ARCH_NAMES", "get_config",
           "get_smoke_config"]

_MODULES = {
    "zamba2-1.2b": zamba2_1p2b,
    "mamba2-2.7b": mamba2_2p7b,
    "gemma3-27b": gemma3_27b,
    "qwen1.5-4b": qwen1p5_4b,
    "gemma3-4b": gemma3_4b,
    "yi-9b": yi_9b,
    "dbrx-132b": dbrx_132b,
    "deepseek-moe-16b": deepseek_moe_16b,
    "musicgen-large": musicgen_large,
    "paligemma-3b": paligemma_3b,
}

ARCH_NAMES = list(_MODULES)


def _module(name: str):
    if name in _MODULES:
        return _MODULES[name]
    raise KeyError(f"unknown config {name!r}; known: {ARCH_NAMES}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()
