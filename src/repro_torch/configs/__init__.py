"""Architecture configurations the port serves (``config()`` is the
published configuration, ``smoke_config()`` a reduced one for CPU tests).

The registry mirrors ``repro.configs``: :func:`get_config` and
:func:`get_smoke_config` take the JAX registry's names. A name the JAX
package has but the port does not serve yet raises
``NotImplementedError`` naming the ROADMAP.md item that ports it."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import gemma3_4b, gemma3_27b, qwen1p5_4b, yi_9b

__all__ = ["gemma3_4b", "gemma3_27b", "qwen1p5_4b", "yi_9b",
           "ARCH_NAMES", "get_config", "get_smoke_config"]

_MODULES = {
    "qwen1.5-4b": qwen1p5_4b,
    "yi-9b": yi_9b,
    "gemma3-4b": gemma3_4b,
    "gemma3-27b": gemma3_27b,
}

#: The JAX registry's names this port does not serve yet, by the
#: ROADMAP.md queue A item that ports them.
_NOT_PORTED = {
    "zamba2-1.2b": 9, "mamba2-2.7b": 9, "dbrx-132b": 9,
    "deepseek-moe-16b": 9, "musicgen-large": 9, "paligemma-3b": 9,
}

ARCH_NAMES = list(_MODULES)


def _module(name: str):
    if name in _MODULES:
        return _MODULES[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"config {name!r} is not ported yet: ROADMAP.md queue A item "
            f"{_NOT_PORTED[name]} (Other families)")
    raise KeyError(f"unknown config {name!r}; known: {ARCH_NAMES}")


def get_config(name: str) -> ModelConfig:
    return _module(name).config()


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).smoke_config()
