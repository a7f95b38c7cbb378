"""Config registry: ``--arch <id>`` lookup (reference:
``src/repro/configs/__init__.py``).

``get_config`` knows all ten assigned architectures and the paper's LSTM,
as the reference does. The ported ones are ``paper-lstm`` and the seven
that ride the transformer chassis (dense, vlm and moe); an architecture
that is not ported yet raises ``NotImplementedError``, an unknown name
``KeyError``, so "not yet" and a typo stay apart.
"""
from __future__ import annotations

from . import (gemma3_4b, granite_moe_3b_a800m, grok_1_314b, h2o_danube_3_4b,
               internlm2_1_8b, paligemma_3b, paper_lstm, qwen3_32b)
from .base import ModelConfig, TrainConfig
from .shapes import SHAPES, InputShape

_MODULES = {
    "gemma3-4b": gemma3_4b,
    "internlm2-1.8b": internlm2_1_8b,
    "grok-1-314b": grok_1_314b,
    "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "qwen3-32b": qwen3_32b,
    "paligemma-3b": paligemma_3b,
    "h2o-danube-3-4b": h2o_danube_3_4b,
    "paper-lstm": paper_lstm,
}

# the reference's pool, in its order; the archs whose model family has no
# port yet (rglru, rwkv6, encdec) are listed so they raise
# NotImplementedError rather than KeyError
_NOT_PORTED = ("recurrentgemma-9b", "rwkv6-3b", "whisper-large-v3")

ARCH_IDS = tuple(k for k in _MODULES if k != "paper-lstm")   # ported pool


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch in _NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (see ROADMAP.md); ported: "
            f"{sorted(_MODULES)}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{sorted(_MODULES) + sorted(_NOT_PORTED)}")
    mod = _MODULES[arch]
    return mod.smoke() if smoke else mod.FULL


__all__ = ["ModelConfig", "TrainConfig", "InputShape", "SHAPES", "ARCH_IDS",
           "get_config"]
