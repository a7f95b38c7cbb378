"""Unified model interface over the ported families.

Port of ``src/repro/models/registry.py``. ``get_model(cfg)`` gives every
ported family the same entry points:

    param_defs()                      the parameter definition tree
    loss(params, batch)               scalar train loss (a tensor)
    init_params(seed, device)         the port's own random init
    train_inputs(batch, seq)          {key: (shape, dtype)} of a batch
    make_train_batch(batch, seq, seed, device)  a concrete synthetic batch

Families: dense, moe and vlm ride the transformer chassis (moe swaps
the MLP for ``models/moe.py`` and adds its load-balance loss; vlm adds
stub patch embeddings as a bidirectional prefix); lstm is the paper's
model. The serving entries (``cache_struct``, ``init_cache``,
``prefill``, ``decode_step``) are ``None`` until serving is ported, and
the families rwkv6, hybrid and encdec raise ``NotImplementedError``
until their modules are (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from . import lstm, transformer
from .common import init_params as _init


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    param_defs: Callable[[], Any]
    loss: Callable[[Any, dict], torch.Tensor]
    init: Callable[[int, torch.device], Any]
    cache_struct: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    prefill: Optional[Callable] = None
    decode_step: Optional[Callable] = None
    supports_decode: bool = False
    supports_long: bool = False

    def init_params(self, seed: int = 0,
                    device: str | torch.device = "cpu") -> Any:
        return self.init(seed, torch.device(device))

    # ---- batch descriptions -------------------------------------------------
    def train_inputs(self, batch: int, seq: int) -> dict:
        cfg = self.cfg
        d = {"tokens": ((batch, seq), torch.int32)}
        if cfg.family == "vlm":
            d["prefix_embeds"] = ((batch, cfg.num_prefix_tokens,
                                   cfg.d_model), cfg.dtype)
        return d

    def make_train_batch(self, batch: int, seq: int, seed: int = 0,
                         device: str | torch.device = "cpu") -> dict:
        """Uniform tokens and, for vlm, N(0, 0.02^2) prefix embeddings,
        drawn on the CPU from one seeded ``torch.Generator`` (the
        reference draws from ``jax.random``: the same distributions,
        other numbers)."""
        cfg = self.cfg
        gen = torch.Generator().manual_seed(seed)
        out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq),
                                       generator=gen, dtype=torch.int32)}
        if cfg.family == "vlm":
            out["prefix_embeds"] = (0.02 * torch.randn(
                (batch, cfg.num_prefix_tokens, cfg.d_model), generator=gen,
                dtype=torch.float32)).to(cfg.dtype)
        return {k: v.to(device) for k, v in out.items()}


def _lstm_init(cfg: ModelConfig, seed: int, device: torch.device) -> dict:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return lstm.init_params(cfg, gen, device)


def get_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return Model(
            cfg=cfg,
            param_defs=lambda: transformer.param_defs(cfg),
            loss=lambda p, b: transformer.loss(cfg, p, b),
            init=lambda seed, dev: _init(transformer.param_defs(cfg), seed,
                                         cfg.dtype, dev))
    if fam == "lstm":
        return Model(
            cfg=cfg,
            param_defs=lambda: lstm.param_defs(cfg),
            loss=lambda p, b: lstm.loss(cfg, p, b["tokens"]),
            init=lambda seed, dev: _lstm_init(cfg, seed, dev))
    if fam in ("rwkv6", "hybrid", "encdec"):
        raise NotImplementedError(
            f"model family {fam!r} is not ported yet (see ROADMAP.md)")
    raise ValueError(f"unknown family: {fam}")
