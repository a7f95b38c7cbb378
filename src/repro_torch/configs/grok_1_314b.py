"""grok-1-314b [moe] — hf:xai-org/grok-1.

64L, d_model 6144, 48 heads (GQA kv=8, head_dim 128), expert d_ff 32768,
vocab 131072; MoE with 8 experts, top-2 routing. Attention logit softcap
30, untied embeddings.

Port of ``src/repro/configs/grok_1_314b.py``: the same fields, with torch
dtypes. At full width one layer's experts hold 8 x 3 x 6144 x 32768 =
4,831,838,208 params, past the int32 indices of a sparse arena and, with
the state training needs, past one 80 GB card, so the port trains it at
``smoke()`` width only; ``chip_smoke.py`` runs one full-width MoE layer.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ModelConfig

FULL = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32_768,
    vocab_size=131_072,
    num_experts=8,
    num_experts_per_tok=2,
    moe_impl="scatter",
    attn_logit_softcap=30.0,
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=128, vocab_size=512, num_experts=4,
        num_experts_per_tok=2, dtype=torch.float32,
        attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=32)
