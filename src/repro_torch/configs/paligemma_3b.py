"""paligemma-3b [vlm] — arXiv:2407.07726 (PaliGemma).

Language backbone: 18L, d_model 2048, 8 heads (GQA kv=1 — MQA,
head_dim 256), d_ff 16384, vocab 257216. Gemma-style tied embeddings +
embed scale. The SigLIP vision tower + projector are the sanctioned STUB:
``input_specs`` provides 256 projected patch embeddings [B, 256, d_model];
they form a bidirectional prefix (prefix-LM mask) ahead of the causal text.

Full-attention prefix-LM -> long_500k skipped.

Port of ``src/repro/configs/paligemma_3b.py``: the same fields, with torch
dtypes.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ModelConfig

FULL = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=257_216,
    num_prefix_tokens=256,
    tie_embeddings=True,
    embed_scale=True,
    act="gelu",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=1,
        head_dim=32, d_ff=256, vocab_size=512, num_prefix_tokens=8,
        dtype=torch.float32, attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=32)
