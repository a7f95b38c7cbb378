"""qwen3-32b [dense] — hf:Qwen/Qwen3-32B (assignment card cites Qwen3-8B;
dims below are the assigned 32b row).

64L, d_model 5120, 64 heads (GQA kv=8, head_dim 128), d_ff 25600,
vocab 151936. QK-norm (per-head RMSNorm on q and k), RoPE 1e6, untied
embeddings, full attention -> long_500k skipped.

Port of ``src/repro/configs/qwen3_32b.py``: the same fields, with torch
dtypes.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ModelConfig

FULL = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25_600,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, dtype=torch.float32,
        attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=32)
