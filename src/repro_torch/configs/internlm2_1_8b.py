"""internlm2-1.8b [dense] — arXiv:2403.17297.

24L, d_model 2048, 16 heads (GQA kv=8, head_dim 128), d_ff 8192,
vocab 92544. Llama-style: RoPE 1e6, SiLU gated MLP, untied embeddings,
full attention (no window) -> long_500k decode is skipped.

Port of ``src/repro/configs/internlm2_1_8b.py``: the same fields, with torch
dtypes.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ModelConfig

FULL = ModelConfig(
    name="internlm2-1.8b",
    family="dense",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92_544,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, dtype=torch.float32,
        attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=32)
