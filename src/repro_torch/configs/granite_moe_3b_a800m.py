"""granite-moe-3b-a800m [moe] — hf:ibm-granite/granite-3.0-3b-a800m-base.

32L, d_model 1536, 24 heads (GQA kv=8, head_dim 64), expert d_ff 512,
vocab 49155; MoE with 40 experts, top-8 routing. Tied embeddings.

Port of ``src/repro/configs/granite_moe_3b_a800m.py``: the same fields,
with torch dtypes.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ModelConfig

FULL = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    num_experts=40,
    num_experts_per_tok=8,
    moe_impl="scatter",
    tie_embeddings=True,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=128, vocab_size=512, num_experts=4,
        num_experts_per_tok=2, dtype=torch.float32,
        attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=32)
