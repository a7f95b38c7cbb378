"""gemma3-4b [dense] — hf:google/gemma-3-4b-pt family (assignment card
cites google/gemma-3-1b-pt; dims below are the assigned 4b row).

34L, d_model 2560, 8 heads (GQA kv=4, head_dim 256), d_ff 10240,
vocab 262144. 5 local(SWA 1024) : 1 global layer pattern, 128k context;
dual RoPE theta (10k local / 1M global); tied embeddings, gemma-style
sqrt(d) embed scale and attn logit softcapping is absent in gemma3 (dropped
vs gemma2) so softcap=None.

Port of ``src/repro/configs/gemma3_4b.py``: the same fields, with torch
dtypes.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ModelConfig

FULL = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab_size=262_144,
    window_size=1024,
    layer_pattern=("L", "L", "L", "L", "L", "G"),
    rope_theta=10_000.0,
    rope_theta_global=1_000_000.0,
    tie_embeddings=True,
    embed_scale=True,
    act="gelu",
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, window_size=16,
        layer_pattern=("L", "G"), dtype=torch.float32,
        attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=32)
