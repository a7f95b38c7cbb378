"""h2o-danube-3-4b [dense] — arXiv:2401.16818 (H2O-Danube series;
llama + mistral architecture mix).

24L, d_model 3840, 32 heads (GQA kv=8, head_dim 120), d_ff 10240,
vocab 32000. Mistral-style sliding-window attention (window 4096) on all
layers per the assignment card -> sub-quadratic SWA decode, long_500k RUNS
with a 4096 ring-buffer KV.

head_dim 120 is not 128-aligned (3840/32), as the model card has it.

Port of ``src/repro/configs/h2o_danube_3_4b.py``: the same fields, with torch
dtypes.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ModelConfig

FULL = ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10_240,
    vocab_size=32_000,
    window_size=4096,
    tie_embeddings=False,
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
        head_dim=32, d_ff=256, vocab_size=512, window_size=16,
        dtype=torch.float32, attn_q_chunk=16, attn_kv_chunk=16, loss_chunk=32)
