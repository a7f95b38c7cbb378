"""The paper's own evaluation model (RedSync §6.2): 2-layer LSTM LM with
1500 hidden units per layer (Press & Wolf 2016), untied embeddings, PTB
vocabulary (10k).

Port of ``src/repro/configs/paper_lstm.py``. At full width its
gradient tree is embed 10000x1500, lm_head 1500x10000 and per layer
wx/wh 1500x6000 (the six bsearch leaves of the §5.5 dispatch, one
66,000,000-element arena) plus two small dense leaves per layer and
lm_bias.
"""
from __future__ import annotations

import dataclasses

import torch

from .base import ModelConfig

FULL = ModelConfig(
    name="paper-lstm",
    family="lstm",
    num_layers=2,
    d_model=1500,            # embedding size
    num_heads=1,
    num_kv_heads=1,
    head_dim=1500,
    d_ff=1500,               # hidden units
    vocab_size=10_000,       # PTB
    tie_embeddings=False,
    dtype=torch.float32,     # paper trains fp32
)


def smoke() -> ModelConfig:
    return dataclasses.replace(
        FULL, d_model=64, d_ff=96, head_dim=96, vocab_size=512,
        loss_chunk=32)
