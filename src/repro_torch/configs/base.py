"""Config system: model / run configs.

Port of ``src/repro/configs/base.py`` (``ModelConfig`` and
``TrainConfig``) with the same field names and defaults, so a config
means the same thing in both packages; only the dtype is a torch dtype.
Fields of features that are not ported yet are kept for that parity;
``build_gradient_sync`` raises when one is switched on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | rwkv6 | hybrid | vlm | encdec | lstm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_theta_global: Optional[float] = None
    window_size: Optional[int] = None
    layer_pattern: Optional[tuple[str, ...]] = None
    attn_logit_softcap: Optional[float] = None
    tie_embeddings: bool = True
    embed_scale: bool = False

    # moe
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_capacity_factor: float = 1.25
    moe_impl: str = "onehot"

    # recurrent / hybrid
    lru_width: Optional[int] = None
    conv1d_width: int = 4
    rwkv_head_dim: int = 64
    lora_dim: int = 32

    # modality stubs
    num_prefix_tokens: int = 0
    encoder_layers: int = 0
    encoder_frames: int = 0
    max_target_positions: int = 0

    # numerics / structure
    act: str = "silu"
    norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16
    scan_layers: bool = True
    remat: bool = True

    # chunk sizes (memory-bounded attention / loss)
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    loss_chunk: int = 2048
    wkv_chunk: int = 64


@dataclass(frozen=True)
class TrainConfig:
    """Run config; see the reference for every field's meaning."""
    lr: float = 0.1
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 0.0
    optimizer: str = "rgc"
    transport: str = "fused_allgather"
    bucket_bytes: int = 4 * 1024 * 1024
    intra_axis: Optional[str] = None
    schedule: str = "sequential"
    density: float = 0.001
    warmup_steps_per_stage: int = 0
    dense_warmup: bool = False
    local_clip: float | None = None
    seed: int = 0
    residual_dtype: str = "f32"     # f32 | bf16
    fuse_leaves: bool = True
    fuse_accumulate: bool = False
    # The reference's selection backend ("jnp" | "pallas"). In the port
    # the tensor's device picks the implementation, so it has no effect.
    backend: str = "jnp"
