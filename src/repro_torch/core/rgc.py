"""Legacy RGC entry points: thin shims over ``GradientSync``.

Port of ``src/repro/core/rgc.py``, for callers of the old monolithic API:

    cfg = RGCConfig(density=0.001, sync_axes=())
    state = rgc_init(params, cfg)
    new_p, new_s = rgc_apply(grads, params, state, lr=lr, cfg=cfg)

New code builds a ``GradientSync`` directly
(``build_gradient_sync("rgc", ...)``). The reference's ``rgc_apply``
runs inside a ``shard_map`` whose axis names include ``cfg.sync_axes``;
here those axes name the workers of a ``launch.mesh.Mesh`` passed as
``mesh=`` (none: one worker). ``device`` is the sync's device (default
CUDA; ``"cpu"`` runs the plain PyTorch path).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .cost_model import DENSE_THRESHOLD_BYTES, TRIMMED_THRESHOLD_BYTES
from .dispatch import SizeBasedPolicy, leaf_nbytes
from .gradient_sync import GradientSync, build_gradient_sync

# canonical registry name -> the method string the legacy API exposed
_LEGACY_METHOD = {
    "dense": "dense",
    "trimmed_topk": "trimmed_topk",
    "threshold_bsearch": "threshold_binary_search",
}


@dataclass(frozen=True)
class RGCConfig:
    density: float = 0.001
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 0.0
    quantize: bool = False
    dense_threshold_bytes: int = DENSE_THRESHOLD_BYTES
    trimmed_threshold_bytes: int = TRIMMED_THRESHOLD_BYTES
    bsearch_interval: int = 5
    fuse_messages: bool = True
    local_clip: float | None = None
    sync_axes: tuple[str, ...] = ("data",)
    # a bf16 residual halves the RGC state; selection and wire stay f32
    residual_dtype: Any = torch.float32
    # the reference's selection backend ("jnp" | "pallas"); here the
    # tensor's device picks the implementation, so it has no effect
    backend: str = "jnp"
    # leaves whose path holds any of these are never quantized (§5.2.3)
    no_quant_paths: tuple[str, ...] = ("lm_head", "embed")


def gradient_sync_from_rgc_config(cfg: RGCConfig, *, mesh: Any = None,
                                  device: str | torch.device | None = None
                                  ) -> GradientSync:
    """The ``GradientSync`` equivalent of a legacy ``RGCConfig``."""
    return build_gradient_sync(
        "rgc_quant" if cfg.quantize else "rgc",
        transport=("fused_allgather" if cfg.fuse_messages
                   else "per_leaf_allgather"),
        sync_axes=cfg.sync_axes,
        mesh=mesh,
        density=cfg.density,
        momentum=cfg.momentum,
        nesterov=cfg.nesterov,
        weight_decay=cfg.weight_decay,
        local_clip=cfg.local_clip,
        residual_dtype=cfg.residual_dtype,
        no_quant_paths=cfg.no_quant_paths,
        dense_threshold_bytes=cfg.dense_threshold_bytes,
        trimmed_threshold_bytes=cfg.trimmed_threshold_bytes,
        backend=cfg.backend,
        bsearch_interval=cfg.bsearch_interval,
        # the legacy monolith cold-searched on every refresh
        warm_start=False,
        device=device,
    )


def leaf_bytes(x: torch.Tensor) -> int:
    """Deprecated: real storage bytes of a leaf (``dispatch.leaf_nbytes``)."""
    return leaf_nbytes(x)


def leaf_method(x: torch.Tensor, cfg: RGCConfig) -> str:
    policy = SizeBasedPolicy(cfg.dense_threshold_bytes,
                             cfg.trimmed_threshold_bytes)
    return _LEGACY_METHOD[policy.compressor_for("", x)]


def rgc_init(params: Any, cfg: RGCConfig | None = None, *, mesh: Any = None,
             device: str | torch.device | None = None) -> Any:
    """State tree congruent with params (a ``LeafState`` at each leaf)."""
    cfg = cfg or RGCConfig()
    return gradient_sync_from_rgc_config(cfg, mesh=mesh,
                                         device=device).init(params)


def rgc_apply(grads: Any, params: Any, state: Any, *, lr, cfg: RGCConfig,
              density: float | None = None, mesh: Any = None,
              device: str | torch.device | None = None) -> tuple[Any, Any]:
    """One synchronized RGC update. Returns (new_params, new_state)."""
    sync = gradient_sync_from_rgc_config(cfg, mesh=mesh, device=device)
    return sync.update(grads, state, params, lr, density=density)
