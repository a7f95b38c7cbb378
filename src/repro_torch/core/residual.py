"""Residual + momentum state for RGC (RedSync §5.7, Algorithm 4).

Port of ``src/repro/core/residual.py``. Per compressed leaf: residual V,
momentum-corrected velocity U, the cached bsearch threshold, the
quantization phase and the threshold-refresh interval counter.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


def pinned_product(a, b):
    """``a * b`` rounded on its own, never fused into a following add.

    The reference needs a loop fence to stop XLA contracting the product
    into an FMA. Eager PyTorch runs each operator as its own kernel, so a
    separate multiply is already pinned; callers must not replace it with
    ``addcmul``, ``lerp`` or ``add(..., alpha=)``, which fuse.
    """
    return a * b


class LeafState(NamedTuple):
    residual: torch.Tensor    # f32 param-shaped
    momentum: torch.Tensor    # f32 param-shaped (0-d placeholder if unused)
    threshold: torch.Tensor   # f32 0-d
    phase: torch.Tensor       # i32 0-d
    interval: torch.Tensor    # i32 0-d


def init_leaf(param: torch.Tensor, *, momentum: bool = True,
              residual_dtype=torch.float32) -> LeafState:
    dev = param.device
    v = torch.zeros(param.shape, dtype=residual_dtype, device=dev)
    u = (torch.zeros(param.shape, dtype=torch.float32, device=dev)
         if momentum else torch.zeros((), dtype=torch.float32, device=dev))
    return LeafState(v, u, torch.zeros((), dtype=torch.float32, device=dev),
                     torch.zeros((), dtype=torch.int32, device=dev),
                     torch.zeros((), dtype=torch.int32, device=dev))


def accumulate(grad, param, state: LeafState, *, momentum: float,
               nesterov: bool, weight_decay: float) -> LeafState:
    """Alg 4 lines 8-19: weight decay, momentum correction, residual add.

    The case the reference's fused ``residual_update`` kernel computes —
    momentum with a param-shaped velocity, f32 gradient and residual, no
    weight decay — goes through that kernel's wrapper
    (``kernels.residual_update``) on the flattened leaf: the CUDA kernel
    on the card, its plain twin on the CPU, both with the separately
    rounded arithmetic below. The other cases stay plain PyTorch on both
    devices.
    """
    if (momentum and not weight_decay and state.momentum.dim() > 0
            and grad.dtype == state.residual.dtype == state.momentum.dtype
            == torch.float32):
        from repro_torch.kernels.residual_update import residual_update

        def flat(a):
            return a.reshape(-1).contiguous()
        u, v = residual_update(flat(grad), flat(state.momentum),
                               flat(state.residual), momentum=momentum,
                               nesterov=nesterov)
        shape = state.residual.shape
        return state._replace(residual=v.reshape(shape),
                              momentum=u.reshape(shape))
    g = grad.to(torch.float32)
    if weight_decay:
        g = g + pinned_product(weight_decay, param.to(torch.float32))
    r = state.residual.to(torch.float32)
    if momentum:
        u = pinned_product(momentum, state.momentum) + g
        v = r + u
        if nesterov:
            v = v + g
    else:
        u = state.momentum
        v = r + g
    return state._replace(residual=v.to(state.residual.dtype), momentum=u)


def zero_at(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` with the flat coordinates ``indices`` set to 0;
    indices >= x.numel() (padding sentinels) are dropped, as the
    reference's ``.at[indices].set(0.0, mode="drop")``."""
    n = x.numel()
    buf = torch.cat([x.reshape(-1), x.new_zeros(1)])
    buf[indices.to(torch.int64).clamp(max=n)] = 0
    return buf[:n].reshape(x.shape)


def mask_communicated(state: LeafState, indices: torch.Tensor, *,
                      momentum: bool) -> LeafState:
    """Alg 4 lines 21-23: clear V (and U) at communicated coordinates."""
    st = state._replace(residual=zero_at(state.residual, indices))
    return mask_momentum(st, indices) if momentum else st


def mask_momentum(state: LeafState, indices: torch.Tensor) -> LeafState:
    """DGC momentum factor masking: clear U at communicated coordinates
    (no-op for a 0-d velocity placeholder)."""
    if state.momentum.dim() == 0:
        return state
    return state._replace(momentum=zero_at(state.momentum, indices))


def accumulate_arena(g2d, v2d, u2d, p2d, *, momentum: float, nesterov: bool,
                     weight_decay: float, residual_dtype=torch.float32):
    """Alg 4 lines 8-19 over a whole arena: the update half of the plain
    twin of the fused residual-update+stats kernel
    (``kernels.segmented.seg_residual_update_stats``), with the same
    separately rounded products. Returns (V', U' or None).
    """
    g = g2d.to(torch.float32)
    if weight_decay:
        g = g + weight_decay * p2d.to(torch.float32)
    if momentum:
        u = momentum * u2d + g
        v = v2d + u
        if nesterov:
            v = v + g
    else:
        u = None
        v = v2d + g
    if residual_dtype != torch.float32:
        v = v.to(residual_dtype).to(torch.float32)
    return v, u


def local_clip_scale(grads_sq_sum: torch.Tensor, clip_norm: float,
                     num_workers: int) -> torch.Tensor:
    """DGC local gradient clipping (§5.6): the factor that clips the
    LOCAL gradient to N^{-1/2} of the global threshold, in f32 as the
    reference computes it."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32,
                            device=grads_sq_sum.device)
    norm = torch.sqrt(grads_sq_sum)
    limit = f32(clip_norm) / torch.sqrt(f32(num_workers))
    return torch.minimum(f32(1.0), limit / torch.maximum(norm, f32(1e-12)))
