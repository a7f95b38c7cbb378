"""Plain PyTorch twins of the segmented kernels.

Port of the segmented half of ``src/repro/kernels/ref.py``. Each twin
computes exactly what the reference's ``jnp`` twin computes and is the
oracle its CUDA kernel (``kernels/csrc/segmented.cu``) is held against:
``seg_abs_sum_max`` bitwise (the pinned summation tree), the integer
counts and the compaction exactly. The wrappers in
``kernels/segmented.py`` run these for CPU tensors; they also run on CUDA
tensors when called directly, which is how the card compares kernel and
twin.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.selection import pinned_sum


def _seg_rows(block_seg) -> list[tuple[int, int]]:
    """Contiguous [row0, row1) row range per segment ordinal."""
    bs = np.asarray(block_seg)
    starts = np.searchsorted(bs, np.arange(bs.max() + 1), side="left")
    ends = np.searchsorted(bs, np.arange(bs.max() + 1), side="right")
    return [(int(s), int(e)) for s, e in zip(starts, ends)]


def _i64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def seg_abs_sum_max(x2d: torch.Tensor, block_seg, block_size, n_seg: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment (sum|x|, max|x|): ``pinned_sum`` over each slot's
    TRUE-length flat vector (padding sliced off) and a plain max."""
    ax = x2d.to(torch.float32).abs()
    bsize = np.asarray(block_size)
    sums, maxs = [], []
    for r0, r1 in _seg_rows(block_seg):
        seg = ax[r0:r1]
        sums.append(pinned_sum(seg.reshape(-1)[:int(bsize[r0])]))
        maxs.append(seg.max())
    return torch.stack(sums), torch.stack(maxs)


def seg_count_gt(x2d: torch.Tensor, block_seg, thresholds: torch.Tensor,
                 n_seg: int) -> torch.Tensor:
    """Per-segment nnz(|x| > thresholds[seg]) as i32 (order-free)."""
    seg = _i64(block_seg, x2d.device)
    thr_b = thresholds.to(torch.float32)[seg]
    cnt_b = (x2d.to(torch.float32).abs() > thr_b[:, None]).sum(1)
    out = torch.zeros(n_seg, dtype=torch.int64, device=x2d.device)
    return out.index_add_(0, seg, cnt_b).to(torch.int32)


def seg_compact_gt(x2d: torch.Tensor, block_seg, block_base, block_size,
                   thresholds: torch.Tensor, cap_per_block: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per arena row, the first ``cap_per_block`` elements with
    |x| > thr of the owning segment (and slot-local index < slot size),
    packed to the front: (values [nb, cap], slot-local i32 indices
    [nb, cap] padded with the slot size, pre-clamp counts [nb])."""
    nb, block = x2d.shape
    dev = x2d.device
    x = x2d.to(torch.float32)
    seg, base, size = (_i64(a, dev)
                       for a in (block_seg, block_base, block_size))
    thr_b = thresholds.to(torch.float32)[seg]

    lidx = base[:, None] + torch.arange(block, device=dev)[None, :]
    mask = (x.abs() > thr_b[:, None]) & (lidx < size[:, None])
    cnts = mask.sum(1).to(torch.int32)

    cap = cap_per_block
    pos = torch.cumsum(mask, 1) - 1
    live = mask & (pos < cap)
    row = torch.arange(nb, device=dev)[:, None]
    # scatter survivors into [nb, cap] buckets (+1 dump slot for the rest)
    tgt = torch.where(live, row * cap + pos, nb * cap).reshape(-1)
    vals = torch.zeros(nb * cap + 1, dtype=torch.float32, device=dev) \
        .scatter_(0, tgt, x.reshape(-1))[:nb * cap].reshape(nb, cap)
    sentinel = size[:, None].expand(nb, cap).reshape(-1)
    idx = torch.cat([sentinel, sentinel.new_zeros(1)]) \
        .scatter_(0, tgt, lidx.reshape(-1))[:nb * cap].reshape(nb, cap)
    return vals, idx.to(torch.int32), cnts
