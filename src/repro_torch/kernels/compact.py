"""Block-bucketed stream compaction of one leaf's survivors |x| > t.

Port of ``src/repro/kernels/compact.py``. ``compact_gt`` takes a flat f32
leaf, a threshold tensor on the same device and a bucket size ``cap``.
Per 1024-element row it keeps the first ``cap`` survivors in index order
as (value, global index), pads the bucket with ``(0.0, n)`` and reports
the row's count before clamping, so the caller sees a bucket overflow.
For a CPU tensor it runs the plain twin ``ref.compact_gt`` on the
reference's zero-padded ``[nb, 1024]`` view; for a CUDA tensor it
launches ``compact_gt_leaf`` (``csrc/leaf.cu``: one warp per row, float4
loads when the leaf is 16-byte aligned); anything else raises.

``compact_gt_exact`` is its exact form, for a leaf whose buckets
overflowed: it writes the first ``capacity`` survivors of the whole leaf,
in index order, to one dense list in a single pass over the leaf
(``compact_gt_exact_leaf``, a chained scan with decoupled look-back;
twin ``ref.compact_gt_exact``). The reference has no kernel for this and
filters in ``jnp`` instead.
"""
from __future__ import annotations

import functools

import torch

from . import ref
from .common import (I, L, P, ROW, aligned, check_leaf, device_scalar,
                     launches, raise_on, stream)

EXACT_TILE = 8192   # elements per tile of compact_gt_exact_leaf (leaf.cu)


@functools.cache
def _fn():
    from .build import load
    fn = load("leaf").compact_gt_launch
    fn.argtypes = [P, L, I, P, I, P, P, P, P]
    fn.restype = I
    return fn


@functools.cache
def _exact_fn():
    from .build import load
    fn = load("leaf").compact_gt_exact_launch
    fn.argtypes = [P, L, I, P, I, P, P, P, I, P]
    fn.restype = I
    return fn


def compact_gt(x: torch.Tensor, threshold: torch.Tensor, cap_per_block: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(values f32 [nb, cap], global indices i32 [nb, cap] padded with n,
    pre-clamp counts i32 [nb]), ``nb = ceil(n / 1024)``."""
    if x.device.type == "cpu":
        return ref.compact_gt(ref.rows(x), threshold, cap_per_block,
                              x.numel())
    check_leaf(x, "compact_gt")
    if not 1 <= cap_per_block <= ROW:
        raise ValueError(f"compact_gt: cap {cap_per_block} not in "
                         f"[1, {ROW}]")
    thr = device_scalar(threshold, x, "compact_gt")
    n = x.numel()
    nb = -(-n // ROW)
    vals = torch.empty((nb, cap_per_block), dtype=torch.float32,
                       device=x.device)
    idx = torch.empty((nb, cap_per_block), dtype=torch.int32,
                      device=x.device)
    cnt = torch.empty(nb, dtype=torch.int32, device=x.device)
    rc = _fn()(x.data_ptr(), n, aligned(x), thr.data_ptr(), cap_per_block,
               vals.data_ptr(), idx.data_ptr(), cnt.data_ptr(), stream())
    raise_on(rc, "compact_gt")
    launches["compact_gt"] += 1
    return vals, idx, cnt


def compact_gt_exact(x: torch.Tensor, threshold: torch.Tensor,
                     capacity: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values f32 [capacity], global indices i32 [capacity]): the first
    ``capacity`` elements with |x| > threshold in index order, padded
    with ``(0.0, n)``."""
    if x.device.type == "cpu":
        return ref.compact_gt_exact(ref.rows(x), threshold, capacity,
                                    x.numel())
    check_leaf(x, "compact_gt_exact")
    if not 1 <= capacity < 2**31:
        raise ValueError(f"compact_gt_exact: capacity {capacity} not in "
                         "[1, 2^31)")
    thr = device_scalar(threshold, x, "compact_gt_exact")
    n = x.numel()
    tiles = -(-n // EXACT_TILE)
    vals = torch.empty(capacity, dtype=torch.float32, device=x.device)
    idx = torch.empty(capacity, dtype=torch.int32, device=x.device)
    # per tile one flag word (status, prefix), then the tile counter;
    # the launch zeroes it
    scratch = torch.empty(tiles + 1, dtype=torch.int64, device=x.device)
    rc = _exact_fn()(x.data_ptr(), n, aligned(x), thr.data_ptr(), capacity,
                     vals.data_ptr(), idx.data_ptr(), scratch.data_ptr(),
                     tiles, stream())
    raise_on(rc, "compact_gt_exact")
    launches["compact_gt_exact"] += 1
    return vals, idx
