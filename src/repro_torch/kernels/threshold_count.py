"""Whole-leaf nnz(|x| > t): the count of Alg 2's ratio ladder and of
Alg 3's bisection on the per-leaf path (``fuse_leaves=False``).

Port of ``src/repro/kernels/threshold_count.py``. ``count_gt`` takes a
flat f32 leaf and a threshold tensor on the same device. For a CPU
tensor it runs the plain twin ``ref.count_gt`` on the reference's
zero-padded ``[nb, 1024]`` view; for a CUDA tensor it launches
``count_gt_leaf`` (``csrc/leaf.cu``), which reads the leaf in place and
the threshold on the device (no host synchronisation); anything else
raises.
"""
from __future__ import annotations

import functools

import torch

from . import ref
from .common import (I, L, P, ROW, aligned, check_leaf, device_scalar,
                     launches, raise_on, stream)


@functools.cache
def _fn():
    from .build import load
    fn = load("leaf").count_gt_launch
    fn.argtypes = [P, L, I, P, I, P, P]
    fn.restype = I
    return fn


def count_gt(x: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """nnz(|x| > threshold) as an i32 scalar tensor on ``x``'s device."""
    if x.device.type == "cpu":
        return ref.count_gt(ref.rows(x), threshold)
    check_leaf(x, "count_gt")
    thr = device_scalar(threshold, x, "count_gt")
    n = x.numel()
    pad = -(-n // ROW) * ROW - n
    out = torch.zeros((), dtype=torch.int32, device=x.device)
    rc = _fn()(x.data_ptr(), n, aligned(x), thr.data_ptr(), pad,
               out.data_ptr(), stream())
    raise_on(rc, "count_gt")
    launches["count_gt"] += 1
    return out
