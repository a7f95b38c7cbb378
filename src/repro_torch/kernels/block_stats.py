"""Whole-leaf (sum|x|, max|x|): the statistics of Alg 2 and Alg 3 on the
per-leaf path (``fuse_leaves=False``).

Port of ``src/repro/kernels/block_stats.py``. ``abs_sum_max`` takes a
flat f32 leaf. For a CPU tensor it runs the plain twin
``ref.abs_sum_max`` on the reference's zero-padded ``[nb, 1024]`` view;
for a CUDA tensor it launches ``abs_colfold_leaf`` + ``abs_finish_leaf``
(``csrc/leaf.cu``); anything else raises. The sum is
``selection.pinned_sum`` of the leaf, bitwise, on both devices: the
order of the reference's ``jnp`` selectors and of the arena statistics,
not the Pallas kernel's sequential block sums (ROADMAP.md §3).
"""
from __future__ import annotations

import functools

import torch

from . import ref
from .common import (I, L, LOG_COLS, P, check_leaf, launches, raise_on,
                     stream)


@functools.cache
def _fn():
    from .build import load
    fn = load("leaf").abs_sum_max_launch
    fn.argtypes = [P, L, I, I, P, P, P]
    fn.restype = I
    return fn


def abs_sum_max(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum|x|, max|x|) as f32 scalar tensors on ``x``'s device."""
    if x.device.type == "cpu":
        return ref.abs_sum_max(ref.rows(x), x.numel())
    check_leaf(x, "abs_sum_max")
    n = x.numel()
    logp = (n - 1).bit_length()
    logc = min(logp, LOG_COLS)
    part = torch.empty(2 << logc, dtype=torch.float32, device=x.device)
    out = torch.empty(2, dtype=torch.float32, device=x.device)
    rc = _fn()(x.data_ptr(), n, logc, logp - logc, part.data_ptr(),
               out.data_ptr(), stream())
    raise_on(rc, "abs_sum_max")
    launches["abs_sum_max"] += 1
    return out[0], out[1]
