"""Whole-leaf (sum|x|, max|x|): the statistics of Alg 2 and Alg 3 on the
per-leaf path (``fuse_leaves=False``).

Port of ``src/repro/kernels/block_stats.py``. ``abs_sum_max`` takes a
flat f32 leaf. For a CPU tensor it runs the plain twin
``ref.abs_sum_max`` on the reference's zero-padded ``[nb, 1024]`` view;
for a CUDA tensor it launches ``abs_sum_max_leaf`` (``csrc/leaf.cu``);
anything else raises. The sum is ``selection.pinned_sum`` of the leaf,
bitwise, on both devices: the order of the reference's ``jnp``
selectors and of the arena statistics, not the Pallas kernel's
sequential block sums (ROADMAP.md §3).

The kernel reads the leaf zero-extended to ``P = 2^logp`` elements as
``[2^(logp - logm), 2^logm]``; every split gives the pinned tree's bits
(``split``). Each block folds 32 whole columns (residue classes mod
``2^logm``) and writes their 32 partials; the last block to finish (a
counter the launch zeroes) folds the ``2^logm`` partials, in the same
launch.
"""
from __future__ import annotations

import functools

import torch

from . import ref
from .common import I, L, P, aligned, check_leaf, launches, raise_on, stream


# Split of the pinned tree (csrc/leaf.cu, abs_sum_max_leaf): 32 columns
# per block, 32 row groups of 8 to 8,192 rows each, at most 2^13 columns
# (32 partials per thread in the last block's fold).
LOG_MIN = 13
LOG_COLS_MAX = 13


def split(n: int) -> tuple[int, int]:
    """(logp, logm) for a leaf of n elements: ``P = 2^logp`` is the
    pinned tree's padded length, zero-extended to at least 2^13 (adding
    zero leaves changes no bit of the sum), and ``2^logm`` the columns of
    the kernel's ``[P / 2^logm, 2^logm]`` view: 256 blocks of 32 columns
    from P = 2^21 up, fewer below, at least 256 rows each."""
    logp = max((n - 1).bit_length(), LOG_MIN)
    return logp, min(LOG_COLS_MAX, logp - 8)


def scratch(logm: int, device: torch.device) -> torch.Tensor:
    """The kernel's scratch at 2^logm columns: the column partials, the
    block maxima, then the blocks-done counter (the launch zeroes it)."""
    return torch.empty((1 << logm) + (1 << (logm - 5)) + 1,
                       dtype=torch.float32, device=device)


@functools.cache
def _fn():
    from .build import load
    fn = load("leaf").abs_sum_max_launch
    fn.argtypes = [P, L, I, I, I, P, P, P]
    fn.restype = I
    return fn


def abs_sum_max(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum|x|, max|x|) as f32 scalar tensors on ``x``'s device."""
    if x.device.type == "cpu":
        return ref.abs_sum_max(ref.rows(x), x.numel())
    check_leaf(x, "abs_sum_max")
    n = x.numel()
    logp, logm = split(n)
    part = scratch(logm, x.device)
    out = torch.empty(2, dtype=torch.float32, device=x.device)
    rc = _fn()(x.data_ptr(), n, aligned(x), logp, logm, part.data_ptr(),
               out.data_ptr(), stream())
    raise_on(rc, "abs_sum_max")
    launches["abs_sum_max"] += 1
    return out[0], out[1]
