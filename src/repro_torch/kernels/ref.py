"""Plain PyTorch twins of the hand-written kernels.

Port of ``src/repro/kernels/ref.py``. Each twin is the oracle its CUDA
kernel is held against on the card, and what the kernel's wrapper runs
for a CPU tensor; the twins also run on CUDA tensors when called
directly, which is how the card compares kernel and twin.

* Segmented twins (kernels of ``kernels/csrc/segmented.cu``, wrappers in
  ``kernels/segmented.py``): ``seg_abs_sum_max`` bitwise (the pinned
  summation tree), the integer counts and the compaction exactly, and
  ``seg_residual_update_stats`` bitwise (the separately rounded products
  of ``accumulate_arena``). Each computes what the reference's ``jnp``
  twin computes.
* Per-leaf twins (kernels of ``kernels/csrc/leaf.cu``, wrappers in
  ``threshold_count.py``, ``block_stats.py``, ``compact.py`` and
  ``residual_update.py``): ``count_gt``, ``abs_sum_max``, ``compact_gt``
  and ``residual_update``, on the reference's zero-padded ``[nb, 1024]``
  view of a flat leaf (``rows``); each docstring says where it departs
  from ``repro.kernels.ref``. ``compact_gt_exact`` is the twin of
  ``compact_gt``'s exact form, which the reference lacks.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.residual import accumulate_arena, pinned_product
from repro_torch.core.selection import first_true, pinned_sum


def _seg_rows(block_seg) -> list[tuple[int, int]]:
    """Contiguous [row0, row1) row range per segment ordinal."""
    bs = np.asarray(block_seg)
    starts = np.searchsorted(bs, np.arange(bs.max() + 1), side="left")
    ends = np.searchsorted(bs, np.arange(bs.max() + 1), side="right")
    return [(int(s), int(e)) for s, e in zip(starts, ends)]


def _i64(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


# The row-wise segmented twins walk the arena in blocks of this many rows,
# so their int64 and bool temporaries stay a fraction of the arena (at the
# 1.89e9-element arena of internlm2-1.8b a whole-arena int64 temporary is
# 15 GB). Rows are independent, so the results do not depend on it.
TWIN_ROWS = 1 << 16


def seg_abs_sum_max(x2d: torch.Tensor, block_seg, block_size, n_seg: int,
                    stride_seg=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment (sum|x|, max|x|): ``pinned_sum`` over each slot's
    TRUE-length flat vector (padding sliced off) and a plain max.

    ``stride_seg`` (per-segment ints) restricts both to the slot's
    ``[::stride]`` subsample of true length ``ceil(n / stride)``, the
    vector the sampled selector searches; ``None`` / stride 1 is exact.
    """
    bsize = np.asarray(block_size)
    sums, maxs = [], []
    for s, (r0, r1) in enumerate(_seg_rows(block_seg)):
        seg = x2d[r0:r1].to(torch.float32).abs()
        stride = 1 if stride_seg is None else int(stride_seg[s])
        if stride > 1:
            vec = seg.reshape(-1)[:int(bsize[r0]):stride]
            sums.append(pinned_sum(vec))
            maxs.append(vec.max())
        else:
            sums.append(pinned_sum(seg.reshape(-1)[:int(bsize[r0])]))
            maxs.append(seg.max())
    return torch.stack(sums), torch.stack(maxs)


def seg_count_gt(x2d: torch.Tensor, block_seg, thresholds: torch.Tensor,
                 n_seg: int, stride_b=None) -> torch.Tensor:
    """Per-segment nnz(|x| > thresholds[seg]) as i32 (order-free).

    ``stride_b`` (per-row ints) counts only the columns with
    ``col % stride == 0``: strides divide the row and slots start on a
    row, so that is the slot-local ``[::stride]`` grid."""
    seg = _i64(block_seg, x2d.device)
    thr_b = thresholds.to(torch.float32)[seg]
    stride_t = None if stride_b is None else _i64(stride_b, x2d.device)
    col = torch.arange(x2d.shape[1], device=x2d.device)[None, :]
    out = torch.zeros(n_seg, dtype=torch.int64, device=x2d.device)
    for r0 in range(0, x2d.shape[0], TWIN_ROWS):
        r1 = min(r0 + TWIN_ROWS, x2d.shape[0])
        mask = x2d[r0:r1].to(torch.float32).abs() > thr_b[r0:r1, None]
        if stride_t is not None:
            mask = mask & (col % stride_t[r0:r1, None] == 0)
        out.index_add_(0, seg[r0:r1], mask.sum(1))
    return out.to(torch.int32)


def seg_compact_gt(x2d: torch.Tensor, block_seg, block_base, block_size,
                   thresholds: torch.Tensor, cap_per_block: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per arena row, the first ``cap_per_block`` elements with
    |x| > thr of the owning segment (and slot-local index < slot size),
    packed to the front: (values [nb, cap], slot-local i32 indices
    [nb, cap] padded with the slot size, pre-clamp counts [nb])."""
    dev = x2d.device
    seg, base, size = (_i64(a, dev)
                       for a in (block_seg, block_base, block_size))
    thr_b = thresholds.to(torch.float32)[seg]
    parts = [_compact_rows(x2d[r0:r0 + TWIN_ROWS], base[r0:r0 + TWIN_ROWS],
                           size[r0:r0 + TWIN_ROWS], thr_b[r0:r0 + TWIN_ROWS],
                           cap_per_block)
             for r0 in range(0, x2d.shape[0], TWIN_ROWS)]
    return tuple(torch.cat(t) for t in zip(*parts))


def _compact_rows(x2d, base, size, thr_b, cap: int):
    """``seg_compact_gt`` of a block of rows, given their per-row slot
    base, slot size and threshold."""
    nb, block = x2d.shape
    dev = x2d.device
    x = x2d.to(torch.float32)
    lidx = base[:, None] + torch.arange(block, device=dev)[None, :]
    mask = (x.abs() > thr_b[:, None]) & (lidx < size[:, None])
    cnts = mask.sum(1).to(torch.int32)

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


def seg_residual_update_stats(g2d, v2d, u2d, p2d, geom, *, momentum: float,
                              nesterov: bool, weight_decay: float = 0.0,
                              round_dtype=None, stride_seg=None):
    """The fused accumulate + statistics pass: ``residual.accumulate_arena``
    (V', U'; V' rounded through ``round_dtype`` when given), then the
    pinned, optionally strided ``seg_abs_sum_max`` of V'. Returns
    (V', U' or None, per-segment sum|V'|, per-segment max|V'|).

    The reference's own twin of this pass sums each segment's rows in
    sequence, as its Pallas grid does. This twin deliberately follows the
    reference's default ``jnp`` pipeline instead, which computes these
    statistics with ``pinned_sum`` (strided for sampled slots): a twin
    that summed otherwise would move the selection thresholds.
    """
    v, u = accumulate_arena(
        g2d, v2d, u2d, p2d, momentum=momentum, nesterov=nesterov,
        weight_decay=weight_decay,
        residual_dtype=torch.float32 if round_dtype is None else round_dtype)
    sums, maxs = seg_abs_sum_max(v, geom.block_seg, geom.block_size,
                                 geom.n_seg, stride_seg)
    return v, u, sums, maxs


# ---------------------------------------------------------------------------
# Per-leaf twins (the whole-leaf kernels of kernels/csrc/leaf.cu)
# ---------------------------------------------------------------------------

def rows(x: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """A flat leaf as the reference's zero-padded f32 ``[nb, block]`` view
    (``repro.kernels.ops._to2d``), ``nb = max(1, ceil(n / block))``."""
    flat = x.reshape(-1).to(torch.float32)
    nb = max(1, -(-flat.numel() // block))
    return F.pad(flat, (0, nb * block - flat.numel())).reshape(nb, block)


def count_gt(x2d: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    """nnz(|x| > threshold) over the padded view, as i32 (order-free).
    The padding counts only when ``0 > threshold``, as in the reference."""
    return (x2d.to(torch.float32).abs() > threshold).sum().to(torch.int32)


def abs_sum_max(x2d: torch.Tensor, n: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum|x|, max|x|) of the leaf's first ``n`` elements.

    The reference's twin sums with ``jnp.sum`` and its Pallas kernel adds
    the rows' sums in sequence; this twin takes ``pinned_sum`` of the
    true-length vector instead, the order of the reference's default
    ``jnp`` selectors (``selection._stats``) and of the arena statistics
    (``seg_abs_sum_max``), so per-leaf and arena thresholds stay bitwise
    equal. The max (order-free) covers the zero padding, which cannot
    raise it."""
    ax = x2d.to(torch.float32).abs()
    return pinned_sum(ax.reshape(-1)[:n]), ax.max()


def compact_gt(x2d: torch.Tensor, threshold: torch.Tensor, cap_per_block: int,
               n: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per row, the first ``cap_per_block`` elements with |x| > threshold
    and global index < ``n``, packed to the front: (values [nb, cap],
    global i32 indices [nb, cap] padded with ``(0.0, n)``, pre-clamp
    counts [nb]). As ``repro.kernels.ref.compact_gt``; computed as the
    one-slot case of ``seg_compact_gt`` (slot-local index = global)."""
    nb, block = x2d.shape
    return seg_compact_gt(x2d, np.zeros(nb, np.int32),
                          np.arange(nb, dtype=np.int64) * block,
                          np.full(nb, n, np.int64),
                          threshold.reshape(1), cap_per_block)


def compact_gt_exact(x2d: torch.Tensor, threshold: torch.Tensor,
                     capacity: int, n: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The first ``capacity`` elements with |x| > threshold and global
    index < ``n``, in index order, padded with ``(0.0, n)``: (values f32
    [capacity], global i32 indices [capacity]). This is what
    ``repro.core.selection.threshold_filter`` selects
    (``jnp.nonzero(mask, size=capacity, fill_value=n)``); the reference
    has no kernel for it and falls back to that function after a bucket
    overflow."""
    flat = x2d.reshape(-1)[:n].to(torch.float32)
    idx = first_true(flat.abs() > threshold, capacity, n)
    vals = torch.where(idx < n, flat[idx.clamp(max=n - 1)],
                       torch.zeros((), dtype=torch.float32, device=flat.device))
    return vals, idx.to(torch.int32)


def residual_update(grad: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                    momentum: float, nesterov: bool
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Alg 4 lines 11-19: ``U' = m * U + g``, ``V' = V + U'`` (``+ g``
    with nesterov). Returns (U', V').

    Departs from ``repro.kernels.ref.residual_update``, whose ``m * U + g``
    is not pinned (XLA may contract it into one FMA): this twin rounds the
    product on its own, as ``residual.accumulate`` does, so it is bitwise
    that function."""
    g = grad.to(torch.float32)
    u_new = pinned_product(momentum, u) + g
    v_new = v + u_new
    if nesterov:
        v_new = v_new + g
    return u_new, v_new
