"""Helpers of the selectors shared with ``multi_select``.

Port of ``_cap_for`` and ``_gather_topk_from_buckets`` from
``src/repro/kernels/ops.py``. The per-leaf kernel compositions of that
module (``trimmed_topk``, ``threshold_binary_search``, ...) wait with
kernels 5-7 (see ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.core.selection import first_true, stable_topk_indices

DEFAULT_BLOCK = 1024


def _cap_for(capacity: int, nb: int, block: int) -> int:
    """Per-block bucket size for gathering ``capacity`` survivors: 4x the
    uniform per-block share, rounded to 8, clamped to the block."""
    per = -(-capacity // nb)
    return min(block, max(8, ((4 * per + 7) // 8) * 8))


def _gather_topk_from_buckets(vals: torch.Tensor, idx: torch.Tensor, k: int,
                              total: int, order_by_magnitude: bool
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pick k entries from the [nb, cap] buckets: by |value|, ties lowest
    bucket position first (trimmed top-k), or the first k valid slots in
    row-major order (binary-search filter); short picks pad with
    (total, 0)."""
    fv, fi = vals.reshape(-1), idx.reshape(-1)
    valid = fi < total
    if order_by_magnitude:
        score = torch.where(valid, fv.abs(), torch.full_like(fv, -1.0))
        pos = stable_topk_indices(score, k)
        ok = valid[pos]
    else:
        pos = first_true(valid, k, -1)
        ok = pos >= 0
        pos = pos.clamp(min=0)
    sel_idx = torch.where(ok, fi[pos], total)
    sel_val = torch.where(ok, fv[pos], torch.zeros_like(fv[pos]))
    return sel_idx.to(torch.int32), sel_val
