"""Communication-set selection (RedSync §5.2, Algorithms 2/3).

Port of ``src/repro/core/selection.py`` (the ``*_quant`` variants wait).
Every selector takes a flat f32 residual vector and returns a
fixed-capacity ``Selected(indices, values, count)``; padding uses index
== size and value 0, exactly as the reference.

Bitwise parity with the reference rests on three rules:

* the pinned scalar arithmetic (``pinned_sum``, ``threshold_at``,
  ``bisect_midpoint``, ``ladder_ratio``, ``warm_ratio``) is written as
  separate eager ops, each rounded once — eager PyTorch never contracts
  a multiply into an add;
* ``jax.lax.top_k`` breaks ties lowest index first, ``torch.topk``
  promises no order, so ranking uses a STABLE descending sort;
* ``jnp.nonzero(mask, size=cap, fill_value=n)`` is ``first_true``,
  which keeps the first ``cap`` true positions in index order without a
  host synchronisation.

The search loops (``jax.lax.while_loop`` in the reference) are host
loops here: one ``.item()`` per iteration decides whether to go on.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .residual import pinned_product


class Selected(NamedTuple):
    """Fixed-capacity sparse communication set (see the reference)."""
    indices: torch.Tensor                 # i32[cap], padded entries == size
    values: torch.Tensor                  # f32[cap] (zeros at padding)
    count: torch.Tensor                   # i32[] true number selected
    overflow: torch.Tensor | None = None  # bool[] nnz exceeded capacity


# Slot alignment granule of the flat residual arenas (repro's
# selection.STATS_BLOCK; the CUDA kernels' row width).
STATS_BLOCK = 1024


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def pinned_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum with the reference's pinned tree: zero-pad to a power of two
    and halve with elementwise adds (``flat[:h] + flat[h:]``)."""
    flat = v.reshape(-1)
    size = 1 << max(0, int(flat.numel() - 1).bit_length())
    flat = F.pad(flat, (0, size - flat.numel()))
    while flat.numel() > 1:
        half = flat.numel() // 2
        flat = flat[:half] + flat[half:]
    return flat[0]


def mean_of_sum(total: torch.Tensor, n) -> torch.Tensor:
    """``total / n`` as a multiply by the f32 reciprocal (computed in
    double and rounded once, as ``jnp.float32(1.0 / n)``)."""
    if isinstance(n, (int, float)):
        return pinned_product(total, _f32(1.0 / n, total))
    return pinned_product(total, _f32(1.0, total) / n.to(torch.float32))


def _stats(ax: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return mean_of_sum(pinned_sum(ax), ax.numel()), ax.max()


def threshold_at(mean, mx, ratio):
    """The Alg 2/3 candidate threshold ``mean + ratio * (mx - mean)``."""
    return mean + pinned_product(ratio, mx - mean)


def bisect_midpoint(l, r):
    """``l + 0.5 * (r - l)``, the reference's pinned halving."""
    return l + pinned_product(_f32(0.5, l), r - l)


def ladder_ratio(step: torch.Tensor, eps) -> torch.Tensor:
    """Alg 2 ratio after ``step`` rungs: ``1 - step * eps`` (f32)."""
    eps = torch.as_tensor(eps, dtype=torch.float32, device=step.device)
    return _f32(1.0, step) - pinned_product(step.to(torch.float32), eps)


def warm_ratio(thr, mean, mx):
    """A previous threshold's ratio coordinate under the current stats,
    clipped into ``[0, 1]``; degenerate spans map to 0."""
    span = mx - mean
    safe = torch.maximum(span, _f32(1e-30, span))
    r = pinned_product(thr - mean, _f32(1.0, span) / safe)
    r = torch.where(span > 0, r, _f32(0.0, span))
    return torch.clamp(r, 0.0, 1.0)


def first_true(mask: torch.Tensor, capacity: int, fill: int) -> torch.Tensor:
    """Positions (int64) of the first ``capacity`` True entries of a 1-D
    mask, padded with ``fill`` — ``jnp.nonzero(mask, size=capacity,
    fill_value=fill)`` without a host synchronisation. Survivors go to
    their rank; the rest land in one dump slot that is cut off."""
    pos = torch.cumsum(mask, 0) - 1
    tgt = torch.where(mask & (pos < capacity), pos, capacity)
    out = torch.full((capacity + 1,), fill, dtype=torch.int64,
                     device=mask.device)
    out.scatter_(0, tgt, torch.arange(mask.numel(), device=mask.device))
    return out[:capacity]


def stable_topk_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest scores, ties lowest index first (the
    order ``jax.lax.top_k`` gives)."""
    return torch.sort(score, descending=True, stable=True).indices[:k]


def _pad_topk(x: torch.Tensor, score: torch.Tensor, k: int) -> Selected:
    """Exact top-k by ``score``; values taken from ``x``."""
    idx = stable_topk_indices(score, k)
    return Selected(idx.to(torch.int32), x[idx],
                    torch.tensor(k, dtype=torch.int32, device=x.device))


def exact_topk(x: torch.Tensor, k: int) -> Selected:
    return _pad_topk(x, x.abs(), k)


def trimmed_topk(x: torch.Tensor, k: int, eps: float = 0.2) -> Selected:
    """Alg 2: walk the ratio ladder until >= k survive, then top-k the
    survivors (trimmed elements score 0)."""
    ax = x.abs()
    mean, mx = _stats(ax)
    step = torch.tensor(1, dtype=torch.int32, device=x.device)
    nnz = (ax > threshold_at(mean, mx, ladder_ratio(step, eps))).sum()
    while bool((nnz < k) & (ladder_ratio(step, eps) > 0.0)):
        step = step + 1
        nnz = (ax > threshold_at(mean, mx, ladder_ratio(step, eps))).sum()
    thr = threshold_at(mean, mx, ladder_ratio(step, eps))
    trimmed_score = torch.where(ax > thr, ax, _f32(0.0, ax))
    return _pad_topk(x, trimmed_score, k)


def search_band(count_at, mean, mx, k: int, eps: float,
                warm: torch.Tensor | None = None) -> torch.Tensor:
    """The Alg 3 bisection: a threshold t with ``k <= count_at(t) <= 2k``,
    optionally warm-started from the previous converged threshold (see
    the reference's docstring for the bracket rule)."""
    eps_t = _f32(eps, mean)

    def in_band(n):
        return (n >= k) & (n <= 2 * k)

    if warm is None:
        l, r = _f32(0.0, mean), _f32(1.0, mean)
        nnz = torch.tensor(-1, device=mean.device)
    else:
        nnz = count_at(warm)
        accept = in_band(nnz)
        r_prev = warm_ratio(warm, mean, mx)
        l = torch.where(nnz > 2 * k, r_prev, _f32(0.0, mean))
        r = torch.where(nnz < k, r_prev, _f32(1.0, mean))

    while bool(~in_band(nnz) & ((r - l) > eps_t)):
        ratio = bisect_midpoint(l, r)
        nnz = count_at(threshold_at(mean, mx, ratio))
        # nnz too small -> threshold too high -> move right bound down
        r = torch.where(nnz < k, ratio, r)
        l = torch.where(nnz > 2 * k, ratio, l)
    thr = threshold_at(mean, mx, bisect_midpoint(l, r))
    if warm is not None:
        thr = torch.where(accept, warm, thr)
    return thr


def threshold_binary_search(x: torch.Tensor, k: int, eps: float = 1e-3,
                            threshold: torch.Tensor | None = None, *,
                            warm: torch.Tensor | None = None
                            ) -> tuple[Selected, torch.Tensor]:
    """Alg 3: a threshold t with k <= nnz(|x|>t) <= 2k, then the first-2k
    filter. ``threshold`` is the §5.2.2 reuse short-circuit."""
    if threshold is not None:
        return threshold_filter(x, threshold, capacity=2 * k), threshold
    ax = x.abs()
    mean, mx = _stats(ax)
    thr = search_band(lambda t: (ax > t).sum(), mean, mx, k, eps, warm)
    return threshold_filter(x, thr, capacity=2 * k), thr


def threshold_filter(x: torch.Tensor, threshold: torch.Tensor,
                     capacity: int) -> Selected:
    """All elements with |x| > threshold, first-``capacity`` in index
    order, padded; ``count`` saturates and ``overflow`` flags the drop."""
    x = x.reshape(-1)
    n = x.numel()
    mask = x.abs() > threshold
    nnz = mask.sum()
    idx = first_true(mask, capacity, n)
    vals = torch.where(idx < n, x[idx.clamp(max=n - 1)], _f32(0.0, x))
    return Selected(idx.to(torch.int32), vals,
                    torch.clamp(nnz, max=capacity).to(torch.int32),
                    nnz > capacity)
