"""The per-leaf selectors (Algorithms 2 and 3), composed from the
per-leaf kernels.

Port of ``src/repro/kernels/ops.py``:

    trimmed_topk            = abs_sum_max -> ratio ladder (count_gt)
                              -> compact_gt -> top-k of the buckets
    threshold_binary_search = abs_sum_max -> bisection (count_gt)
                              -> count_gt + compact_gt -> first-2k gather
    threshold_filter        = count_gt + compact_gt -> first-capacity gather

When a row's survivors overflow its bucket, ``compact_gt_exact`` writes
every survivor (the filter: the first ``capacity``) to one dense list in
index order in one pass over the leaf, and the gather reads that list
instead: the selection stays on the kernels. The one plain step is the
short pick of a trimmed top-k whose ladder ran out with fewer than k
survivors, which reads only the leaf's first k elements
(``_short_pick``). ``pick_trimmed`` and ``pick_first`` hold these
branches; ``segmented.multi_select`` runs them on each arena slot too.
``common.branches`` counts both branches on either device.

The kernel wrappers (``threshold_count``, ``block_stats``, ``compact``)
pick the device: the CUDA kernel for a CUDA tensor, the plain twin for a
CPU tensor, so the CPU runs the very composition the card runs. Every
result is bitwise what the reference's default ``jnp`` selectors return
(``selection.trimmed_topk``, ``threshold_binary_search``,
``threshold_filter``), which the reference's Pallas compositions are not
in two places (ROADMAP.md §3):

* the statistics sum in ``pinned_sum`` order (``block_stats``);
* ``trimmed_topk`` takes the compressor's ``eps``, and after a bucket
  overflow or a short pick returns the exact top-k of the trimmed
  scores (the rule ``multi_select`` follows); the reference's Pallas
  composition falls back on overflow only, to an untrimmed exact top-k.

The quantized selectors (§5.2.3) run the same compositions on the signed
score (``selection._signed_score``, >= +0.0 everywhere, so ``|score| >
t`` is ``score > t``), then take the values from the leaf itself at the
selected indices and quantize them (``selection._quantize``):

    threshold_binary_search_quant = threshold_binary_search(score), cold
    trimmed_topk_quant            = trimmed_topk(score)

bitwise the reference's ``selection.*_quant``. ``exact_topk_quant``
has no kernel form in either package (a sort).

The reference's ``ops.residual_update`` is ``residual_update.residual_update``
on flat leaves, which ``residual.accumulate`` calls. The search loops are
host loops: one ``.item()`` per iteration decides whether to go on.
"""
from __future__ import annotations

import torch

from repro_torch.core.selection import (Selected, _quantize, _signed_score,
                                        first_true, gather_values,
                                        ladder_ratio, mean_of_sum,
                                        search_band, stable_topk_indices,
                                        threshold_at)

from . import block_stats, compact, threshold_count
from .common import branches

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


def _flat(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).to(torch.float32).contiguous()


def _nb(n: int) -> int:
    return max(1, -(-n // DEFAULT_BLOCK))


def stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean|x|, max|x|): the pinned sum times the f32 reciprocal of n."""
    x = _flat(x)
    s, m = block_stats.abs_sum_max(x)
    return mean_of_sum(s, x.numel()), m


def nnz_gt(x: torch.Tensor, threshold: torch.Tensor) -> torch.Tensor:
    return threshold_count.count_gt(_flat(x), threshold)


def trimmed_topk(x: torch.Tensor, k: int, *, eps: float = 0.2) -> Selected:
    """Algorithm 2 on the per-leaf kernels; capacity == k."""
    x = _flat(x)
    n = x.numel()
    mean, mx = stats(x)
    step = torch.tensor(1, dtype=torch.int32, device=x.device)
    nnz = threshold_count.count_gt(
        x, threshold_at(mean, mx, ladder_ratio(step, eps)))
    while bool((nnz < k) & (ladder_ratio(step, eps) > 0.0)):
        step = step + 1
        nnz = threshold_count.count_gt(
            x, threshold_at(mean, mx, ladder_ratio(step, eps)))
    thr = threshold_at(mean, mx, ladder_ratio(step, eps))

    cap = _cap_for(2 * k, _nb(n), DEFAULT_BLOCK)
    vals, idx, counts = compact.compact_gt(x, thr, cap)
    over, short, alive = torch.stack(
        ((counts > cap).any().long(), (nnz < k).long(),
         counts.sum().long())).tolist()
    si, sv = pick_trimmed(x, thr, k, vals, idx, over, short, alive)
    return Selected(si, sv, torch.tensor(k, dtype=torch.int32,
                                         device=x.device))


def pick_trimmed(x: torch.Tensor, thr: torch.Tensor, k: int,
                 vals: torch.Tensor, idx: torch.Tensor, over: bool,
                 short: bool, alive: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The trimmed top-k of flat ``x`` at ``thr`` from its survivor
    buckets (``vals``, ``idx``): after a bucket overflow, from the exact
    list of every survivor (``alive`` of them; at least k slots, so a
    short pick still ranks all of them); with fewer than k survivors,
    completed by the short pick. Returns (indices, values)."""
    if over:
        branches["exact_compaction"] += 1
        vals, idx = compact.compact_gt_exact(x, thr, max(k, alive))
    si, sv = _gather_topk_from_buckets(vals, idx, k, x.numel(),
                                       order_by_magnitude=True)
    if short:
        branches["short_pick"] += 1
        si, sv = _short_pick(x, thr, si, sv, k)
    return si, sv


def pick_first(x: torch.Tensor, thr: torch.Tensor, capacity: int,
               vals: torch.Tensor, idx: torch.Tensor, over: bool
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The first ``capacity`` survivors of flat ``x`` at ``thr`` in index
    order, from its survivor buckets, or after a bucket overflow from the
    exact form. Returns (indices, values)."""
    if over:
        branches["exact_compaction"] += 1
        sv, si = compact.compact_gt_exact(x, thr, capacity)
        return si, sv
    return _gather_topk_from_buckets(vals, idx, capacity, x.numel(),
                                     order_by_magnitude=False)


def _short_pick(x: torch.Tensor, thr: torch.Tensor, si: torch.Tensor,
                sv: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Fewer than k survivors: the exact top-k of the trimmed scores
    (``where(|x| > thr, |x|, 0)``, ties lowest index first) is the P
    survivors of score > 0, ranked (the head of ``si``), then the first
    k - P elements of score 0 in index order. P <= nnz < k, so those lie
    in x[:k]: only that prefix is read."""
    n = x.numel()
    ah = x[:k].abs()
    zero = first_true(~((ah > thr) & (ah > 0)), k, n)
    p = ((si < n) & (sv != 0)).sum()
    j = torch.arange(k, device=x.device)
    pick = torch.where(j < p, si.to(torch.int64), zero[(j - p).clamp(min=0)])
    return pick.to(torch.int32), x[pick]


def threshold_binary_search(x: torch.Tensor, k: int, *, eps: float = 1e-3,
                            warm: torch.Tensor | None = None
                            ) -> tuple[Selected, torch.Tensor]:
    """Algorithm 3 on the per-leaf kernels; capacity == 2k. ``warm`` seeds
    the bracket from the previous threshold (``selection.search_band``);
    ``None`` is the cold search. Returns (selection, threshold)."""
    x = _flat(x)
    mean, mx = stats(x)
    thr = search_band(lambda t: threshold_count.count_gt(x, t), mean, mx, k,
                      eps, warm)
    return _filter(x, thr, 2 * k), thr


def threshold_filter(x: torch.Tensor, threshold: torch.Tensor,
                     capacity: int) -> Selected:
    """First-``capacity`` |x| > threshold filter on the per-leaf kernels
    (the §5.2.2 reuse step), with ``selection.threshold_filter``'s
    overflow semantics and count header."""
    return _filter(_flat(x), threshold, capacity)


def _filter(x: torch.Tensor, thr: torch.Tensor, capacity: int) -> Selected:
    """count -> compact -> first-``capacity`` gather; after a bucket
    overflow, the first ``capacity`` survivors from the exact form."""
    nnz = threshold_count.count_gt(x, thr)
    cap = _cap_for(capacity, _nb(x.numel()), DEFAULT_BLOCK)
    vals, idx, counts = compact.compact_gt(x, thr, cap)
    si, sv = pick_first(x, thr, capacity, vals, idx,
                        bool((counts > cap).any()))
    return Selected(si, sv, torch.clamp(nnz, max=capacity).to(torch.int32),
                    nnz > capacity)


def threshold_binary_search_quant(x: torch.Tensor, k: int, phase, *,
                                  eps: float = 1e-3) -> Selected:
    """The quantized Alg 3 on the per-leaf kernels: a cold search on the
    signed score (threshold reuse is off under quantization), the
    first-2k filter, values from ``x``, quantized. capacity == 2k."""
    x = _flat(x)
    sel, _ = threshold_binary_search(_signed_score(x, phase), k, eps=eps)
    return _from_leaf(x, sel)


def trimmed_topk_quant(x: torch.Tensor, k: int, phase, *,
                       eps: float = 0.2) -> Selected:
    """The quantized Alg 2 on the per-leaf kernels: the trimmed top-k of
    the signed score, values from ``x``, quantized. capacity == k."""
    x = _flat(x)
    return _from_leaf(x, trimmed_topk(_signed_score(x, phase), k, eps=eps))


def _from_leaf(x: torch.Tensor, sel: Selected) -> Selected:
    """A selection made on the score, with the leaf's own values at its
    indices, quantized."""
    return _quantize(sel._replace(values=gather_values(x, sel.indices)),
                     x.numel())
