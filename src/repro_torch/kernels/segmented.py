"""Segmented kernels + selectors for the flat residual arenas.

Port of ``src/repro/kernels/segmented.py`` (exact, non-strided forms).
One arena coalesces many same-dtype leaves (``core.arena``); each kernel
runs ONCE over the whole arena while selection stays segmented — every
slot keeps its own ``k``, statistics, threshold and bucket capacity:

* ``seg_abs_sum_max`` — per-segment (sum|x|, max|x|);
* ``seg_count_gt``    — per-segment nnz(|x| > t_s), one launch per
                        search iteration for every segment;
* ``seg_compact_gt``  — block-bucketed compaction of every slot's
                        survivors with slot-local indices.

Each wrapper takes the plain twin (``kernels.ref``) for a CPU tensor and
launches its hand-written CUDA kernel (``csrc/segmented.cu``) for a CUDA
tensor; anything else raises. ``launches`` counts kernel launches per
wrapper (one per call on the card; the CPU path counts nothing).

``multi_select`` runs Algorithms 2 and 3 across every slot of every arena
with one count launch per search iteration. It follows the reference's
``use_pallas=False`` (jnp) semantics on both devices: the trimmed
fallback to exact top-k fires on bucket overflow OR when fewer than k
elements survive the last rung. Its search loop is a host loop: one
``.item()`` per iteration decides whether to go on.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.selection import (Selected, _pad_topk, bisect_midpoint,
                                        ladder_ratio, threshold_at,
                                        threshold_filter, warm_ratio)

from . import ref
from .ops import _cap_for, _gather_topk_from_buckets

__all__ = ["seg_abs_sum_max", "seg_count_gt", "seg_compact_gt", "seg_stats",
           "seg_mean", "SegmentSpec", "multi_select", "launches"]

ROW = 1024                       # arena row width the kernels are built for
LOG_COLS = 16                    # seg_abs_sum_max phase-1 columns: <= 2^16

# Kernel launches per wrapper since the last reset (plain ints; chip_smoke
# zeroes them before the main path and reads them after).
launches = {"seg_abs_sum_max": 0, "seg_count_gt": 0, "seg_compact_gt": 0}


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("segmented")
    lib.seg_abs_sum_max_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I,
                                           _P, _P, _P, _P, _P]
    lib.seg_count_gt_launch.argtypes = [_P, _P, _P, _I, _P, _P]
    lib.seg_compact_gt_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I,
                                          _P, _P, _P, _P]
    for fn in (lib.seg_abs_sum_max_launch, lib.seg_count_gt_launch,
               lib.seg_compact_gt_launch):
        fn.restype = _I
    return lib


class _DeviceMaps(NamedTuple):
    """A geometry's maps as device tensors (built once per device)."""
    block_seg: torch.Tensor   # i32[nb]
    block_base: torch.Tensor  # i32[nb]
    block_size: torch.Tensor  # i32[nb]
    seg_off: torch.Tensor     # i64[n_seg] first element of each slot
    seg_n: torch.Tensor       # i32[n_seg] true slot size
    seg_logc: torch.Tensor    # i32[n_seg] log2 of phase-1 columns
    seg_logr: torch.Tensor    # i32[n_seg] log2 of phase-1 rows
    cmax: int


def _device_maps(geom, device: torch.device) -> _DeviceMaps:
    key = str(device)
    if key not in geom.device_maps:
        logp = [max(0, int(n - 1).bit_length()) for n in geom.seg_sizes]
        logc = [min(p, LOG_COLS) for p in logp]

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=device)
        geom.device_maps[key] = _DeviceMaps(
            i32(geom.block_seg), i32(geom.block_base), i32(geom.block_size),
            torch.as_tensor(np.asarray([r0 * geom.block
                                        for r0, _ in geom.seg_rows],
                                       np.int64), device=device),
            i32(geom.seg_sizes), i32(logc),
            i32([p - c for p, c in zip(logp, logc)]),
            1 << max(logc))
    return geom.device_maps[key]


def _check_launch(x2d: torch.Tensor, geom, name: str) -> None:
    if x2d.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x2d.device}")
    if (x2d.dtype != torch.float32 or not x2d.is_contiguous()
            or x2d.dim() != 2 or x2d.shape[1] != ROW
            or x2d.shape[0] != geom.nblocks or x2d.data_ptr() % 16):
        raise ValueError(
            f"{name}: expects a contiguous 16-byte-aligned f32 "
            f"[{geom.nblocks}, {ROW}] arena, got {x2d.dtype} "
            f"{tuple(x2d.shape)}")
    if geom.n_seg > 65535:
        raise ValueError(f"{name}: at most 65535 segments per launch")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def seg_abs_sum_max(x2d: torch.Tensor, geom
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment (sum|x|, max|x|) over [nb, 1024] arena rows; the sum is
    ``selection.pinned_sum`` of each slot's true-length vector, bitwise.
    """
    if x2d.device.type == "cpu":
        return ref.seg_abs_sum_max(x2d, geom.block_seg, geom.block_size,
                                   geom.n_seg)
    _check_launch(x2d, geom, "seg_abs_sum_max")
    m = _device_maps(geom, x2d.device)
    part = torch.empty((2, geom.n_seg, m.cmax), dtype=torch.float32,
                       device=x2d.device)
    out = torch.empty((2, geom.n_seg), dtype=torch.float32,
                      device=x2d.device)
    rc = _lib().seg_abs_sum_max_launch(
        x2d.data_ptr(), m.seg_off.data_ptr(), m.seg_n.data_ptr(),
        m.seg_logc.data_ptr(), m.seg_logr.data_ptr(), geom.n_seg, m.cmax,
        part[0].data_ptr(), part[1].data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), _stream())
    _raise_on(rc, "seg_abs_sum_max")
    launches["seg_abs_sum_max"] += 1
    return out[0], out[1]


def seg_count_gt(x2d: torch.Tensor, geom, thresholds: torch.Tensor
                 ) -> torch.Tensor:
    """Per-segment nnz(|x| > thresholds[seg]) as i32 — one launch per
    search iteration for the whole (super-)arena."""
    if x2d.device.type == "cpu":
        return ref.seg_count_gt(x2d, geom.block_seg, thresholds, geom.n_seg)
    _check_launch(x2d, geom, "seg_count_gt")
    m = _device_maps(geom, x2d.device)
    thr = thresholds.to(torch.float32).contiguous()
    out = torch.zeros(geom.n_seg, dtype=torch.int32, device=x2d.device)
    rc = _lib().seg_count_gt_launch(
        x2d.data_ptr(), m.block_seg.data_ptr(), thr.data_ptr(),
        geom.nblocks, out.data_ptr(), _stream())
    _raise_on(rc, "seg_count_gt")
    launches["seg_count_gt"] += 1
    return out


def seg_compact_gt(x2d: torch.Tensor, geom, thresholds: torch.Tensor,
                   cap_per_block: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per row, the first ``cap_per_block`` survivors of |x| > thr[seg]:
    (values [nb, cap], slot-local i32 indices [nb, cap] padded with the
    slot size, pre-clamp counts [nb])."""
    if x2d.device.type == "cpu":
        return ref.seg_compact_gt(x2d, geom.block_seg, geom.block_base,
                                  geom.block_size, thresholds, cap_per_block)
    _check_launch(x2d, geom, "seg_compact_gt")
    if not 1 <= cap_per_block <= ROW:
        raise ValueError(f"seg_compact_gt: cap {cap_per_block} not in "
                         f"[1, {ROW}]")
    m = _device_maps(geom, x2d.device)
    thr = thresholds.to(torch.float32).contiguous()
    nb = geom.nblocks
    vals = torch.empty((nb, cap_per_block), dtype=torch.float32,
                       device=x2d.device)
    idx = torch.empty((nb, cap_per_block), dtype=torch.int32,
                      device=x2d.device)
    cnt = torch.empty(nb, dtype=torch.int32, device=x2d.device)
    rc = _lib().seg_compact_gt_launch(
        x2d.data_ptr(), m.block_seg.data_ptr(), m.block_base.data_ptr(),
        m.block_size.data_ptr(), thr.data_ptr(), nb, cap_per_block,
        vals.data_ptr(), idx.data_ptr(), cnt.data_ptr(), _stream())
    _raise_on(rc, "seg_compact_gt")
    launches["seg_compact_gt"] += 1
    return vals, idx, cnt


# ---------------------------------------------------------------------------
# Segmented selectors (Algorithm 2/3 across all slots at once)
# ---------------------------------------------------------------------------

def seg_mean(sums: torch.Tensor, geom) -> torch.Tensor:
    """Per-segment mean: the pinned f32-reciprocal multiply of
    ``selection.mean_of_sum``, vectorized over slots."""
    recip = torch.tensor([np.float32(1.0 / n) for n in geom.seg_sizes],
                         dtype=torch.float32, device=sums.device)
    return sums * recip


def seg_stats(x2d: torch.Tensor, geom) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment (mean|x|, max|x|)."""
    sums, maxs = seg_abs_sum_max(x2d, geom)
    return seg_mean(sums, geom), maxs


def _slot_flat(x2d: torch.Tensor, geom, s: int) -> torch.Tensor:
    """Slot ``s`` as the flat f32[size] vector the per-leaf path sees."""
    r0, r1 = geom.seg_rows[s]
    return x2d[r0:r1].reshape(-1)[:geom.seg_sizes[s]]


class SegmentSpec(NamedTuple):
    """One arena's selection request for ``multi_select`` (see the
    reference): the search ``alg``, its ``eps``, optional per-slot message
    ``capacities``, and the §5.2.2 reuse / warm-start runtime fields."""
    alg: str                                # "trimmed" | "bsearch"
    eps: float
    capacities: tuple[int, ...] = ()
    refresh: torch.Tensor | None = None     # bool[n_seg]
    cached: torch.Tensor | None = None      # f32[n_seg]
    warm: bool = False


def _norm_caps(spec: SegmentSpec, geom) -> tuple[int, ...]:
    if spec.capacities:
        return tuple(spec.capacities)
    if spec.alg == "trimmed":
        return tuple(geom.seg_ks)
    return tuple(2 * k for k in geom.seg_ks)


def multi_select(parts: list[tuple[torch.Tensor, Any, SegmentSpec,
                                   tuple[torch.Tensor, torch.Tensor] | None]]
                 ) -> list[tuple[list[Selected], torch.Tensor]]:
    """Algorithm 2 AND 3 across every slot of every arena, ONE count
    launch per search iteration.

    ``parts`` is ``[(x2d, geometry, SegmentSpec, stats-or-None), ...]``.
    The arenas are row-stacked into one super-arena; trimmed segments
    step their pinned ratio ladder and bsearch segments bisect their
    bracket in one loop; converged (or reuse / warm-accepted) segments
    are FROZEN, so each walks exactly its per-leaf iterate sequence.
    Returns one ``(selections, thresholds)`` pair per part, in order.
    """
    geoms = [p[1] for p in parts]
    specs = [p[2] for p in parts]
    if len(parts) == 1:
        x_all, geom_all = parts[0][0], geoms[0]
    else:
        from repro_torch.core.arena import stack_geometries
        x_all = torch.cat([p[0] for p in parts], dim=0)
        geom_all = stack_geometries(geoms)
    dev = x_all.device

    n = geom_all.n_seg
    k_vec = torch.tensor(geom_all.seg_ks, dtype=torch.int32, device=dev)
    two_k = 2 * k_vec

    # --- static per-segment vectors -------------------------------------
    trim_np = np.concatenate([
        np.full(g.n_seg, s.alg == "trimmed") for g, s in zip(geoms, specs)])
    eps_np = np.concatenate([
        np.full(g.n_seg, s.eps, np.float32) for g, s in zip(geoms, specs)])
    warm_np = np.concatenate([
        np.full(g.n_seg, bool(s.warm) and s.alg == "bsearch")
        for g, s in zip(geoms, specs)])
    caps_sel = sum((_norm_caps(s, g) for g, s in zip(geoms, specs)), ())
    is_trim = torch.as_tensor(trim_np, device=dev)
    eps_vec = torch.as_tensor(eps_np, device=dev)
    warm_vec = torch.as_tensor(warm_np, device=dev)
    any_trim = bool(trim_np.any())
    any_warm = bool(warm_np.any())

    # --- runtime per-segment vectors ------------------------------------
    refresh = torch.cat([
        s.refresh.reshape(-1).to(dev) if s.refresh is not None
        else torch.ones(g.n_seg, dtype=torch.bool, device=dev)
        for g, s in zip(geoms, specs)])
    have_cached = any(s.cached is not None for s in specs)
    cached = torch.cat([
        s.cached.reshape(-1).to(device=dev, dtype=torch.float32)
        if s.cached is not None
        else torch.zeros(g.n_seg, dtype=torch.float32, device=dev)
        for g, s in zip(geoms, specs)])

    # --- statistics (per-segment — independent of arena grouping) -------
    if all(p[3] is None for p in parts):
        mean, mx = seg_stats(x_all, geom_all)
    else:
        means, maxs = [], []
        for (x2d, geom, _spec, stats) in parts:
            if stats is None:
                stats = seg_stats(x2d, geom)
            means.append(stats[0])
            maxs.append(stats[1])
        mean, mx = torch.cat(means), torch.cat(maxs)

    def count_est(thr):
        return seg_count_gt(x_all, geom_all, thr)

    def in_band(nz):
        return (nz >= k_vec) & (nz <= two_k)

    # --- initial probe: trimmed rung 1 + warm cached thresholds ---------
    step = torch.ones(n, dtype=torch.int32, device=dev)
    zeros_f = torch.zeros(n, dtype=torch.float32, device=dev)
    ones_f = torch.ones(n, dtype=torch.float32, device=dev)
    if any_trim or any_warm:
        thr0 = torch.where(
            is_trim, threshold_at(mean, mx, ladder_ratio(step, eps_vec)),
            cached)
        cnt0 = count_est(thr0)
        accept = warm_vec & refresh & ~is_trim & in_band(cnt0)
        use0 = is_trim | warm_vec
        nnz = torch.where(use0, cnt0, torch.full_like(cnt0, -1))
        r_prev = warm_ratio(cached, mean, mx)
        seed = warm_vec & ~is_trim
        l = torch.where(seed & (cnt0 > two_k), r_prev, zeros_f)
        r = torch.where(seed & (cnt0 < k_vec), r_prev, ones_f)
    else:
        accept = torch.zeros(n, dtype=torch.bool, device=dev)
        nnz = torch.full((n,), -1, dtype=torch.int32, device=dev)
        l, r = zeros_f, ones_f

    # --- unified search loop: one count launch per iteration ------------
    def trim_active(step, nnz):
        return is_trim & (nnz < k_vec) & (ladder_ratio(step, eps_vec) > 0.0)

    def bs_active(l, r, nnz):
        return (~is_trim & refresh & ~accept & ~in_band(nnz)
                & ((r - l) > eps_vec))

    while True:
        ta = trim_active(step, nnz)
        ba = bs_active(l, r, nnz)
        if not bool((ta | ba).any()):
            break
        step = torch.where(ta, step + 1, step)
        ratio_b = bisect_midpoint(l, r)
        ratio = torch.where(is_trim, ladder_ratio(step, eps_vec), ratio_b)
        cnt = count_est(threshold_at(mean, mx, ratio))
        nnz = torch.where(ta | ba, cnt, nnz)
        r = torch.where(ba & (cnt < k_vec), ratio_b, r)
        l = torch.where(ba & (cnt > two_k), ratio_b, l)
    nnz_loop = nnz

    ratio_fin = torch.where(is_trim, ladder_ratio(step, eps_vec),
                            bisect_midpoint(l, r))
    thr = threshold_at(mean, mx, ratio_fin)
    if any_warm:
        thr = torch.where(accept, cached, thr)
    if have_cached:
        thr = torch.where(is_trim | refresh, thr, cached)

    # --- one full count + one compaction for every arena ----------------
    nnz_full = seg_count_gt(x_all, geom_all, thr)
    caps = [_cap_for(2 * k if t else max(2 * k, c), r1 - r0, geom_all.block)
            for t, k, c, (r0, r1) in zip(
                trim_np, geom_all.seg_ks, caps_sel, geom_all.seg_rows)]
    vals, idx, cnts = seg_compact_gt(x_all, geom_all, thr, max(caps))

    # --- per-slot gathers from the short buckets ------------------------
    picks, flags = [], []
    for s in range(n):
        row0, row1 = geom_all.seg_rows[s]
        cap, k, size = caps[s], geom_all.seg_ks[s], geom_all.seg_sizes[s]
        overflow = (cnts[row0:row1] > cap).any()
        if trim_np[s]:
            picks.append(_gather_topk_from_buckets(
                vals[row0:row1, :cap], idx[row0:row1, :cap], k, size,
                order_by_magnitude=True))
            # mirror selection.trimmed_topk: the full top-k pads with real
            # zero-score indices when fewer than k survive
            flags.append(overflow | (nnz_loop[s] < k))
        else:
            picks.append(_gather_topk_from_buckets(
                vals[row0:row1, :cap], idx[row0:row1, :cap], caps_sel[s],
                size, order_by_magnitude=False))
            flags.append(overflow)
    fallback = torch.stack(flags).tolist()       # one host sync for all

    results: list[tuple[list[Selected], torch.Tensor]] = []
    seg0 = 0
    for (x2d, geom, _spec, _stats) in parts:
        out: list[Selected] = []
        for sl in range(geom.n_seg):
            s = seg0 + sl
            si, sv = picks[s]
            if trim_np[s]:
                if fallback[s]:
                    flat = _slot_flat(x2d, geom, sl)
                    ax = flat.abs()
                    e = _pad_topk(flat, torch.where(ax > thr[s], ax,
                                                    torch.zeros_like(ax)),
                                  geom.seg_ks[sl])
                    si, sv = e.indices, e.values
                out.append(Selected(si, sv, torch.tensor(
                    geom.seg_ks[sl], dtype=torch.int32, device=dev)))
            else:
                if fallback[s]:
                    e = threshold_filter(_slot_flat(x2d, geom, sl), thr[s],
                                         capacity=caps_sel[s])
                    si, sv = e.indices, e.values
                out.append(Selected(
                    si, sv, torch.clamp(nnz_full[s], max=caps_sel[s]),
                    nnz_full[s] > caps_sel[s]))
        results.append((out, thr[seg0:seg0 + geom.n_seg]))
        seg0 += geom.n_seg
    return results
