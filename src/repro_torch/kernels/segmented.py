"""Segmented kernels + selectors for the flat residual arenas.

Port of ``src/repro/kernels/segmented.py``. One arena coalesces many
same-dtype leaves (``core.arena``); each kernel runs ONCE over the whole
arena while selection stays segmented — every slot keeps its own ``k``,
statistics, threshold and bucket capacity:

* ``seg_abs_sum_max`` — per-segment (sum|x|, max|x|), over the whole slot
                        or, with ``stride_seg``, its ``[::stride]``
                        subsample (the sampled selector's statistics);
* ``seg_count_gt``    — per-segment nnz(|x| > t_s), one launch per
                        search iteration for every segment; with
                        ``stride_seg`` only the stride grid is counted;
* ``seg_compact_gt``  — block-bucketed compaction of every slot's
                        survivors with slot-local indices;
* ``seg_residual_update_stats`` — the residual update (Alg 4) and the
                        (optionally strided) statistics of the updated
                        residual in one pass over the arena.

Each wrapper takes the plain twin (``kernels.ref``) for a CPU tensor and
launches its hand-written CUDA kernel (``csrc/segmented.cu``) for a CUDA
tensor; anything else raises. ``launches`` (``kernels.common``) counts
kernel launches per wrapper and form (one per call on the card; the CPU
path counts nothing).

``multi_select`` runs Algorithms 2 and 3 across every slot of every arena
with one count launch per search iteration; sampled slots (a stride > 1
in their ``SegmentSpec``) search on strided statistics and strided
counts scaled by the stride, and the final count stays exact. It follows
the reference's ``use_pallas=False`` (jnp) semantics on both devices: the
trimmed slots' exact top-k of the trimmed scores on a bucket overflow OR
when fewer than k elements survive the last rung, the filter slots' first
``capacity`` survivors on a bucket overflow. It reaches them as the
per-leaf selectors do (``ops.pick_trimmed``, ``ops.pick_first``): the
slot's survivors from the exact compaction ``compact.compact_gt_exact``
on its flat view, and the short pick; no whole-slot filter or sort runs.
``common.branches`` counts both. Its search loop is a host loop: one
``.item()`` per iteration decides whether to go on, and one more sync
reads every slot's overflow, short flag and survivor total.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.selection import (Selected, bisect_midpoint,
                                        ladder_ratio, threshold_at,
                                        warm_ratio)

from . import ref
from .common import F as _F, I as _I, L as _L, LOG_COLS, P as _P, ROW
from .common import launches, raise_on as _raise_on, stream as _stream
from .ops import _cap_for, pick_first, pick_trimmed

__all__ = ["seg_abs_sum_max", "seg_count_gt", "seg_compact_gt",
           "seg_residual_update_stats", "seg_stats", "seg_mean",
           "SegmentSpec", "multi_select", "launches"]


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    from .build import load
    lib = load("segmented")
    lib.seg_abs_sum_max_launch.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I,
                                           _P, _P, _P, _P, _P]
    lib.seg_abs_sum_max_strided_launch.argtypes = [_P, _P, _P, _P, _I, _I,
                                                   _P, _P, _P, _P, _P]
    lib.seg_count_gt_launch.argtypes = [_P, _P, _P, _I, _P, _P]
    lib.seg_count_gt_strided_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I,
                                                 _P, _P, _P, _P]
    lib.seg_residual_update_stats_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _F, _I, _F, _I, _P, _P, _P, _P, _P, _P, _I,
        _I, _P, _P, _P, _P, _P]
    lib.seg_compact_gt_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I,
                                          _P, _P, _P, _P]
    lib.launch_floor_launch.argtypes = [_I, _I, _P]
    lib.seg_strided_log_g.argtypes = [_L]
    for fn in (lib.seg_abs_sum_max_launch, lib.seg_abs_sum_max_strided_launch,
               lib.seg_count_gt_launch, lib.seg_count_gt_strided_launch,
               lib.seg_residual_update_stats_launch,
               lib.seg_compact_gt_launch, lib.launch_floor_launch,
               lib.seg_strided_log_g):
        fn.restype = _I
    return lib


class _DeviceMaps(NamedTuple):
    """A geometry's maps for one set of per-segment strides, as device
    tensors (built once per geometry, device and strides)."""
    block_seg: torch.Tensor   # i32[nb]
    block_base: torch.Tensor  # i32[nb]
    block_size: torch.Tensor  # i32[nb]
    seg_off: torch.Tensor     # i64[n_seg] first element of each slot
    seg_n: torch.Tensor       # i32[n_seg] sampled elements: ceil(size/stride)
    seg_stride: torch.Tensor  # i32[n_seg]
    seg_pad: torch.Tensor     # i32[n_seg] padded slot size
    seg_logc: torch.Tensor    # i32[n_seg] log2 of phase-1 columns
    seg_logr: torch.Tensor    # i32[n_seg] log2 of phase-1 rows
    cmax: int
    log_g: int                # log2 of the strided forms' clusters per slot
    samp_part: torch.Tensor   # f32[n_seg << (log_g + 6)] their cluster
    count_part: torch.Tensor  # i32[n_seg << log_g]        partials
    ticket: torch.Tensor      # i32[2, n_seg] 0 between launches


def _strides(stride_seg, geom) -> tuple[int, ...] | None:
    """The one normalisation of per-segment strides: ``None`` when every
    stride is 1 (the exact forms), else the strides as ints. Each must be
    a power of two that divides the arena row, as
    ``cost_model.sample_stride`` makes them."""
    if stride_seg is None:
        return None
    st = tuple(int(s) for s in stride_seg)
    if len(st) != geom.n_seg or any(
            s < 1 or s > ROW or s & (s - 1) for s in st):
        raise ValueError(f"strides {st} are not {geom.n_seg} powers of two "
                         f"in [1, {ROW}]")
    return st if any(s > 1 for s in st) else None


def _device_maps(geom, device: torch.device,
                 strides: tuple[int, ...] | None) -> _DeviceMaps:
    key = (str(device), strides)
    if key not in geom.device_maps:
        strides = strides or (1,) * geom.n_seg
        ns = [-(-n // s) for n, s in zip(geom.seg_sizes, strides)]
        logp = [max(0, int(n - 1).bit_length()) for n in ns]
        logc = [min(p, LOG_COLS) for p in logp]

        def i32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=device)
        pads = [(r1 - r0) * geom.block for r0, r1 in geom.seg_rows]
        # the strided forms' clusters per slot, for the largest slot's
        # samples (padded to a power of two) or stride grid
        log_g = _lib().seg_strided_log_g(max(
            max(1 << p for p in logp),
            max(p // s for p, s in zip(pads, strides))))
        geom.device_maps[key] = _DeviceMaps(
            i32(geom.block_seg), i32(geom.block_base), i32(geom.block_size),
            torch.as_tensor(np.asarray([r0 * geom.block
                                        for r0, _ in geom.seg_rows],
                                       np.int64), device=device),
            i32(ns), i32(strides), i32(pads),
            i32(logc), i32([p - c for p, c in zip(logp, logc)]),
            1 << max(logc), log_g,
            torch.empty(geom.n_seg << (log_g + 6), dtype=torch.float32,
                        device=device),
            torch.empty(geom.n_seg << log_g, dtype=torch.int32,
                        device=device),
            torch.zeros((2, geom.n_seg), dtype=torch.int32, device=device))
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


def seg_abs_sum_max(x2d: torch.Tensor, geom, stride_seg=None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment (sum|x|, max|x|) over [nb, 1024] arena rows; the sum is
    ``selection.pinned_sum`` of each slot's true-length vector, bitwise.
    With ``stride_seg`` (per-segment strides, 1 = exact) each slot
    contributes only its ``[::stride]`` subsample, and only those
    elements are read."""
    strides = _strides(stride_seg, geom)
    if x2d.device.type == "cpu":
        return ref.seg_abs_sum_max(x2d, geom.block_seg, geom.block_size,
                                   geom.n_seg, strides)
    _check_launch(x2d, geom, "seg_abs_sum_max")
    m = _device_maps(geom, x2d.device, strides)
    out = torch.empty((2, geom.n_seg), dtype=torch.float32,
                      device=x2d.device)
    if strides:
        rc = _lib().seg_abs_sum_max_strided_launch(
            x2d.data_ptr(), m.seg_off.data_ptr(), m.seg_n.data_ptr(),
            m.seg_stride.data_ptr(), geom.n_seg, m.log_g,
            m.samp_part.data_ptr(), m.ticket[0].data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), _stream())
    else:
        part = torch.empty((2, geom.n_seg, m.cmax), dtype=torch.float32,
                           device=x2d.device)
        rc = _lib().seg_abs_sum_max_launch(
            x2d.data_ptr(), m.seg_off.data_ptr(), m.seg_n.data_ptr(),
            m.seg_stride.data_ptr(), m.seg_logc.data_ptr(),
            m.seg_logr.data_ptr(), geom.n_seg, m.cmax, part[0].data_ptr(),
            part[1].data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
            _stream())
    _raise_on(rc, "seg_abs_sum_max")
    launches["seg_abs_sum_max_strided" if strides
             else "seg_abs_sum_max"] += 1
    return out[0], out[1]


def seg_count_gt(x2d: torch.Tensor, geom, thresholds: torch.Tensor,
                 stride_seg=None) -> torch.Tensor:
    """Per-segment nnz(|x| > thresholds[seg]) as i32 — one launch per
    search iteration for the whole (super-)arena. With ``stride_seg``
    only each slot's ``[::stride]`` grid is read and counted."""
    strides = _strides(stride_seg, geom)
    if x2d.device.type == "cpu":
        stride_b = (np.asarray(strides, np.int32)[np.asarray(geom.block_seg)]
                    if strides else None)
        return ref.seg_count_gt(x2d, geom.block_seg, thresholds, geom.n_seg,
                                stride_b)
    _check_launch(x2d, geom, "seg_count_gt")
    m = _device_maps(geom, x2d.device, strides)
    thr = thresholds.to(torch.float32).contiguous()
    if strides:
        # one store per segment: no zeroing
        out = torch.empty(geom.n_seg, dtype=torch.int32, device=x2d.device)
        rc = _lib().seg_count_gt_strided_launch(
            x2d.data_ptr(), m.seg_off.data_ptr(), m.seg_stride.data_ptr(),
            m.seg_pad.data_ptr(), thr.data_ptr(), geom.n_seg, m.log_g,
            m.count_part.data_ptr(), m.ticket[1].data_ptr(), out.data_ptr(),
            _stream())
    else:
        # the exact count adds each row's count with an atomic
        out = torch.zeros(geom.n_seg, dtype=torch.int32, device=x2d.device)
        rc = _lib().seg_count_gt_launch(
            x2d.data_ptr(), m.block_seg.data_ptr(), thr.data_ptr(),
            geom.nblocks, out.data_ptr(), _stream())
    _raise_on(rc, "seg_count_gt")
    launches["seg_count_gt_strided" if strides else "seg_count_gt"] += 1
    return out


def seg_residual_update_stats(
        g2d: torch.Tensor, v2d: torch.Tensor, u2d: torch.Tensor | None,
        p2d: torch.Tensor | None, geom, *, momentum: float, nesterov: bool,
        weight_decay: float = 0.0, round_dtype=None, stride_seg=None
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor, torch.Tensor]:
    """Alg 4's residual update over the whole arena and the per-segment
    (sum|V'|, max|V'|) of the result, in one pass: ``g += wd * p``;
    ``U' = m * U + g``, ``V' = V + U'`` (``+ g`` with nesterov), or
    ``V' = V + g`` without momentum; V' optionally rounded through
    ``round_dtype`` (bf16). Statistics as ``seg_abs_sum_max(V',
    stride_seg)``. ``u2d`` is needed iff ``momentum``, ``p2d`` iff
    ``weight_decay``. Returns (V', U' or None, sums, maxs)."""
    if momentum and u2d is None:
        raise ValueError("momentum accumulation needs the velocity arena")
    if weight_decay and p2d is None:
        raise ValueError("weight decay needs the parameter arena")
    strides = _strides(stride_seg, geom)
    if g2d.device.type == "cpu":
        return ref.seg_residual_update_stats(
            g2d, v2d, u2d, p2d, geom, momentum=momentum, nesterov=nesterov,
            weight_decay=weight_decay, round_dtype=round_dtype,
            stride_seg=strides)
    if round_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"seg_residual_update_stats: no kernel rounds "
                         f"through {round_dtype}")
    ins = [g2d, v2d] + ([u2d] if momentum else []) + \
        ([p2d] if weight_decay else [])
    for a in ins:
        _check_launch(a, geom, "seg_residual_update_stats")
    m = _device_maps(geom, g2d.device, strides)
    v_new = torch.empty_like(v2d)
    u_new = torch.empty_like(u2d) if momentum else None
    part = torch.empty((2, geom.n_seg, m.cmax), dtype=torch.float32,
                       device=g2d.device)
    out = torch.empty((2, geom.n_seg), dtype=torch.float32,
                      device=g2d.device)

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = _lib().seg_residual_update_stats_launch(
        g2d.data_ptr(), v2d.data_ptr(), ptr(u2d) if momentum else None,
        ptr(p2d) if weight_decay else None, v_new.data_ptr(), ptr(u_new),
        momentum, int(bool(nesterov)), weight_decay,
        int(round_dtype == torch.bfloat16), m.seg_off.data_ptr(),
        m.seg_n.data_ptr(), m.seg_stride.data_ptr(), m.seg_pad.data_ptr(),
        m.seg_logc.data_ptr(), m.seg_logr.data_ptr(), geom.n_seg, m.cmax,
        part[0].data_ptr(), part[1].data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), _stream())
    _raise_on(rc, "seg_residual_update_stats")
    launches["seg_residual_update_stats"] += 1
    return v_new, u_new, out[0], out[1]


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
    m = _device_maps(geom, x2d.device, None)
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

def seg_mean(sums: torch.Tensor, geom, stride_seg=None) -> torch.Tensor:
    """Per-segment mean: the pinned f32-reciprocal multiply of
    ``selection.mean_of_sum``, vectorized over slots. With ``stride_seg``
    it divides by each slot's SAMPLED count ``ceil(n / stride)``."""
    ns = (geom.seg_sizes if stride_seg is None else
          [-(-n // int(s)) for n, s in zip(geom.seg_sizes, stride_seg)])
    recip = torch.tensor([np.float32(1.0 / n) for n in ns],
                         dtype=torch.float32, device=sums.device)
    return sums * recip


def seg_stats(x2d: torch.Tensor, geom, stride_seg=None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-segment (mean|x|, max|x|), over each slot's ``[::stride]``
    subsample where ``stride_seg`` gives a stride > 1."""
    sums, maxs = seg_abs_sum_max(x2d, geom, stride_seg)
    return seg_mean(sums, geom, stride_seg), maxs


def _slot_flat(x2d: torch.Tensor, geom, s: int) -> torch.Tensor:
    """Slot ``s`` as the flat f32[size] vector the per-leaf path sees."""
    r0, r1 = geom.seg_rows[s]
    return x2d[r0:r1].reshape(-1)[:geom.seg_sizes[s]]


class SegmentSpec(NamedTuple):
    """One arena's selection request for ``multi_select`` (see the
    reference): the search ``alg``, its ``eps``, optional per-slot message
    ``capacities``, per-slot sampling ``strides`` (bsearch only; all 1 is
    exact), and the §5.2.2 reuse / warm-start runtime fields."""
    alg: str                                # "trimmed" | "bsearch"
    eps: float
    capacities: tuple[int, ...] = ()
    strides: tuple[int, ...] = ()
    refresh: torch.Tensor | None = None     # bool[n_seg]
    cached: torch.Tensor | None = None      # f32[n_seg]
    warm: bool = False


def _norm_caps(spec: SegmentSpec, geom) -> tuple[int, ...]:
    if spec.capacities:
        return tuple(spec.capacities)
    if spec.alg == "trimmed":
        return tuple(geom.seg_ks)
    return tuple(2 * k for k in geom.seg_ks)


def _norm_strides(spec: SegmentSpec, geom) -> tuple[int, ...]:
    if spec.strides and spec.alg == "bsearch":
        return tuple(int(s) for s in spec.strides)
    return (1,) * geom.n_seg


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
    strides = sum((_norm_strides(s, g) for g, s in zip(geoms, specs)), ())
    sampled = any(s > 1 for s in strides)
    stride_vec = torch.tensor(strides, dtype=torch.int32, device=dev)
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
        mean, mx = seg_stats(x_all, geom_all, strides)
    else:
        means, maxs = [], []
        for (x2d, geom, spec, stats) in parts:
            if stats is None:
                stats = seg_stats(x2d, geom, _norm_strides(spec, geom))
            means.append(stats[0])
            maxs.append(stats[1])
        mean, mx = torch.cat(means), torch.cat(maxs)

    def count_est(thr):
        """One launch: per-segment counts; sampled segments count their
        subsample and scale it by the stride (exact segments: x 1)."""
        cnt = seg_count_gt(x_all, geom_all, thr, strides)
        return cnt * stride_vec if sampled else cnt

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

    # --- per-slot selection: the short buckets, or the exact form ------
    # One host sync reads every slot's bucket overflow, short flag (a
    # trimmed slot with fewer than k survivors) and survivor total.
    host = []
    for s in range(n):
        row0, row1 = geom_all.seg_rows[s]
        host += [(cnts[row0:row1] > caps[s]).any(),
                 nnz_loop[s] < geom_all.seg_ks[s],
                 cnts[row0:row1].sum()]
    host = torch.stack([h.to(torch.int64) for h in host]).tolist()

    results: list[tuple[list[Selected], torch.Tensor]] = []
    seg0 = 0
    for (x2d, geom, _spec, _stats) in parts:
        out: list[Selected] = []
        for sl in range(geom.n_seg):
            s = seg0 + sl
            row0, row1 = geom_all.seg_rows[s]
            over, short, alive = host[3 * s:3 * s + 3]
            flat = _slot_flat(x2d, geom, sl)
            vals_s = vals[row0:row1, :caps[s]]
            idx_s = idx[row0:row1, :caps[s]]
            if trim_np[s]:
                si, sv = pick_trimmed(flat, thr[s], geom.seg_ks[sl], vals_s,
                                      idx_s, over, short, alive)
                out.append(Selected(si, sv, torch.tensor(
                    geom.seg_ks[sl], dtype=torch.int32, device=dev)))
            else:
                si, sv = pick_first(flat, thr[s], caps_sel[s], vals_s,
                                    idx_s, over)
                out.append(Selected(
                    si, sv, torch.clamp(nnz_full[s], max=caps_sel[s]),
                    nnz_full[s] > caps_sel[s]))
        results.append((out, thr[seg0:seg0 + geom.n_seg]))
        seg0 += geom.n_seg
    return results
