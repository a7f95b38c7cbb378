#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile N]

Drives the port (``src/repro_torch``) only; imports nothing of JAX or of
the JAX package. Phases, each fatal on failure:

1. card facts (``nvidia-smi`` name and power limit, torch device name);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and print the build time;
3. every kernel against its plain PyTorch twin on the card — sums
   bitwise, counts and compaction exactly, the fused residual update's
   V'/U' bitwise — and each kernel's device time (20 launches in one
   CUDA graph, CUDA events) beside its bound, its per-call time from the
   host and its twin's time. The exact segmented forms run at the
   full-width arena of the paper's 2-layer 1500-unit LSTM under the
   default dispatch (six slots, 64,458 rows), on the same arena with 2%
   of each slot's rows crowded wholly above the threshold (the bucketed
   compaction at caps 16, 1 and 1024, and timed there too) and on a
   small ragged arena with ties, threshold 0 and bucket overflow (caps 8,
   1 and 1024); the strided (sampled)
   forms and the fused residual-update+stats pass at the full-width
   nine-slot sampled arena (strides 512 and 1, 64,480 rows) and on a
   ragged arena with strides 1-1024, slot sizes off the stride, ties and
   threshold 0; the fused pass with momentum 0.9, with nesterov and
   weight decay, without momentum and with a bf16 round. After the
   strided forms' times, the launch floor (an empty kernel of one block
   and on their grid of clusters of 8 blocks), then for each the device
   operations one wrapper call issues (from ``torch.profiler``: fails
   unless one), its samples' 32-byte sectors beside the useful bytes of
   the bound, and its time with the samples cold in HBM; the strided
   forms with every stride 1 are held against the exact twins at the
   full-width arena and timed beside the exact forms. The per-leaf
   kernels (count_gt, abs_sum_max, compact_gt, its exact form
   compact_gt_exact at up to four capacities, residual_update) run on the
   full-width leaves (15M and 9M elements, a threshold that overflows the
   16-wide buckets in 100 rows, and threshold 0; compact_gt at caps 16, 1
   and 1024), on the same leaves with 2% of their rows crowded wholly
   above the threshold (compact_gt timed there too), on tied leaves of 1
   to 70,000 elements and on two misaligned views (5,000 and 4,999
   elements), every output bitwise;
   compact_gt_exact and abs_sum_max also on two slots of the full-width
   arena (the views multi_select gives them). abs_sum_max is timed
   against torch.linalg.vector_norm as a yardstick, compact_gt_exact both
   writing every survivor (the trimmed top-k) and the first 2k at the
   bisection's threshold (the filter), at both leaf sizes;
4. two full-width ``GradientSync.update`` steps (refresh, then threshold
   reuse) with the kernels, and again with the twins on the same CUDA
   tensors, for ``rgc`` (arena, and per leaf: 3a), ``trimmed_topk``
   (arena, and per leaf: 3b) and ``sampled_bsearch`` with
   ``fuse_accumulate`` off and on: params, residual, momentum, thresholds
   and packed messages bitwise equal; sampled fused equal to sampled
   per-leaf accumulation; and after one update, per leaf (3a) equal to
   arena (default);
5. five paths through ``Trainer(paper_lstm.FULL, TrainConfig(...))``,
   8 steps each of a seeded synthetic stream (batch 20 x seq 35): the
   default (``rgc``), 2a (``optimizer="sampled_bsearch"``), 2b (the
   same with ``fuse_accumulate=True``), 3a (``fuse_leaves=False``) and
   3b (``optimizer="trimmed_topk", fuse_leaves=False``). Kernel launch
   counts and the selectors' branch counts (exact compaction after a
   bucket overflow, short pick; arena and per leaf) are zeroed just before
   each path and read just after; every loss must be finite, each path
   must launch the kernels it names, a path whose buckets overflowed must
   have run the exact compaction, no plain whole-leaf or whole-slot
   filter or sort may run on the card, and every kernel must be launched
   on some path;
   with ``--profile N``, N more steps of each path under
   ``torch.profiler`` print its device time by kernel;
6. a JSON line per kernel (time, bound, launches on each path, error),
   then the last line ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is present or the
port is not beside this script.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12            # H100 SXM f32 outside the tensor cores
SEED = 0


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean time of ``fn`` in ms over ``reps`` calls back to back (warmed),
    by CUDA events: device time while the host keeps ahead, else the
    host's launch rate."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` in ms: ``reps`` calls captured in one
    CUDA graph and replayed, so no host work sits between the launches
    (a small kernel's time is otherwise the wrapper's host overhead)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_kernel(name: str, kern, plain, nbytes: int, ops: int, *,
                source: str = "segmented.cu", library=None) -> dict:
    """Device time (graph), per-call time (events, host included), the
    twin's time, the bound of one kernel and, where one PyTorch call
    computes the same function, that call's device time (graph); prints
    one line."""
    ms = graph_ms(kern, 20)
    call_ms = cuda_ms(kern, 20)
    plain_ms = cuda_ms(plain, 3)
    lib_ms = None if library is None else graph_ms(library, 20)
    b_ms, b_by = bound_ms(nbytes, ops)
    lib = "" if lib_ms is None else f"; library call {lib_ms:.4f} ms"
    print(f"[kernels] {name}: {ms:.4f} ms on the device (bound {b_ms:.4f} "
          f"ms by {b_by}, {b_ms / ms:.1%} of it); {call_ms:.4f} ms per "
          f"call from the host; plain twin {plain_ms:.4f} ms{lib}")
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "launches": None, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def full_width_group(density: float = 0.001):
    """The arena GradientSync builds for paper-lstm FULL: the six
    bsearch leaves in tree order."""
    from repro_torch.core import arena, sync
    sizes = [("['embed']['table']", 10_000 * 1500),
             ("['lm_head']", 1500 * 10_000),
             ("['lstm_0']['wh']", 1500 * 6000),
             ("['lstm_0']['wx']", 1500 * 6000),
             ("['lstm_1']['wh']", 1500 * 6000),
             ("['lstm_1']['wx']", 1500 * 6000)]
    slots = []
    for i, (path, n) in enumerate(sizes):
        k = max(1, math.ceil(density * n))
        slots.append((i, path, n, k, 2 * k, sync.message_len(2 * k, False)))
    return arena.build_group(0, "threshold_bsearch", "torch.float32", slots)


def sampled_full_group(density: float = 0.001):
    """The one arena paths 2a/2b build for paper-lstm FULL: every leaf to
    ``sampled_bsearch``, in tree order (nine slots, 66,028,000
    elements). Returns the group and its per-slot strides."""
    from repro_torch.configs import paper_lstm
    from repro_torch.core import arena, compressors, sync, tree
    from repro_torch.models import lstm
    comp = compressors.SampledBSearch()
    slots = []
    for i, (path, (shape, _, _)) in enumerate(tree.flatten_with_paths(
            lstm.param_defs(paper_lstm.FULL))):
        n = math.prod(shape)
        k = max(1, math.ceil(density * n))
        cap = comp.capacity(k)
        slots.append((i, path, n, k, cap, sync.message_len(cap, False)))
    group = arena.build_group(0, "sampled_bsearch", "torch.float32", slots)
    return group, comp.segment_strides(group.geometry)


RAGGED_STRIDES = (1, 16, 1024, 2, 8, 512, 4, 64)


def ragged_group(sizes=(1, 1000, 1024, 1025, 5000, 70_000, 3)):
    from repro_torch.core import arena, sync
    return arena.build_group(0, "threshold_bsearch", "torch.float32", [
        (i, f"s{i}", n, max(1, n // 100), 2 * max(1, n // 100),
         sync.message_len(2 * max(1, n // 100), False))
        for i, n in enumerate(sizes)])


def _arena_of(group, gen, scale: float = 1.0, tied: bool = False):
    """A seeded CUDA arena for ``group``: normal values, or with ``tied``
    few distinct magnitudes (ties everywhere), times ``scale``."""
    import torch
    from repro_torch.core import arena
    leaves = {}
    for slot in group.slots:
        if tied:
            v = torch.randint(-4, 5, (slot.size,), generator=gen,
                              device="cuda").to(torch.float32) * 0.5
        else:
            v = torch.randn(slot.size, generator=gen, device="cuda")
        leaves[slot.leaf] = v * scale
    return arena.gather(group, leaves)


def _crowded(x, bands):
    """A copy of ``x`` (a flat leaf or an [nb, 1024] arena) in which every
    row of each [r0, r1) band lies wholly above any threshold below 4:
    x -> sign(x) (4 + |x|); zeros (slot padding) stay zero. The rest
    keeps its random fill. Real steps crowd their survivors into a few
    rows: nearly every bucketed compaction of the main path overflows."""
    import torch
    y = x.clone()
    flat = y.view(-1)
    for r0, r1 in bands:
        band = flat[r0 * 1024:r1 * 1024]
        band.copy_(torch.where(band != 0, torch.sign(band) * (4 + band.abs()),
                               band))
    return y


def _band(r0: int, r1: int) -> tuple[int, int]:
    """2% of the rows [r0, r1) (at least one), a tenth of the way in."""
    a = r0 + (r1 - r0) // 10
    return a, a + max(1, (r1 - r0) // 50)


def _same_bits(a, b) -> bool:
    import torch
    if a is None or b is None:
        return a is None and b is None
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _max_err(a, b) -> float:
    return 0.0 if a is None else float((a.float() - b.float()).abs().max())


def phase_kernels(results: dict) -> None:
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import segmented as kseg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def plain_stats(x2d, geom):
        return ref.seg_abs_sum_max(x2d, geom.block_seg, geom.block_size,
                                   geom.n_seg)

    def plain_count(x2d, geom, thr):
        return ref.seg_count_gt(x2d, geom.block_seg, thr, geom.n_seg)

    def plain_compact(x2d, geom, thr, cap):
        return ref.seg_compact_gt(x2d, geom.block_seg, geom.block_base,
                                  geom.block_size, thr, cap)

    same_bits = _same_bits
    cases = []
    full = full_width_group()
    x_full = _arena_of(full, gen)
    thr_full = torch.tensor([3.0, 3.1, 2.9, 3.0, 3.2, 3.0], device=dev)
    cases.append(("full-width", x_full, full.geometry, thr_full, (16,)))
    # the survivors crowd 2% of each slot's rows; the bucket at the main
    # path's cap 16, one slot, and every survivor of a row (cap 1024)
    x_crowd = _crowded(x_full, [_band(*r) for r in full.geometry.seg_rows])
    cases.append(("full-width crowded", x_crowd, full.geometry, thr_full,
                  (16, 1, 1024)))
    rag = ragged_group()
    x_rag = _arena_of(rag, gen, tied=True)
    n_rag = rag.geometry.n_seg
    cases.append(("ragged thr=1", x_rag, rag.geometry,
                  torch.full((n_rag,), 1.0, device=dev), (8,)))
    cases.append(("ragged thr=0 overflow", x_rag, rag.geometry,
                  torch.zeros(n_rag, device=dev), (8, 1, 1024)))

    err = {"seg_abs_sum_max": 0.0, "seg_count_gt": 0.0,
           "seg_compact_gt": 0.0}
    for name, x2d, geom, thr, caps in cases:
        ks, km = kseg.seg_abs_sum_max(x2d, geom)
        ps, pm = plain_stats(x2d, geom)
        kc = kseg.seg_count_gt(x2d, geom, thr)
        pc = plain_count(x2d, geom, thr)
        torch.cuda.synchronize()
        ok = {"seg_abs_sum_max": same_bits(ks, ps) and same_bits(km, pm),
              "seg_count_gt": same_bits(kc, pc), "seg_compact_gt": True}
        err["seg_abs_sum_max"] = max(
            err["seg_abs_sum_max"], float((ks - ps).abs().max()),
            float((km - pm).abs().max()))
        err["seg_count_gt"] = max(err["seg_count_gt"],
                                  float((kc - pc).abs().max()))
        over = []
        for cap in caps:
            kv, ki, kn = kseg.seg_compact_gt(x2d, geom, thr, cap)
            pv, pi, pn = plain_compact(x2d, geom, thr, cap)
            torch.cuda.synchronize()
            ok["seg_compact_gt"] &= (same_bits(kv, pv) and same_bits(ki, pi)
                                     and same_bits(kn, pn))
            err["seg_compact_gt"] = max(
                err["seg_compact_gt"], float((kv - pv).abs().max()),
                float((ki - pi).abs().max()), float((kn - pn).abs().max()))
            over.append(f"{int((kn > cap).sum())} at cap {cap}")
            del kv, ki, kn, pv, pi, pn
        print(f"[kernels] {name}: " + ", ".join(
            f"{k} {'equal' if v else 'DIFFERS'}" for k, v in ok.items())
            + f"; rows over the cap {', '.join(over)} (of "
            f"{geom.nblocks:,})")
        if not all(ok.values()):
            _fail(f"kernel differs from its plain twin on {name}")

    # timing at the full-width shapes the main path gives the kernels
    geom, nb, nseg = full.geometry, full.geometry.nblocks, full.geometry.n_seg
    xbytes = x_full.numel() * 4
    elems = x_full.numel()
    timing = {
        "seg_abs_sum_max": (
            lambda: kseg.seg_abs_sum_max(x_full, geom),
            lambda: plain_stats(x_full, geom),
            xbytes + nseg * (8 + 4 * 3) + 2 * nseg * 4, 3 * elems),
        "seg_count_gt": (
            lambda: kseg.seg_count_gt(x_full, geom, thr_full),
            lambda: plain_count(x_full, geom, thr_full),
            xbytes + nb * 4 + 2 * nseg * 4, 3 * elems),
        "seg_compact_gt": (
            lambda: kseg.seg_compact_gt(x_full, geom, thr_full, 16),
            lambda: plain_compact(x_full, geom, thr_full, 16),
            xbytes + 3 * nb * 4 + nseg * 4 + nb * 16 * 8 + nb * 4,
            3 * elems),
    }
    replaces = {"seg_abs_sum_max": "src/repro/kernels/segmented.py:113",
                "seg_count_gt": "src/repro/kernels/segmented.py:182",
                "seg_compact_gt": "src/repro/kernels/segmented.py:242"}
    for name, (kern, plain, nbytes, ops) in timing.items():
        results[name] = time_kernel(name, kern, plain, nbytes, ops)
        results[name].update(replaces=replaces[name],
                             max_abs_err=err[name])
    # the same compaction where the survivors crowd 2% of the rows
    nbytes, ops = timing["seg_compact_gt"][2:]
    time_kernel("seg_compact_gt crowded",
                lambda: kseg.seg_compact_gt(x_crowd, geom, thr_full, 16),
                lambda: plain_compact(x_crowd, geom, thr_full, 16),
                nbytes, ops)
    del x_crowd

    # Why the exact forms keep their own kernels: the strided forms with
    # every stride 1 compute the same, timed here against them on this arena
    # (a stride-1 slot inside a sampled call takes this path).
    m = kseg._device_maps(geom, dev, None)
    lib = kseg._lib()
    sums = torch.empty((2, nseg), dtype=torch.float32, device=dev)
    cnt = torch.empty(nseg, dtype=torch.int32, device=dev)

    def stats_at_1():
        kseg._raise_on(lib.seg_abs_sum_max_strided_launch(
            x_full.data_ptr(), m.seg_off.data_ptr(), m.seg_n.data_ptr(),
            m.seg_stride.data_ptr(), nseg, m.log_g, m.samp_part.data_ptr(),
            m.ticket[0].data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
            kseg._stream()), "stats_sampled at stride 1")

    def count_at_1():
        kseg._raise_on(lib.seg_count_gt_strided_launch(
            x_full.data_ptr(), m.seg_off.data_ptr(), m.seg_stride.data_ptr(),
            m.seg_pad.data_ptr(), thr_full.data_ptr(), nseg, m.log_g,
            m.count_part.data_ptr(), m.ticket[1].data_ptr(), cnt.data_ptr(),
            kseg._stream()), "count_sampled at stride 1")
    stats_at_1()
    count_at_1()
    ps, pm = plain_stats(x_full, geom)
    if not (same_bits(sums[0], ps) and same_bits(sums[1], pm)
            and same_bits(cnt, plain_count(x_full, geom, thr_full))):
        _fail("a strided form at stride 1 differs from the exact twin")
    print(f"[kernels] every stride 1 at full width ({1 << m.log_g} clusters "
          f"of 8 blocks per slot; equal to the exact twins): stats_sampled "
          f"{graph_ms(stats_at_1, 20):.4f} ms against seg_abs_sum_max "
          f"{results['seg_abs_sum_max']['ms']:.4f}, count_sampled "
          f"{graph_ms(count_at_1, 20):.4f} ms against count_gt "
          f"{results['seg_count_gt']['ms']:.4f}")


def phase_sampled_kernels(results: dict) -> None:
    """The strided forms and the fused residual-update+stats pass against
    their twins, then their times at the full-width sampled arena."""
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import segmented as kseg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    same_bits, max_err = _same_bits, _max_err

    def stride_rows(geom, strides):
        return np.asarray(strides, np.int32)[np.asarray(geom.block_seg)]

    full, st_full = sampled_full_group()
    rag = ragged_group((1, 1000, 1024, 1025, 5000, 70_000, 3, 333_333))
    cases = [("full-width sampled", full, st_full, False),
             ("ragged strided", rag, RAGGED_STRIDES, True)]
    configs = [("m=0.9", dict(momentum=0.9, nesterov=False, weight_decay=0.0,
                              round_dtype=None)),
               ("m=0.9 nesterov wd=1e-4",
                dict(momentum=0.9, nesterov=True, weight_decay=1e-4,
                     round_dtype=None)),
               ("m=0", dict(momentum=0.0, nesterov=False, weight_decay=0.0,
                            round_dtype=None)),
               ("m=0.9 bf16", dict(momentum=0.9, nesterov=False,
                                   weight_decay=0.0,
                                   round_dtype=torch.bfloat16))]
    err = {"seg_abs_sum_max_strided": 0.0, "seg_count_gt_strided": 0.0,
           "seg_residual_update_stats": 0.0}
    keep = {}
    for name, group, strides, tied in cases:
        geom = group.geometry
        x = _arena_of(group, gen, 1.0, tied)
        ks, km = kseg.seg_abs_sum_max(x, geom, strides)
        ps, pm = ref.seg_abs_sum_max(x, geom.block_seg, geom.block_size,
                                     geom.n_seg, strides)
        ok_s = same_bits(ks, ps) and same_bits(km, pm)
        err["seg_abs_sum_max_strided"] = max(
            err["seg_abs_sum_max_strided"], max_err(ks, ps), max_err(km, pm))
        ok_c = True
        for thr in (torch.full((geom.n_seg,), 1.0, device=dev),
                    torch.zeros(geom.n_seg, device=dev)):
            kc = kseg.seg_count_gt(x, geom, thr, strides)
            pc = ref.seg_count_gt(x, geom.block_seg, thr, geom.n_seg,
                                  stride_rows(geom, strides))
            ok_c = ok_c and same_bits(kc, pc)
            err["seg_count_gt_strided"] = max(err["seg_count_gt_strided"],
                                              max_err(kc, pc))
        g2d, v2d, u2d, p2d = (_arena_of(group, gen, sc, tied)
                              for sc in (1e-3, 1e-2, 1e-3, 0.05))
        ok_r = []
        for cname, kw in configs:
            u = u2d if kw["momentum"] else None
            p = p2d if kw["weight_decay"] else None
            got = kseg.seg_residual_update_stats(g2d, v2d, u, p, geom,
                                                 stride_seg=strides, **kw)
            want = ref.seg_residual_update_stats(g2d, v2d, u, p, geom,
                                                 stride_seg=strides, **kw)
            torch.cuda.synchronize()
            ok_r.append(all(same_bits(a, b) for a, b in zip(got, want)))
            err["seg_residual_update_stats"] = max(
                err["seg_residual_update_stats"],
                *(max_err(a, b) for a, b in zip(got, want)))
            print(f"[kernels] {name} seg_residual_update_stats {cname}: "
                  f"{'equal' if ok_r[-1] else 'DIFFERS'}")
            del got, want
        print(f"[kernels] {name}: seg_abs_sum_max strided "
              f"{'equal' if ok_s else 'DIFFERS'}, seg_count_gt strided "
              f"{'equal' if ok_c else 'DIFFERS'}; strides {strides}")
        if not (ok_s and ok_c and all(ok_r)):
            _fail(f"a strided or fused kernel differs from its twin on "
                  f"{name}")
        keep[name] = (x, g2d, v2d, u2d)

    # timing at the full-width sampled arena the paths 2a/2b run
    x, g2d, v2d, u2d = keep["full-width sampled"]
    del keep
    geom, nb, nseg = full.geometry, full.geometry.nblocks, full.geometry.n_seg
    thr = torch.full((nseg,), 2.0, device=dev)
    n_samp = sum(-(-n // s) for n, s in zip(geom.seg_sizes, st_full))
    n_grid = sum(1024 // s for s in stride_rows(geom, st_full))
    abytes = g2d.numel() * 4
    resid_kw = dict(momentum=0.9, nesterov=False, weight_decay=0.0,
                    round_dtype=None, stride_seg=st_full)
    timing = {
        "seg_abs_sum_max_strided": (
            lambda: kseg.seg_abs_sum_max(x, geom, st_full),
            lambda: ref.seg_abs_sum_max(x, geom.block_seg, geom.block_size,
                                        nseg, st_full),
            n_samp * 4 + nseg * (8 + 4 * 4) + 2 * nseg * 4, 3 * n_samp),
        "seg_count_gt_strided": (
            lambda: kseg.seg_count_gt(x, geom, thr, st_full),
            lambda: ref.seg_count_gt(x, geom.block_seg, thr, nseg,
                                     stride_rows(geom, st_full)),
            n_grid * 4 + nseg * (8 + 4 + 4 + 4) + nseg * 4, 3 * n_grid),
        "seg_residual_update_stats": (
            lambda: kseg.seg_residual_update_stats(g2d, v2d, u2d, None, geom,
                                                   **resid_kw),
            lambda: ref.seg_residual_update_stats(g2d, v2d, u2d, None, geom,
                                                  **resid_kw),
            5 * abytes + 2 * nseg * 4, 4 * g2d.numel() + 3 * n_samp),
    }
    replaces = {
        "seg_abs_sum_max_strided": "src/repro/kernels/segmented.py:91",
        "seg_count_gt_strided": "src/repro/kernels/segmented.py:165",
        "seg_residual_update_stats": "src/repro/kernels/segmented.py:328"}
    for name, (kern, plain, nbytes, ops) in timing.items():
        results[name] = time_kernel(name, kern, plain, nbytes, ops)
        results[name].update(replaces=replaces[name],
                             max_abs_err=err[name])
    sampled_forms(x, geom, st_full, thr, results)


def launch_floor(n_seg: int, log_g: int) -> dict:
    """The least device time of one launch (graph harness): an empty kernel
    of one block, and on the strided forms' grid (2^log_g clusters of 8
    blocks per segment)."""
    from repro_torch.kernels import segmented as kseg

    def empty(lg):
        def fn():
            kseg._raise_on(kseg._lib().launch_floor_launch(
                n_seg, lg, kseg._stream()), "empty kernel")
        return fn
    floor = {"block": graph_ms(empty(-1), 20),
             "grid": graph_ms(empty(log_g), 20)}
    print(f"[kernels] launch floor: empty kernel, one block "
          f"{floor['block']:.4f} ms; on the strided forms' grid of "
          f"{n_seg} x {1 << log_g} clusters of 8 blocks "
          f"{floor['grid']:.4f} ms")
    return floor


def cold_ms(fn, reps: int) -> float:
    """Device time of ``fn`` with its inputs cold in HBM: in one CUDA graph
    each call follows a 128 MB write (over the 50 MB L2), less the time of
    the writes alone."""
    import torch
    flush = torch.empty(32 << 20, dtype=torch.float32, device="cuda")
    both = graph_ms(lambda: (flush.zero_(), fn()), reps)
    return both - graph_ms(flush.zero_, reps)


def device_ops(fn) -> list[str]:
    """The device operations (kernels and memsets) one call of ``fn``
    issues, by name, from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def sampled_forms(x, geom, strides, thr, results: dict) -> None:
    """The strided forms at the full-width sampled arena: the device
    operations one wrapper call issues (must be one), the 32-byte sectors
    their samples occupy beside the useful bytes, the launch floor on
    their grid and their time with the samples cold in HBM."""
    from repro_torch.kernels import segmented as kseg

    pads = [(r1 - r0) * 1024 for r0, r1 in geom.seg_rows]
    n_samp = [-(-n // s) for n, s in zip(geom.seg_sizes, strides)]
    n_grid = [p // s for p, s in zip(pads, strides)]

    def sectors(counts):
        # samples s floats apart: one sector each from s = 8 on
        return 32 * sum(c if s >= 8 else -(-c * s // 8)
                        for c, s in zip(counts, strides))
    m = kseg._device_maps(geom, x.device, tuple(strides))
    floor = launch_floor(geom.n_seg, m.log_g)
    for name, call, useful, sec in (
            ("seg_abs_sum_max_strided",
             lambda: kseg.seg_abs_sum_max(x, geom, strides),
             4 * sum(n_samp), sectors(n_samp)),
            ("seg_count_gt_strided",
             lambda: kseg.seg_count_gt(x, geom, thr, strides),
             4 * sum(n_grid), sectors(n_grid))):
        ops = device_ops(call)
        print(f"[kernels] {name}: {len(ops)} device operation(s) per "
              f"wrapper call {ops}; {useful:,} useful bytes "
              f"({useful / 3.35e9:.6f} ms at 3.35 TB/s), {sec:,} bytes of "
              f"32-byte sectors ({sec / 3.35e9:.6f} ms); launch floor on "
              f"its grid {floor['grid']:.4f} ms; {results[name]['ms']:.4f} "
              f"ms warm, {cold_ms(call, 20):.4f} ms with its samples cold")
        if len(ops) != 1:
            _fail(f"{name} issues {len(ops)} device operations per call")


# The per-leaf kernels and the TPU kernel each replaces.
LEAF_REPLACES = {
    "count_gt": "src/repro/kernels/threshold_count.py:28",
    "abs_sum_max": "src/repro/kernels/block_stats.py:28",
    "compact_gt": "src/repro/kernels/compact.py:51",
    "compact_gt_exact": "src/repro/kernels/compact.py:51",
    "residual_update": "src/repro/kernels/residual_update.py:28"}
LEAF_RAGGED = (1, 1000, 1024, 1025, 5000, 70_000)


def _leaf_twins() -> dict:
    """The plain twin of each per-leaf wrapper, with the wrapper's
    arguments (flat leaves)."""
    from repro_torch.kernels import ref
    return {
        "count_gt": lambda x, t: ref.count_gt(ref.rows(x), t),
        "abs_sum_max": lambda x: ref.abs_sum_max(ref.rows(x), x.numel()),
        "compact_gt": lambda x, t, cap: ref.compact_gt(ref.rows(x), t, cap,
                                                       x.numel()),
        "compact_gt_exact": lambda x, t, capacity:
            ref.compact_gt_exact(ref.rows(x), t, capacity, x.numel()),
        "residual_update": ref.residual_update}


def _full_width_leaf(n: int, gen):
    """A seeded full-width leaf: normal values, with the first 100 rows
    scaled by 4 so that a threshold of 3 overflows a 16-wide bucket in
    those rows and in no other."""
    import torch
    x = torch.randn(n, generator=gen, device="cuda")
    x[:100 * 1024] *= 4.0
    return x


def phase_leaf_kernels(results: dict) -> None:
    """The per-leaf kernels against their twins, bitwise, on the
    full-width leaves (15M and 9M elements), plain and crowded, on ragged
    tied leaves and on misaligned views, and the exact compaction and the statistics also on
    slots of the full-width arena (the views ``multi_select`` gives them
    after a bucket overflow); then their times at full width."""
    import torch
    from repro_torch.kernels import (block_stats, compact, ops,
                                     residual_update, threshold_count)
    from repro_torch.kernels import segmented as kseg
    from repro_torch.kernels.ops import _cap_for

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    same_bits, max_err = _same_bits, _max_err
    twin = _leaf_twins()

    def tied(n):
        return torch.randint(-4, 5, (n,), generator=gen,
                             device=dev).to(torch.float32) * 0.5

    full = {n: _full_width_leaf(n, gen) for n in (15_000_000, 9_000_000)}
    # the survivors crowd 2% of the rows, wholly above the threshold
    crowd = {n: _crowded(x, [_band(0, -(-n // 1024))])
             for n, x in full.items()}
    # the main path's cap (_cap_for: 16), one slot, every survivor
    cases = [(f"full-width{kind} n={n:,}", x, (3.0, 0.0),
              (_cap_for(2 * math.ceil(0.001 * n), -(-n // 1024), 1024), 1,
               1024), 2 * math.ceil(0.001 * n))
             for kind, leaves in (("", full), (" crowded", crowd))
             for n, x in leaves.items()]
    cases += [(f"ragged tied n={n}", tied(n), (1.0, 0.0), (8,), 50)
              for n in LEAF_RAGGED]
    cases.append(("misaligned n=5000", tied(5001)[1:], (1.0, 0.0),
                  (8, 1, 1024), 50))
    cases.append(("misaligned n=4999", tied(5001)[2:], (1.0, 0.0),
                  (8, 1, 1024), 50))
    err = {k: 0.0 for k in LEAF_REPLACES}
    for label, x, thrs, caps, msg in cases:
        ok = {k: True for k in LEAF_REPLACES}
        overflow_rows = []
        n = x.numel()
        for thr in thrs:
            t = torch.tensor(thr, device=dev)
            kc, pc = threshold_count.count_gt(x, t), twin["count_gt"](x, t)
            ok["count_gt"] &= same_bits(kc, pc)
            err["count_gt"] = max(err["count_gt"], max_err(kc, pc))
            for cap in caps:
                kb = compact.compact_gt(x, t, cap)
                pb = twin["compact_gt"](x, t, cap)
                torch.cuda.synchronize()
                ok["compact_gt"] &= all(same_bits(a, b)
                                        for a, b in zip(kb, pb))
                err["compact_gt"] = max(
                    err["compact_gt"],
                    *(max_err(a, b) for a, b in zip(kb, pb)))
                if cap == caps[0]:
                    overflow_rows.append(int((kb[2] > cap).sum()))
                del kb, pb
            # the exact form at one slot, the filter's capacity, every
            # survivor, and the whole leaf (padding after the survivors)
            for capacity in sorted({1, min(n, msg), min(n, int(kc)) or 1,
                                    n}):
                ke = compact.compact_gt_exact(x, t, capacity)
                pe = twin["compact_gt_exact"](x, t, capacity)
                ok["compact_gt_exact"] &= all(same_bits(a, b)
                                              for a, b in zip(ke, pe))
                err["compact_gt_exact"] = max(
                    err["compact_gt_exact"],
                    *(max_err(a, b) for a, b in zip(ke, pe)))
        ks, pk = block_stats.abs_sum_max(x), twin["abs_sum_max"](x)
        ok["abs_sum_max"] = all(same_bits(a, b) for a, b in zip(ks, pk))
        err["abs_sum_max"] = max(err["abs_sum_max"],
                                 *(max_err(a, b) for a, b in zip(ks, pk)))
        g = torch.randn(x.shape, generator=gen, device=dev) * 1e-3
        u = torch.randn(x.shape, generator=gen, device=dev) * 1e-2
        for nesterov in (False, True):
            kw = dict(momentum=0.9, nesterov=nesterov)
            got = residual_update.residual_update(g, u, x, **kw)
            want = twin["residual_update"](g, u, x, **kw)
            ok["residual_update"] &= all(same_bits(a, b)
                                         for a, b in zip(got, want))
            err["residual_update"] = max(
                err["residual_update"],
                *(max_err(a, b) for a, b in zip(got, want)))
        torch.cuda.synchronize()
        print(f"[leaf] {label}: " + ", ".join(
            f"{k} {'equal' if v else 'DIFFERS'}" for k, v in ok.items())
            + f"; caps {caps}, rows over cap {caps[0]} at thresholds "
            f"{thrs}: {overflow_rows} of {-(-n // 1024):,}")
        if not all(ok.values()):
            _fail(f"a per-leaf kernel differs from its twin on {label}")

    # the exact form and the statistics on slot views of the full-width
    # arena (offsets 14,649 and 46,875 rows), as multi_select runs them
    group = full_width_group()
    arena = _arena_of(group, gen)
    for s in (1, 5):
        x = kseg._slot_flat(arena, group.geometry, s)
        n, k = x.numel(), group.geometry.seg_ks[s]
        ok = all(same_bits(a, b) for a, b in zip(block_stats.abs_sum_max(x),
                                                 twin["abs_sum_max"](x)))
        for thr in (3.0, 0.0):
            t = torch.tensor(thr, device=dev)
            alive = int(threshold_count.count_gt(x, t))
            for capacity in sorted({1, 2 * k, alive or 1, n}):
                ke = compact.compact_gt_exact(x, t, capacity)
                pe = twin["compact_gt_exact"](x, t, capacity)
                ok &= all(same_bits(a, b) for a, b in zip(ke, pe))
                err["compact_gt_exact"] = max(
                    err["compact_gt_exact"],
                    *(max_err(a, b) for a, b in zip(ke, pe)))
        torch.cuda.synchronize()
        print(f"[leaf] arena slot {s} ({group.slots[s].leaf}, n={n:,}, "
              f"offset {x.data_ptr() - arena.data_ptr():,} bytes): "
              f"compact_gt_exact and abs_sum_max "
              f"{'equal' if ok else 'DIFFER'}")
        if not ok:
            _fail(f"a per-leaf kernel differs from its twin on arena slot {s}")
    del arena, x, ke, pe

    # timing at the shapes the per-leaf paths give the kernels
    for n, x in full.items():
        t = torch.tensor(3.0, device=dev)
        cap = _cap_for(2 * math.ceil(0.001 * n), -(-n // 1024), 1024)
        nb = -(-n // 1024)
        tiles = -(-n // compact.EXACT_TILE)
        g = torch.randn(n, generator=gen, device=dev) * 1e-3
        u = torch.randn(n, generator=gen, device=dev) * 1e-2
        kw = dict(momentum=0.9, nesterov=False)
        # the exact form as the trimmed top-k runs it: every survivor
        alive = int(threshold_count.count_gt(x, t))
        print(f"[leaf] compact_gt_exact n={n:,}: {alive:,} survivors of "
              f"threshold 3, all written")
        timing = {
            "count_gt": (lambda: threshold_count.count_gt(x, t),
                         lambda: twin["count_gt"](x, t),
                         4 * n + 4 + 4, 3 * n, None),
            "abs_sum_max": (lambda: block_stats.abs_sum_max(x),
                            lambda: twin["abs_sum_max"](x), 4 * n + 8, 3 * n,
                            lambda: torch.linalg.vector_norm(x, 1)),
            "compact_gt": (lambda: compact.compact_gt(x, t, cap),
                           lambda: twin["compact_gt"](x, t, cap),
                           4 * n + 4 + nb * cap * 8 + nb * 4, 3 * n, None),
            "compact_gt_exact": (
                lambda: compact.compact_gt_exact(x, t, alive),
                lambda: twin["compact_gt_exact"](x, t, alive),
                4 * n + 4 + alive * 8 + (tiles + 1) * 8, 3 * n, None),
            "residual_update": (
                lambda: residual_update.residual_update(g, u, x, **kw),
                lambda: twin["residual_update"](g, u, x, **kw),
                5 * 4 * n, 3 * n, None),
        }
        for name, (kern, plain, nbytes, n_ops, lib) in timing.items():
            row = time_kernel(f"{name} n={n:,}", kern, plain, nbytes, n_ops,
                              source="leaf.cu", library=lib)
            if n == 15_000_000:
                row.update(name=name, replaces=LEAF_REPLACES[name],
                           max_abs_err=err[name])
                results[name] = row
        # the bucketed compaction where the survivors crowd 2% of the rows
        xc = crowd[n]
        over = int((compact.compact_gt(xc, t, cap)[2] > cap).sum())
        time_kernel(f"compact_gt crowded n={n:,} ({over:,} of {nb:,} rows "
                    f"over cap {cap})",
                    lambda: compact.compact_gt(xc, t, cap),
                    lambda: twin["compact_gt"](xc, t, cap),
                    *timing["compact_gt"][2:4], source="leaf.cu")
        # abs_sum_max at other column splits than block_stats.split's 2^13:
        # the same bits, other launch shapes (2^(logm - 5) blocks)
        want = twin["abs_sum_max"](x)
        logp = block_stats.split(n)[0]
        for logm in (11, 12, 13):
            part = block_stats.scratch(logm, dev)
            out = torch.empty(2, device=dev)

            def at_split(logm=logm, part=part, out=out):
                rc = block_stats._fn()(x.data_ptr(), n, 1, logp, logm,
                                       part.data_ptr(), out.data_ptr(),
                                       kseg._stream())
                kseg._raise_on(rc, f"abs_sum_max at 2^{logm} columns")
            at_split()
            same = all(same_bits(a, b) for a, b in zip(out, want))
            ms = graph_ms(at_split, 20)
            print(f"[leaf] abs_sum_max n={n:,} at 2^{logm} columns "
                  f"({1 << (logm - 5)} blocks): {ms:.4f} ms, "
                  f"{'equal' if same else 'DIFFERS'}")
            if not same:
                _fail(f"abs_sum_max at 2^{logm} columns differs from its twin")
        # the exact form as the filter runs it: the first 2k survivors at
        # the threshold the bisection finds on this leaf
        k = math.ceil(0.001 * n)
        t_f = ops.threshold_binary_search(x, k)[1]
        alive = int(threshold_count.count_gt(x, t_f))
        time_kernel(f"compact_gt_exact n={n:,} capacity 2k={2 * k:,} "
                    f"({alive:,} survivors)",
                    lambda: compact.compact_gt_exact(x, t_f, 2 * k),
                    lambda: twin["compact_gt_exact"](x, t_f, 2 * k),
                    4 * n + 4 + 2 * k * 8 + (tiles + 1) * 8, 3 * n,
                    source="leaf.cu")
        del g, u
    print("[leaf] library_ms: abs_sum_max against torch.linalg.vector_norm"
          "(x, 1), which sums in its own order (a yardstick only); no one "
          "PyTorch call counts |x| > t, buckets survivors, returns the "
          "first survivors' values and indices, or returns both U' and V'")


def _full_width_tree(gen, dev, scale: float):
    import torch
    from repro_torch.configs import paper_lstm
    from repro_torch.core import tree
    from repro_torch.models import lstm
    defs = lstm.param_defs(paper_lstm.FULL)
    leaves = [torch.randn(shape, generator=gen, device=dev) * scale
              for _, (shape, _i, _s) in tree.flatten_with_paths(defs)]
    return tree.unflatten(tree.structure(defs), leaves)


def _twins_patched():
    """Every kernel wrapper replaced by its plain twin (a context)."""
    import contextlib
    from unittest import mock

    import numpy as np
    from repro_torch.kernels import ref
    from repro_torch.kernels import segmented as kseg

    def rows(g, stride_seg):
        return (None if stride_seg is None else
                np.asarray(stride_seg, np.int32)[np.asarray(g.block_seg)])
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        kseg, "seg_abs_sum_max", lambda x, g, stride_seg=None:
        ref.seg_abs_sum_max(x, g.block_seg, g.block_size, g.n_seg,
                            stride_seg)))
    stack.enter_context(mock.patch.object(
        kseg, "seg_count_gt", lambda x, g, t, stride_seg=None:
        ref.seg_count_gt(x, g.block_seg, t, g.n_seg, rows(g, stride_seg))))
    stack.enter_context(mock.patch.object(
        kseg, "seg_compact_gt", lambda x, g, t, c: ref.seg_compact_gt(
            x, g.block_seg, g.block_base, g.block_size, t, c)))
    stack.enter_context(mock.patch.object(
        kseg, "seg_residual_update_stats", ref.seg_residual_update_stats))
    from repro_torch.kernels import (block_stats, compact, residual_update,
                                     threshold_count)
    twin = _leaf_twins()
    for mod, name in ((threshold_count, "count_gt"),
                      (block_stats, "abs_sum_max"), (compact, "compact_gt"),
                      (compact, "compact_gt_exact"),
                      (residual_update, "residual_update")):
        stack.enter_context(mock.patch.object(mod, name, twin[name]))
    return stack


def phase_sync() -> None:
    """Two full-width updates with kernels vs with the twins patched in,
    for rgc (arena, and per leaf: 3a), trimmed_topk (arena, and per leaf:
    3b) and sampled_bsearch with per-leaf and fused accumulation; then sampled
    fused vs sampled per-leaf accumulation, and the state after one
    per-leaf update (3a) vs after one arena update (default)."""
    import torch
    from repro_torch.core import tree
    from repro_torch.core.gradient_sync import build_gradient_sync
    from repro_torch.kernels import common
    from repro_torch.kernels import segmented as kseg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    params = _full_width_tree(gen, dev, 0.05)
    grads = [_full_width_tree(gen, dev, 1e-3) for _ in range(2)]
    lr = torch.tensor(0.1, dtype=torch.float32, device=dev)

    def run(optimizer, fuse_leaves, fuse_accumulate):
        """(params, state, messages) after the two updates, and (params,
        state) after the first."""
        sync = build_gradient_sync(optimizer, device=dev,
                                   fuse_leaves=fuse_leaves,
                                   fuse_accumulate=fuse_accumulate)
        sent = []
        gather = sync.transport.allgather

        def spy(messages):
            sent.extend(m.clone() for m in messages)
            return gather(messages)
        sync.transport.allgather = spy
        p, st = params, sync.init(params)
        states = []
        for g in grads:
            p, st = sync.update(g, st, p, lr)
            states.append((p, st))
        torch.cuda.synchronize()
        return p, st, sent, states[0]

    def flat(x):
        out = []
        for leaf in tree.flatten(x)[0]:
            out.extend(leaf if isinstance(leaf, tuple) else [leaf])
        return out

    def equal(pairs) -> bool:
        for a, b in pairs:
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            if not torch.equal(a, b):
                return False
        return True

    def bitwise(a_run, b_run) -> bool:
        (pa, sa, ma, _), (pb, sb, mb, _) = a_run, b_run
        if len(ma) != len(mb) or not ma:
            return False
        return equal(list(zip(flat(pa), flat(pb)))
                     + list(zip(flat(sa), flat(sb))) + list(zip(ma, mb)))

    kept = {}
    for optimizer, fuse_leaves, fuse in (
            ("rgc", True, False), ("trimmed_topk", True, False),
            ("sampled_bsearch", True, False),
            ("sampled_bsearch", True, True), ("rgc", False, False),
            ("trimmed_topk", False, False)):
        label = (f"{optimizer} fuse_leaves={fuse_leaves} "
                 f"fuse_accumulate={fuse}")
        before = dict(kseg.launches)
        took = dict(common.branches)
        t0 = time.perf_counter()
        with_kernels = run(optimizer, fuse_leaves, fuse)
        t_k = time.perf_counter() - t0
        used = {k: kseg.launches[k] - before[k] for k in before
                if kseg.launches[k] != before[k]}
        took = {k: common.branches[k] - took[k] for k in took}
        before = dict(kseg.launches)
        with _twins_patched():
            t0 = time.perf_counter()
            with_twins = run(optimizer, fuse_leaves, fuse)
            t_p = time.perf_counter() - t0
        if kseg.launches != before:
            _fail("the twin run launched a kernel")
        print(f"[sync] {label}: 2 full-width updates: kernels {t_k:.2f} s "
              f"(launches {used}; branches {took}), plain twins "
              f"{t_p:.2f} s")
        if not bitwise(with_kernels, with_twins):
            _fail(f"full-width GradientSync.update ({label}) differs "
                  f"between the kernels and the plain twins")
        thr = [float(s.threshold) for s in tree.flatten(with_kernels[1])[0]]
        print(f"[sync] {label}: params, residual, momentum, thresholds and "
              f"{len(with_kernels[2])} packed messages bitwise equal; "
              f"thresholds {thr}")
        if optimizer != "trimmed_topk":
            kept[(optimizer, fuse_leaves, fuse)] = with_kernels
        del with_twins
    if not bitwise(kept[("sampled_bsearch", True, False)],
                   kept[("sampled_bsearch", True, True)]):
        _fail("sampled_bsearch: fuse_accumulate=True differs from False")
    print("[sync] sampled_bsearch: fuse_accumulate True and False bitwise "
          "equal on the card")
    (pa, sa), (pb, sb) = (kept[("rgc", fl, False)][3] for fl in (True, False))
    fields = [(a, b) for x, y in zip(tree.flatten(sa)[0], tree.flatten(sb)[0])
              for a, b in ((x.residual, y.residual), (x.momentum, y.momentum),
                           (x.threshold, y.threshold))]
    if not equal(list(zip(flat(pa), flat(pb))) + fields):
        _fail("one per-leaf rgc update (3a) differs from one arena update")
    print("[sync] rgc: after one update, per leaf (3a) and arena (default) "
          "params, residual, momentum and thresholds bitwise equal")


LEAF_KERNELS = tuple(LEAF_REPLACES)
# (key, label, TrainConfig overrides, kernels the path must launch)
PATHS = (
    ("default", "default", {},
     ("seg_abs_sum_max", "seg_count_gt", "seg_compact_gt",
      "residual_update")),
    ("2a", "2a sampled_bsearch", {"optimizer": "sampled_bsearch"},
     ("seg_abs_sum_max_strided", "seg_count_gt_strided", "seg_count_gt",
      "seg_compact_gt", "residual_update")),
    ("2b", "2b sampled_bsearch fuse_accumulate",
     {"optimizer": "sampled_bsearch", "fuse_accumulate": True},
     ("seg_residual_update_stats", "seg_count_gt_strided", "seg_count_gt",
      "seg_compact_gt")),
    ("3a", "3a rgc per leaf", {"fuse_leaves": False}, LEAF_KERNELS),
    ("3b", "3b trimmed_topk per leaf",
     {"optimizer": "trimmed_topk", "fuse_leaves": False}, LEAF_KERNELS),
)


def _selection_spies(buckets: list, plain: dict):
    """A context that records what the selectors do on the card: every
    bucketed compaction's (row counts, bucket size) into ``buckets``, and
    into ``plain`` each call of the plain whole-vector selections
    (``selection.threshold_filter``, ``selection._pad_topk``) on a CUDA
    tensor. A row over the largest bucket of a ``seg_compact_gt`` launch
    overflows its slot's bucket, so the count is a lower bound there."""
    import contextlib
    from unittest import mock

    from repro_torch.core import selection
    from repro_torch.kernels import compact, ops
    from repro_torch.kernels import segmented as kseg

    def spy_compact(fn):
        def spy(*args):
            out = fn(*args)
            buckets.append((out[2], args[-1]))
            return out
        return spy

    def spy_plain(name, fn):
        def spy(x, *args, **kw):
            if x.device.type == "cuda":
                plain[name] = plain.get(name, 0) + 1
            return fn(x, *args, **kw)
        return spy
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        kseg, "seg_compact_gt", spy_compact(kseg.seg_compact_gt)))
    stack.enter_context(mock.patch.object(
        compact, "compact_gt", spy_compact(compact.compact_gt)))
    for name in ("threshold_filter", "_pad_topk"):
        plain_fn = getattr(selection, name)
        # the modules that hold the plain function itself (ops has its own
        # threshold_filter: the composition of the kernels)
        for mod in (selection, kseg, ops):
            if getattr(mod, name, None) is plain_fn:
                stack.enter_context(mock.patch.object(
                    mod, name, spy_plain(name, plain_fn)))
    return stack


def phase_train(results: dict, profile: int) -> None:
    import torch
    from repro_torch.configs import paper_lstm
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import common
    from repro_torch.kernels import segmented as kseg
    from repro_torch.launch.train import profile_steps
    from repro_torch.train.trainer import Trainer

    steps = 8
    per_path = {k: {} for k in kseg.launches}
    for key, label, overrides, needs in PATHS:
        trainer = Trainer(paper_lstm.FULL, TrainConfig(**overrides))
        state = trainer.init_state()
        data = iter(SyntheticLM(vocab_size=10_000, batch=20, seq_len=35,
                                seed=SEED))
        torch.cuda.synchronize()
        rec = []
        last = [time.perf_counter(), {}]

        def on_metrics(step, density, loss):
            torch.cuda.synchronize()
            now = time.perf_counter()
            counts = {k: v - last[1].get(k, 0)
                      for k, v in kseg.launches.items() if v}
            rec.append((step, loss, now - last[0], counts))
            last[0], last[1] = now, dict(kseg.launches)

        for counts in (kseg.launches, common.branches):
            for k in counts:
                counts[k] = 0
        buckets, plain = [], {}
        last[0] = time.perf_counter()
        with _selection_spies(buckets, plain):
            state = trainer.run(state, data, steps, log_every=0,
                                on_metrics=on_metrics)
        total = dict(kseg.launches)
        for step, loss, dt, counts in rec:
            print(f"[train] {label}: step {step} loss {loss:.6f} time "
                  f"{dt * 1e3:.2f} ms launches {counts}")
        med = statistics.median(dt for _, _, dt, _ in rec)
        over = sum(bool((cnt > cap).any()) for cnt, cap in buckets)
        print(f"[train] {label}: median step {med * 1e3:.2f} ms; launches "
              f"over {steps} steps "
              f"{ {k: v for k, v in total.items() if v} }; branches "
              f"{dict(common.branches)}; bucketed compactions with a row "
              f"over its bucket {over} of {len(buckets)}; whole-leaf or "
              f"whole-slot plain selections on the card {plain}")
        if not all(math.isfinite(loss) for _, loss, _, _ in rec):
            _fail(f"non-finite loss on path {label}")
        if over and not common.branches["exact_compaction"]:
            _fail(f"buckets overflowed on path {label} and no exact "
                  f"compaction ran")
        if any(plain.values()):
            _fail(f"a plain whole-leaf selection ran on the card on path "
                  f"{label}: {plain}")
        for name in needs:
            if total[name] <= 0:
                _fail(f"{name} was not launched on path {label}")
        for k, v in total.items():
            per_path[k][key] = v
        if profile:
            print(f"[profile] {label}:")
            profile_steps(trainer, state, data, profile)
        del trainer, state
        torch.cuda.empty_cache()
    for name, counts in per_path.items():
        if not any(counts.values()):
            _fail(f"{name} was launched on no path")
        results[name]["launches"] = counts


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after each path's steps, profile N more steps")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "src"))
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; devices {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    logs = build.build(("segmented", "leaf"))
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {name}: {line.strip()}")

    results: dict = {}
    phase_kernels(results)
    phase_sampled_kernels(results)
    phase_leaf_kernels(results)
    phase_sync()
    phase_train(results, args.profile)

    print(json.dumps({"kernels": [results[k] for k in (
        "seg_abs_sum_max", "seg_count_gt", "seg_compact_gt",
        "seg_abs_sum_max_strided", "seg_count_gt_strided",
        "seg_residual_update_stats", *LEAF_KERNELS)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
