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
3b. the quantized search forms (``ops.threshold_binary_search_quant``,
   ``ops.trimmed_topk_quant``: the per-leaf kernels on the signed score)
   with the kernels and with the twins, in both phases, on full-width
   leaves of 9M and 15M elements, a 9M leaf of ±0.0 with 1% nonzero
   entries and a 9M leaf with 100 positives (fewer than k of phase 0's
   sign): indices, count, overflow and quantized values bitwise, and
   bitwise equal to the plain ``selection.*_quant`` on the same leaf;
   each form's time per call on the two normal leaves beside the plain
   version's;
4. two full-width ``GradientSync.update`` steps (refresh, then threshold
   reuse) with the kernels, and again with the twins on the same CUDA
   tensors, for ``rgc`` (arena, and per leaf: 3a), ``trimmed_topk``
   (arena, and per leaf: 3b), ``sampled_bsearch`` with
   ``fuse_accumulate`` off and on, ``rgc_quant`` and
   ``"factor_masking+warmup(rgc)"`` with ``local_clip=1.0``: params,
   residual, momentum, thresholds, phases and packed messages bitwise
   equal; sampled fused equal to sampled per-leaf accumulation; and
   after one update, per leaf (3a) equal to arena (default). Then the
   §5.6 schedules on the default path, four full-width updates each,
   params, residual, momentum, thresholds and messages bitwise:
   ``chunked`` equal to ``sequential`` (each sparse leaf's message,
   whichever chunk carried it) and with the kernels equal to with the
   twins; ``stale1`` and ``staleK(k=2)`` equal to a ``sequential`` sync
   whose transport gathers each step's messages one and two steps late
   (their pending messages equal to the ones not gathered yet);
   ``staleK(k=1)`` equal to ``stale1``; ``reabsorb_pending`` of a
   one-step ``stale1`` state gives back the pre-mask residual; the chunk
   layout holds every leaf once, in reverse parameter order;
5. seven paths through ``Trainer(paper_lstm.FULL, TrainConfig(...))``,
   8 steps each of a seeded synthetic stream (batch 20 x seq 35): the
   default (``rgc``), 2a (``optimizer="sampled_bsearch"``), 2b (the
   same with ``fuse_accumulate=True``), 3a (``fuse_leaves=False``),
   3b (``optimizer="trimmed_topk", fuse_leaves=False``), 4a
   (``optimizer="rgc_quant"``: the embedding and output layer in the
   arena, the four LSTM matrices through ``quantized(threshold_bsearch)``
   per leaf, whose phases must be 0 again after the 8 steps) and 4b
   (``optimizer="factor_masking+warmup(rgc)"``, ``local_clip=1.0``,
   ``warmup_steps_per_stage=2``: its density per step must follow the
   four DGC warm-up stages, two steps each), and the schedules 5a
   (``schedule="chunked"``), 5b (``"stale1"``) and 5c
   (``"staleK(k=2)"``); the host syncs inside ``multi_select`` are
   counted per step on every path. Kernel launch
   counts and the selectors' branch counts (exact compaction after a
   bucket overflow, short pick; arena and per leaf) are zeroed just before
   each path and read just after; every loss must be finite, each path
   must launch the kernels it names, a path whose buckets overflowed must
   have run the exact compaction, no plain whole-leaf or whole-slot
   filter or sort may run on the card, and every kernel must be launched
   on some path;
   with ``--profile N``, N more steps of each path under
   ``torch.profiler`` print its device time by kernel;
6. data-parallel ranks on the one card over ``torch.distributed``
   (``spawn`` children, ``gloo`` on CUDA tensors, a file store in a
   temporary directory), full-width ``paper-lstm`` with the
   ``TrainConfig`` defaults on a seeded global batch of 40 x 35: at p = 2
   (``("data",) = 2``, 20 rows per rank) 4 steps of the default path with
   the kernels, then with the twins: kernels == twins bitwise (params,
   residual, momentum, thresholds), ranks' params bitwise equal after
   every step, each rank's gathered rows == every rank's own packed
   buffer, each rank's launches per step the phase-5 default path's
   (the same kernels; the same counts for those whose counts do not
   depend on the data; the exact compactions equal to the overflow
   branches; step 1 equal to a one-worker run on rank 0's rows); path 4a
   (2 steps): kernels == twins, ranks' params equal, and
   ``per_leaf_allgather`` == ``fused_allgather``; path 3a
   with ``bucketed_allgather`` (at least 3 buckets) and
   ``per_leaf_allgather`` == ``fused_allgather``; ``chunked`` (4 steps:
   ranks equal, equal to ``sequential`` on its logged gradients, one
   collective per chunk with messages) and ``stale1`` (3 steps: ranks
   equal, equal to ``sequential`` gathering one step late); at p = 4
   (``("node", "local") = (2, 2)``) ``hierarchical`` with either intra
   axis == ``fused_allgather``, and path 4a (2 steps) with
   ``hierarchical`` == ``fused_allgather``; one rank over NCCL == no
   mesh. A collective that waits over ``DIST_PG_TIMEOUT_S`` raises.
   Prints the
   ``WallClockTimer`` stage split (ms per step and share per stage, the
   counters, the median step) at p = 1 and p = 2, and each rank's peak
   device memory;
7. checkpoints at full width: (7a) on the default path and under
   ``staleK(k=2)``, an uninterrupted 8-step run, a run with
   ``ckpt_every=2`` that dies after step 5 (no end save), and a fresh
   ``Trainer`` that restores step 4, replays the stream and finishes:
   params, every ``LeafState`` field and the pending ring bitwise equal
   to the uninterrupted run's, with the kernels' launches counted over
   these runs; (7b) elastic p = 2 -> 1: two spawned gloo ranks train 2
   steps under ``stale1`` and save (rows gathered, rank 0 writes), then
   two restores at p = 1 must be bitwise equal and equal to the remainder
   rule applied in numpy to the saved rows after reabsorbing each row's
   ring; (7c) the launcher, ``--ckpt-every 2 --steps 4`` then
   ``--resume --steps 6`` == ``--steps 6`` bitwise. Prints each save's
   seconds and bytes (full or delta; a delta's sparse and dense leaves),
   each restore's seconds, the phase's seconds and the card's name and
   power limit;
8. the transformer chassis at full width, each with ``TrainConfig()``
   (``rgc``, density 0.001, ``fuse_leaves``, ``sequential``) on the
   seeded zipf stream: (8a) ``internlm2-1.8b`` FULL (24 layers, bf16,
   1,889,110,016 params; its nine matrices form one 1,889,009,664-element
   arena), global batch 2 x seq 4096 for 4 steps, each step's loss
   (finite) and wall time, the peak device memory and the launches
   (fails unless ``seg_abs_sum_max``, ``seg_count_gt`` and
   ``seg_compact_gt`` launch), one profiled step (device time by kernel,
   busy and idle share), then one ``GradientSync.update`` on a further
   step's gradients with the kernels and one with the twins from the
   same state (params, residual, momentum, thresholds, phases and the
   wire messages bitwise; the kernel run's result is held on the host),
   and, between the two, kernels 1-3 on that update's arena at its
   thresholds and bucket (each output bitwise its twin's, then 20
   launches in one CUDA graph beside the bound) and 7e / 8 on the
   largest input the update gave them (bitwise their twins'); (8b) ``gemma3-4b`` at 6 of its 34 layers
   (one ``L L L L L G`` cycle: window 1024 and theta 10k, then global
   theta 1M) and (8c) ``paligemma-3b`` at 2 of its 18 layers (a
   256-token bidirectional stub prefix plus 1024 text tokens), batch 1,
   2 steps each: losses finite, params moved, peak memory printed;
9. the MoE FFN (``models/moe.py``) on the transformer chassis:
   (9a) ``granite-moe-3b-a800m`` FULL at 20 of its 32 layers (d_model
   1536, 40 experts of d_ff 512, top-8, scatter dispatch, bf16;
   2,090,059,776 params; 20 layers is the deepest cut whose bsearch
   arena, 2,088,768,512 elements, stays below the int32 limit of its
   message indices), batch 2 x seq 4096 for 4 steps as 8a with
   ``TrainConfig(local_clip=1.0)`` (``GRANITE_TRAIN`` says why): losses
   finite, each step's wall time, the peak device memory, the arenas'
   sizes (fails at the int32 limit), the launches (fails unless kernels
   1-3 launch), one profiled step, each leaf's largest gradient beside
   its largest entry, one update with the kernels, and kernels 1-3 on
   its bsearch arena and 7e / 8 on their largest inputs, each against
   its twin bitwise, then the same update with the twins, bitwise, as
   8a;
   (9b) one MoE layer at full width on 512 tokens in f32, of granite
   (capacity factor 1.25 and 0.1) and of ``grok-1-314b`` (d_model 6144,
   8 experts of d_ff 32768, top-2; 1.25): ``gate_idx`` / ``slot`` /
   ``keep`` identical under the one-hot and scatter forms and equal to
   the same function on the CPU, the forms' outputs, aux loss and
   gradients (x and every MoE leaf) within ``tests/test_torch_moe.py``'s
   tolerances, drops at 0.1, everything finite, each form's forward +
   backward time;
   (9c) ``grok-1-314b`` smoke (top-2, softcap 30, untied), batch 2 x
   128, 2 steps: losses finite, params moved;
10. a JSON line per kernel (time, bound, launches on each path, on rank
   0 of the p = 2 default path, over phase 7a's runs and over phase 8a's
   and 9a's steps, error), then the last line ``{"ok": true, "device":
   {...}}``.

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


# phase 3b: the quantized selectors' leaf sizes (the four LSTM matrices
# of path 4a and the embedding-sized leaf) and the main path's density
QUANT_LEAVES = (9_000_000, 15_000_000)
QUANT_DENSITY = 0.001


def _quant_cases(gen, dev) -> list:
    """(label, flat leaf) for phase 3b: seeded normal leaves at each size;
    a 9M leaf of ±0.0 with 1% nonzero entries; and one where only 100
    elements are positive, so phase 0 finds fewer than k (and ±0.0
    sits among the negatives)."""
    import torch
    n = QUANT_LEAVES[0]
    cases = [(f"normal n={m:,}", torch.randn(m, generator=gen, device=dev))
             for m in QUANT_LEAVES]
    x = torch.randn(n, generator=gen, device=dev)
    keep = torch.rand(n, generator=gen, device=dev) < 0.01
    sign = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5,
                       -1.0, 1.0)
    cases.append((f"signed zeros n={n:,}", torch.where(keep, x, 0.0) * sign))
    y = -torch.randn(n, generator=gen, device=dev).abs()
    y[torch.randperm(n, generator=gen, device=dev)[:100]] *= -1.0
    y[torch.rand(n, generator=gen, device=dev) < 0.2] = -0.0
    cases.append((f"100 positives n={n:,}", y))
    return cases


def phase_quant_forms() -> None:
    """The quantized search forms (``ops.threshold_binary_search_quant``,
    ``ops.trimmed_topk_quant``) with the kernels and with the twins, in
    both phases, on the full-width leaves and two skewed ones: indices,
    count, overflow and the quantized values bitwise, and bitwise equal
    to the plain ``selection.*_quant`` on the same leaf. Each form's time
    on the normal leaves (phase 0) beside the plain version's."""
    import torch
    from repro_torch.core import selection
    from repro_torch.kernels import ops
    from repro_torch.kernels import segmented as kseg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    forms = ("threshold_binary_search_quant", "trimmed_topk_quant")
    for label, x in _quant_cases(gen, dev):
        k = math.ceil(QUANT_DENSITY * x.numel())
        for phase in (0, 1):
            ph = torch.tensor(phase, dtype=torch.int32, device=dev)
            for form in forms:
                before = dict(kseg.launches)
                got = getattr(ops, form)(x, k, ph)
                used = {n: kseg.launches[n] - before[n] for n in before
                        if kseg.launches[n] != before[n]}
                with _twins_patched():
                    want = getattr(ops, form)(x, k, ph)
                plain = getattr(selection, form)(x, k, ph)
                torch.cuda.synchronize()
                same = all(_same_bits(a, b) for a, b in zip(got, want))
                as_plain = all(_same_bits(a, b) for a, b in zip(got, plain))
                n_pos = int((selection._signed_score(x, ph) > 0).sum())
                print(f"[quant] {form} {label} phase {phase}: kernels and "
                      f"twins {'equal' if same else 'DIFFER'}, kernels and "
                      f"plain selection.{form} "
                      f"{'equal' if as_plain else 'DIFFER'}; count "
                      f"{int(got.count):,} of k={k:,} ({n_pos:,} of the "
                      f"phase's sign), mean {float(got.values[0]):.6g}, "
                      f"launches {used}")
                if not same:
                    _fail(f"ops.{form} differs between the kernels and the "
                          f"twins on {label} phase {phase}")
                if not as_plain:
                    _fail(f"ops.{form} differs from selection.{form} on "
                          f"{label} phase {phase}")
                if not used:
                    _fail(f"ops.{form} launched no kernel on {label}")
                if label.startswith("normal") and phase == 0:
                    ms = cuda_ms(lambda: getattr(ops, form)(x, k, ph), 5)
                    plain_ms = cuda_ms(
                        lambda: getattr(selection, form)(x, k, ph), 3)
                    print(f"[quant] {form} {label} k={k:,}: kernels "
                          f"{ms:.4f} ms per call (host loop included); "
                          f"plain selection.{form} {plain_ms:.4f} ms")


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

    def run(optimizer, fuse_leaves, fuse_accumulate, kw):
        """(params, state, messages) after the two updates, and (params,
        state) after the first."""
        sync = build_gradient_sync(optimizer, device=dev,
                                   fuse_leaves=fuse_leaves,
                                   fuse_accumulate=fuse_accumulate, **kw)
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
    for optimizer, fuse_leaves, fuse, kw in (
            ("rgc", True, False, {}), ("trimmed_topk", True, False, {}),
            ("sampled_bsearch", True, False, {}),
            ("sampled_bsearch", True, True, {}), ("rgc", False, False, {}),
            ("trimmed_topk", False, False, {}),
            ("rgc_quant", True, False, {}),
            ("factor_masking+warmup(rgc)", True, False,
             {"local_clip": 1.0})):
        label = (f"{optimizer} fuse_leaves={fuse_leaves} "
                 f"fuse_accumulate={fuse}"
                 + "".join(f" {k}={v}" for k, v in kw.items()))
        before = dict(kseg.launches)
        took = dict(common.branches)
        t0 = time.perf_counter()
        with_kernels = run(optimizer, fuse_leaves, fuse, kw)
        t_k = time.perf_counter() - t0
        used = {k: kseg.launches[k] - before[k] for k in before
                if kseg.launches[k] != before[k]}
        took = {k: common.branches[k] - took[k] for k in took}
        before = dict(kseg.launches)
        with _twins_patched():
            t0 = time.perf_counter()
            with_twins = run(optimizer, fuse_leaves, fuse, kw)
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
        phases = [int(s.phase) for s in tree.flatten(with_kernels[1])[0]]
        print(f"[sync] {label}: params, residual, momentum, thresholds, "
              f"phases and {len(with_kernels[2])} packed messages bitwise "
              f"equal; thresholds {thr}; phases {phases}")
        if optimizer in ("rgc", "sampled_bsearch"):
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


def _delay(transport, k: int) -> list:
    """Make ``transport.allgather`` gather the messages it was given ``k``
    calls earlier (all-zero messages for the first ``k`` calls), so a
    ``sequential`` sync applies each step's selection ``k`` steps late: the
    stale schedules' semantics built without their code. Returns the
    queue of messages not gathered yet, oldest first."""
    import torch
    gather = transport.allgather
    queue: list = []

    def delayed(messages):
        if not queue:
            queue.extend([torch.zeros_like(m) for m in messages]
                         for _ in range(k))
        queue.append(list(messages))
        return gather(queue.pop(0))
    transport.allgather = delayed
    return queue


def _leaf_messages(sync) -> list:
    """Record each update's gathered row-0 message of every sparse leaf,
    ``{leaf index: tensor}``, whichever unit (an arena slot or a per-leaf
    message, in whichever chunk) carried it. Returns the list of the
    updates' dicts."""
    from repro_torch.core import arena
    sent: list = []
    update, apply = sync.update, sync._apply_gathered

    def update_spy(*args, **kw):
        sent.append({})
        return update(*args, **kw)

    def apply_spy(gathered, meta, *args):
        for buf, m in zip(gathered, meta):
            if m[0] == "arena":
                for slot, sbuf in zip(m[1].slots,
                                      arena.split_message(m[1], buf)):
                    sent[-1][slot.leaf] = sbuf[0].clone()
            else:
                sent[-1][m[1]] = buf[0].clone()
        return apply(gathered, meta, *args)
    sync.update, sync._apply_gathered = update_spy, apply_spy
    return sent


SCHED_STEPS = 4


def phase_schedules() -> None:
    """Phase 4, the §5.6 schedules on the default path at full width, 4
    updates each (params, residual, momentum, thresholds and messages
    bitwise): ``chunked`` == ``sequential`` (each sparse leaf's message,
    whichever chunk carried it), ``chunked`` with the kernels == with the
    twins, ``stale1`` and ``staleK(k=2)`` == a ``sequential`` sync whose
    transport gathers each step's messages 1 and 2 steps late (pending ==
    the messages not gathered yet), ``staleK(k=1)`` == ``stale1``;
    ``reabsorb_pending`` of one ``stale1`` step from a zero state gives
    back the pre-mask residual, which is that step's gradient
    (V = 0 + (0.9 * 0 + g)); the chunk layout covers every leaf once, in
    reverse parameter order."""
    import torch
    from repro_torch.core import tree
    from repro_torch.core.gradient_sync import build_gradient_sync
    from repro_torch.core.overlap import reabsorb_pending
    from repro_torch.kernels import segmented as kseg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 5)
    params = _full_width_tree(gen, dev, 0.05)
    grads = [_full_width_tree(gen, dev, 1e-3) for _ in range(SCHED_STEPS)]
    lr = torch.tensor(0.1, dtype=torch.float32, device=dev)
    paths = [p for p, _ in tree.flatten_with_paths(params)]

    def run(schedule, delay=0, steps=SCHED_STEPS):
        """(leaves of the final params and state by key, per-step leaf
        messages, the sync, the final state)."""
        sync = build_gradient_sync("rgc", device=dev, schedule=schedule)
        queue = _delay(sync.transport, delay) if delay else []
        sent = _leaf_messages(sync)
        p, st = params, sync.init(params)
        before = dict(kseg.launches)
        for g in grads[:steps]:
            p, st = sync.update(g, st, p, lr)
        torch.cuda.synchronize()
        used = {k: kseg.launches[k] - before[k] for k in before
                if kseg.launches[k] != before[k]}
        out = _with_pending(_leaves(p, st), st, queue)
        print(f"[sched] {schedule}{f' (delay {delay})' if delay else ''}: "
              f"{steps} full-width updates, launches {used}")
        return out, sent, sync, st

    def same_messages(a, b) -> bool:
        return len(a) == len(b) and all(
            x.keys() == y.keys() and all(
                torch.equal(_bits(x[k]), _bits(y[k])) for k in x)
            for x, y in zip(a, b))

    bad = []
    seq, seq_sent, _, _ = run("sequential")
    chk, chk_sent, chk_sync, _ = run("chunked")
    if not (_same(chk, seq) and same_messages(chk_sent, seq_sent)):
        bad.append("chunked != sequential")
    with _twins_patched():
        twins, twins_sent, _, _ = run("chunked")
    if not (_same(chk, twins) and same_messages(chk_sent, twins_sent)):
        bad.append("chunked with kernels != with twins")
    del twins, twins_sent
    plans = next(v for k, v in chk_sync._plans.items() if "chunked" in k)
    layout = [[paths[i] for i in
               ([s.leaf for g in pl.groups for s in g.slots]
                + [i for i, _, _ in pl.sparse] + list(pl.dense))]
              for pl in plans]
    print(f"[sched] chunked layout (chunk_bytes {chk_sync.chunk_bytes}): "
          f"{layout}; arena ids "
          f"{[g.aid for pl in plans for g in pl.groups]}")
    if [p for chunk in layout for p in chunk] != paths[::-1]:
        bad.append(f"chunk layout {layout} is not every leaf once in "
                   f"reverse parameter order")
    torch.cuda.empty_cache()

    s1, _, _, _ = run("stale1")
    rep1, _, _, _ = run("sequential", delay=1)
    if not _same(s1, rep1):
        bad.append("stale1 != sequential delayed by one step")
    k1, _, _, _ = run("staleK(k=1)")
    if not _same(k1, s1):
        bad.append("staleK(k=1) != stale1")
    del k1, rep1
    k2, _, _, _ = run("staleK(k=2)")
    rep2, _, _, _ = run("sequential", delay=2)
    if not _same(k2, rep2):
        bad.append("staleK(k=2) != sequential delayed by two steps")
    del k2, rep2, s1
    torch.cuda.empty_cache()

    _, _, sync1, st = run("stale1", steps=1)
    res = tree.flatten(reabsorb_pending(sync1, params, st))[0]
    g0 = tree.flatten(grads[0])[0]
    sparse = [i for i, (path, x) in enumerate(tree.flatten_with_paths(
        params)) if sync1.policy.compressor_for(path, x) != "dense"]
    restored = all(torch.equal(_bits(res[i].residual), _bits(g0[i]))
                   for i in sparse)
    print(f"[sched] reabsorb_pending of a one-step stale1 state: the "
          f"residual of the {len(sparse)} sparse leaves == the step's "
          f"gradient bitwise: {restored}")
    if not restored:
        bad.append("reabsorb_pending did not restore the pre-mask residual")
    if bad:
        _fail("phase 4 schedules: " + "; ".join(bad))
    print(f"[sched] OK over {SCHED_STEPS} full-width updates: chunked == "
          f"sequential (params, residual, momentum, thresholds, each "
          f"leaf's message), chunked kernels == twins, stale1 == sequential "
          f"one step late and staleK(k=2) two steps late (pending == the "
          f"messages not gathered yet), staleK(k=1) == stale1")


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
    ("4a", "4a rgc_quant", {"optimizer": "rgc_quant"},
     ("seg_abs_sum_max", "seg_count_gt", "seg_compact_gt", "count_gt",
      "abs_sum_max", "compact_gt", "residual_update")),
    ("4b", "4b factor_masking+warmup(rgc) local_clip",
     {"optimizer": "factor_masking+warmup(rgc)", "local_clip": 1.0,
      "warmup_steps_per_stage": 2},
     ("seg_abs_sum_max", "seg_count_gt", "seg_compact_gt",
      "residual_update")),
    ("5a", "5a chunked", {"schedule": "chunked"},
     ("seg_abs_sum_max", "seg_count_gt", "seg_compact_gt",
      "residual_update")),
    ("5b", "5b stale1", {"schedule": "stale1"},
     ("seg_abs_sum_max", "seg_count_gt", "seg_compact_gt",
      "residual_update")),
    ("5c", "5c staleK(k=2)", {"schedule": "staleK(k=2)"},
     ("seg_abs_sum_max", "seg_count_gt", "seg_compact_gt",
      "residual_update")),
)
# path 4b's density per step: each DGC warm-up stage for two steps
RAMP_4B = (0.25, 0.25, 0.0625, 0.0625, 0.015625, 0.015625, 0.004, 0.004)


def _selection_spies(buckets: list, plain: dict):
    """A context that records what the selectors do on the card: every
    bucketed compaction's (row counts, bucket size) into ``buckets``, and
    into ``plain`` each call of the plain whole-vector selections
    (``selection.threshold_filter``, ``selection._pad_topk`` and the
    first-survivors filter both plain filters share) on a CUDA tensor. A row over the largest bucket of a ``seg_compact_gt`` launch
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
    for name in ("threshold_filter", "_pad_topk", "_first_survivors"):
        plain_fn = getattr(selection, name)
        # the modules that hold the plain function itself (ops has its own
        # threshold_filter: the composition of the kernels)
        for mod in (selection, kseg, ops):
            if getattr(mod, name, None) is plain_fn:
                stack.enter_context(mock.patch.object(
                    mod, name, spy_plain(name, plain_fn)))
    return stack


def _host_sync_spy(count: list, owner, name: str):
    """A context that adds to ``count[0]`` each host synchronisation
    (``bool``, ``int``, ``float``, ``.item()``, ``.tolist()`` of a CUDA
    tensor) made inside ``owner.name``: ``Quantized.compress`` (the cold
    searches of path 4a's quantized leaves and their filters) or
    ``segmented.multi_select`` (the arena searches)."""
    import contextlib
    from unittest import mock

    import torch

    def counting(fn):
        def spy(self, *args, **kw):
            if self.is_cuda:
                count[0] += 1
            return fn(self, *args, **kw)
        return spy
    inner = getattr(owner, name)

    def spied(*args, **kw):
        with contextlib.ExitStack() as stack:
            for attr in ("__bool__", "__int__", "__float__", "item",
                         "tolist"):
                stack.enter_context(mock.patch.object(
                    torch.Tensor, attr, counting(getattr(torch.Tensor,
                                                         attr))))
            return inner(*args, **kw)
    return mock.patch.object(owner, name, spied)


def _check_4a(trainer, state, rec, syncs) -> None:
    """Path 4a: the four quantized leaves' phase after its steps (0 after
    an even number of flips), and the host synchronisations of their
    cold searches per step, as ``_host_sync_spy`` counted them."""
    from repro_torch.core import tree
    sync = trainer._sync
    flat_p = dict(tree.flatten_with_paths(state.params))
    phases = {path: int(st.phase)
              for path, st in tree.flatten_with_paths(state.rgc)
              if sync._leaf_compressor(sync.policy.compressor_for(
                  path, flat_p[path]), path).quantized}
    print(f"[train] 4a rgc_quant: quantized leaves' phase after "
          f"{len(rec)} steps {phases}; host syncs of their searches per "
          f"step (counted) {syncs}; count_gt launches per step "
          f"{[c.get('count_gt', 0) for _, _, _, c in rec]}")
    if not all(syncs):
        _fail(f"path 4a: no host sync counted in a quantized search: "
              f"{syncs}")
    if len(phases) != 4 or any(phases.values()):
        _fail(f"path 4a: quantized leaves' phases {phases}, want four 0s")


def phase_train(results: dict, profile: int) -> list[dict]:
    """The seven paths; returns the default path's kernel launches per
    step."""
    import torch
    from repro_torch.configs import paper_lstm
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import compressors
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
            densities.append(density)
            syncs.append(host_syncs[0])
            select_syncs.append(arena_syncs[0])
            host_syncs[0] = arena_syncs[0] = 0
            last[0], last[1] = now, dict(kseg.launches)

        for counts in (kseg.launches, common.branches):
            for k in counts:
                counts[k] = 0
        buckets, plain, densities, syncs, host_syncs = [], {}, [], [], [0]
        select_syncs, arena_syncs = [], [0]
        last[0] = time.perf_counter()
        with _selection_spies(buckets, plain), \
                _host_sync_spy(host_syncs, compressors.Quantized,
                               "compress"), \
                _host_sync_spy(arena_syncs, kseg, "multi_select"):
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
              f"whole-slot plain selections on the card {plain}; host "
              f"syncs in multi_select per step {select_syncs}")
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
        if key == "4a":
            _check_4a(trainer, state, rec, syncs)
        if key == "4b":
            print(f"[train] {label}: density per step {densities}")
            if tuple(densities) != RAMP_4B:
                _fail(f"path 4b's densities {densities}, not {RAMP_4B}")
        for k, v in total.items():
            per_path[k][key] = v
        if key == "default":
            default_steps = [counts for _, _, _, counts in rec]
        if profile:
            print(f"[profile] {label}:")
            profile_steps(trainer, state, data, profile)
        del trainer, state
        torch.cuda.empty_cache()
    for name, counts in per_path.items():
        if not any(counts.values()):
            _fail(f"{name} was launched on no path")
        results[name]["launches"] = counts
    return default_steps


# ---------------------------------------------------------------------------
# phase 6: data-parallel ranks on the one card (torch.distributed)
# ---------------------------------------------------------------------------

DIST_STEPS = 4
DIST_BATCH = 40            # global: 20 rows per rank at p = 2, as phase 5
STEPS_3A = 3
STEPS_4A = 2
BUCKET_BYTES_3A = 300_000  # four buckets of path 3a's six messages
# a phase-6 collective that waits longer than this raises (a hung or dead
# peer rank); the task's deadline in ``_spawn`` bounds the whole group
DIST_PG_TIMEOUT_S = 300
# the default path's kernels whose launches per step do not depend on the
# data (the search's counts and the exact compactions do)
FIXED_PER_STEP = ("seg_abs_sum_max", "seg_compact_gt", "residual_update")


def _dist_data(rows: slice | None = None):
    """Phase 6's seeded global batches (``rows``: a slice of each)."""
    from repro_torch.data.synthetic import SyntheticLM
    for batch in SyntheticLM(vocab_size=10_000, batch=DIST_BATCH,
                             seq_len=35, seed=SEED):
        yield batch if rows is None else {"tokens": batch["tokens"][rows]}


def _bits(t):
    import torch
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _leaves(params, rgc=None) -> dict:
    """A params tree and, if given, the residual, momentum, threshold and
    phase of every leaf of its ``LeafState`` tree (inside a buffered
    schedule's ``ScheduleState`` too), by path."""
    from repro_torch.core import tree
    from repro_torch.core.overlap import ScheduleState
    if isinstance(rgc, ScheduleState):
        rgc = rgc.leaf
    out = {f"p{k}": v for k, v in tree.flatten_with_paths(params)}
    for k, st in tree.flatten_with_paths(rgc or {}):
        for fld in ("residual", "momentum", "threshold", "phase"):
            out[f"s{k}.{fld}"] = getattr(st, fld)
    return out


def _same(a: dict, b: dict) -> bool:
    import torch
    return a.keys() == b.keys() and all(
        torch.equal(_bits(a[k]), _bits(b[k])) for k in a)


def _agree(ok: bool) -> bool:
    """True when ``ok`` holds on every rank of the default group."""
    import torch
    import torch.distributed as dist
    flag = torch.tensor([int(ok)])
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def _ranks_equal(tensors: list) -> bool:
    """Whether every rank holds rank 0's bits in each of ``tensors``."""
    import torch
    import torch.distributed as dist
    ok = True
    for t in tensors:
        buf = _bits(t).clone()
        dist.broadcast(buf, src=0)
        ok &= torch.equal(buf, _bits(t))
    return _agree(ok)


def _rows_are_buffers(own, gathered) -> bool:
    """Whether row q of this rank's gathered matrix is rank q's own
    packed buffer, for every q, on every rank (world-group meshes)."""
    import torch
    import torch.distributed as dist
    ok = True
    for q in range(gathered.shape[0]):
        buf = own.clone() if q == dist.get_rank() else torch.empty_like(own)
        dist.broadcast(buf, src=q)
        ok &= torch.equal(_bits(buf), _bits(gathered[q]))
    return _agree(ok)


def _dist_run(mesh, overrides: dict, steps: int, *, timer=None,
              rows: slice | None = None, wrap=None, check=None) -> tuple:
    """``steps`` of ``Trainer(paper_lstm.FULL, TrainConfig(**overrides),
    mesh=mesh)`` on phase 6's batches, launch and branch counts zeroed
    just before. ``timer``: a stage timer the sync reports to (reset
    after step 1), with a device barrier before and after each
    ``GradientSync.update``, whose host times split the step (the
    backward's queued kernels then end before the first stage starts);
    ``wrap(transport)``: called before the first step;
    ``check(step, state)``: run after each step, outside the timed
    window. Returns (final state, per-step records, the replay log: the
    initial params and each step's ``(grads, lr, density)`` as
    ``GradientSync.update`` got them)."""
    import torch
    from repro_torch.configs import paper_lstm
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import common
    from repro_torch.kernels import segmented as kseg
    from repro_torch.train.trainer import Trainer, make_gradient_sync

    trainer = Trainer(paper_lstm.FULL, TrainConfig(**overrides), mesh=mesh)
    if timer is not None:
        trainer._sync = make_gradient_sync(trainer.tc, trainer.device, mesh,
                                           timer)
    sync = trainer._sync
    if wrap is not None:
        wrap(sync.transport)
    log: dict = {"steps": []}
    update = sync.update
    marks = []

    def logged(grads, state, params, lr, density=None):
        if timer is not None:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = update(grads, state, params, lr, density=density)
        if timer is not None:
            torch.cuda.synchronize()
        marks.append((t0, time.perf_counter()))
        log.setdefault("params", params)
        log["steps"].append(({k: v.clone() for k, v in
                              _leaves(grads).items()}, lr, density))
        return out
    sync.update = logged
    state = trainer.init_state()
    data = _dist_data(rows)
    rec = []
    for counts in (kseg.launches, common.branches):
        for k in counts:
            counts[k] = 0
    for step in range(1, steps + 1):
        launches, branches = dict(kseg.launches), dict(common.branches)
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = trainer.run(state, data, 1, log_every=0,
                            on_metrics=lambda s, d, loss: losses.append(loss))
        torch.cuda.synchronize()
        rec.append({"loss": losses[0], "s": time.perf_counter() - t0,
                    "to_sync_s": marks[-1][0] - t0,
                    "sync_s": marks[-1][1] - marks[-1][0],
                    "launches": {k: v - launches[k]
                                 for k, v in kseg.launches.items()
                                 if v != launches[k]},
                    "branches": {k: v - branches[k]
                                 for k, v in common.branches.items()}})
        if timer is not None and step == 1:
            timer.reset()
        if check is not None:
            check(step, state)
    return state, rec, log


def _replay(mesh, overrides: dict, log: dict, timer=None,
            delay: int = 0) -> dict:
    """The logged steps again through a fresh ``GradientSync`` built from
    ``TrainConfig(**overrides)``: every update gets the same gradients
    (so the model's own reduction order cannot enter the comparison).
    ``delay``: its transport gathers each step's messages that many steps
    late (``_delay``). Returns ``_leaves`` of the final params and state,
    with the pending messages (or the delayed ones not gathered yet) as
    ``q<i>``."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import tree
    from repro_torch.train.trainer import make_gradient_sync

    params = log["params"]
    sync = make_gradient_sync(TrainConfig(**overrides),
                              tree.flatten(params)[0][0].device, mesh, timer)
    queue = _delay(sync.transport, delay) if delay else []
    state = sync.init(params)
    struct = tree.structure(params)
    for grads, lr, density in log["steps"]:
        params, state = sync.update(
            tree.unflatten(struct, list(grads.values())), state, params, lr,
            density=density)
    return _with_pending(_leaves(params, state), state, queue)


def _with_pending(out: dict, state, queue=()) -> dict:
    """``out`` plus the messages still in flight as ``q<i>``, oldest
    first: a schedule state's pending buffers (a ``staleK`` ring
    generation by generation), or the delayed messages of ``queue``."""
    from repro_torch.core.overlap import ScheduleState
    waiting = [m for msgs in queue for m in msgs]
    if isinstance(state, ScheduleState):
        gens = state.pending
        if gens and not isinstance(gens[0], tuple):
            gens = (gens,)              # stale1's flat buffer
        waiting += [m for gen in gens for m in gen]
    out.update((f"q{i}", m) for i, m in enumerate(waiting))
    return out


def _chunks_with_messages(overrides: dict, params, mesh) -> int:
    """How many chunks of the ``chunked`` schedule carry sparse messages
    (one collective each) for ``params``' tree."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import tree
    from repro_torch.train.trainer import make_gradient_sync
    flat = tree.flatten_with_paths(params)
    leaves = [x for _, x in flat]
    sync = make_gradient_sync(TrainConfig(**overrides), leaves[0].device,
                              mesh)
    plans = sync._chunk_plans(tree.structure(params),
                              tuple(p for p, _ in flat), leaves,
                              sync.density, False)
    return sum(bool(pl.groups or pl.sparse) for pl in plans)


def _dist_p2(rank: int, mesh, workdir: str) -> dict:
    """World 2, ("data",) = 2: the default path with the kernels (stage
    timer on; ranks' params and the gathered rows checked after every
    step), its steps replayed with the twins; path 4a, its steps replayed
    with the twins and with the per-leaf transport; then path 3a, its
    steps replayed with the bucketed and per-leaf transports."""
    import torch
    from repro_torch.core import WallClockTimer
    out: dict = {"checks": {}}
    seen: list = []
    checks = out["checks"]

    def spy(transport):
        gather = transport.allgather

        def wrapped(messages):
            got = gather(messages)
            seen.append((torch.cat(messages).clone(),
                         torch.cat(got, dim=1).clone()))
            return got
        transport.allgather = wrapped

    def check(step, state):
        checks[f"ranks_equal_step{step}"] = _ranks_equal(
            list(_leaves(state.params).values()))
        checks[f"rows_step{step}"] = bool(seen) and all(
            [_rows_are_buffers(own, g) for own, g in seen])
        seen.clear()

    timer = WallClockTimer()
    state, out["default"], log = _dist_run(
        mesh, {}, DIST_STEPS, timer=timer, wrap=spy, check=check)
    out["split"] = timer.summary()
    with _twins_patched():
        twins = _replay(mesh, {}, log)
    checks["kernels_equal_twins"] = _agree(
        _same(_leaves(state.params, state.rgc), twins))
    del state, log, twins
    torch.cuda.empty_cache()

    # path 4a: kernels == twins, ranks equal, per leaf == fused
    kw = {"optimizer": "rgc_quant"}
    state, out["4a"], log = _dist_run(mesh, kw, STEPS_4A)
    fused = _leaves(state.params, state.rgc)
    checks["4a_ranks_equal"] = _ranks_equal(
        list(_leaves(state.params).values()))
    with _twins_patched():
        twins = _replay(mesh, kw, log)
    checks["4a_kernels_equal_twins"] = _agree(_same(fused, twins))
    got = _replay(mesh, {**kw, "transport": "per_leaf_allgather"}, log)
    checks["4a_per_leaf_allgather_equal_fused"] = _agree(_same(got, fused))
    del state, log, twins, got
    torch.cuda.empty_cache()

    kw = {"fuse_leaves": False}
    state, _, log = _dist_run(mesh, kw, STEPS_3A)
    fused = _leaves(state.params, state.rgc)
    for name, extra in (("bucketed_allgather",
                         {"bucket_bytes": BUCKET_BYTES_3A}),
                        ("per_leaf_allgather", {})):
        timer = WallClockTimer()
        got = _replay(mesh, {**kw, "transport": name, **extra}, log, timer)
        out[f"3a_{name}"] = timer.summary()["counts"]
        checks[f"3a_{name}_equal_fused"] = _agree(_same(got, fused))
    del state, log, fused, got
    torch.cuda.empty_cache()

    # the schedules: chunked (ranks equal, == sequential on its logged
    # gradients, one collective per chunk with messages) and stale1 (==
    # sequential gathering each step's messages one step late)
    kw = {"schedule": "chunked"}
    timer = WallClockTimer()
    state, out["chunked"], log = _dist_run(mesh, kw, DIST_STEPS,
                                           timer=timer)
    checks["chunked_ranks_equal"] = _ranks_equal(
        list(_leaves(state.params).values()))
    checks["chunked_equal_sequential"] = _agree(_same(
        _leaves(state.params, state.rgc), _replay(mesh, {}, log)))
    n_chunks = _chunks_with_messages(kw, log["params"], mesh)
    out["chunked_counts"] = timer.summary()["counts"]
    out["chunks_with_messages"] = n_chunks
    checks["chunked_collectives_equal_chunks"] = (
        out["chunked_counts"].get("collectives") == n_chunks * (
            DIST_STEPS - 1))
    del state, log
    torch.cuda.empty_cache()

    kw = {"schedule": "stale1"}
    state, out["stale1"], log = _dist_run(mesh, kw, STEPS_3A)
    checks["stale1_ranks_equal"] = _ranks_equal(
        list(_leaves(state.params).values()))
    checks["stale1_equal_delayed_sequential"] = _agree(_same(
        _with_pending(_leaves(state.params, state.rgc), state.rgc),
        _replay(mesh, {}, log, delay=1)))
    return out


def _dist_p4(rank: int, mesh, workdir: str) -> dict:
    """World 4, ("node", "local") = (2, 2): the default path's fused
    steps replayed with both hierarchical transports, then path 4a's
    (quantized leaves' ``[count | indices | mean]`` messages through the
    int32 reassembly) with ``hierarchical``."""
    import torch
    out: dict = {"checks": {}}
    state, out["fused_allgather"], log = _dist_run(mesh, {}, 3)
    fused = _leaves(state.params, state.rgc)
    out["checks"]["ranks_equal"] = _ranks_equal(
        list(_leaves(state.params).values()))
    for label, kw in (("hierarchical", {}),
                      ("hierarchical_intra_node", {"intra_axis": "node"})):
        got = _replay(mesh, {"transport": "hierarchical", **kw}, log)
        out["checks"][f"{label}_equal_fused"] = _agree(_same(got, fused))
    del state, log, fused, got
    torch.cuda.empty_cache()

    kw = {"optimizer": "rgc_quant"}
    state, _, log = _dist_run(mesh, kw, STEPS_4A)
    fused = _leaves(state.params, state.rgc)
    out["checks"]["4a_ranks_equal"] = _ranks_equal(
        list(_leaves(state.params).values()))
    got = _replay(mesh, {**kw, "transport": "hierarchical"}, log)
    out["checks"]["4a_hierarchical_equal_fused"] = _agree(_same(got, fused))
    return out


def _dist_nccl1(rank: int, mesh, workdir: str) -> dict:
    """World 1 over NCCL, default path; its steps replayed without a
    mesh."""
    state, rec, log = _dist_run(mesh, {}, 3)
    return {"default": rec, "checks": {"nccl_equal_no_mesh": _same(
        _leaves(state.params, state.rgc), _replay(None, {}, log))}}


# task: (world, mesh shape, axes, backend, runner)
DIST_TASKS = {
    "p2": (2, (2,), ("data",), "gloo", _dist_p2),
    "p4": (4, (2, 2), ("node", "local"), "gloo", _dist_p4),
    "nccl1": (1, (1,), ("data",), "nccl", _dist_nccl1),
}


def _dist_worker(task: str, rank: int, workdir: str) -> None:
    """One rank of a phase-6 task (a spawned child: it imports this file
    and runs no phase of its own; the parent already built the kernels).
    Writes ``<task>-rank<r>.json``, or its traceback to ``.err``."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from repro_torch.launch.mesh import Mesh, init_process_group
        world, shape, axes, backend, runner = DIST_TASKS[task]
        init_process_group(
            f"file://{workdir}/{task}.pg", rank, world, backend=backend,
            device="cuda",
            timeout=datetime.timedelta(seconds=DIST_PG_TIMEOUT_S))
        torch.cuda.reset_peak_memory_stats()
        out = runner(rank, Mesh(shape, axes), workdir)
        torch.cuda.synchronize()
        out["max_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
        with open(os.path.join(workdir, f"{task}-rank{rank}.json"), "w") as f:
            json.dump(out, f)
    except BaseException:
        with open(os.path.join(workdir, f"{task}-rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(task: str, workdir: str, timeout: float = 600.0) -> list[dict]:
    """Run a phase-6 task on its ranks (``spawn`` children); fail unless
    every rank exits 0 in time. Returns each rank's results."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    world = DIST_TASKS[task][0]
    procs = [ctx.Process(target=_dist_worker, args=(task, r, workdir))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(1.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = []
    for r, p in enumerate(procs):
        if p.exitcode != 0:
            path = os.path.join(workdir, f"{task}-rank{r}.err")
            errs.append(f"rank {r} exit {p.exitcode}:\n"
                        + (open(path).read() if os.path.exists(path)
                           else "(no traceback: killed or timed out)"))
    if errs:
        _fail(f"phase 6 task {task}:\n" + "\n".join(errs))
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"{task}-rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def _print_split(label: str, split: dict, steps: int, rec: list,
                 smi: str) -> None:
    """The stage split of ``steps`` timed steps, one line per stage."""
    for name, st in split["stages"].items():
        print(f"[dist] {label}: stage {name} {1e3 * st['total_s'] / steps:.3f}"
              f" ms/step, share {st['share']:.4f} ({st['calls']} calls)")
    print(f"[dist] {label}: counters per step "
          f"{ {k: v / steps for k, v in split['counts'].items()} }")
    def med(key):
        return 1e3 * statistics.median(r[key] for r in rec[1:])
    print(f"[dist] {label}: median step {med('s'):.3f} ms = forward and "
          f"backward (to the sync) {med('to_sync_s'):.3f} + "
          f"GradientSync.update {med('sync_s'):.3f} + the rest; the "
          f"stages sum to {1e3 * split['total_s'] / steps:.3f} ms/step "
          f"(steps 2-{len(rec)}; {smi}; one card, gloo staging through "
          f"the host)")


def phase_dist(results: dict, default_steps: list[dict], smi: str) -> None:
    """Data-parallel ranks on the one card; see the module docstring."""
    import tempfile

    import torch
    from repro_torch.core import WallClockTimer

    # p = 1 on rank 0's rows of the p = 2 run: the split's baseline, and
    # step 1's launches must equal rank 0's at p = 2
    timer = WallClockTimer()
    _, rec1, _ = _dist_run(None, {}, DIST_STEPS, timer=timer,
                           rows=slice(0, DIST_BATCH // 2))
    split1 = timer.summary()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as workdir:
        p2 = _spawn("p2", workdir)
        p4 = _spawn("p4", workdir)
        n1 = _spawn("nccl1", workdir)

    bad = [f"{task} rank {r}: {name}"
           for task, ranks in (("p2", p2), ("p4", p4), ("nccl1", n1))
           for r, res in enumerate(ranks)
           for name, ok in res["checks"].items() if not ok]
    allowed = set().union(*default_steps)
    for r, res in enumerate(p2):
        for s, (rec, one) in enumerate(zip(res["default"], default_steps),
                                       1):
            got = rec["launches"]
            print(f"[dist] p=2 rank {r} step {s}: loss {rec['loss']:.6f} "
                  f"time {rec['s'] * 1e3:.2f} ms launches {got} "
                  f"(phase 5 step {s}: {one}) branches {rec['branches']}")
            if set(got) - allowed or any(got.get(k, 0) != one.get(k, 0)
                                         for k in FIXED_PER_STEP):
                bad.append(f"p=2 rank {r} step {s}: launches {got}, "
                           f"phase 5 {one}")
            if got.get("compact_gt_exact", 0) != \
                    rec["branches"]["exact_compaction"]:
                bad.append(f"p=2 rank {r} step {s}: exact compactions "
                           f"{got} vs branches {rec['branches']}")
            for k in PATHS[0][3]:
                if not got.get(k):
                    bad.append(f"p=2 rank {r} step {s}: {k} not launched")
        if not all(math.isfinite(x["loss"]) for x in res["default"]):
            bad.append(f"p=2 rank {r}: non-finite loss")
        for s, rec in enumerate(res["4a"], 1):
            print(f"[dist] p=2 rank {r} 4a rgc_quant step {s}: loss "
                  f"{rec['loss']:.6f} time {rec['s'] * 1e3:.2f} ms launches "
                  f"{rec['launches']} branches {rec['branches']}")
            if not math.isfinite(rec["loss"]):
                bad.append(f"p=2 rank {r} 4a step {s}: non-finite loss")
            for k in next(p[3] for p in PATHS if p[0] == "4a"):
                if not rec["launches"].get(k):
                    bad.append(f"p=2 rank {r} 4a step {s}: {k} not launched")
        for sched in ("chunked", "stale1"):
            for s, rec in enumerate(res[sched], 1):
                print(f"[dist] p=2 rank {r} {sched} step {s}: loss "
                      f"{rec['loss']:.6f} time {rec['s'] * 1e3:.2f} ms "
                      f"launches {rec['launches']}")
                if not math.isfinite(rec["loss"]):
                    bad.append(f"p=2 rank {r} {sched} step {s}: non-finite "
                               f"loss")
    print(f"[dist] p=2 chunked: {p2[0]['chunks_with_messages']} chunks "
          f"with messages; counters over steps 2-{DIST_STEPS} "
          f"{p2[0]['chunked_counts']}")
    if p2[0]["default"][0]["launches"] != rec1[0]["launches"]:
        bad.append(f"step 1 launches: p=2 rank 0 "
                   f"{p2[0]['default'][0]['launches']}, p=1 on its rows "
                   f"{rec1[0]['launches']}")
    for name in ("bucketed_allgather", "per_leaf_allgather"):
        print(f"[dist] p=2 3a {name}: counters over {STEPS_3A} steps "
              f"{p2[0]['3a_' + name]}")
    if p2[0]["3a_bucketed_allgather"].get("buckets", 0) < 3 * STEPS_3A:
        bad.append(f"3a bucketed: fewer than 3 buckets per step "
                   f"{p2[0]['3a_bucketed_allgather']}")
    for task, ranks in (("p2", p2), ("p4", p4), ("nccl1", n1)):
        print(f"[dist] {task}: checks {ranks[0]['checks']}; peak memory "
              f"per rank (GiB) "
              f"{[round(r['max_memory_gib'], 3) for r in ranks]}")
    med4 = statistics.median(x["s"] for x in p4[0]["fused_allgather"][1:])
    print(f"[dist] p=4 rank 0 fused_allgather median step "
          f"{1e3 * med4:.2f} ms")
    _print_split("p=1", split1, DIST_STEPS - 1, rec1, smi)
    _print_split("p=2 rank 0", p2[0]["split"], DIST_STEPS - 1,
                 p2[0]["default"], smi)
    if bad:
        _fail("phase 6: " + "; ".join(bad))
    total = {}
    for rec in p2[0]["default"]:
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v
    for name in results:
        results[name]["launches"]["default_p2_rank0"] = total.get(name, 0)
    print(f"[dist] OK: p=2 kernels == twins, ranks equal every step, "
          f"gathered rows == every rank's buffer; 4a kernels == twins, "
          f"ranks equal, per-leaf == fused; 3a bucketed and per-leaf "
          f"== fused; chunked ranks equal, == sequential, one collective "
          f"per chunk with messages; stale1 ranks equal, == sequential one "
          f"step late; p=4 hierarchical (both intra axes) == fused, 4a "
          f"hierarchical == fused; NCCL world 1 == no mesh")


# ---------------------------------------------------------------------------
# phase 7: checkpoint chains, crash/resume and elastic restore
# ---------------------------------------------------------------------------

# (label, TrainConfig overrides): the default path, and staleK(k=2), whose
# ring holds two generations at the crash
CKPT_PATHS = (("default", {}), ("5c staleK(k=2)", {"schedule": "staleK(k=2)"}))
CKPT_STEPS, CKPT_CRASH, CKPT_AT, CKPT_EVERY = 8, 5, 4, 2
ELASTIC_STEPS = 2          # stale1 at p = 2, saved at this step


class _Crash(Exception):
    """Raised from ``on_metrics`` to kill a run mid-way."""


def _ckpt_data(skip: int = 0):
    """Phase 5's seeded stream from batch ``skip`` on."""
    import itertools
    from repro_torch.data.synthetic import SyntheticLM
    stream = SyntheticLM(vocab_size=10_000, batch=20, seq_len=35, seed=SEED)
    return map(stream.batch_at, itertools.count(skip))


def _state_leaves(state) -> dict:
    """Every tensor of a ``TrainState``'s params and optimizer state (the
    pending ring too) by its checkpoint key."""
    from repro_torch.checkpoint.ckpt import flatten
    return dict(flatten({"params": state.params, "rgc": state.rgc}))


def _same_host(a: dict, b: dict) -> bool:
    """Whether two ``{key: numpy array}`` dicts hold the same keys, in
    the same order, and the same shapes and bytes."""
    import numpy as np
    return list(a) == list(b) and all(
        a[k].shape == b[k].shape and np.ascontiguousarray(a[k]).tobytes()
        == np.ascontiguousarray(b[k]).tobytes() for k in a)


def _chain_entries(directory: str) -> list[dict]:
    """Each manifest entry with its ``arrays.npz`` bytes and, for a
    delta, how many leaves (and bytes) went sparse and dense."""
    import zipfile
    from repro_torch.checkpoint import read_manifest
    out = []
    for e in read_manifest(directory)["entries"]:
        path = os.path.join(directory, e["path"])
        npz = os.path.join(path, "arrays.npz")
        sizes = {i.filename[:-len(".npy")]: i.file_size
                 for i in zipfile.ZipFile(npz).infolist()}
        rec = {"step": e["step"], "kind": e["kind"],
               "bytes": os.path.getsize(npz), "leaves": len(sizes)}
        if e["kind"] == "delta":
            with open(os.path.join(path, "meta.json")) as f:
                kinds = json.load(f)["kinds"]
            for kind in ("sparse", "dense"):
                keys = [k for k, v in kinds.items() if v == kind]
                rec[kind] = len(keys)
                rec[f"{kind}_bytes"] = sum(sizes[k] for k in keys)
            rec["sparse_keys"] = [k for k, v in kinds.items()
                                  if v == "sparse"]
        out.append(rec)
    return out


def _print_chain(label: str, directory: str, seconds: dict) -> None:
    for rec in _chain_entries(directory):
        extra = ""
        if rec["kind"] == "delta":
            extra = (f"; {rec['sparse']} leaves sparse "
                     f"({rec['sparse_bytes']:,} bytes: "
                     f"{', '.join(rec['sparse_keys'])}), {rec['dense']} "
                     f"dense ({rec['dense_bytes']:,} bytes)")
        print(f"[ckpt] {label}: save step {rec['step']} {rec['kind']} "
              f"{rec['bytes']:,} bytes of {rec['leaves']} leaves in "
              f"{seconds.get(rec['step'], float('nan')):.3f} s{extra}")


def _timed_saves(trainer, seconds: dict) -> None:
    """Record each ``save_checkpoint``'s seconds (device drained first)
    by step."""
    import torch
    save = trainer.save_checkpoint

    def timed(state):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = save(state)
        seconds[state.step] = time.perf_counter() - t0
        return out
    trainer.save_checkpoint = timed


def _dist_ckpt2(rank: int, mesh, workdir: str) -> dict:
    """World 2, ("data",) = 2: ``ELASTIC_STEPS`` full-width steps under
    ``stale1`` that save one checkpoint (every rank's rows gathered
    through gloo, rank 0 writes) into ``<workdir>/ckpt2``."""
    from repro_torch.configs import paper_lstm
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.trainer import Trainer
    trainer = Trainer(paper_lstm.FULL, TrainConfig(schedule="stale1"),
                      mesh=mesh, ckpt_dir=os.path.join(workdir, "ckpt2"),
                      ckpt_every=ELASTIC_STEPS)
    seconds: dict = {}
    _timed_saves(trainer, seconds)
    losses = []
    trainer.run(trainer.init_state(), _dist_data(), ELASTIC_STEPS,
                log_every=0, on_metrics=lambda s, d, loss: losses.append(loss))
    return {"checks": {}, "losses": losses, "save_s": seconds}


DIST_TASKS["ckpt2"] = (2, (2,), ("data",), "gloo", _dist_ckpt2)


def _elastic_numpy(rows: dict, trainer) -> dict:
    """The remainder rule at p = 1, in numpy, on the saved p = 2 rows:
    each row's ring reabsorbed into its residual (``reabsorb_pending`` on
    the card), residual and velocity summed in row order, params and the
    scalars from row 0, the ring zero."""
    import numpy as np
    from repro_torch.checkpoint.ckpt import flatten, to_numpy, unflatten_like
    from repro_torch.core.overlap import reabsorb_pending

    fresh = trainer.init_state()
    template = {"params": fresh.params, "rgc": fresh.rgc}
    reabsorbed = []
    for i in range(2):
        row = unflatten_like(template, {k: v[i] for k, v in rows.items()})
        reabsorbed.append({f"['rgc'].leaf{k}": to_numpy(v) for k, v in
                           flatten(reabsorb_pending(
                               trainer._sync, row["params"], row["rgc"]))})
    out = {}
    for k, v in rows.items():
        if k in reabsorbed[0]:
            a, b = reabsorbed[0][k], reabsorbed[1][k]
            if k.endswith((".residual", ".momentum")) and a.ndim:
                out[k] = np.zeros_like(a) + a + b
            else:
                out[k] = a
        elif k.startswith("['rgc'].pending"):
            out[k] = np.zeros_like(v[0])
        else:
            out[k] = v[0]
    return out


def phase_ckpt(results: dict, smi: str) -> None:
    """Crash/resume on one card, elastic 2 -> 1 and the launcher; see the
    module docstring."""
    import tempfile

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.ckpt import to_numpy
    from repro_torch.configs import paper_lstm
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import segmented as kseg
    from repro_torch.launch import train as launcher
    from repro_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    bad = []
    for k in kseg.launches:
        kseg.launches[k] = 0
    for label, overrides in CKPT_PATHS:
        tc = TrainConfig(**overrides)
        trainer = Trainer(paper_lstm.FULL, tc)
        state = trainer.run(trainer.init_state(), _ckpt_data(), CKPT_STEPS,
                            log_every=0)
        want = _state_leaves(state)
        del trainer, state
        with tempfile.TemporaryDirectory() as workdir:
            seconds: dict = {}
            crashed = Trainer(paper_lstm.FULL, tc, ckpt_dir=workdir,
                              ckpt_every=CKPT_EVERY)
            _timed_saves(crashed, seconds)

            def crash(step, density, loss):
                if step == CKPT_CRASH:
                    raise _Crash
            try:
                crashed.run(crashed.init_state(), _ckpt_data(), CKPT_STEPS,
                            log_every=0, on_metrics=crash)
                bad.append(f"{label}: the run did not crash")
            except _Crash:
                pass
            del crashed
            torch.cuda.empty_cache()
            resumed = Trainer(paper_lstm.FULL, tc, ckpt_dir=workdir)
            _timed_saves(resumed, seconds)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = resumed.restore_checkpoint(CKPT_AT)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            state = resumed.run(state, _ckpt_data(CKPT_AT),
                                CKPT_STEPS - CKPT_AT, log_every=0)
            got = _state_leaves(state)
            same = got.keys() == want.keys() and all(
                torch.equal(_bits(got[k]), _bits(want[k])) for k in want)
            _print_chain(label, workdir, seconds)
            print(f"[ckpt] {label}: restore of step {CKPT_AT} "
                  f"{restore_s:.3f} s; {len(want)} leaves after step "
                  f"{CKPT_STEPS} bitwise equal to the uninterrupted run: "
                  f"{same}")
            if not same:
                bad.append(f"{label}: resumed state != uninterrupted")
            del resumed, state, got, want
            torch.cuda.empty_cache()
    total = dict(kseg.launches)
    for name in PATHS[0][3]:
        if not total.get(name):
            bad.append(f"{name} was not launched in the crash/resume runs")
    for name in results:
        results[name]["launches"]["ckpt_resume"] = total.get(name, 0)

    # 7b: elastic p = 2 -> 1
    with tempfile.TemporaryDirectory() as workdir:
        ranks = _spawn("ckpt2", workdir)
        d = os.path.join(workdir, "ckpt2")
        _print_chain("p=2 stale1", d, {int(k): v for k, v in
                                       ranks[0]["save_s"].items()})
        tc = TrainConfig(schedule="stale1")
        restored, times = [], []
        for _ in range(2):
            trainer = Trainer(paper_lstm.FULL, tc, ckpt_dir=d)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state = trainer.restore_checkpoint()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            restored.append({k: to_numpy(v) for k, v in
                             _state_leaves(state).items()})
            del state
        rows = CheckpointManager(d).resolve_flat()
        rule = _elastic_numpy(rows, trainer)
        del trainer
        twice = _same_host(restored[0], restored[1])
        numpy_rule = _same_host(restored[0], rule)
        print(f"[ckpt] elastic p=2 -> 1 (stale1, step {ELASTIC_STEPS}): "
              f"restores {[round(t, 3) for t in times]} s; two restores "
              f"bitwise equal: {twice}; equal to the remainder rule in "
              f"numpy on the reabsorbed rows: {numpy_rule}; rank losses "
              f"{[r['losses'] for r in ranks]}")
        if not (twice and numpy_rule):
            bad.append(f"elastic 2 -> 1: twice {twice}, rule {numpy_rule}")
        del restored, rows, rule
        torch.cuda.empty_cache()

    # 7c: the launcher, --ckpt-every then --resume == uninterrupted
    with tempfile.TemporaryDirectory() as workdir:
        base = ["--arch", "paper-lstm", "--batch", "20", "--seq", "35",
                "--density", "0.001", "--data", "zipf", "--log-every", "0"]
        a, b = os.path.join(workdir, "a"), os.path.join(workdir, "b")
        t0 = time.perf_counter()
        launcher.main(base + ["--steps", "4", "--ckpt-dir", a,
                              "--ckpt-every", "2"])
        launcher.main(base + ["--steps", "6", "--ckpt-dir", a, "--resume"])
        launcher.main(base + ["--steps", "6", "--ckpt-dir", b])
        got, want = (CheckpointManager(x).resolve_flat(6) for x in (a, b))
        same = _same_host(got, want)
        print(f"[ckpt] launcher: --steps 4 --ckpt-every 2, then --resume "
              f"--steps 6 == --steps 6, bitwise: {same} "
              f"({time.perf_counter() - t0:.1f} s for the three runs)")
        if not same:
            bad.append("launcher resume != uninterrupted")
    print(f"[ckpt] phase 7 {time.perf_counter() - t_phase:.1f} s; {smi}")
    if bad:
        _fail("phase 7: " + "; ".join(bad))
    print("[ckpt] OK: crash/resume bitwise (default, staleK(k=2)), elastic "
          "2 -> 1 deterministic and == the numpy rule, launcher resume == "
          "uninterrupted")


# ---------------------------------------------------------------------------
# phase 8: the transformer chassis at full width (dense and vlm configs)
# ---------------------------------------------------------------------------

# 8a: internlm2-1.8b FULL (24 layers), global batch x TRAIN_4K's sequence
MODEL_BATCH, MODEL_SEQ, MODEL_STEPS = 2, 4096, 4
SEG_KERNELS = ("seg_abs_sum_max", "seg_count_gt", "seg_compact_gt")


def _model_data(model, batch: int, seq: int):
    """The seeded zipf stream (``bigram`` draws a vocab x vocab float64
    matrix: 68 GB at vocab 92,544), with the vlm stub prefix attached to
    every batch as the launcher does."""
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.launch.train import _with_stub
    data = iter(SyntheticLM(model.cfg.vocab_size, batch, seq, seed=SEED))
    if model.cfg.family == "vlm":
        data = _with_stub(data, model.make_train_batch(batch, seq))
    return data


def _train_model(label: str, cfg, batch: int, seq: int, steps: int,
                 smi: str, tc=None):
    """``Trainer(cfg, tc or TrainConfig())`` for ``steps`` steps of the zipf
    stream with the launch counts zeroed first; prints each step's loss
    and wall time, the peak device memory and the launches, and fails on
    a non-finite loss or params that did not move. Returns (trainer,
    state, data, launches)."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import tree
    from repro_torch.kernels import common
    from repro_torch.kernels import segmented as kseg
    from repro_torch.train.trainer import Trainer

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, tc or TrainConfig())
    # no reference to the initial state may outlive the first step: it
    # would hold a second full copy of params, residual and velocity
    box = [trainer.init_state()]
    first = [p.cpu() for p in tree.flatten(box[0].params)[0]]
    n = sum(p.numel() for p in first)
    data = _model_data(trainer.model, batch, seq)
    for counts in (kseg.launches, common.branches):
        for k in counts:
            counts[k] = 0
    rec = []
    torch.cuda.synchronize()
    last = [time.perf_counter()]

    def on_metrics(step, density, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        rec.append((step, loss, now - last[0]))
        last[0] = now
    state = trainer.run(box.pop(), data, steps, log_every=0,
                        on_metrics=on_metrics)
    launches = {k: v for k, v in kseg.launches.items() if v}
    peak = torch.cuda.max_memory_allocated()
    moved = sum(int(not torch.equal(a, b.cpu())) for a, b in
                zip(first, tree.flatten(state.params)[0]))
    n_leaves = len(first)
    del first
    for step, loss, dt in rec:
        print(f"[model] {label}: step {step} loss {loss:.6f} time "
              f"{dt * 1e3:.1f} ms")
    print(f"[model] {label}: {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab_size:,}, {n:,} params "
          f"({str(cfg.dtype).replace('torch.', '')}), batch {batch} x seq "
          f"{seq}; peak device memory {peak / 2**30:.2f} GiB "
          f"(max_memory_allocated); {moved} of {n_leaves} param leaves "
          f"moved; launches over {steps} steps {launches}; branches "
          f"{dict(common.branches)}; {smi}")
    if not all(math.isfinite(loss) for _, loss, _ in rec):
        _fail(f"phase {label}: non-finite loss")
    if not moved:
        _fail(f"phase {label}: the params did not move")
    return trainer, state, data, launches


def _model_grads(model, params, batch):
    """The local gradients one trainer step hands to the sync."""
    import torch
    from repro_torch.core import tree
    leaves, treedef = tree.flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss = model.loss(tree.unflatten(treedef, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return tree.unflatten(treedef, list(grads))


def _select_spies(seen: list):
    """A context recording each ``multi_select`` call's arena, geometry,
    thresholds and bucket size into ``seen``."""
    import contextlib
    from unittest import mock

    from repro_torch.kernels import segmented as kseg

    def spy_select(fn):
        def spy(parts):
            rec = {"x2d": parts[0][0], "geom": parts[0][1]}
            seen.append(rec)
            out = fn(parts)
            rec["thr"] = out[0][1].clone()
            return out
        return spy

    def spy_compact(fn):
        def spy(x2d, geom, thr, cap):
            if seen and "cap" not in seen[-1]:
                seen[-1]["cap"] = cap
            return fn(x2d, geom, thr, cap)
        return spy
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        kseg, "multi_select", spy_select(kseg.multi_select)))
    stack.enter_context(mock.patch.object(
        kseg, "seg_compact_gt", spy_compact(kseg.seg_compact_gt)))
    return stack


def _leaf_spies(calls: dict):
    """A context recording into ``calls`` the largest call (by elements)
    that an update makes of the per-leaf kernels on its path: 7e
    ``compact_gt_exact`` (an arena slot after a bucket overflow) and 8
    ``residual_update`` (an f32 leaf): name -> (wrapper, args, kwargs)."""
    import contextlib
    from unittest import mock

    from repro_torch.kernels import compact, residual_update

    def spy(name, fn):
        def record(x, *args, **kwargs):
            if name not in calls or x.numel() > calls[name][1][0].numel():
                calls[name] = (fn, (x, *args), kwargs)
            return fn(x, *args, **kwargs)
        return record
    stack = contextlib.ExitStack()
    for mod, name in ((compact, "compact_gt_exact"),
                      (residual_update, "residual_update")):
        stack.enter_context(mock.patch.object(
            mod, name, spy(name, getattr(mod, name))))
    return stack


def _sync_update(trainer, state, grads, sent: list):
    """The trainer's ``GradientSync.update`` of ``state`` on ``grads``;
    the wire messages go into ``sent``. Returns (params, rgc state)."""
    from unittest import mock

    import torch
    sync = trainer._sync
    lr = torch.tensor(trainer.tc.lr, dtype=torch.float32, device="cuda")

    def spy(ms, fn=sync.transport.allgather):
        sent.append(list(ms))
        return fn(ms)
    with mock.patch.object(sync.transport, "allgather", spy):
        return sync.update(grads, state.rgc, state.params, lr,
                           density=trainer.density_at(state.step))


def _kernel_update(trainer, state, grads, label: str):
    """One update with the kernels on one step's gradients; prints its
    time (host clock, drained) and its bsearch arena. Returns (params and
    state leaves by path, wire messages, the first ``multi_select``'s
    arena, the largest 7e / 8 calls)."""
    import torch

    sent, seen, calls = [], [], {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _select_spies(seen), _leaf_spies(calls):
        got = _sync_update(trainer, state, grads, sent)
    torch.cuda.synchronize()
    t_k = time.perf_counter() - t0
    arena = seen[0]
    x2d, geom, thr, cap = (arena[k] for k in ("x2d", "geom", "thr", "cap"))
    print(f"[model] {label} update with the kernels {t_k * 1e3:.1f} ms; "
          f"arena {geom.nblocks:,} rows x 1024 ({x2d.numel():,} elements, "
          f"{geom.n_seg} slots, bucket {cap}), thresholds "
          f"{[float(t) for t in thr]}")
    return _leaves(*got), sent, arena, calls


def _outputs(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def _check_arena_kernels(arena: dict, arena_of: str, smi: str) -> None:
    """Kernels 1-3 on one update's arena, at its thresholds and bucket:
    every output bitwise its twin's (fails otherwise); then each timed,
    20 launches in one CUDA graph, beside its bound and its twin."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import segmented as kseg

    x2d, geom, thr, cap = (arena[k] for k in ("x2d", "geom", "thr", "cap"))
    nb, nseg, xbytes, elems = geom.nblocks, geom.n_seg, x2d.numel() * 4, \
        x2d.numel()
    kernels = {
        "seg_abs_sum_max": (
            lambda: kseg.seg_abs_sum_max(x2d, geom),
            lambda: ref.seg_abs_sum_max(x2d, geom.block_seg,
                                        geom.block_size, nseg),
            xbytes + nseg * (8 + 4 * 3) + 2 * nseg * 4, 3 * elems),
        "seg_count_gt": (
            lambda: kseg.seg_count_gt(x2d, geom, thr),
            lambda: ref.seg_count_gt(x2d, geom.block_seg, thr, nseg),
            xbytes + nb * 4 + 2 * nseg * 4, 3 * elems),
        "seg_compact_gt": (
            lambda: kseg.seg_compact_gt(x2d, geom, thr, cap),
            lambda: ref.seg_compact_gt(x2d, geom.block_seg, geom.block_base,
                                       geom.block_size, thr, cap),
            xbytes + 3 * nb * 4 + nseg * 4 + nb * cap * 8 + nb * 4,
            3 * elems),
    }
    for name, (kern, plain, nbytes, ops) in kernels.items():
        got, want = _outputs(kern()), _outputs(plain())
        torch.cuda.synchronize()
        same = len(got) == len(want) and all(
            _same_bits(a, b) for a, b in zip(got, want))
        print(f"[kernels] {name} at the {arena_of} arena ({elems:,} "
              f"elements, bucket {cap}): kernel == twin bitwise: {same}; "
              f"{smi}")
        if not same:
            _fail(f"{name} differs from its twin at the {arena_of} arena")
        del got, want
        time_kernel(f"{name} at the {arena_of} arena", kern, plain,
                    nbytes, ops)


def _check_leaf_calls(calls: dict, label: str, smi: str) -> None:
    """7e and 8, whichever the update launched, again on the arguments
    of their largest call in it: kernel == twin bitwise (fails
    otherwise)."""
    import torch
    twins = _leaf_twins()
    for name, (fn, args, kwargs) in calls.items():
        got, want = fn(*args, **kwargs), twins[name](*args, **kwargs)
        torch.cuda.synchronize()
        same = len(got) == len(want) and all(
            _same_bits(a, b) for a, b in zip(got, want))
        print(f"[kernels] {label} {name} on the largest input the update "
              f"gave it ({args[0].numel():,} elements): kernel == twin "
              f"bitwise: {same}; {smi}")
        if not same:
            _fail(f"phase {label}: {name} differs from its twin on the "
                  f"largest input of the update")
        del got, want


def _twins_update(trainer, state, grads, want: dict, sent_k: list,
                  label: str, smi: str) -> None:
    """The same update with every kernel replaced by its twin: params,
    residual, momentum, thresholds, phases (``want``, on the host) and
    wire messages (``sent_k``) bitwise those of the kernels' update."""
    import torch

    sent_t = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with _twins_patched():
        got = _sync_update(trainer, state, grads, sent_t)
    torch.cuda.synchronize()
    t_t = time.perf_counter() - t0
    have = _leaves(*got)
    same = have.keys() == want.keys() and all(
        torch.equal(_bits(have[k]), _bits(want[k].to("cuda")))
        for k in want)
    msgs = (len(sent_k) == len(sent_t) == 1
            and len(sent_k[0]) == len(sent_t[0])
            and all(torch.equal(_bits(a), _bits(b))
                    for a, b in zip(sent_k[0], sent_t[0])))
    n_msg = sum(m.numel() for m in sent_k[0]) if sent_k else 0
    print(f"[model] {label} one full-width update, kernels vs twins from "
          f"the same state: {len(want)} params / residual / momentum / "
          f"threshold / phase leaves bitwise equal: {same}; "
          f"{len(sent_k[0]) if sent_k else 0} wire messages "
          f"({n_msg:,} words, the selected indices inside) bitwise equal: "
          f"{msgs}; twins' update {t_t * 1e3:.1f} ms; {smi}")
    if not (same and msgs):
        _fail(f"phase {label}: the full-width update with the kernels "
              f"differs from the one with the twins")


def phase_models(results: dict, smi: str) -> None:
    """8a internlm2-1.8b FULL, 8b gemma3-4b at 6 layers, 8c paligemma-3b
    at 2 layers; see the module docstring."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import profile_steps

    t_phase = time.perf_counter()
    cfg = get_config("internlm2-1.8b")
    trainer, state, data, launches = _train_model(
        "8a internlm2-1.8b", cfg, MODEL_BATCH, MODEL_SEQ, MODEL_STEPS, smi)
    for name in SEG_KERNELS:
        if not launches.get(name):
            _fail(f"phase 8a: {name} was not launched")
    for name in results:
        results[name]["launches"]["8a_internlm2"] = launches.get(name, 0)
    print(f"[profile] 8a internlm2-1.8b ({smi}):")
    profile_steps(trainer, state, data, 1)
    gc.collect()
    torch.cuda.empty_cache()
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(data).items()}
    grads = _model_grads(trainer.model, state.params, batch)
    leaves, sent, arena, calls = _kernel_update(trainer, state, grads, "8a")
    want = {k: v.cpu() for k, v in leaves.items()}
    del leaves
    _check_arena_kernels(arena, "internlm2-1.8b", smi)
    _check_leaf_calls(calls, "8a", smi)
    del arena, calls
    torch.cuda.empty_cache()
    _twins_update(trainer, state, grads, want, sent, "8a", smi)
    del trainer, state, data, batch, grads, want, sent
    gc.collect()

    gemma = dataclasses.replace(get_config("gemma3-4b"), num_layers=6)
    if gemma.pattern_codes() != (1, 1, 1, 1, 1, 0):
        _fail(f"phase 8b: layer codes {gemma.pattern_codes()}")
    out = _train_model("8b gemma3-4b (6 of 34 layers)", gemma, 1, 4096, 2,
                       smi)
    del out
    gc.collect()
    pali = dataclasses.replace(get_config("paligemma-3b"), num_layers=2)
    out = _train_model("8c paligemma-3b (2 of 18 layers, 256-token prefix)",
                       pali, 1, 1024, 2, smi)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[model] phase 8 {time.perf_counter() - t_phase:.1f} s; {smi}")
    print("[model] OK: internlm2-1.8b full width trained with kernels 1-3, "
          "kernels == twins on a full-width update and on its arena; "
          "gemma3-4b and paligemma-3b trained")


# ---------------------------------------------------------------------------
# phase 9: the MoE FFN (moe family) at full width
# ---------------------------------------------------------------------------

# 9a: granite-moe-3b-a800m FULL at 20 of its 32 layers, the deepest cut
# whose bsearch arena keeps its int32 message indices (below 2^31 - 1)
GRANITE_LAYERS = 20
# 9a's TrainConfig: the defaults and DGC's local gradient clipping. The
# reference's init (``fan_in = shape[0]``, the layer count for stacked
# leaves) gives this model's tied embedding table gradients of up to
# ~5e7 against entries of ~0.12 (9a prints both), so plain RGC diverges
# (NaN by step 3 at the default lr on an H100, and at lr 0.01 and
# 0.001), as the reference's own trainer does at smoke width with 20
# layers
GRANITE_TRAIN = {"local_clip": 1.0}
# 9b: one MoE layer at full width on this many tokens (f32), held to the
# tolerances of tests/test_torch_moe.py: the output within rtol 1e-5 and
# 1e-6 of its largest magnitude, aux rtol 1e-6, gradients within 1e-5 of
# each one's largest magnitude
MOE_TOKENS = 512
MOE_OUT_TOL, MOE_AUX_RTOL, MOE_GRAD_TOL = 1e-6, 1e-6, 1e-5
# 9b's archs and capacity factors (None: the config's own): granite's
# and 0.1, where choices drop; grok-1-314b's (one layer: 4,831,838,208
# expert params, 19.3 GB in f32, so both forms' gradients fit beside it)
MOE_LAYERS = (("granite-moe-3b-a800m", (None, 0.1)),
              ("grok-1-314b", (None,)))


def _moe_run(cfg, params, x, ct):
    """One MoE FFN forward and backward of ``sum(out * ct) + aux``;
    returns (route, out, aux, grads by leaf name and ``x``, ms of the
    forward + backward by CUDA events over 5 calls, timed first so that
    no earlier gradients are held beside it)."""
    from unittest import mock

    import torch
    from repro_torch.models import moe

    seen = []

    def spy(*a, fn=moe._route):
        seen.append(fn(*a))
        return seen[-1]

    def fwd_bwd():
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        xx = x.detach().requires_grad_(True)
        out, aux = moe.moe_ffn(cfg, p, xx)
        grads = torch.autograd.grad(torch.sum(out * ct) + aux,
                                    [*p.values(), xx])
        return out.detach(), aux.detach(), dict(zip([*p, "x"], grads))
    ms = cuda_ms(fwd_bwd, 5)
    with mock.patch.object(moe, "_route", spy):
        out, aux, grads = fwd_bwd()
    return seen[0], out, aux, grads, ms


def _close(got, want, rtol: float, atol_of_scale: float) -> tuple[bool,
                                                                  float]:
    """Whether ``got`` is within ``rtol`` of ``want`` plus
    ``atol_of_scale`` times max |want|, and max |got - want|; with rtol
    0, no temporary but the difference (a grok expert leaf is 6 GiB)."""
    import torch
    scale = float(torch.linalg.vector_norm(want, float("inf")))
    diff = got - want
    err = float(torch.linalg.vector_norm(diff, float("inf")))
    del diff
    ok = (bool(torch.allclose(got, want, rtol=rtol,
                              atol=atol_of_scale * scale)) if rtol
          else err <= atol_of_scale * scale)
    return ok, err


def phase_moe_layer(arch: str, factors, smi: str) -> None:
    """9b: one MoE layer of ``arch`` at full width: routing identical
    under both forms and on the CPU, one-hot == scatter within the CPU
    tests' tolerances, at each capacity factor; drops at 0.1."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.common import init_params

    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32)
    params = init_params(moe.moe_defs(cfg), SEED, torch.float32, "cuda")
    n_params = sum(v.numel() for v in params.values())
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn((1, MOE_TOKENS, cfg.d_model), generator=gen,
                    device="cuda")
    ct = torch.randn(x.shape, generator=gen, device="cuda")
    for factor in factors:
        factor = factor or cfg.moe_capacity_factor
        c = dataclasses.replace(cfg, moe_capacity_factor=factor)
        cap = moe._capacity(MOE_TOKENS, c)
        runs = {}
        for impl in ("onehot", "scatter"):
            runs[impl] = _moe_run(dataclasses.replace(c, moe_impl=impl),
                                  params, x, ct)
        cpu = moe._route(c, {"router": params["router"].cpu()},
                         x.cpu().reshape(MOE_TOKENS, -1), cap)
        same_route = all(
            torch.equal(runs["onehot"][0][i], runs["scatter"][0][i])
            and torch.equal(runs["scatter"][0][i].cpu(), cpu[i])
            for i in (1, 2, 3))
        keep = runs["scatter"][0][3]
        dropped = int((~keep).sum())
        (_, o1, a1, g1, ms1), (_, o2, a2, g2, ms2) = runs.values()
        del runs
        out_ok, out_err = _close(o1, o2, 1e-5, MOE_OUT_TOL)
        aux_ok = abs(float(a1) - float(a2)) <= MOE_AUX_RTOL * abs(float(a2))
        finite = all(bool(torch.isfinite(t).all()) for t in (o1, o2, a1, a2))
        grad = {}
        for k in list(g2):
            grad[k] = _close(g1[k], g2[k], 0.0, MOE_GRAD_TOL)
            finite &= bool(torch.isfinite(g1[k]).all()
                           and torch.isfinite(g2[k]).all())
            del g1[k], g2[k]
        print(f"[moe] 9b one MoE layer of {arch} at full width (d_model "
              f"{cfg.d_model}, {cfg.num_experts} experts of d_ff "
              f"{cfg.d_ff}, top-{cfg.num_experts_per_tok}; {n_params:,} "
              f"params), {MOE_TOKENS} tokens f32, capacity factor {factor} "
              f"(capacity {cap}): gate_idx / slot / keep identical under "
              f"both forms and equal to the CPU's: {same_route}; "
              f"{dropped} of {keep.numel()} choices dropped; one-hot vs "
              f"scatter: output max |diff| {out_err:.3g} (scale "
              f"{float(o2.abs().max()):.4g}), aux {float(a1):.9g} vs "
              f"{float(a2):.9g}, gradients' max |diff| "
              f"{ {k: round(v[1], 9) for k, v in grad.items()} }; forward "
              f"+ backward {ms1:.3f} ms one-hot, {ms2:.3f} ms scatter "
              f"(CUDA events, 5 calls); peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
        if not same_route:
            _fail(f"phase 9b {arch}: routing differs (factor {factor})")
        if not (out_ok and aux_ok and all(ok for ok, _ in grad.values())):
            _fail(f"phase 9b {arch}: one-hot and scatter disagree (factor "
                  f"{factor})")
        if not finite:
            _fail(f"phase 9b {arch}: non-finite output (factor {factor})")
        if factor == 0.1 and not dropped:
            _fail(f"phase 9b {arch}: capacity factor 0.1 dropped nothing")
        del o1, o2, a1, a2, g1, g2, keep
    del params, x, ct
    torch.cuda.empty_cache()


def phase_moe(results: dict, smi: str) -> None:
    """9a granite-moe-3b-a800m FULL at 20 layers, 9b one MoE layer of
    granite and of grok at full width, 9c grok-1-314b smoke; see the
    module docstring."""
    import dataclasses
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import tree
    from repro_torch.core.arena import INT32_MAX
    from repro_torch.launch.train import profile_steps

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              num_layers=GRANITE_LAYERS)
    label = f"9a granite-moe-3b-a800m ({GRANITE_LAYERS} of 32 layers)"
    trainer, state, data, launches = _train_model(
        label, cfg, MODEL_BATCH, MODEL_SEQ, MODEL_STEPS, smi,
        tc=TrainConfig(**GRANITE_TRAIN))
    groups = [g for plan in trainer._sync._plans.values()
              for g in plan.groups]
    print(f"[moe] 9a arenas: "
          f"{[(g.compressor, g.dtype, g.total) for g in groups]}; the "
          f"int32 limit {INT32_MAX:,}")
    if not groups or max(g.total for g in groups) >= INT32_MAX:
        _fail("phase 9a: an arena reaches the int32 limit (or none formed)")
    for name in SEG_KERNELS:
        if not launches.get(name):
            _fail(f"phase 9a: {name} was not launched")
    for name in results:
        results[name]["launches"]["9a_granite"] = launches.get(name, 0)
    print(f"[profile] {label} ({smi}):")
    profile_steps(trainer, state, data, 1)
    gc.collect()
    torch.cuda.empty_cache()
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in next(data).items()}
    grads = _model_grads(trainer.model, state.params, batch)
    # why 9a clips (GRANITE_TRAIN): each leaf's largest |gradient| beside
    # its largest |entry|
    scales = {path: (f"{float(g.abs().max()):.4g}",
                     f"{float(p.abs().max()):.4g}")
              for (path, p), g in zip(tree.flatten_with_paths(state.params),
                                      tree.flatten(grads)[0])}
    print(f"[moe] 9a max |gradient| / max |param| by leaf: {scales}; {smi}")
    leaves, sent, arena, calls = _kernel_update(trainer, state, grads, "9a")
    want = {k: v.cpu() for k, v in leaves.items()}
    del leaves
    _check_arena_kernels(arena, "granite-moe-3b-a800m", smi)
    _check_leaf_calls(calls, "9a", smi)
    del arena, calls
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _twins_update(trainer, state, grads, want, sent, "9a", smi)
    print(f"[moe] 9a peak device memory through the twins' update "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {smi}")
    del trainer, state, data, batch, grads, want, sent
    gc.collect()
    torch.cuda.empty_cache()

    for arch, factors in MOE_LAYERS:
        torch.cuda.reset_peak_memory_stats()
        phase_moe_layer(arch, factors, smi)

    out = _train_model("9c grok-1-314b smoke", get_config(
        "grok-1-314b", smoke=True), 2, 128, 2, smi)
    del out
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[moe] phase 9 {time.perf_counter() - t_phase:.1f} s; {smi}")
    print(f"[moe] OK: granite-moe-3b-a800m at full width "
          f"({GRANITE_LAYERS} layers) trained with kernels 1-3, kernels 1-3, "
          f"7e and 8 == twins at its shapes and on a whole update; one-hot "
          f"== scatter at granite's and grok-1-314b's width; grok-1-314b "
          f"smoke trained")


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="after each path's steps, profile N more steps")
    args = ap.parse_args(argv)
    # the caching allocator grows segments instead of leaving gaps: at
    # 9a's 62 GiB peak, fixed segments strand up to 16.5 GiB reserved but
    # unallocated, and a 7.8 GiB arena copy then fails on an 80 GB card
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
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
    phase_quant_forms()
    phase_sync()
    phase_schedules()
    default_steps = phase_train(results, args.profile)
    phase_dist(results, default_steps, smi)
    phase_ckpt(results, smi)
    phase_models(results, smi)
    phase_moe(results, smi)

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
