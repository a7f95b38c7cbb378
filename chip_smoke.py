#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``) only; imports nothing of JAX or of
the JAX package. Phases, each fatal on failure:

1. card facts (``nvidia-smi`` name and power limit, torch device name);
2. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, all at once) and print the build time;
3. every kernel against its plain PyTorch twin on the card, at the
   full-width arena of the paper's 2-layer 1500-unit LSTM (six slots,
   64,458 rows) and on a small ragged arena with ties, threshold 0 and
   bucket overflow — sums bitwise, counts and compaction exactly — and
   each kernel's time (CUDA events) beside its bound and its twin's time;
4. two full-width ``GradientSync.update`` steps (refresh, then threshold
   reuse) with the kernels, and again with the twins on the same CUDA
   tensors: params, residual, momentum, thresholds and packed messages
   bitwise equal;
5. the main path: ``Trainer(paper_lstm.FULL, TrainConfig())`` for 8 steps
   of a seeded synthetic stream (batch 20 x seq 35); kernel launch counts
   are zeroed just before and read just after; every loss must be finite
   and every kernel launched;
6. a JSON line per kernel (time, bound, launches, error), then the last
   line ``{"ok": true, "device": {...}}``.

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
    """Mean device time of ``fn`` in ms over ``reps`` launches (warmed)."""
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


def ragged_group():
    from repro_torch.core import arena, sync
    sizes = [1, 1000, 1024, 1025, 5000, 70_000, 3]
    return arena.build_group(0, "threshold_bsearch", "torch.float32", [
        (i, f"s{i}", n, max(1, n // 100), 2 * max(1, n // 100),
         sync.message_len(2 * max(1, n // 100), False))
        for i, n in enumerate(sizes)])


def phase_kernels(results: dict) -> None:
    import torch
    from repro_torch.core import arena
    from repro_torch.kernels import ref
    from repro_torch.kernels import segmented as kseg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)

    def arena_of(group, tied: bool):
        leaves = {}
        for slot in group.slots:
            if tied:    # few distinct magnitudes: ties everywhere
                v = torch.randint(-4, 5, (slot.size,), generator=gen,
                                  device=dev).to(torch.float32) * 0.5
            else:
                v = torch.randn(slot.size, generator=gen, device=dev)
            leaves[slot.leaf] = v
        return arena.gather(group, leaves)

    def plain_stats(x2d, geom):
        return ref.seg_abs_sum_max(x2d, geom.block_seg, geom.block_size,
                                   geom.n_seg)

    def plain_count(x2d, geom, thr):
        return ref.seg_count_gt(x2d, geom.block_seg, thr, geom.n_seg)

    def plain_compact(x2d, geom, thr, cap):
        return ref.seg_compact_gt(x2d, geom.block_seg, geom.block_base,
                                  geom.block_size, thr, cap)

    def same_bits(a, b) -> bool:
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return a.shape == b.shape and bool(torch.equal(a, b))

    cases = []
    full = full_width_group()
    x_full = arena_of(full, tied=False)
    thr_full = torch.tensor([3.0, 3.1, 2.9, 3.0, 3.2, 3.0], device=dev)
    cases.append(("full-width", x_full, full.geometry, thr_full, 16))
    rag = ragged_group()
    x_rag = arena_of(rag, tied=True)
    n_rag = rag.geometry.n_seg
    cases.append(("ragged thr=1", x_rag, rag.geometry,
                  torch.full((n_rag,), 1.0, device=dev), 8))
    cases.append(("ragged thr=0 overflow", x_rag, rag.geometry,
                  torch.zeros(n_rag, device=dev), 8))

    err = {"seg_abs_sum_max": 0.0, "seg_count_gt": 0.0,
           "seg_compact_gt": 0.0}
    for name, x2d, geom, thr, cap in cases:
        ks, km = kseg.seg_abs_sum_max(x2d, geom)
        ps, pm = plain_stats(x2d, geom)
        kc = kseg.seg_count_gt(x2d, geom, thr)
        pc = plain_count(x2d, geom, thr)
        kv, ki, kn = kseg.seg_compact_gt(x2d, geom, thr, cap)
        pv, pi, pn = plain_compact(x2d, geom, thr, cap)
        torch.cuda.synchronize()
        ok = {"seg_abs_sum_max": same_bits(ks, ps) and same_bits(km, pm),
              "seg_count_gt": same_bits(kc, pc),
              "seg_compact_gt": (same_bits(kv, pv) and same_bits(ki, pi)
                                 and same_bits(kn, pn))}
        err["seg_abs_sum_max"] = max(
            err["seg_abs_sum_max"], float((ks - ps).abs().max()),
            float((km - pm).abs().max()))
        err["seg_count_gt"] = max(err["seg_count_gt"],
                                  float((kc - pc).abs().max()))
        err["seg_compact_gt"] = max(
            err["seg_compact_gt"], float((kv - pv).abs().max()),
            float((ki - pi).abs().max()), float((kn - pn).abs().max()))
        print(f"[kernels] {name}: " + ", ".join(
            f"{k} {'equal' if v else 'DIFFERS'}" for k, v in ok.items())
            + f"; rows with overflow {int((kn > cap).sum())}")
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
    for name, (kern, plain, nbytes, ops) in timing.items():
        ms = cuda_ms(kern, 20)
        plain_ms = cuda_ms(plain, 3)
        b_ms, b_by = bound_ms(nbytes, ops)
        print(f"[kernels] {name}: {ms:.4f} ms (bound {b_ms:.4f} ms by "
              f"{b_by}, {b_ms / ms:.1%} of it); plain twin {plain_ms:.4f} ms")
        results[name] = {
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segmented.cu",
            "replaces": {"seg_abs_sum_max": "src/repro/kernels/segmented.py:113",
                         "seg_count_gt": "src/repro/kernels/segmented.py:182",
                         "seg_compact_gt": "src/repro/kernels/segmented.py:242",
                         }[name],
            "launches": None, "max_abs_err": err[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None}


def _full_width_tree(gen, dev, scale: float):
    import torch
    from repro_torch.configs import paper_lstm
    from repro_torch.core import tree
    from repro_torch.models import lstm
    defs = lstm.param_defs(paper_lstm.FULL)
    leaves = [torch.randn(shape, generator=gen, device=dev) * scale
              for _, (shape, _i, _s) in tree.flatten_with_paths(defs)]
    return tree.unflatten(tree.structure(defs), leaves)


def phase_sync() -> None:
    """Two full-width updates with kernels vs with the twins patched in."""
    from unittest import mock

    import torch
    from repro_torch.core import tree
    from repro_torch.core.gradient_sync import build_gradient_sync
    from repro_torch.kernels import ref
    from repro_torch.kernels import segmented as kseg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    params = _full_width_tree(gen, dev, 0.05)
    grads = [_full_width_tree(gen, dev, 1e-3) for _ in range(2)]
    lr = torch.tensor(0.1, dtype=torch.float32, device=dev)

    def run():
        sync = build_gradient_sync("rgc", device=dev)
        sent = []
        gather = sync.transport.allgather

        def spy(messages):
            sent.extend(m.clone() for m in messages)
            return gather(messages)
        sync.transport.allgather = spy
        p, st = params, sync.init(params)
        for g in grads:
            p, st = sync.update(g, st, p, lr)
        torch.cuda.synchronize()
        return p, st, sent

    before = dict(kseg.launches)
    t0 = time.perf_counter()
    with_kernels = run()
    t_k = time.perf_counter() - t0
    used = {k: kseg.launches[k] - before[k] for k in before}
    before = dict(kseg.launches)
    with mock.patch.object(
            kseg, "seg_abs_sum_max", lambda x, g: ref.seg_abs_sum_max(
                x, g.block_seg, g.block_size, g.n_seg)), \
        mock.patch.object(
            kseg, "seg_count_gt", lambda x, g, t: ref.seg_count_gt(
                x, g.block_seg, t, g.n_seg)), \
        mock.patch.object(
            kseg, "seg_compact_gt", lambda x, g, t, c: ref.seg_compact_gt(
                x, g.block_seg, g.block_base, g.block_size, t, c)):
        t0 = time.perf_counter()
        with_twins = run()
        t_p = time.perf_counter() - t0
    if any(kseg.launches[k] != before[k] for k in before):
        _fail("the twin run launched a kernel")
    print(f"[sync] 2 full-width updates: kernels {t_k:.2f} s "
          f"(launches {used}), plain twins {t_p:.2f} s")

    def flat(x):
        out = []
        for leaf in tree.flatten(x)[0]:
            out.extend(leaf if isinstance(leaf, tuple) else [leaf])
        return out

    (pk, sk, mk), (pp, sp, mp) = with_kernels, with_twins
    pairs = list(zip(flat(pk), flat(pp))) + list(zip(flat(sk), flat(sp)))
    pairs += list(zip(mk, mp))
    if len(mk) != len(mp) or not mk:
        _fail("sync runs sent different message lists")
    for a, b in pairs:
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            _fail("full-width GradientSync.update differs between the "
                  "kernels and the plain twins")
    thr = [float(s.threshold) for s in tree.flatten(sk)[0]]
    print(f"[sync] params, residual, momentum, thresholds and "
          f"{len(mk)} packed messages bitwise equal; thresholds {thr}")


def phase_train(results: dict) -> None:
    import torch
    from repro_torch.configs import paper_lstm
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.kernels import segmented as kseg
    from repro_torch.train.trainer import Trainer

    steps = 8
    trainer = Trainer(paper_lstm.FULL, TrainConfig())
    state = trainer.init_state()
    data = iter(SyntheticLM(vocab_size=10_000, batch=20, seq_len=35,
                            seed=SEED))
    torch.cuda.synchronize()
    rec = []
    last = [time.perf_counter(), {}]

    def on_metrics(step, density, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        counts = {k: v - last[1].get(k, 0) for k, v in kseg.launches.items()}
        rec.append((step, loss, now - last[0], counts))
        last[0], last[1] = now, dict(kseg.launches)

    for k in kseg.launches:
        kseg.launches[k] = 0
    last[0] = time.perf_counter()
    trainer.run(state, data, steps, log_every=0, on_metrics=on_metrics)
    total = dict(kseg.launches)
    for step, loss, dt, counts in rec:
        print(f"[train] step {step} loss {loss:.6f} time {dt * 1e3:.2f} ms "
              f"launches {counts}")
    med = statistics.median(dt for _, _, dt, _ in rec)
    print(f"[train] median step {med * 1e3:.2f} ms; launches over "
          f"{steps} steps {total}")
    if not all(math.isfinite(loss) for _, loss, _, _ in rec):
        _fail("non-finite loss")
    for name, n in total.items():
        if n <= 0:
            _fail(f"{name} was not launched on the main path")
        results[name]["launches"] = n


def main() -> int:
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
    logs = build.build(("segmented",))
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {name}: {line.strip()}")

    results: dict = {}
    phase_kernels(results)
    phase_sync()
    phase_train(results)

    print(json.dumps({"kernels": [results[k] for k in (
        "seg_abs_sum_max", "seg_count_gt", "seg_compact_gt")]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
