"""What the CUDA kernel wrappers share: the launch counters, the ctypes
argument types, PyTorch's current stream and the launch check.

``launches`` counts kernel launches per wrapper and form since the last
reset (plain ints, one per call on the card; the CPU path counts
nothing). ``branches`` counts, on either device, the data-dependent
branches the selectors take, per leaf (``kernels.ops``) and per arena
slot (``segmented.multi_select``): the exact compaction after a bucket
overflow, and the short pick of a trimmed top-k with fewer than k
survivors. ``chip_smoke.py`` zeroes both before each path it drives and
reads them after.
"""
from __future__ import annotations

import ctypes

import torch

ROW = 1024          # row width the kernels are built for (csrc/common.cuh)
LOG_COLS = 16       # arena statistics, phase 1: at most 2^16 columns

launches = {"seg_abs_sum_max": 0, "seg_count_gt": 0, "seg_compact_gt": 0,
            "seg_abs_sum_max_strided": 0, "seg_count_gt_strided": 0,
            "seg_residual_update_stats": 0, "count_gt": 0, "abs_sum_max": 0,
            "compact_gt": 0, "compact_gt_exact": 0, "residual_update": 0}
branches = {"exact_compaction": 0, "short_pick": 0}

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def check_leaf(x: torch.Tensor, name: str) -> None:
    """Raise unless ``x`` is what a per-leaf kernel takes: a contiguous
    1-D f32 CUDA tensor of 1 to 2^31 - 1024 elements (indices are i32)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if (x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous()
            or not 0 < x.numel() <= 2**31 - 1024):
        raise ValueError(
            f"{name}: expects a contiguous 1-D f32 leaf of 1 to 2^31 - 1024 "
            f"elements, got {x.dtype} {tuple(x.shape)}")


def device_scalar(t: torch.Tensor, x: torch.Tensor, name: str
                  ) -> torch.Tensor:
    """The threshold ``t`` as a contiguous f32 scalar on ``x``'s device
    (read there by the kernel: no host synchronisation)."""
    if t.device != x.device or t.numel() != 1:
        raise ValueError(f"{name}: the threshold must be one value on "
                         f"{x.device}, got {tuple(t.shape)} on {t.device}")
    return t.to(torch.float32).reshape(1).contiguous()


def aligned(*ts: torch.Tensor) -> int:
    """1 when every tensor's data is 16-byte aligned (float4 loads)."""
    return int(all(t.data_ptr() % 16 == 0 for t in ts))
