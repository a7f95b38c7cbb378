"""Transport backends: wire packing + collectives.

Port of ``src/repro/core/transport.py``, ``fused_allgather`` only: every
message is concatenated into ONE buffer, gathered once and split (§5.3
tensor fusion). This slice runs one worker, so the gather is the
identity; the bucketed, hierarchical, per-leaf and dense-psum backends
arrive with ``torch.distributed`` in the multi-GPU slice.
"""
from __future__ import annotations

from typing import Any

import torch

from . import registry
from . import sync as sync_lib
from .instrument import NullTimer
from .selection import Selected


class FusedAllgather:
    name = "fused_allgather"

    def __init__(self, sync_axes: tuple[str, ...] = (), timer=None):
        self.sync_axes = tuple(sync_axes)
        self.timer = timer if timer is not None else NullTimer()

    def num_workers(self) -> int:
        if self.sync_axes:
            raise NotImplementedError(
                "multi-worker sync is not ported yet (see ROADMAP.md)")
        return 1

    def pack(self, sel: Selected, quantized: bool) -> torch.Tensor:
        return sync_lib.pack(sel, quantized)

    def allreduce_mean(self, grad: torch.Tensor) -> torch.Tensor:
        return sync_lib.dense_allreduce_mean(grad, self.sync_axes)

    def allgather(self, messages: list[torch.Tensor]
                  ) -> list[torch.Tensor]:
        if not messages:
            return []
        self.timer.count("messages", len(messages))
        self.timer.count("collectives")
        return sync_lib.fused_allgather(messages, self.sync_axes)


@registry.register(registry.TRANSPORT, "fused_allgather")
def _fused(sync_axes: tuple[str, ...] = (), timer=None,
           **_: Any) -> FusedAllgather:
    return FusedAllgather(sync_axes, timer=timer)
