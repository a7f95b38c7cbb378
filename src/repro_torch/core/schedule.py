"""Warm-up density schedule (RedSync §5.7).

Port of ``src/repro/core/schedule.py`` (pure Python): exponentially
decaying density stages before the target, or dense-allreduce SGD
(density 1.0 sentinel) in their place when ``dense_warmup`` is set.
"""
from __future__ import annotations

from dataclasses import dataclass

DGC_WARMUP = (0.25, 0.0625, 0.015625, 0.004)


@dataclass(frozen=True)
class DensitySchedule:
    """Piecewise-constant density over training steps."""
    target: float = 0.001
    warmup_steps_per_stage: int = 0
    stages: tuple[float, ...] = DGC_WARMUP
    dense_warmup: bool = False   # RedSync large-scale variant (§5.7)

    def density_at(self, step: int) -> float:
        if self.warmup_steps_per_stage <= 0:
            return self.target
        stage = step // self.warmup_steps_per_stage
        if stage >= len(self.stages):
            return self.target
        if self.dense_warmup:
            return 1.0           # sentinel: use dense allreduce this stage
        return self.stages[stage]
