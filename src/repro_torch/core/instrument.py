"""Stage instrumentation for the sync pipeline (Fig 10's decomposition).

Port of ``src/repro/core/instrument.py``. ``GradientSync.update`` and the
transports thread every pipeline stage through ``timer.stage(name,
thunk)`` and record dimensionless facts with ``timer.count``:
``dispatch_<stage>`` fused-operation launches, the transports'
``messages`` / ``collectives`` / ``buckets`` and ``select_overflow``.
The stages are the reference's: Fig 10's bars, with the paper's ``mask``
bar split into ``accumulate`` (residual/momentum accumulation) and
``mask`` (clearing V/U at the communicated coordinates).

* ``NullTimer`` — the default: ``stage`` just calls the thunk and
  ``count`` does nothing, so an untimed step adds no host sync.
* ``WallClockTimer`` — host wall time per stage, with a barrier after
  the thunk: ``torch.cuda.synchronize`` on each CUDA device the stage's
  output lives on (the reference's ``jax.block_until_ready``; a CPU
  stage has finished when it returns). A stage's time therefore holds
  the host's launch and ``.item()`` costs as well as the device's.

``set_lane`` opens a named attribution lane: while one is set, stage
times are additionally summed under it (``summary()["lanes"]``).
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Any, Callable

import torch

# Canonical stage order of one sync step (Fig 10's x-axis, with the
# paper's "mask" bar split into accumulate + mask).
STAGES = ("accumulate", "select", "mask", "pack", "transfer", "unpack")


class NullTimer:
    """No-op timer: the default hook."""

    active = False

    def stage(self, name: str, thunk: Callable[[], Any]) -> Any:
        return thunk()

    def count(self, name: str, n: int = 1) -> None:
        pass

    def set_lane(self, lane: str | None) -> None:
        pass

    def summary(self) -> dict:
        return {}


def _cuda_devices(out: Any, found: set) -> set:
    """The CUDA devices of every tensor in a nest of tuples, lists and
    dicts (NamedTuples such as ``Selected`` and ``LeafState`` included)."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _cuda_devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _cuda_devices(x, found)
    return found


class WallClockTimer:
    """Per-stage wall-clock accumulator with device barriers."""

    active = True

    def __init__(self) -> None:
        self.times: dict[str, list[float]] = defaultdict(list)
        self.counts: dict[str, int] = defaultdict(int)
        # {lane: {stage: total_s}}, summed alongside the unlaned totals
        self.lane_times: dict[str, dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        self._lane: str | None = None

    def stage(self, name: str, thunk: Callable[[], Any]) -> Any:
        t0 = time.perf_counter()
        out = thunk()
        for dev in _cuda_devices(out, set()):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.times[name].append(dt)
        if self._lane is not None:
            self.lane_times[self._lane][name] += dt
        return out

    def count(self, name: str, n: int = 1) -> None:
        # callers may pass a 0-d bool tensor (the select_overflow flag)
        self.counts[name] += int(n)

    def set_lane(self, lane: str | None) -> None:
        self._lane = lane

    def reset(self) -> None:
        self.times.clear()
        self.counts.clear()
        self.lane_times.clear()
        self._lane = None

    def summary(self) -> dict:
        """``{"stages": {name: {calls, total_s, mean_ms, share}},
        "counts": {...}, "total_s": float}`` in ``STAGES`` order (other
        stage names appended, sorted), plus ``"lanes"`` (each lane's
        per-stage second totals) once a lane was set."""
        totals = {n: sum(ts) for n, ts in self.times.items()}
        grand = sum(totals.values())
        order = [s for s in STAGES if s in totals] + sorted(
            n for n in totals if n not in STAGES)
        stages = {}
        for n in order:
            ts = self.times[n]
            stages[n] = {
                "calls": len(ts),
                "total_s": totals[n],
                "mean_ms": 1e3 * totals[n] / max(len(ts), 1),
                "share": totals[n] / grand if grand > 0 else 0.0,
            }
        out = {"stages": stages, "counts": dict(self.counts),
               "total_s": grand}
        if self.lane_times:
            out["lanes"] = {lane: dict(stages_)
                            for lane, stages_ in self.lane_times.items()}
        return out
