"""Stage instrumentation hook for the sync pipeline (Fig 10's stages).

Port of ``src/repro/core/instrument.py``, ``NullTimer`` only: the sync
loop threads every stage through ``timer.stage(name, thunk)`` and counts
fused dispatches with ``timer.count``; the null timer just runs the
thunk. A CUDA-event stage timer waits for the benchmark slice.
"""
from __future__ import annotations

from typing import Any, Callable


class NullTimer:
    """No-op timer: the default hook."""

    active = False

    def stage(self, name: str, thunk: Callable[[], Any]) -> Any:
        return thunk()

    def count(self, name: str, n: int = 1) -> None:
        pass
