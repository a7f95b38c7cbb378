"""Composable gradient-compression API (RedSync decomposed).

Port of ``src/repro/core/api.py``: the six structural protocols the
pipeline is built from, with ``torch.Tensor`` where the reference has
``jax.Array``. Implementations register with ``core.registry`` and need
not inherit anything; the protocols are ``runtime_checkable``, so
``isinstance(obj, Transport)`` checks that the members exist.

``Compressor``
    Per-leaf selection/decompression policy (``dense``,
    ``trimmed_topk``, ``threshold_bsearch``, ``sampled_bsearch``).
``StageTimer``
    Stage instrumentation hook (``core.instrument``: ``NullTimer``,
    ``WallClockTimer``).
``Transport``
    Wire packing + collectives over ``sync_axes`` (``core.transport``).
``DispatchPolicy``
    The per-leaf compressor choice (§5.5 ``size_based``, ``fixed``).
``Correction``
    DGC convergence corrections run ahead of any compressor.
``Schedule``
    The §5.6 dispatch order of one sync step (``core.overlap``).
"""
from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch

from .residual import LeafState
from .selection import Selected


@runtime_checkable
class Compressor(Protocol):
    """Per-leaf compression: residual vector -> sparse communication set.

    A compressor MAY set ``supports_segmented = True`` and provide the
    arena methods (``segment_spec`` / ``finish_segments``); the sync
    loop fuses only leaves whose compressor does."""

    name: str
    quantized: bool

    def capacity(self, k: int) -> int:
        """Fixed message capacity for a target of k."""
        ...

    def init_leaf(self, param: torch.Tensor, *, momentum: bool,
                  residual_dtype: Any) -> LeafState:
        """Per-leaf residual/momentum/threshold state."""
        ...

    def compress(self, flat_v: torch.Tensor, k: int,
                 state: LeafState) -> tuple[Selected, LeafState]:
        """Select the communication set from the flat f32 residual."""
        ...

    def decompress(self, gathered: torch.Tensor, size: int,
                   k: int) -> torch.Tensor:
        """[workers, msg_len] wire messages -> dense f32[size] update SUM."""
        ...


@runtime_checkable
class StageTimer(Protocol):
    """Pipeline stage instrumentation (Fig 10's decomposition)."""

    active: bool

    def stage(self, name: str, thunk: Any) -> Any:
        """Run ``thunk()`` as pipeline stage ``name``; return its value."""
        ...

    def count(self, name: str, n: int = 1) -> None:
        """Accumulate a counter (no barrier, no timing)."""
        ...

    def set_lane(self, lane: str | None) -> None:
        """Attribute subsequent stages to a lane; ``None`` returns to the
        unlaned default."""
        ...

    def summary(self) -> dict:
        """Collected per-stage timings/counters ({} for null timers)."""
        ...


@runtime_checkable
class Transport(Protocol):
    """Wire packing + collectives over the data-parallel mesh axes."""

    name: str
    sync_axes: tuple[str, ...]
    timer: Any

    def num_workers(self) -> int:
        """Product of the ``sync_axes`` sizes (1 with no axes)."""
        ...

    def pack(self, sel: Selected, quantized: bool) -> torch.Tensor:
        """Selected -> packed f32 wire message."""
        ...

    def allgather(self, messages: list[torch.Tensor]
                  ) -> list[torch.Tensor]:
        """Exchange packed messages; returns per-message [workers, len]."""
        ...

    def allreduce_mean(self, grad: torch.Tensor) -> torch.Tensor:
        """Dense fallback for small leaves (all-reduce mean)."""
        ...


@runtime_checkable
class DispatchPolicy(Protocol):
    """Per-leaf compressor choice from the raw gradient's path, shape and
    dtype only."""

    def compressor_for(self, path: str, leaf: torch.Tensor) -> str:
        """Registered compressor name for this leaf ("dense" = allreduce)."""
        ...


@runtime_checkable
class Correction(Protocol):
    """Convergence correction run ahead of any compressor: ``on_grads``,
    ``accumulate`` (None = not mine), ``on_communicated`` and
    ``density_at`` (None = no schedule owned here)."""

    name: str
    needs_momentum_buffer: bool

    def on_grads(self, grads: list[torch.Tensor],
                 params: list[torch.Tensor],
                 num_workers: int) -> list[torch.Tensor]:
        """Transform the whole local gradient list before accumulation."""
        ...

    def accumulate(self, grad: torch.Tensor, param: torch.Tensor,
                   state: LeafState, *,
                   weight_decay: float) -> LeafState | None:
        """Fold this leaf's gradient into its residual; None = pass."""
        ...

    def on_communicated(self, state: LeafState,
                        indices: torch.Tensor) -> LeafState:
        """Mask leaf state at communicated coordinates (padding-safe)."""
        ...

    def density_at(self, step: int, target: float) -> float | None:
        """Scheduled density at ``step``; None = no schedule owned here."""
        ...


@runtime_checkable
class Schedule(Protocol):
    """Overlap scheduler (§5.6): owns ``GradientSync``'s init/update
    orchestration through its stage helpers. The reference's
    ``wrap_state_specs`` (shard_map partition specs) has no counterpart:
    the port shards nothing."""

    name: str

    def init_state(self, sync: Any, params: Any, leaf_state: Any) -> Any:
        """Wrap (or pass through) the LeafState tree as the full state."""
        ...

    def step(self, sync: Any, grads: Any, state: Any, params: Any,
             lr: torch.Tensor, density: float) -> tuple[Any, Any]:
        """One synchronized step; returns (new_params, new_state)."""
        ...
