"""Correction implementations (DGC, Lin et al. 1712.01887).

Port of ``src/repro/core/correction.py``: ``CorrectionBase``, the four
DGC corrections ``GradientSync.update`` runs ahead of the compressor —

* ``momentum``: momentum correction, with momentum factor masking of its
  own velocity, plus its flat-arena hooks;
* ``factor_masking`` (alias ``masking``): clear U at communicated
  coordinates;
* ``local_clip`` (alias ``clip``): scale the local gradient so its norm
  stays under N^{-1/2} of the global clip threshold;
* ``warmup``: the §5.7 density ramp (``core.schedule``) —

and the ``split_corrections`` spec grammar.
"""
from __future__ import annotations

from typing import Any

import torch

from . import registry
from .residual import (LeafState, accumulate, local_clip_scale,
                       mask_momentum, pinned_product)
from .schedule import DGC_WARMUP, DensitySchedule


class CorrectionBase:
    """No-op defaults for every correction hook (see the reference)."""

    name = "?"
    needs_momentum_buffer = False
    arena_mask_momentum = False

    def arena_coeffs(self) -> tuple[float, bool] | None:
        """(momentum, nesterov) if this correction owns residual
        accumulation in the fusable Alg 4 form; None = not an owner."""
        return None

    def arena_safe(self) -> bool:
        """Whether the flat-arena path reproduces this correction exactly:
        structurally true when neither per-leaf hook is overridden."""
        cls = type(self)
        return (cls.accumulate is CorrectionBase.accumulate
                and cls.on_communicated is CorrectionBase.on_communicated)

    def on_grads(self, grads: list, params: list, num_workers: int) -> list:
        return grads

    def accumulate(self, grad, param, state: LeafState, *,
                   weight_decay: float) -> LeafState | None:
        return None

    def on_communicated(self, state: LeafState, indices) -> LeafState:
        return state

    def density_at(self, step: int, target: float) -> float | None:
        return None

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<correction {self.name}>"


class MomentumCorrection(CorrectionBase):
    """DGC momentum correction on the residual buffer (Alg 4 l.11-19),
    with momentum factor masking of its own velocity."""

    name = "momentum"
    needs_momentum_buffer = True
    arena_mask_momentum = True

    def __init__(self, momentum: float = 0.9, nesterov: bool = False):
        self.momentum = momentum
        self.nesterov = nesterov

    def accumulate(self, grad, param, state, *, weight_decay):
        return accumulate(grad, param, state, momentum=self.momentum,
                          nesterov=self.nesterov, weight_decay=weight_decay)

    def on_communicated(self, state, indices):
        return mask_momentum(state, indices)

    def arena_coeffs(self):
        return self.momentum, self.nesterov

    def arena_safe(self):
        return True


class FactorMasking(CorrectionBase):
    """Standalone DGC momentum factor masking: clear U at communicated
    coordinates (a no-op on a 0-d velocity placeholder)."""

    name = "factor_masking"
    arena_mask_momentum = True

    def on_communicated(self, state, indices):
        return mask_momentum(state, indices)

    def arena_safe(self):
        return True


class LocalClip(CorrectionBase):
    """DGC local gradient clipping (§5.6), before residual accumulation.

    The squared norm is the leaves' pinned sums of g², added in tree
    order by Python's ``sum`` (from int 0), and each leaf is scaled by
    a separately rounded product, as in the reference."""

    name = "local_clip"

    def __init__(self, clip_norm: float = 1.0):
        self.clip_norm = clip_norm

    def on_grads(self, grads, params, num_workers):
        from .selection import pinned_sum
        sq = sum(pinned_sum(g.to(torch.float32) ** 2) for g in grads)
        scale = local_clip_scale(sq, self.clip_norm, num_workers)
        # JAX promotes a bf16 leaf times the f32 scale to f32; torch
        # would keep bf16 for a 0-d scale
        return [pinned_product(g.to(torch.promote_types(g.dtype, scale.dtype)),
                               scale) for g in grads]


class Warmup(CorrectionBase):
    """Sparsity warm-up ramp (§5.7): owns the density of each step through
    a ``DensitySchedule``; the trainer asks
    ``GradientSync.scheduled_density(step)``."""

    name = "warmup"
    DEFAULT_STEPS_PER_STAGE = 25

    def __init__(self, schedule: DensitySchedule):
        self.schedule = schedule

    def density_at(self, step, target):
        return self.schedule.density_at(step)


# --- spec grammar ----------------------------------------------------------

def _split_top_plus(spec: str) -> tuple[str, str | None]:
    """First top-level '+'-separated term, and the remainder (or None)."""
    depth = 0
    for i, ch in enumerate(spec):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "+" and depth == 0:
            return spec[:i].strip(), spec[i + 1:].strip()
    return spec.strip(), None


def _is_correction(name: str) -> bool:
    return name in registry.names(registry.CORRECTION)


def split_corrections(spec: str) -> tuple[list[str], str]:
    """Parse the extended optimizer grammar into (corrections, base spec):
    ``"momentum+clip(threshold_bsearch)"`` -> (["momentum", "clip"],
    "threshold_bsearch"); a corrections-only spec gives base ``""``."""
    corrections: list[str] = []
    rest = spec.strip()
    while rest:
        term, tail = _split_top_plus(rest)
        head, _, paren = term.partition("(")
        head = head.strip()
        if paren and term.endswith(")") and _is_correction(head):
            if tail is not None:
                raise ValueError(
                    f"bad optimizer spec {spec!r}: parenthesized correction "
                    f"{head!r} must wrap the rest of the pipeline")
            corrections.append(head)
            rest = paren[:-1].strip()
            continue
        if _is_correction(term):
            corrections.append(term)
            rest = tail or ""
            continue
        if tail is not None:
            raise ValueError(
                f"bad optimizer spec {spec!r}: {term!r} is not a registered "
                f"correction {registry.names(registry.CORRECTION)} and only "
                f"the final term may name the base optimizer")
        return corrections, term
    return corrections, ""


# --- registration ----------------------------------------------------------

@registry.register(registry.CORRECTION, "momentum")
def _momentum(momentum: float = 0.9, nesterov: bool = False,
              **_: Any) -> MomentumCorrection:
    return MomentumCorrection(momentum=momentum, nesterov=nesterov)


@registry.register(registry.CORRECTION, "factor_masking")
def _factor_masking(**_: Any) -> FactorMasking:
    return FactorMasking()


@registry.register(registry.CORRECTION, "local_clip")
def _local_clip(local_clip: float | None = None, **_: Any) -> LocalClip:
    return LocalClip(clip_norm=1.0 if local_clip is None else local_clip)


@registry.register(registry.CORRECTION, "warmup")
def _warmup(density: float = 0.001, warmup_steps_per_stage: int = 0,
            dense_warmup: bool = False,
            warmup_stages: tuple[float, ...] = DGC_WARMUP,
            **_: Any) -> Warmup:
    # a spec that names warmup asks for a ramp: an unset stage length
    # falls back to the default
    steps = (warmup_steps_per_stage if warmup_steps_per_stage > 0
             else Warmup.DEFAULT_STEPS_PER_STAGE)
    return Warmup(DensitySchedule(target=density,
                                  warmup_steps_per_stage=steps,
                                  stages=tuple(warmup_stages),
                                  dense_warmup=dense_warmup))


registry.register_alias(registry.CORRECTION, "clip", "local_clip")
registry.register_alias(registry.CORRECTION, "masking", "factor_masking")
