"""Correction implementations (DGC, Lin et al. 1712.01887).

Port of ``src/repro/core/correction.py``: ``CorrectionBase``,
``MomentumCorrection`` (momentum correction with its own momentum factor
masking, plus its flat-arena hooks) and the ``split_corrections`` spec
grammar. ``factor_masking``, ``local_clip`` and ``warmup`` are not
ported yet; their names stay registered so every spec string parses
exactly as in the reference, and building one raises.
"""
from __future__ import annotations

from typing import Any

from . import registry
from .residual import LeafState, accumulate, mask_momentum


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


def _not_ported(name: str):
    def factory(**_: Any):
        raise NotImplementedError(
            f"correction {name!r} is not ported to repro_torch yet "
            f"(see ROADMAP.md)")
    return factory


for _name in ("factor_masking", "local_clip", "warmup"):
    registry.register(registry.CORRECTION, _name)(_not_ported(_name))
registry.register_alias(registry.CORRECTION, "clip", "local_clip")
registry.register_alias(registry.CORRECTION, "masking", "factor_masking")
