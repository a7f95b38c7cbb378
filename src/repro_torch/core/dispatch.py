"""Per-leaf method dispatch (§5.5), as pluggable ``DispatchPolicy``s.

Port of ``src/repro/core/dispatch.py``. ``size_based`` is the paper's
rule on the leaf's REAL byte size: < 128 KB dense allreduce, 128 KB -
4 MB trimmed top-k, >= 4 MB threshold binary search. ``fixed`` routes
every leaf through one named compressor.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from . import registry
from .cost_model import (DENSE_THRESHOLD_BYTES, TRIMMED_THRESHOLD_BYTES,
                         choose_method)

# cost-model method name -> registered compressor name
_METHOD_COMPRESSOR = {
    "dense": "dense",
    "trimmed_topk": "trimmed_topk",
    "threshold_binary_search": "threshold_bsearch",
}


def leaf_nbytes(x) -> int:
    """Real storage bytes of a leaf."""
    return int(x.numel()) * x.element_size()


@dataclass(frozen=True)
class SizeBasedPolicy:
    """RedSync §5.5: choose the selector by leaf byte size."""

    dense_threshold_bytes: int = DENSE_THRESHOLD_BYTES
    trimmed_threshold_bytes: int = TRIMMED_THRESHOLD_BYTES

    def compressor_for(self, path: str, leaf) -> str:
        method = choose_method(leaf_nbytes(leaf), self.dense_threshold_bytes,
                               self.trimmed_threshold_bytes)
        return _METHOD_COMPRESSOR[method]


@dataclass(frozen=True)
class FixedPolicy:
    """Every leaf uses one registered compressor."""

    compressor: str = "threshold_bsearch"

    def compressor_for(self, path: str, leaf) -> str:
        return self.compressor


@registry.register(registry.DISPATCH_POLICY, "size_based")
def _size_based(dense_threshold_bytes: int = DENSE_THRESHOLD_BYTES,
                trimmed_threshold_bytes: int = TRIMMED_THRESHOLD_BYTES,
                **_: Any) -> SizeBasedPolicy:
    return SizeBasedPolicy(dense_threshold_bytes, trimmed_threshold_bytes)


@registry.register(registry.DISPATCH_POLICY, "fixed")
def _fixed(compressor: str = "threshold_bsearch", **_: Any) -> FixedPolicy:
    return FixedPolicy(compressor)
