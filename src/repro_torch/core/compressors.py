"""Compressor implementations (RedSync §5.2), registry-addressable.

Port of ``src/repro/core/compressors.py``: ``dense``, ``trimmed_topk``
and ``threshold_bsearch`` (alias ``threshold_binary_search``) with the
segmented-arena protocol (``segment_spec`` / ``finish_segments``) and
§5.2.2 threshold reuse (refresh every ``interval`` steps, warm-started
bisection in between refreshes). ``exact_topk``, ``sampled_bsearch`` and
the ``quantized(...)`` wrapper wait.

The reference's ``backend`` parameter ("jnp" | "pallas") is accepted
and ignored: in the port the tensor's device picks the implementation
(plain PyTorch on the CPU, the CUDA kernels on the card), and both
compute what the reference's default ``jnp`` backend computes.
"""
from __future__ import annotations

from typing import Any

import torch

from . import registry
from . import selection as sel_lib
from . import sync as sync_lib
from .residual import LeafState, init_leaf
from .selection import Selected


class _Base:
    """Shared init/decompress; subclasses define capacity + compress."""

    name = "?"
    quantized = False
    supports_segmented = False

    def init_leaf(self, param: torch.Tensor, *, momentum: bool,
                  residual_dtype: Any = torch.float32) -> LeafState:
        return init_leaf(param, momentum=momentum,
                         residual_dtype=residual_dtype)

    def segment_spec(self, geom, states):
        raise NotImplementedError(
            f"compressor {self.name!r} has no segmented implementation")

    def finish_segments(self, states, thr):
        return list(states)

    def decompress(self, gathered: torch.Tensor, size: int,
                   k: int) -> torch.Tensor:
        return sync_lib.unpack_decompress(
            gathered, size, self.capacity(k), self.quantized)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<compressor {self.name}>"


class Dense(_Base):
    """Sentinel: leaf takes the dense allreduce path (no sparse message)."""

    name = "dense"

    def capacity(self, k: int) -> int:
        return 0

    def compress(self, flat_v, k, state):
        raise NotImplementedError(
            "dense leaves are synchronized via Transport.allreduce_mean")


class TrimmedTopK(_Base):
    """Alg 2: statistics-guided trimming, then top-k over survivors."""

    name = "trimmed_topk"
    supports_segmented = True

    def __init__(self, eps: float = 0.2):
        self.eps = eps

    def capacity(self, k: int) -> int:
        return k

    def compress(self, flat_v, k, state):
        return sel_lib.trimmed_topk(flat_v, k, self.eps), state

    def segment_spec(self, geom, states):
        from repro_torch.kernels import segmented as kseg
        return kseg.SegmentSpec(alg="trimmed", eps=self.eps)


class ThresholdBSearch(_Base):
    """Alg 3: threshold binary search with §5.2.2 threshold reuse;
    capacity == 2k (true length in the ``count`` header)."""

    name = "threshold_bsearch"
    supports_segmented = True

    def __init__(self, interval: int = 5, eps: float = 1e-3,
                 warm_start: bool = True):
        self.interval = interval
        self.eps = eps
        self.warm_start = warm_start

    def capacity(self, k: int) -> int:
        return 2 * k

    def compress(self, flat_v, k, state: LeafState
                 ) -> tuple[Selected, LeafState]:
        if bool(state.interval % self.interval == 0):
            s, thr = sel_lib.threshold_binary_search(
                flat_v, k, self.eps,
                warm=state.threshold if self.warm_start else None)
        else:
            s = sel_lib.threshold_filter(flat_v, state.threshold,
                                         capacity=2 * k)
            thr = state.threshold
        return s, state._replace(threshold=thr, interval=state.interval + 1)

    def segment_spec(self, geom, states):
        """Alg 3 spec with per-segment threshold reuse from the cached
        LeafState scalars."""
        from repro_torch.kernels import segmented as kseg
        intervals = torch.stack([st.interval for st in states])
        cached = torch.stack([st.threshold for st in states])
        return kseg.SegmentSpec(alg="bsearch", eps=self.eps,
                                refresh=(intervals % self.interval) == 0,
                                cached=cached, warm=self.warm_start)

    def finish_segments(self, states, thr):
        return [st._replace(threshold=thr[i], interval=st.interval + 1)
                for i, st in enumerate(states)]


# --- registration ----------------------------------------------------------

@registry.register(registry.COMPRESSOR, "dense")
def _dense(**_: Any) -> Dense:
    return Dense()


@registry.register(registry.COMPRESSOR, "trimmed_topk")
def _trimmed(trim_eps: float = 0.2, **_: Any) -> TrimmedTopK:
    return TrimmedTopK(eps=trim_eps)


@registry.register(registry.COMPRESSOR, "threshold_bsearch")
def _bsearch(bsearch_interval: int = 5, bsearch_eps: float = 1e-3,
             warm_start: bool = True, **_: Any) -> ThresholdBSearch:
    return ThresholdBSearch(interval=bsearch_interval, eps=bsearch_eps,
                            warm_start=warm_start)


registry.register_alias(registry.COMPRESSOR, "threshold_binary_search",
                        "threshold_bsearch")
