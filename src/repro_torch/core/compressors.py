"""Compressor implementations (RedSync §5.2), registry-addressable.

Port of ``src/repro/core/compressors.py``: ``dense``, ``exact_topk``,
``trimmed_topk``, ``threshold_bsearch`` (alias
``threshold_binary_search``) and ``sampled_bsearch`` with the
segmented-arena protocol (``segment_spec`` / ``finish_segments``) and
§5.2.2 threshold reuse (refresh every ``interval`` steps, warm-started
bisection in between refreshes), and the §5.2.3 ``quantized(<inner>)``
wrapper (a bare ``quantized`` wraps ``exact_topk``).

The reference's ``backend`` parameter ("jnp" | "pallas") is accepted
and ignored: in the port the tensor's device picks the implementation
(plain PyTorch on the CPU, the CUDA kernels on the card), and both
compute what the reference's default ``jnp`` backend computes. Per leaf,
``trimmed_topk`` and ``threshold_bsearch`` compress, and select their
quantized variants, through the kernel compositions of ``kernels.ops``
on both devices (the kernels' plain twins on the CPU);
``sampled_bsearch`` through a one-slot arena on the card and
``selection.sampled_threshold_search`` on the CPU; ``exact_topk`` sorts
(``selection.exact_topk``) on both.
"""
from __future__ import annotations

from typing import Any

import torch

from . import registry
from . import selection as sel_lib
from .cost_model import sample_stride, sampled_capacity
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

    def segment_strides(self, geom) -> tuple[int, ...]:
        """Per-slot sampling strides of the arena statistics (1 = exact)."""
        return (1,) * geom.n_seg

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


class ExactTopK(_Base):
    """The radixSelect baseline: exact |x| top-k (capacity == k)."""

    name = "exact_topk"

    def capacity(self, k: int) -> int:
        return k

    def compress(self, flat_v, k, state):
        return sel_lib.exact_topk(flat_v, k), state

    def quant_select(self, flat_v, k, phase) -> Selected:
        return sel_lib.exact_topk_quant(flat_v, k, phase)


class TrimmedTopK(_Base):
    """Alg 2: statistics-guided trimming, then top-k over survivors."""

    name = "trimmed_topk"
    supports_segmented = True

    def __init__(self, eps: float = 0.2):
        self.eps = eps

    def capacity(self, k: int) -> int:
        return k

    def compress(self, flat_v, k, state):
        from repro_torch.kernels import ops as kops
        return kops.trimmed_topk(flat_v, k, eps=self.eps), state

    def segment_spec(self, geom, states):
        from repro_torch.kernels import segmented as kseg
        return kseg.SegmentSpec(alg="trimmed", eps=self.eps)

    def quant_select(self, flat_v, k, phase) -> Selected:
        from repro_torch.kernels import ops as kops
        return kops.trimmed_topk_quant(flat_v, k, phase, eps=self.eps)


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
        from repro_torch.kernels import ops as kops
        if bool(state.interval % self.interval == 0):
            s, thr = kops.threshold_binary_search(
                flat_v, k, eps=self.eps,
                warm=state.threshold if self.warm_start else None)
        else:
            s = kops.threshold_filter(flat_v, state.threshold, 2 * k)
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

    def quant_select(self, flat_v, k, phase) -> Selected:
        # the alternating sign phase rules out threshold sharing
        # (§5.2.3): the quantized variant always re-searches, cold
        from repro_torch.kernels import ops as kops
        return kops.threshold_binary_search_quant(flat_v, k, phase,
                                                  eps=self.eps)


class SampledBSearch(ThresholdBSearch):
    """Alg 3 with DGC-style sampled statistics and sampled nnz counting:
    mean/max and every search count come from each leaf's ``[::stride]``
    subsample (``cost_model.sample_stride``), and the message carries
    tolerance headroom, ``capacity(k) == sampled_capacity(k, tolerance)``.
    The final filter uses the true count. ``tolerance == 0`` is stride 1,
    the exact ``threshold_bsearch``."""

    name = "sampled_bsearch"

    def __init__(self, interval: int = 5, eps: float = 1e-3,
                 warm_start: bool = True, tolerance: float = 0.5):
        super().__init__(interval=interval, eps=eps, warm_start=warm_start)
        self.tolerance = tolerance

    def capacity(self, k: int) -> int:
        return sampled_capacity(k, self.tolerance)

    def segment_strides(self, geom) -> tuple[int, ...]:
        return tuple(sample_stride(k, self.tolerance) for k in geom.seg_ks)

    def compress(self, flat_v, k, state: LeafState
                 ) -> tuple[Selected, LeafState]:
        if flat_v.device.type != "cpu":
            return self.compress_arena(flat_v, k, state)
        cap = self.capacity(k)
        if bool(state.interval % self.interval == 0):
            s, thr = sel_lib.sampled_threshold_search(
                flat_v, k, stride=sample_stride(k, self.tolerance),
                capacity=cap, eps=self.eps,
                warm=state.threshold if self.warm_start else None)
        else:
            s = sel_lib.threshold_filter(flat_v, state.threshold,
                                         capacity=cap)
            thr = state.threshold
        return s, state._replace(threshold=thr, interval=state.interval + 1)

    def compress_arena(self, flat_v, k, state: LeafState
                       ) -> tuple[Selected, LeafState]:
        """The lone leaf as a one-slot arena through ``multi_select`` —
        the strided kernels exist only in segmented form — as the
        reference's Pallas branch does; bitwise the per-leaf search."""
        from repro_torch.kernels import segmented as kseg

        from .arena import ARENA_BLOCK, single_slot_geometry
        n = flat_v.numel()
        geom = single_slot_geometry(n, k)
        x2d = flat_v.new_zeros(geom.nblocks * ARENA_BLOCK)
        x2d[:n] = flat_v.reshape(-1)
        spec = self.segment_spec(geom, [state])
        ((sel, thr),) = kseg.multi_select(
            [(x2d.reshape(geom.nblocks, ARENA_BLOCK), geom, spec, None)])
        return sel[0], self.finish_segments([state], thr)[0]

    def segment_spec(self, geom, states):
        return super().segment_spec(geom, states)._replace(
            strides=self.segment_strides(geom),
            capacities=tuple(self.capacity(k) for k in geom.seg_ks))

    # no quantized variant: the single-mean payload is incompatible with
    # the sampled capacity headroom (the count could exceed 2k)
    quant_select = None


class Quantized(_Base):
    """§5.2.3 wrapper: same-signed selection (top-k, then bottom-k, by
    ``LeafState.phase``) and a one-scalar-mean payload."""

    quantized = True

    def __init__(self, inner: _Base):
        if getattr(inner, "quantized", False):
            raise ValueError("cannot quantize an already-quantized "
                             f"compressor {inner.name!r}")
        if not callable(getattr(inner, "quant_select", None)):
            raise ValueError(
                f"compressor {inner.name!r} has no quantized variant")
        self.inner = inner
        self.name = f"quantized({inner.name})"

    def capacity(self, k: int) -> int:
        return self.inner.capacity(k)

    def compress(self, flat_v, k, state: LeafState
                 ) -> tuple[Selected, LeafState]:
        sel = self.inner.quant_select(flat_v, k, state.phase)
        return sel, state._replace(phase=(state.phase + 1) % 2)


# --- registration ----------------------------------------------------------

@registry.register(registry.COMPRESSOR, "dense")
def _dense(**_: Any) -> Dense:
    return Dense()


@registry.register(registry.COMPRESSOR, "exact_topk")
def _exact(**_: Any) -> ExactTopK:
    return ExactTopK()


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


@registry.register(registry.COMPRESSOR, "sampled_bsearch")
def _sampled(bsearch_interval: int = 5, bsearch_eps: float = 1e-3,
             warm_start: bool = True, sampled_tolerance: float = 0.5,
             **_: Any) -> SampledBSearch:
    return SampledBSearch(interval=bsearch_interval, eps=bsearch_eps,
                          warm_start=warm_start,
                          tolerance=sampled_tolerance)


@registry.register(registry.COMPRESSOR, "quantized")
def _quantized(inner: _Base | None = None, **params: Any) -> Quantized:
    # bare "quantized" defaults to the exact-top-k inner selector
    return Quantized(inner if inner is not None
                     else registry.make(registry.COMPRESSOR, "exact_topk",
                                        **params))
