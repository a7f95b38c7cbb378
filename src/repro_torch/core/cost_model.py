"""Port of ``src/repro/core/cost_model.py`` (copied verbatim; pure Python).

RedSync communication cost model (§5.5, Appendix B).

    T_sparse = T_select + lg(p)·α + (p−1)·M·D·β + p·γ₁          (Eq 1)
    T_dense  = 2·lg(p)·α + 2·(p−1)/p·M·β + (p−1)/p·γ₂           (Eq 2)

α: per-message latency [s]; β: transfer time per element [s/elem]
(β = elem_bytes / link bandwidth); γ₁: per-node decompress cost for a
size-M message; γ₂: dense reduction cost for a size-M message.

The model drives two things:
  * ``choose_method`` — the paper's per-layer dispatch (<128 KB dense
    allreduce; 128 KB–4 MB trimmed top-k; >4 MB sampled binary search).
  * the Fig 7/8/9 scalability projections in benchmarks/.

Hardware presets include the paper's two testbeds and our TPU v5e target.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class NetworkModel:
    """α/β/γ parameters for one interconnect + accelerator pairing."""
    name: str
    alpha: float          # latency per message [s]
    bandwidth: float      # bytes/s effective allreduce/allgather bandwidth
    gamma1: float         # decompress (scatter-add) [s per message element]
    gamma2: float         # dense reduce [s per element]
    elem_bytes: int = 4   # f32 wire format

    @property
    def beta(self) -> float:
        return self.elem_bytes / self.bandwidth


# The paper's testbeds (§6.1: Muradin 3.5 GB/s, Piz Daint 1.5 GB/s) and the
# TPU v5e target (~50 GB/s/link ICI). γ values follow the paper's observation
# that decompression runs at a fraction of HBM bandwidth for small messages.
MURADIN = NetworkModel("muradin-8xTitanV", alpha=10e-6, bandwidth=3.5e9,
                       gamma1=2e-11, gamma2=5e-12)
PIZ_DAINT = NetworkModel("piz-daint-P100", alpha=15e-6, bandwidth=1.5e9,
                         gamma1=2e-11, gamma2=5e-12)
TPU_V5E = NetworkModel("tpu-v5e-ici", alpha=1e-6, bandwidth=50e9,
                       gamma1=5e-12, gamma2=1.2e-12)

PRESETS = {m.name: m for m in (MURADIN, PIZ_DAINT, TPU_V5E)}


# Effective selection scan rate [elements/s]: trimmed top-k style single
# pass over the residual at a fraction of memory bandwidth (Fig 3 scale —
# a 27M-element ResNet50 selects in ~3 ms on the paper's GPUs).
SELECT_THROUGHPUT = 9e9


def t_select_model(m: int, throughput: float = SELECT_THROUGHPUT) -> float:
    """Modeled selection time for an ``m``-element residual (one scan)."""
    return m / throughput


def sample_stride(k: int, tolerance: float, block: int = 1024) -> int:
    """Subsampling stride for sampled threshold search (DGC-style).

    The sampled nnz estimate at the true in-band threshold has relative
    sampling error ~ sqrt(stride / k); keeping that within tolerance/2 of
    the k..2k band gives ``stride <= k * tolerance^2 / 4``. Rounded down
    to a power of two so the stride divides the arena block size and the
    per-leaf / segmented subsample grids coincide, and capped at
    ``block`` so every kernel row contributes at least one sample.
    ``tolerance <= 0`` pins the exact path (stride 1).
    """
    if tolerance <= 0.0 or k <= 0:
        return 1
    target = max(1.0, k * tolerance * tolerance / 4.0)
    stride = 1 << int(math.floor(math.log2(target)))
    return max(1, min(block, stride))


def sampled_capacity(k: int, tolerance: float) -> int:
    """Message capacity for sampled bsearch: 2k plus tolerance headroom.

    The sampled search can converge to a threshold whose *true* nnz
    overshoots the k..2k band by ~the sampling tolerance; the extra
    ``ceil(2k * tolerance)`` slots absorb that so the overflow flag fires
    only on genuine estimate blowouts. ``tolerance=0`` gives exactly the
    exact-path capacity ``2k``.
    """
    return 2 * k + int(math.ceil(2 * k * tolerance))


def t_select_sampled(m: int, density: float, tolerance: float,
                     search_iters: int = 10,
                     throughput: float = SELECT_THROUGHPUT) -> float:
    """Modeled sampled-selection time for an ``m``-element residual.

    The bisection's ``search_iters`` counting scans touch only the
    ``m / stride`` subsample; one full scan remains for the final filter
    that materializes the message. ``tolerance=0`` degenerates to the
    exact search cost (``search_iters`` full scans + the filter scan).
    """
    k = max(1, int(m * density))
    stride = sample_stride(k, tolerance)
    return (search_iters * (m / stride) + m) / throughput


def eq1_terms(p: int, m: int, density: float, net: NetworkModel,
              t_select: float = 0.0, quantized: bool = False) -> dict:
    """Eq 1 term-by-term: the ONE definition of the sparse-step costs.

    ``m`` in elements. The wire message is k indices + k values (2k
    elements); quantization replaces the values with one scalar mean, so
    the payload halves to ~k elements (§5.2.3). ``unpack`` is the p·γ₁
    decompression term that Fig 10 shows dominating at scale. Both the
    scalar ``t_sparse`` and the Fig 7/10 benchmark decompositions are
    sums/shares of exactly these terms.
    """
    wire_elems = m * density * (1.0 if quantized else 2.0)
    return {
        "select": t_select,
        "latency": math.log2(max(p, 2)) * net.alpha,
        "bandwidth": (p - 1) * wire_elems * net.beta,
        "unpack": p * (m * density) * net.gamma1,
    }


def t_sparse(p: int, m: int, density: float, net: NetworkModel,
             t_select: float = 0.0, quantized: bool = False) -> float:
    """Eq 1 (the sum of ``eq1_terms``)."""
    return sum(eq1_terms(p, m, density, net, t_select, quantized).values())


def t_dense(p: int, m: int, net: NetworkModel) -> float:
    """Eq 2 (Rabenseifner allreduce)."""
    return (2 * math.log2(max(p, 2)) * net.alpha
            + 2 * (p - 1) / p * m * net.beta
            + (p - 1) / p * m * net.gamma2)


def speedup(p: int, m: int, density: float, net: NetworkModel,
            t_select: float = 0.0, quantized: bool = False) -> float:
    return t_dense(p, m, net) / t_sparse(p, m, density, net, t_select, quantized)


def predicted_shares(p: int, m: int, density: float, net: NetworkModel,
                     t_select: float | None = None,
                     quantized: bool = False) -> dict:
    """Fig 10 modeled decomposition: share of step time per stage.

    ``t_select=None`` derives the selection time from ``t_select_model``
    (one residual scan) instead of a hard-coded constant. ``transfer``
    folds the latency and bandwidth terms together, matching how the
    measured pipeline times its single ``transfer`` stage.
    """
    if t_select is None:
        t_select = t_select_model(m)
    terms = eq1_terms(p, m, density, net, t_select, quantized)
    tot = sum(terms.values())
    return {
        "select": terms["select"] / tot,
        "transfer": (terms["latency"] + terms["bandwidth"]) / tot,
        "unpack": terms["unpack"] / tot,
        "total_s": tot,
    }


def bandwidth_ratio(p: int, density: float) -> float:
    """Paper's §5.5 observation: sparse/dense *bandwidth-term* ratio is
    (p−1)·D / (2·(p−1)/p) = p·D/2 — model compression ≠ wire compression.
    With p=128, D=0.1% → 6.4% (12.8% for unquantized idx+val messages)."""
    return (p - 1) * density / (2 * (p - 1) / p)


# --- the paper's per-layer method dispatch (§5.5 last paragraph) -----------

DENSE_THRESHOLD_BYTES = 128 * 1024        # below: dense allreduce
TRIMMED_THRESHOLD_BYTES = 4 * 1024 * 1024  # below: trimmed top-k; above: bsearch


def choose_method(param_bytes: int,
                  dense_threshold: int = DENSE_THRESHOLD_BYTES,
                  trimmed_threshold: int = TRIMMED_THRESHOLD_BYTES) -> str:
    """§5.5 dispatch with PINNED half-open boundaries.

    ``[0, dense)`` → dense; ``[dense, trimmed)`` → trimmed top-k;
    ``[trimmed, ∞)`` → threshold binary search. The paper says "smaller
    than 128 KB", so a leaf of EXACTLY 128 KB is sparsified (trimmed) and
    one of exactly 4 MB goes to the binary search. 0-byte leaves are
    dense (nothing to select from; the dense collective is a no-op).
    ``dispatch.SizeBasedPolicy`` delegates here, so the cost model and the
    live per-leaf dispatch can never disagree at the boundaries.
    """
    if param_bytes < 0:
        raise ValueError(f"param_bytes must be >= 0, got {param_bytes}")
    if param_bytes < dense_threshold:
        return "dense"
    if param_bytes < trimmed_threshold:
        return "trimmed_topk"
    return "threshold_binary_search"
