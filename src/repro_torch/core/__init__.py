"""RedSync core, PyTorch port (reference: ``src/repro/core``).

Importing the package registers every ported component (compressors,
corrections, dispatch policies, transports, schedules) in ``registry``.
"""
from . import compressors, correction, dispatch, overlap, transport  # noqa: F401
from . import registry
from .api import (Compressor, Correction, DispatchPolicy, Schedule,
                  StageTimer, Transport)
from .compressors import (Dense, ExactTopK, Quantized, ThresholdBSearch,
                          TrimmedTopK)
from .correction import (CorrectionBase, FactorMasking, LocalClip,
                         MomentumCorrection, Warmup, split_corrections)
from .dispatch import FixedPolicy, SizeBasedPolicy, leaf_nbytes
from .gradient_sync import GradientSync, build_gradient_sync
from .instrument import STAGES, NullTimer, WallClockTimer
from .rgc import RGCConfig, gradient_sync_from_rgc_config, rgc_apply, rgc_init
from .schedule import DensitySchedule
from .selection import (Selected, exact_topk, exact_topk_quant,
                        threshold_binary_search, threshold_binary_search_quant,
                        threshold_filter, trimmed_topk, trimmed_topk_quant)
from .transport import (BucketedAllgather, DensePsum, FusedAllgather,
                        HierarchicalAllgather, PerLeafAllgather,
                        assign_buckets)

__all__ = [
    "registry",
    "Compressor", "Correction", "DispatchPolicy", "Schedule", "StageTimer",
    "Transport",
    "Dense", "ExactTopK", "Quantized", "ThresholdBSearch", "TrimmedTopK",
    "CorrectionBase", "FactorMasking", "LocalClip", "MomentumCorrection",
    "Warmup", "split_corrections",
    "FixedPolicy", "SizeBasedPolicy", "leaf_nbytes",
    "GradientSync", "build_gradient_sync",
    "STAGES", "NullTimer", "WallClockTimer",
    "RGCConfig", "gradient_sync_from_rgc_config", "rgc_apply", "rgc_init",
    "DensitySchedule",
    "Selected", "exact_topk", "exact_topk_quant", "threshold_binary_search",
    "threshold_binary_search_quant", "threshold_filter", "trimmed_topk",
    "trimmed_topk_quant",
    "BucketedAllgather", "DensePsum", "FusedAllgather",
    "HierarchicalAllgather", "PerLeafAllgather", "assign_buckets",
]
