"""RedSync core, PyTorch port (reference: ``src/repro/core``).

Importing the package registers every ported component (compressors,
corrections, dispatch policies, transports, schedules) in ``registry``.
"""
from . import compressors, correction, dispatch, overlap, transport  # noqa: F401
from . import registry
from .api import (Compressor, Correction, DispatchPolicy, Schedule,
                  StageTimer, Transport)
from .gradient_sync import GradientSync, build_gradient_sync
from .instrument import STAGES, NullTimer, WallClockTimer
from .transport import (BucketedAllgather, DensePsum, FusedAllgather,
                        HierarchicalAllgather, PerLeafAllgather,
                        assign_buckets)

__all__ = [
    "registry",
    "Compressor", "Correction", "DispatchPolicy", "Schedule", "StageTimer",
    "Transport",
    "GradientSync", "build_gradient_sync",
    "STAGES", "NullTimer", "WallClockTimer",
    "BucketedAllgather", "DensePsum", "FusedAllgather",
    "HierarchicalAllgather", "PerLeafAllgather", "assign_buckets",
]
