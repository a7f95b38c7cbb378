"""RedSync core, PyTorch port (reference: ``src/repro/core``).

Importing the package registers every ported component (compressors,
corrections, dispatch policies, transports, schedules) in ``registry``.
"""
from . import compressors, correction, dispatch, overlap, transport  # noqa: F401
from . import registry  # noqa: F401
