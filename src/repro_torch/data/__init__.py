"""Synthetic data (reference: ``src/repro/data``)."""
from .synthetic import SyntheticLM, bigram_batches  # noqa: F401
