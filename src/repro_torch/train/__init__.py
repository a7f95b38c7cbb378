"""Training loop (reference: ``src/repro/train``)."""
