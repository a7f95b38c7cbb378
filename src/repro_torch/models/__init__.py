"""Models (reference: ``src/repro/models``); only ``lstm`` so far."""
