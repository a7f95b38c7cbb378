"""Command-line launchers (reference: ``src/repro/launch``)."""
