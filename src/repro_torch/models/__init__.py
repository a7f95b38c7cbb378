"""Models (reference: ``src/repro/models``): the paper's ``lstm`` and
the transformer chassis (``common``, ``attention``, ``transformer``) of
the dense and vlm families, behind ``registry.get_model``."""
