"""Hand-written CUDA kernels and their plain PyTorch twins
(reference: ``src/repro/kernels``). Sources live in ``csrc/`` and are
built at first use by ``build``; nothing is compiled at import.
"""
