"""PyTorch / CUDA port of the RedSync reproduction (reference: ``src/repro``).

Laid out module for module like ``repro``; each module's docstring names
the file it ports. The package imports ``torch`` and ``numpy`` only —
never ``jax`` and nothing of ``repro`` — so it runs on a GPU host without
JAX. The parity tests (``tests/test_torch_*.py``) import both packages
and pass numpy arrays between them.

Entry points (``Trainer``, ``build_gradient_sync``, the
``repro_torch.launch.train`` CLI) run on ``torch.device("cuda")`` unless
the caller passes ``device="cpu"``; without a card and without an
explicit CPU request they raise. Kernel wrappers pick their
implementation from the tensor they are given: the plain PyTorch twin for
a CPU tensor, the hand-written CUDA kernel for a CUDA tensor.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` -> CUDA; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev
