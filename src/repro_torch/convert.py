"""Carry trees between the JAX reference and the port as numpy arrays.

The two packages draw different random numbers from the same seed, so a
parity run initialises in JAX and moves the values across:

    params_np = jax.tree.map(np.asarray, params)      # JAX side
    params = convert.from_numpy(params_np, device)    # port side

Parameters map one to one (``embed.table``, ``lm_head``, ``lm_bias``,
``lstm_i.{wx,wh,b}``; same layouts, no transposes). A ``LeafState``
tree (any named tuple with the reference's five fields at the leaves)
becomes the port's ``LeafState`` tree; ``to_numpy`` goes the other way.
numpy has no bfloat16 of its own: a bf16 array (JAX's ``ml_dtypes``
type) crosses by its bits, and a bf16 tensor comes back as float32,
which holds every bf16 value exactly.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.residual import LeafState


def _is_leaf_state(x: Any) -> bool:
    return getattr(x, "_fields", None) == LeafState._fields


def _to_torch(a, device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.to(torch.float32) if t.dtype == torch.bfloat16 else t).numpy()


def from_numpy(t: Any, device: str | torch.device = "cpu") -> Any:
    """Nested dict of numpy arrays (or of LeafStates of numpy arrays) ->
    the same tree of torch tensors on ``device``."""
    if isinstance(t, dict):
        return {k: from_numpy(v, device) for k, v in t.items()}
    if _is_leaf_state(t):
        return LeafState(*(_to_torch(f, device) for f in t))
    return _to_torch(t, device)


def to_numpy(t: Any) -> Any:
    """Port tree (tensors or LeafStates) -> nested dict of numpy arrays;
    LeafStates become the port's LeafState of numpy arrays."""
    if isinstance(t, dict):
        return {k: to_numpy(v) for k, v in t.items()}
    if _is_leaf_state(t):
        return LeafState(*(_to_numpy(f) for f in t))
    return _to_numpy(t)

