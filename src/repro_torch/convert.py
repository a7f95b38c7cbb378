"""Carry trees between the JAX reference and the port as numpy arrays.

The two packages draw different random numbers from the same seed, so a
parity run initialises in JAX and moves the values across:

    params_np = jax.tree.map(np.asarray, params)      # JAX side
    params = convert.from_numpy(params_np, device)    # port side

Parameters map one to one, same layouts, no transposes. The paper's
LSTM: ``embed.table``, ``lm_head``, ``lm_bias``, ``lstm_i.{wx,wh,b}``.
The transformer chassis (dense, moe and vlm): ``embed.table`` (and
``embed.lm_head`` when untied), ``layers.{attn.{wq,wk,wv,wo,q_norm,k_norm},
ffn.{w_gate,w_up,w_down},norm_attn,norm_ffn}``, each stacked on a
leading layer axis (``q_norm`` / ``k_norm`` only with qk-norm), and
``final_norm``. In the moe family ``layers.ffn`` is the MoE FFN:
``router`` ``[L, D, E]``, ``w_gate`` / ``w_up`` ``[L, E, D, F]`` and
``w_down`` ``[L, E, F, D]``.

A ``LeafState`` tree (any named tuple with the reference's five fields
at the leaves) becomes the port's ``LeafState`` tree, and a buffered
schedule's state (any named tuple with ``ScheduleState``'s fields
``leaf`` and ``pending``) the port's ``ScheduleState``: its LeafState
tree, and its pending messages as a flat tuple (``stale1``) or a ring of
tuples (``staleK``); ``to_numpy`` goes the other way.

numpy has no bfloat16 of its own: a bf16 array (JAX's ``ml_dtypes``
type) crosses by its bits, and a bf16 tensor comes back as float32,
which holds every bf16 value exactly.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.overlap import ScheduleState
from repro_torch.core.residual import LeafState


def _is_leaf_state(x: Any) -> bool:
    return getattr(x, "_fields", None) == LeafState._fields


def _is_schedule_state(x: Any) -> bool:
    return getattr(x, "_fields", None) == ScheduleState._fields


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
    """Nested dict of numpy arrays (or of LeafStates of numpy arrays, or a
    ScheduleState of those) -> the same tree of torch tensors on
    ``device``."""
    if isinstance(t, dict):
        return {k: from_numpy(v, device) for k, v in t.items()}
    if _is_leaf_state(t):
        return LeafState(*(_to_torch(f, device) for f in t))
    if _is_schedule_state(t):
        return ScheduleState(*(from_numpy(f, device) for f in t))
    if isinstance(t, (tuple, list)):      # pending messages, or a ring
        return tuple(from_numpy(x, device) for x in t)
    return _to_torch(t, device)


def to_numpy(t: Any) -> Any:
    """Port tree (tensors, LeafStates or a ScheduleState) -> nested dict
    of numpy arrays; LeafStates become the port's LeafState of numpy
    arrays, a ScheduleState the port's ScheduleState of them."""
    if isinstance(t, dict):
        return {k: to_numpy(v) for k, v in t.items()}
    if _is_leaf_state(t):
        return LeafState(*(_to_numpy(f) for f in t))
    if _is_schedule_state(t):
        return ScheduleState(*(to_numpy(f) for f in t))
    if isinstance(t, (tuple, list)):
        return tuple(to_numpy(x) for x in t)
    return _to_numpy(t)

