"""Elastic worker-count changes for checkpointed sync state.

Port of ``src/repro/checkpoint/elastic.py``. Each data-parallel worker
holds ITS OWN residual / velocity / pending messages (they diverge
because each worker accumulates its own local gradients), so a faithful
checkpoint captures every worker's copy:

    ``stack_worker_copies``   leaf -> ndarray[p, *leaf.shape]: row r is
                              the rank at first-axis-major mesh position
                              r, gathered over the mesh's batch axes
    ``unstack_to_devices``    the inverse: every rank takes its own row
                              to its device (bitwise resume)

In the reference one process holds every device's buffer; here each
rank is a process, so stacking is an all-gather and unstacking a read.
Without a mesh both are ``p = 1``.

When the worker count changes between save and restore, per-worker
state is REDISTRIBUTED by the pinned remainder rule, uniform for shrink
and grow:

    new worker w  <-  SUM of old workers { i < p_old : i mod p_new == w }

summed in ascending ``i``. Additive state (residual, velocity) is
SUMMED: gradient mass is conserved, none dropped or double-counted.
Non-additive per-worker scalars (warm-start threshold, phase / interval
counters) follow the copy rule ``new[w] = old[w mod p_old]``. In-flight
pending rings must be reabsorbed into the residual FIRST
(``core.overlap.reabsorb_pending``): they were packed for a
1/p_old-weighted apply and cannot be replayed at p_new.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import sync as sync_lib
from repro_torch.core.residual import LeafState

from .ckpt import map_with_keys, to_numpy, to_torch
from .delta import dtype_name

__all__ = ["stack_worker_copies", "unstack_to_devices",
           "redistribute_stacked", "redistribute_tree",
           "redistribute_leaf_states"]


def _gather_rows(leaf: torch.Tensor, mesh) -> np.ndarray:
    """``[p, *leaf.shape]`` host rows of every rank's ``leaf``. A bf16
    leaf crosses as its bits widened to int32 (a type every backend
    gathers), then narrows back exactly."""
    axes = tuple(mesh.axis_names)
    x = leaf.detach()
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        x = x.view(torch.int16).to(torch.int32)
    rows = sync_lib.sparse_allgather(x.reshape(-1), axes, mesh)
    if bf16:
        rows = rows.to(torch.int16).view(torch.bfloat16)
    return to_numpy(rows.reshape(mesh.axes_size(axes), *leaf.shape))


def stack_worker_copies(tree: Any, mesh=None) -> Any:
    """Every leaf -> ``ndarray[p, *shape]`` on the host: one row per
    worker of ``mesh`` (collective: every rank calls it). Without a mesh
    ``p = 1``."""
    if mesh is None:
        return map_with_keys(lambda _, leaf: to_numpy(leaf)[None], tree)
    return map_with_keys(lambda _, leaf: _gather_rows(leaf, mesh), tree)


def unstack_to_devices(tree: Any, mesh, device) -> Any:
    """Inverse of ``stack_worker_copies``: this rank's row of each
    stacked leaf as a tensor on ``device``. ``mesh=None`` takes row 0."""
    row, p = 0, 1
    if mesh is not None:
        axes = tuple(mesh.axis_names)
        row, p = mesh.index(axes), mesh.axes_size(axes)

    def unstack(key, stacked):
        stacked = np.asarray(stacked)
        if mesh is not None and stacked.shape[0] != p:
            raise ValueError(
                f"stacked leaf {key} has {stacked.shape[0]} worker rows "
                f"but the mesh has {p} workers — redistribute first")
        return to_torch(stacked[row], device)

    return map_with_keys(unstack, tree)


def redistribute_stacked(stacked: np.ndarray, p_new: int,
                         additive: bool) -> np.ndarray:
    """One stacked leaf ``[p_old, ...]`` -> ``[p_new, ...]``.

    ``additive=True``: the pinned remainder SUM rule (residual /
    velocity mass conserved), in ascending ``i``; bf16 rows add in bf16
    (each sum rounded once to nearest even). ``additive=False``: the
    copy rule ``new[w] = old[w mod p_old]``.
    """
    stacked = np.asarray(stacked)
    p_old = stacked.shape[0]
    if p_new < 1:
        raise ValueError(f"p_new must be >= 1, got {p_new}")
    if p_new == p_old:
        return stacked
    if additive:
        if dtype_name(stacked) == "bfloat16":
            rows = to_torch(stacked)
            out = torch.zeros((p_new,) + tuple(rows.shape[1:]),
                              dtype=rows.dtype)
            for i in range(p_old):
                out[i % p_new] = out[i % p_new] + rows[i]
            return to_numpy(out)
        out = np.zeros((p_new,) + stacked.shape[1:], stacked.dtype)
        for i in range(p_old):
            out[i % p_new] = out[i % p_new] + stacked[i]
        return out
    return stacked[[w % p_old for w in range(p_new)]]


def redistribute_leaf_states(stacked_leaf_tree: Any, p_new: int) -> Any:
    """Redistribute a stacked ``LeafState`` tree (a LeafState, or nested
    dicts of them) to ``p_new`` workers.

    Per-field rules: ``residual`` is additive; ``momentum`` is additive
    iff it is the param-shaped velocity buffer (``momentum=False``
    leaves a scalar placeholder: copy rule); ``threshold`` / ``phase`` /
    ``interval`` are warm-start caches and lockstep counters: copy rule.
    """
    if isinstance(stacked_leaf_tree, dict):
        return {k: redistribute_leaf_states(v, p_new)
                for k, v in stacked_leaf_tree.items()}
    ls = stacked_leaf_tree
    res = np.asarray(ls.residual)
    mom = np.asarray(ls.momentum)
    return LeafState(
        residual=redistribute_stacked(res, p_new, additive=True),
        momentum=redistribute_stacked(
            mom, p_new, additive=mom.shape == res.shape),
        threshold=redistribute_stacked(ls.threshold, p_new, False),
        phase=redistribute_stacked(ls.phase, p_new, False),
        interval=redistribute_stacked(ls.interval, p_new, False))


def redistribute_tree(stacked_tree: Any, p_new: int,
                      is_additive: Callable[[str, Any], bool]) -> Any:
    """Map ``redistribute_stacked`` over a stacked tree;
    ``is_additive(key, leaf)`` classifies each leaf by its key string
    (``ckpt.flatten``'s) and value."""
    return map_with_keys(
        lambda key, leaf: redistribute_stacked(leaf, p_new,
                                               is_additive(key, leaf)),
        stacked_tree)
