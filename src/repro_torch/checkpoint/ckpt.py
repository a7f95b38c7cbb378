"""Minimal deterministic checkpointing for trees of tensors.

Port of ``src/repro/checkpoint/ckpt.py``, writing the same files:
``<dir>/step_<n>/arrays.npz`` + ``tree.json``. Leaves are saved
flattened under the reference's key strings (``jax.tree_util.keystr``:
``['params']['b']``, ``['rgc'].leaf['b'].residual``,
``['rgc'].pending[0]``), in the reference's order: dict keys sorted,
named-tuple fields in field order, tuple and list items by index. So for
the same state both packages write byte-identical files and each
restores the other's. ``restore`` validates the structure against a
template tree (shape + dtype), so a config/ckpt mismatch fails loudly.
Writes are atomic (tmp dir + rename): an interrupted save never corrupts
the latest checkpoint.

Leaves may be torch tensors (on any device) or numpy arrays. A bf16
leaf is stored as its ``uint16`` bit pattern with ``orig_dtype``
``"bfloat16"`` in ``tree.json``; in memory it is a ``delta.BF16`` array
(see ``checkpoint.delta``), and ``to_torch`` views it back as
``torch.bfloat16``.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, Callable

import numpy as np
import torch

from .delta import BF16, dtype_name


def to_numpy(leaf) -> np.ndarray:
    """A tensor or array as a host numpy array of its own dtype (bf16 as
    a ``BF16`` array of its bits)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(BF16)
        return leaf.numpy()
    return np.asarray(leaf)


def to_torch(arr: np.ndarray, device: str | torch.device = "cpu"
             ) -> torch.Tensor:
    """Inverse of ``to_numpy``: a tensor on ``device`` (a copy)."""
    arr = np.array(arr, copy=True)
    if dtype_name(arr) == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def np_dtype(leaf) -> np.dtype:
    """The numpy dtype ``to_numpy`` gives a tensor or array (``BF16`` for
    bf16)."""
    if isinstance(leaf, torch.Tensor):
        name = str(leaf.dtype).removeprefix("torch.")
        return BF16 if name == "bfloat16" else np.dtype(name)
    return np.asarray(leaf).dtype


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """(key string, leaf) pairs in the reference's flattening order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in flatten(getattr(tree, f), f"{prefix}.{f}")]
    if isinstance(tree, (tuple, list)):
        return [kv for i, x in enumerate(tree)
                for kv in flatten(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def map_with_keys(fn: Callable[[str, Any], Any], tree: Any,
                  prefix: str = "") -> Any:
    """The same tree with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(tree, dict):
        return {k: map_with_keys(fn, v, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_keys(fn, getattr(tree, f),
                                          f"{prefix}.{f}")
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_keys(fn, x, f"{prefix}[{i}]")
                          for i, x in enumerate(tree))
    return fn(prefix, tree)


def _to_disk(arr: np.ndarray) -> np.ndarray:
    """npz has no bf16 codec: a ``BF16`` array goes as plain ``uint16``;
    the dtype is recorded in tree.json and reversed at restore."""
    return arr.view(np.uint16) if dtype_name(arr) == "bfloat16" else arr


def _flatten_native(tree: Any) -> dict[str, np.ndarray]:
    """``{key: host array}`` in native dtypes (bf16 as ``BF16``): the
    in-memory form the sparse-delta chain diffs against."""
    return {k: to_numpy(leaf) for k, leaf in flatten(tree)}


def save(directory: str, step: int, tree: Any) -> str:
    return save_flat(directory, step, _flatten_native(tree))


def save_flat(directory: str, step: int,
              flat: dict[str, np.ndarray]) -> str:
    """Write one full snapshot from an already-flattened native-dtype
    leaf dict (``_flatten_native`` keys). Atomic like ``save``."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        arrays = {k: _to_disk(v) for k, v in flat.items()}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        meta = {k: {"shape": list(v.shape), "dtype": str(v.dtype),
                    "orig_dtype": dtype_name(flat[k])}
                for k, v in arrays.items()}
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump({"step": step, "leaves": meta}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def load_flat(directory: str, step: int) -> dict[str, np.ndarray]:
    """Template-free load of one full snapshot as a native-dtype flat
    dict (bf16 leaves viewed as ``BF16`` via the recorded
    ``orig_dtype``)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "tree.json")) as f:
        meta = json.load(f)["leaves"]
    data = np.load(os.path.join(path, "arrays.npz"))
    out = {}
    for key, arr in data.items():
        orig = meta.get(key, {}).get("orig_dtype")
        if orig == "bfloat16" and arr.dtype == np.uint16:
            arr = arr.view(BF16)
        out[key] = arr
    return out


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(directory: str, template: Any, step: int | None = None) -> Any:
    """The snapshot at ``step`` (default latest) shaped like ``template``
    (see ``unflatten_like``)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    return unflatten_like(template, np.load(os.path.join(path,
                                                         "arrays.npz")))


def unflatten_like(template: Any, flat) -> Any:
    """Validate a flat ``{key: array}`` mapping against ``template`` and
    put its arrays in the template's places: a missing leaf raises
    ``KeyError``, a shape mismatch ``ValueError``; each array takes its
    template leaf's dtype, and a tensor leaf's device (numpy leaves give
    numpy arrays)."""
    def one(key, tmpl):
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = flat[key]
        shape = tuple(tmpl.shape) if isinstance(tmpl, torch.Tensor) \
            else np.shape(tmpl)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(
                f"shape mismatch at {key}: ckpt {arr.shape} vs "
                f"template {shape}")
        want = np_dtype(tmpl)
        if dtype_name(want) == "bfloat16" and arr.dtype == np.uint16:
            arr = arr.view(BF16)
        elif dtype_name(want) != dtype_name(arr):
            arr = np.asarray(arr, dtype=want)
        if isinstance(tmpl, torch.Tensor):
            return to_torch(arr, tmpl.device)
        return arr
    return map_with_keys(one, template)
