"""Bit-exact sparse incremental checkpoint deltas.

Port of ``src/repro/checkpoint/delta.py`` (numpy only). One leaf's delta
is the packed wire layout of ``core.sync`` (``pack_pieces``): a flat f32
vector

    [ count (i32 bitcast) | indices (i32 bitcast) x count | payload x count ]

with ``capacity == count``. The payload stores the NEW bit patterns, not
arithmetic differences (``old + (new - old)`` is not invertible in
floating point, overwriting bits is):

    f32    payload = the new values verbatim
    bf16   payload = the new values widened to f32 (exact)
    i32    payload = the new values' bits

Changed coordinates are found by BIT comparison on the integer view, so
``-0.0 -> 0.0`` and NaN-payload changes are captured. A leaf whose
packed delta would not undercut the dense copy (``2*nnz + 1 >= size``)
or whose dtype has no exact f32 carrier falls back to a dense copy
(``leaf_delta`` returns ``None``). ``apply_delta`` raises ``ValueError``
on a corrupt or truncated vector rather than mis-restoring.

numpy has no bfloat16 of its own and the port does not use
``ml_dtypes``: a bf16 leaf is held as its ``uint16`` bit pattern in an
array of dtype ``BF16`` (``uint16`` tagged ``"bfloat16"`` in the dtype's
metadata). ``dtype_name`` reads the tag, and the checkpoint files record
it as the leaf's ``orig_dtype``, as the reference does for its
``ml_dtypes`` arrays. The tag survives copies, reshapes, indexing and
``np.zeros``, not ``np.stack`` or ``np.concatenate``; arithmetic on such
an array is integer arithmetic on the bits, so bf16 sums go through
torch (``checkpoint.elastic``).
"""
from __future__ import annotations

import numpy as np

__all__ = ["BF16", "dtype_name", "leaf_delta", "apply_delta",
           "delta_nbytes"]

BF16 = np.dtype(np.uint16, metadata={"dtype": "bfloat16"})


def dtype_name(a) -> str:
    """numpy's name of an array's dtype (or of a dtype), ``"bfloat16"``
    for ``BF16``."""
    dt = getattr(a, "dtype", a)
    meta = dt.metadata
    return "bfloat16" if meta and meta.get("dtype") == "bfloat16" \
        else str(dt)


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _carrier(arr: np.ndarray):
    """(int_view, payload_f32, inverse) for dtypes with an exact f32
    carrier; None for dtypes that must go dense."""
    a = np.ascontiguousarray(arr).reshape(-1)
    if dtype_name(a) == "bfloat16":
        return (a.view(np.uint16),
                lambda v: _bf16_to_f32(v.view(np.uint16)),
                lambda p, d: (p.view(np.uint32) >> 16).astype(np.uint16)
                .view(d))
    if a.dtype == np.float32:
        return (a.view(np.uint32), lambda v: v.astype(np.float32),
                lambda p, d: p)
    if a.dtype in (np.dtype(np.int32), np.dtype(np.uint32)):
        return (a.view(np.uint32),
                lambda v: v.view(np.uint32).view(np.float32),
                lambda p, d: p.view(d))            # same-itemsize bit view
    return None


def leaf_delta(old: np.ndarray, new: np.ndarray) -> np.ndarray | None:
    """Packed sparse delta ``old -> new``, or None for the dense fallback.

    ``None`` means "store ``new`` verbatim": dtype has no exact f32
    carrier (f64, i64, ...) or the sparse form would not be smaller.
    """
    old = np.asarray(old)
    new = np.asarray(new)
    if old.shape != new.shape or dtype_name(old) != dtype_name(new):
        raise ValueError(
            f"delta base mismatch: {old.shape}/{dtype_name(old)} vs "
            f"{new.shape}/{dtype_name(new)}")
    c = _carrier(new)
    if c is None:
        return None
    old_bits = _carrier(old)[0]
    new_bits, to_payload, _ = c
    idx = np.nonzero(old_bits != new_bits)[0]
    nnz = int(idx.size)
    if 2 * nnz + 1 >= new.size:
        return None
    payload = to_payload(np.ascontiguousarray(new).reshape(-1)[idx])
    return np.concatenate([
        np.asarray([nnz], np.int32).view(np.float32),
        idx.astype(np.int32).view(np.float32),
        payload.astype(np.float32, copy=False),
    ])


def apply_delta(old: np.ndarray, packed: np.ndarray) -> np.ndarray:
    """Rebuild the new leaf from its base and a packed sparse delta.

    Bit-exact inverse of ``leaf_delta``; raises ``ValueError`` on a
    corrupt or truncated vector (bad length, out-of-range or
    non-monotonic indices).
    """
    old = np.asarray(old)
    packed = np.asarray(packed, np.float32)
    if packed.ndim != 1 or packed.size < 1:
        raise ValueError("corrupt delta: empty or non-flat packed vector")
    nnz = int(packed[:1].view(np.int32)[0])
    if nnz < 0 or packed.size != 1 + 2 * nnz:
        raise ValueError(
            f"corrupt delta: header says {nnz} entries but packed length "
            f"is {packed.size} (expected {1 + 2 * max(nnz, 0)}) — "
            f"truncated write?")
    idx = packed[1:1 + nnz].view(np.int32)
    if nnz and (idx[0] < 0 or idx[-1] >= old.size
                or np.any(np.diff(idx) <= 0)):
        raise ValueError(
            "corrupt delta: indices out of range or non-monotonic")
    c = _carrier(old)
    if c is None:
        raise ValueError(
            f"delta applied to dtype {old.dtype} which has no sparse "
            f"carrier — the chain should hold a dense copy")
    _, _, from_payload = c
    flat = np.ascontiguousarray(old).reshape(-1).copy()
    flat[idx] = from_payload(packed[1 + nnz:], old.dtype).astype(
        old.dtype, copy=False)
    return flat.reshape(old.shape)


def delta_nbytes(packed: np.ndarray | None, dense: np.ndarray) -> int:
    """On-disk bytes this leaf's entry costs (sparse or dense fallback)."""
    return int(dense.nbytes if packed is None else packed.nbytes)
