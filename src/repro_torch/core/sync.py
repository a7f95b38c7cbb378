"""Sparse synchronization wire format (RedSync §5.3/§5.4).

Port of ``src/repro/core/sync.py``. A message is one f32 vector

    [ count (i32 bit-cast) | indices (i32 bit-cast) x cap | values x cap ]

Indices stay int32 end to end and are bit-cast with ``.view``, so packed
bytes equal the reference's. This slice runs one worker: the allgather is
the identity ``msg[None]``; ``torch.distributed`` arrives with the
multi-GPU slice. Quantized payloads (§5.2.3) wait with the quantized
selectors.
"""
from __future__ import annotations

import torch

from .selection import Selected


def _i2f(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).view(torch.float32)


def _f2i(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def message_len(capacity: int, quantized: bool) -> int:
    return 1 + capacity + (1 if quantized else capacity)


def pack_pieces(sel: Selected, quantized: bool) -> list[torch.Tensor]:
    """The wire-format segments of one message, in order."""
    if quantized:
        raise NotImplementedError(
            "quantized messages are not ported yet (see ROADMAP.md)")
    return [_i2f(sel.count.reshape(1)), _i2f(sel.indices), sel.values]


def pack(sel: Selected, quantized: bool) -> torch.Tensor:
    return torch.cat(pack_pieces(sel, quantized))


def unpack_decompress(gathered: torch.Tensor, size: int, capacity: int,
                      quantized: bool) -> torch.Tensor:
    """[num_workers, msg_len] -> dense f32[size] SUM of all messages.

    Dead slots (beyond each worker's ``count``, or padding index ==
    size) are sent to a dump element past the end. Worker rows are
    applied in ascending order; one worker's live indices are distinct,
    so each row is a gather-add-scatter with no atomics and no
    order-dependent float sums — the same adds, in the same order, as
    the reference's scatter-add.
    """
    if quantized:
        raise NotImplementedError(
            "quantized messages are not ported yet (see ROADMAP.md)")
    counts = _f2i(gathered[:, 0])
    idx = _f2i(gathered[:, 1:1 + capacity]).to(torch.int64)
    vals = gathered[:, 1 + capacity:1 + 2 * capacity]
    slot = torch.arange(capacity, device=gathered.device)[None, :]
    live = (slot < counts[:, None]) & (idx >= 0) & (idx < size)
    idx = torch.where(live, idx, size)
    dense = torch.zeros(size + 1, dtype=torch.float32,
                        device=gathered.device)
    for w in range(gathered.shape[0]):
        dense[idx[w]] = dense[idx[w]] + vals[w]
    return dense[:size]


def sparse_allgather(msg: torch.Tensor, axes: tuple[str, ...]
                     ) -> torch.Tensor:
    """All-gather one packed message over the data-parallel workers;
    the single-worker case (no axes) is the identity."""
    if axes:
        raise NotImplementedError(
            "multi-worker collectives are not ported yet (see ROADMAP.md)")
    return msg[None]


def fused_allgather(messages: list[torch.Tensor], axes: tuple[str, ...]
                    ) -> list[torch.Tensor]:
    """Tensor fusion: concat all messages -> ONE allgather -> split."""
    lens = [int(m.shape[0]) for m in messages]
    return split_rows(sparse_allgather(torch.cat(messages), axes), lens)


def split_rows(gathered: torch.Tensor, lens: list[int]
               ) -> list[torch.Tensor]:
    """[p, sum(lens)] fused buffer -> per-leaf [p, len] segments."""
    out, off = [], 0
    for length in lens:
        out.append(gathered[:, off:off + length])
        off += length
    return out


def dense_allreduce_mean(grad: torch.Tensor, axes: tuple[str, ...]
                         ) -> torch.Tensor:
    """Dense fallback: allreduce-mean over workers (identity for one)."""
    if axes:
        raise NotImplementedError(
            "multi-worker collectives are not ported yet (see ROADMAP.md)")
    return grad.to(torch.float32)
