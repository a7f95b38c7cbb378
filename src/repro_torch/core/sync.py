"""Sparse synchronization wire format (RedSync §5.3/§5.4).

Port of ``src/repro/core/sync.py``. A message is one f32 vector

    [ count (i32 bit-cast) | indices (i32 bit-cast) x cap | payload ]

payload = values x cap, or for a quantized message (§5.2.3) one scalar:
the mean ``sum(values) / max(count, 1)``. Indices stay int32 end to end
and are bit-cast with ``.view``, so packed bytes equal the reference's,
but for that mean: the reference sums in an order XLA picks, this port
with ``torch.sum``, so the two may differ in the last few bits (ROADMAP.md
§3 states the tolerance).

Collectives run over ``torch.distributed`` on the process groups of a
``launch.mesh.Mesh``: the workers are the ranks that differ along the
sync ``axes``, and gathered rows come out major in the order ``axes``
names them, as ``jax.lax.all_gather`` stacks them. No axes is the
single-worker identity. A gathered message is moved, never added: the
count and index words are int32 bit patterns whose f32 views are mostly
denormals, and any float arithmetic on them (a flush-to-zero sum) would
destroy them.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .selection import Selected


def _i2f(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32).view(torch.float32)


def _f2i(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def message_len(capacity: int, quantized: bool) -> int:
    return 1 + capacity + (1 if quantized else capacity)


def pack_pieces(sel: Selected, quantized: bool) -> list[torch.Tensor]:
    """The wire-format segments of one message, in order."""
    pieces = [_i2f(sel.count.reshape(1)), _i2f(sel.indices)]
    if quantized:
        denom = torch.clamp(sel.count, min=1).to(torch.float32)
        return pieces + [(sel.values.sum() / denom).reshape(1)]
    return pieces + [sel.values]


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
    the reference's scatter-add. A quantized row adds its one mean at
    each of its live indices.
    """
    counts = _f2i(gathered[:, 0])
    idx = _f2i(gathered[:, 1:1 + capacity]).to(torch.int64)
    if quantized:
        vals = gathered[:, 1 + capacity:2 + capacity].expand(-1, capacity)
    else:
        vals = gathered[:, 1 + capacity:1 + 2 * capacity]
    slot = torch.arange(capacity, device=gathered.device)[None, :]
    live = (slot < counts[:, None]) & (idx >= 0) & (idx < size)
    idx = torch.where(live, idx, size)
    dense = torch.zeros(size + 1, dtype=torch.float32,
                        device=gathered.device)
    for w in range(gathered.shape[0]):
        dense[idx[w]] = dense[idx[w]] + vals[w]
    return dense[:size]


def _group(mesh, axes: tuple[str, ...]):
    if mesh is None:
        raise ValueError(f"sync axes {axes} need a mesh "
                         f"(repro_torch.launch.mesh.Mesh)")
    return mesh.group(axes)


def sparse_allgather(msg: torch.Tensor, axes: tuple[str, ...],
                     mesh=None) -> torch.Tensor:
    """All-gather one packed message over the workers of ``axes``:
    ``[prod(axis sizes), len]`` rows, major in the order of ``axes``.
    Empty ``axes`` (one worker) is the identity."""
    if not axes:
        return msg[None]
    group = _group(mesh, axes)
    msg = msg.contiguous()
    rows = [torch.empty_like(msg) for _ in range(mesh.axes_size(axes))]
    dist.all_gather(rows, msg, group=group)
    out = torch.stack(rows)
    # the group's rows ascend in mesh order; reorder to the order of axes
    order = mesh.mesh_order(axes)
    if order != tuple(axes):
        out = out.reshape(*(mesh.size(a) for a in order), -1).permute(
            *(order.index(a) for a in axes), len(order))
    return out.reshape(-1, msg.shape[0])


def fused_allgather(messages: list[torch.Tensor], axes: tuple[str, ...],
                    mesh=None) -> list[torch.Tensor]:
    """Tensor fusion: concat all messages -> ONE allgather -> split."""
    lens = [int(m.shape[0]) for m in messages]
    return split_rows(sparse_allgather(torch.cat(messages), axes, mesh),
                      lens)


def split_rows(gathered: torch.Tensor, lens: list[int]
               ) -> list[torch.Tensor]:
    """[p, sum(lens)] fused buffer -> per-leaf [p, len] segments."""
    out, off = [], 0
    for length in lens:
        out.append(gathered[:, off:off + length])
        off += length
    return out


def hierarchical_allgather(msg: torch.Tensor, inter_axes: tuple[str, ...],
                           intra_axis: str | None,
                           sync_axes: tuple[str, ...] | None = None,
                           mesh=None) -> torch.Tensor:
    """§5.4 two-level exchange: inter-node sparse allgather + intra-node
    sum all-reduce.

    Hop 1 gathers the packed messages over the inter-node axes only (each
    worker receives its same-local-rank peer's message from every node).
    Hop 2 reassembles the full message matrix over the intra axis: each
    worker writes its rows at its own local slot of a zero int32 buffer
    ``[n_inter, n_local, len]`` and the group sums it. Every entry has
    one writer, so the integer sum is an exact bit move (an f32 sum would
    flush the denormal count and index words). Rows come out inter-major;
    when ``sync_axes`` puts the intra axis elsewhere than last, the block
    is moved back into that order, so the result equals a flat
    ``sparse_allgather`` over ``sync_axes`` byte for byte.
    """
    if intra_axis is None:
        return sparse_allgather(msg, inter_axes, mesh)
    if not inter_axes:
        return sparse_allgather(msg, (intra_axis,), mesh)
    g_inter = sparse_allgather(msg, inter_axes, mesh)   # [n_inter, len]
    n_local = mesh.size(intra_axis)
    full = torch.zeros((g_inter.shape[0], n_local, g_inter.shape[1]),
                       dtype=torch.int32, device=msg.device)
    full[:, mesh.index((intra_axis,))] = _f2i(g_inter)
    dist.all_reduce(full, group=_group(mesh, (intra_axis,)))
    out = full.view(torch.float32)                     # [n_inter, n_local, L]
    if sync_axes and tuple(sync_axes) != tuple(inter_axes) + (intra_axis,):
        sizes = [mesh.size(a) for a in inter_axes]
        out = out.reshape(*sizes, n_local, out.shape[-1])
        out = torch.movedim(out, len(sizes), sync_axes.index(intra_axis))
    return out.reshape(-1, msg.shape[0])


def dense_allreduce_mean(grad: torch.Tensor, axes: tuple[str, ...],
                         mesh=None) -> torch.Tensor:
    """Dense fallback: all-reduce sum over the workers of ``axes``, then
    divided by their number (the reference's ``pmean``); the identity
    for one worker."""
    g = grad.to(torch.float32)
    if not axes:
        return g
    g = g.clone()
    dist.all_reduce(g, group=_group(mesh, axes))
    return g / mesh.axes_size(axes)
