"""Flat residual arenas: coalesced storage views for the sparse sync path.

Port of ``src/repro/core/arena.py``. Sparse leaves sharing a gradient
dtype and a segmented compressor are laid out in one contiguous f32
arena of ``[nblocks, ARENA_BLOCK]`` rows; every slot starts on a block
boundary and its padding is zero, so each slot's rows are the 2-D view
the per-leaf selectors would build, and selection stays segmented (each
leaf keeps its own ``k``). The layout is pure Python/numpy and identical
to the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property
from typing import Any, Sequence

import numpy as np
import torch

from . import sync as sync_lib
from .selection import STATS_BLOCK, Selected

ARENA_BLOCK = STATS_BLOCK      # element alignment of arena slots


def padded_size(n: int, block: int = ARENA_BLOCK) -> int:
    return max(1, -(-n // block)) * block


@dataclass(frozen=True)
class Slot:
    """One leaf's segment of an arena (static metadata)."""

    leaf: int          # position in the flattened gradient tree
    path: str
    offset: int        # element offset into the arena (ARENA_BLOCK-aligned)
    size: int          # true element count
    padded: int        # size rounded up to ARENA_BLOCK
    row0: int          # first row of the arena's [nblocks, ARENA_BLOCK] view
    k: int             # per-leaf selection target
    capacity: int      # message capacity (compressor.capacity(k))
    msg_offset: int    # element offset into the arena's wire message
    msg_len: int       # sync.message_len(capacity, quantized)

    @property
    def nblocks(self) -> int:
        return self.padded // ARENA_BLOCK

    @property
    def rows(self) -> tuple[int, int]:
        return self.row0, self.row0 + self.nblocks


@dataclass(frozen=True, eq=False)
class SegmentGeometry:
    """Per-block segment maps the segmented kernels consume (numpy).

    ``block_seg[b]`` is the slot ordinal owning arena row ``b``;
    ``block_base[b]`` that row's first slot-local element index;
    ``block_size[b]`` the owning slot's true size. ``device_maps`` holds
    the kernel wrappers' per-device copies of these maps, built once per
    geometry and device instead of on every launch.
    """

    block: int
    n_seg: int
    nblocks: int
    block_seg: np.ndarray    # [nblocks] i32
    block_base: np.ndarray   # [nblocks] i32
    block_size: np.ndarray   # [nblocks] i32
    seg_sizes: tuple[int, ...]
    seg_ks: tuple[int, ...]
    seg_rows: tuple[tuple[int, int], ...]
    device_maps: dict = field(default_factory=dict, repr=False)


def single_slot_geometry(n: int, k: int,
                         block: int = ARENA_BLOCK) -> SegmentGeometry:
    """A one-slot geometry viewing a lone flat leaf as a mini arena, so
    the per-leaf path can run the segmented kernels (the strided ones
    exist only in segmented form); its zero-padded [nb, block] view is
    the leaf's own 2-D layout."""
    nb = max(1, -(-n // block))
    return SegmentGeometry(
        block=block, n_seg=1, nblocks=nb,
        block_seg=np.zeros(nb, np.int32),
        block_base=np.arange(nb, dtype=np.int32) * block,
        block_size=np.full(nb, n, np.int32),
        seg_sizes=(n,), seg_ks=(k,), seg_rows=((0, nb),))


def stack_geometries(geoms: Sequence[SegmentGeometry]) -> SegmentGeometry:
    """Row-concatenate several arenas' geometries into one super-arena
    (segment ordinals and row ranges offset), so one kernel launch covers
    every segment of every arena."""
    if not geoms:
        raise ValueError("stack_geometries needs at least one geometry")
    block = geoms[0].block
    if any(g.block != block for g in geoms):
        raise ValueError("cannot stack geometries with different blocks")
    seg_parts, rows_parts = [], []
    seg_off = row_off = 0
    sizes: tuple[int, ...] = ()
    ks: tuple[int, ...] = ()
    for g in geoms:
        seg_parts.append(np.asarray(g.block_seg, np.int32) + seg_off)
        rows_parts.extend((r0 + row_off, r1 + row_off)
                          for r0, r1 in g.seg_rows)
        sizes += tuple(g.seg_sizes)
        ks += tuple(g.seg_ks)
        seg_off += g.n_seg
        row_off += g.nblocks
    return SegmentGeometry(
        block=block, n_seg=seg_off, nblocks=row_off,
        block_seg=np.concatenate(seg_parts),
        block_base=np.concatenate(
            [np.asarray(g.block_base, np.int32) for g in geoms]),
        block_size=np.concatenate(
            [np.asarray(g.block_size, np.int32) for g in geoms]),
        seg_sizes=sizes, seg_ks=ks, seg_rows=tuple(rows_parts))


@dataclass(frozen=True)
class ArenaGroup:
    """A contiguous f32 arena over same-dtype, same-compressor leaves."""

    aid: int
    compressor: str
    dtype: str
    slots: tuple[Slot, ...]

    @property
    def total(self) -> int:
        last = self.slots[-1]
        return last.offset + last.padded

    @property
    def nblocks(self) -> int:
        return self.total // ARENA_BLOCK

    @property
    def msg_total(self) -> int:
        last = self.slots[-1]
        return last.msg_offset + last.msg_len

    @cached_property
    def geometry(self) -> SegmentGeometry:
        seg = np.empty(self.nblocks, np.int32)
        base = np.empty(self.nblocks, np.int32)
        size = np.empty(self.nblocks, np.int32)
        for s_ord, slot in enumerate(self.slots):
            r0, r1 = slot.rows
            seg[r0:r1] = s_ord
            base[r0:r1] = (np.arange(slot.nblocks, dtype=np.int32)
                           * ARENA_BLOCK)
            size[r0:r1] = slot.size
        return SegmentGeometry(
            block=ARENA_BLOCK, n_seg=len(self.slots), nblocks=self.nblocks,
            block_seg=seg, block_base=base, block_size=size,
            seg_sizes=tuple(s.size for s in self.slots),
            seg_ks=tuple(s.k for s in self.slots),
            seg_rows=tuple(s.rows for s in self.slots))


def build_group(aid: int, compressor: str, dtype: str,
                leaves: Sequence[tuple[int, str, int, int, int, int]]
                ) -> ArenaGroup:
    """Lay out one arena. ``leaves`` holds per-slot
    ``(leaf_index, path, size, k, capacity, msg_len)`` in tree order."""
    slots = []
    off = row = moff = 0
    for leaf, path, size, k, capacity, msg_len in leaves:
        pad = padded_size(size)
        slots.append(Slot(leaf=leaf, path=path, offset=off, size=size,
                          padded=pad, row0=row, k=k, capacity=capacity,
                          msg_offset=moff, msg_len=msg_len))
        off += pad
        row += pad // ARENA_BLOCK
        moff += msg_len
    return ArenaGroup(aid=aid, compressor=compressor, dtype=dtype,
                      slots=tuple(slots))


# -- gather / scatter views -------------------------------------------------

def gather(group: ArenaGroup, arrays: Any) -> torch.Tensor:
    """Leaf arrays (indexed by tree position) -> [nblocks, ARENA_BLOCK]
    f32, each slot flattened, upcast and zero-padded."""
    first = arrays[group.slots[0].leaf]
    out = torch.zeros(group.total, dtype=torch.float32, device=first.device)
    for slot in group.slots:
        out[slot.offset:slot.offset + slot.size] = \
            arrays[slot.leaf].reshape(-1)
    return out.reshape(group.nblocks, ARENA_BLOCK)


def scatter(group: ArenaGroup, arena2d: torch.Tensor
            ) -> dict[int, torch.Tensor]:
    """Arena view -> {leaf_index: flat f32[size]} (padding dropped)."""
    flat = arena2d.reshape(-1)
    return {slot.leaf: flat[slot.offset:slot.offset + slot.size]
            for slot in group.slots}


def communicated_indices(group: ArenaGroup,
                         selected: Sequence[Selected]) -> torch.Tensor:
    """Slot-local selected indices -> one arena-global i32 index vector;
    padding sentinels map past the arena's end."""
    total = group.total
    out = []
    for slot, sel in zip(group.slots, selected):
        out.append(torch.where(sel.indices < slot.size,
                               sel.indices + slot.offset, total))
    return torch.cat(out)


def mask_arena(arena2d: torch.Tensor, global_idx: torch.Tensor
               ) -> torch.Tensor:
    """Clear the communicated coordinates of one arena (Alg 4 l.21-23)."""
    from .residual import zero_at
    return zero_at(arena2d, global_idx)


# -- wire format ------------------------------------------------------------

def pack_group(group: ArenaGroup, selected: Sequence[Selected]
               ) -> torch.Tensor:
    """All slot messages -> ONE packed wire buffer (slot order)."""
    pieces = []
    for sel in selected:
        pieces.extend(sync_lib.pack_pieces(sel, quantized=False))
    return torch.cat(pieces)


def split_message(group: ArenaGroup, gathered: torch.Tensor
                  ) -> list[torch.Tensor]:
    """[workers, msg_total] gathered arena buffer -> per-slot segments."""
    return [gathered[:, s.msg_offset:s.msg_offset + s.msg_len]
            for s in group.slots]
