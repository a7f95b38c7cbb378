"""Transport backends: wire packing + collectives over ``sync_axes``.

Port of ``src/repro/core/transport.py``. Five registered backends
(§5.3/§5.4), all on the packed wire format of ``core.sync``:

* ``fused_allgather``    — every message concatenated into ONE buffer,
                           one allgather, then split (§5.3 fusion).
* ``bucketed_allgather`` — fusion under a byte budget: messages packed
                           greedily into contiguous buckets of at most
                           ``bucket_bytes``, one fused allgather each; the
                           gathered rows equal ``fused_allgather``'s.
* ``hierarchical``       — §5.4 two-level exchange on a two-axis mesh: a
                           sparse allgather over the inter-node axes and
                           an exact int32 sum over the intra-node axis;
                           small dense leaves take the joint all-reduce.
* ``per_leaf_allgather`` — one collective per message (the unfused
                           baseline).
* ``dense_psum``         — dense-only baseline; a sparse message is a
                           configuration error.

The workers are the ranks of a ``launch.mesh.Mesh`` that differ along
``sync_axes``; with no axes every collective is the single-worker
identity and no mesh is needed. Each backend counts ``messages`` and
``collectives`` (and ``buckets``) per step on its ``StageTimer``.
"""
from __future__ import annotations

from typing import Any

import torch

from . import registry
from . import sync as sync_lib
from .instrument import NullTimer
from .selection import Selected

# Default fused-bucket byte budget (the reference's).
DEFAULT_BUCKET_BYTES = 4 * 1024 * 1024


def assign_buckets(nbytes: list[int], bucket_bytes: int) -> list[list[int]]:
    """Greedy contiguous bucketing of message byte sizes.

    Message ``i`` joins the current bucket unless that would push the
    bucket past ``bucket_bytes``; a message larger than the budget on its
    own gets a singleton bucket. Nothing is dropped or split, and leaf
    order is kept."""
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be > 0, got {bucket_bytes}")
    buckets: list[list[int]] = []
    cur: list[int] = []
    cur_bytes = 0
    for i, nb in enumerate(nbytes):
        if cur and cur_bytes + nb > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        buckets.append(cur)
    return buckets


class _Base:
    name = "?"

    def __init__(self, sync_axes: tuple[str, ...] = (), timer=None,
                 mesh=None):
        self.sync_axes = tuple(sync_axes)
        self.timer = timer if timer is not None else NullTimer()
        self.mesh = mesh

    def num_workers(self) -> int:
        if not self.sync_axes:
            return 1
        if self.mesh is None:
            raise ValueError(f"sync axes {self.sync_axes} need a mesh "
                             f"(repro_torch.launch.mesh.Mesh)")
        return self.mesh.axes_size(self.sync_axes)

    def pack(self, sel: Selected, quantized: bool) -> torch.Tensor:
        return sync_lib.pack(sel, quantized)

    def allreduce_mean(self, grad: torch.Tensor) -> torch.Tensor:
        return sync_lib.dense_allreduce_mean(grad, self.sync_axes, self.mesh)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<transport {self.name} axes={self.sync_axes}>"


class FusedAllgather(_Base):
    name = "fused_allgather"

    def allgather(self, messages: list[torch.Tensor]
                  ) -> list[torch.Tensor]:
        if not messages:
            return []
        self.timer.count("messages", len(messages))
        self.timer.count("collectives")
        return sync_lib.fused_allgather(messages, self.sync_axes, self.mesh)


class BucketedAllgather(_Base):
    """§5.3 fusion under a byte budget: one fused allgather per bucket."""

    name = "bucketed_allgather"

    def __init__(self, sync_axes: tuple[str, ...] = (),
                 bucket_bytes: int = DEFAULT_BUCKET_BYTES, timer=None,
                 mesh=None):
        super().__init__(sync_axes, timer, mesh)
        self.bucket_bytes = int(bucket_bytes)

    def allgather(self, messages: list[torch.Tensor]
                  ) -> list[torch.Tensor]:
        if not messages:
            return []
        nbytes = [m.numel() * m.element_size() for m in messages]
        buckets = assign_buckets(nbytes, self.bucket_bytes)
        self.timer.count("messages", len(messages))
        self.timer.count("buckets", len(buckets))
        self.timer.count("collectives", len(buckets))
        out: list[torch.Tensor | None] = [None] * len(messages)
        for idxs in buckets:
            gathered = sync_lib.fused_allgather(
                [messages[i] for i in idxs], self.sync_axes, self.mesh)
            for i, g in zip(idxs, gathered):
                out[i] = g
        return out


class HierarchicalAllgather(_Base):
    """§5.4 intra-node exact sum + inter-node sparse allgather.

    ``intra_axis`` names the fast mesh axis; every other sync axis forms
    the slow inter-node hop. It defaults to the LAST sync axis ("local"
    on the ``("node", "local")`` mesh). With fewer than two sync axes
    there is no hierarchy and the transport is the flat fused gather."""

    name = "hierarchical"

    def __init__(self, sync_axes: tuple[str, ...] = (),
                 intra_axis: str | None = None, timer=None, mesh=None):
        super().__init__(sync_axes, timer, mesh)
        if intra_axis is not None and intra_axis not in self.sync_axes:
            raise ValueError(
                f"intra_axis {intra_axis!r} not among sync_axes "
                f"{self.sync_axes}")
        if intra_axis is None and len(self.sync_axes) >= 2:
            intra_axis = self.sync_axes[-1]
        self.intra_axis = intra_axis if len(self.sync_axes) >= 2 else None
        self.inter_axes = tuple(a for a in self.sync_axes
                                if a != self.intra_axis)

    def allgather(self, messages: list[torch.Tensor]
                  ) -> list[torch.Tensor]:
        if not messages:
            return []
        lens = [int(m.shape[0]) for m in messages]
        buf = torch.cat(messages)
        self.timer.count("messages", len(messages))
        self.timer.count("collectives", 2 if self.intra_axis else 1)
        gathered = sync_lib.hierarchical_allgather(
            buf, self.inter_axes, self.intra_axis, self.sync_axes, self.mesh)
        return sync_lib.split_rows(gathered, lens)


class PerLeafAllgather(_Base):
    name = "per_leaf_allgather"

    def allgather(self, messages: list[torch.Tensor]
                  ) -> list[torch.Tensor]:
        self.timer.count("messages", len(messages))
        self.timer.count("collectives", len(messages))
        return [sync_lib.sparse_allgather(m, self.sync_axes, self.mesh)
                for m in messages]


class DensePsum(_Base):
    name = "dense_psum"

    def allgather(self, messages: list[torch.Tensor]
                  ) -> list[torch.Tensor]:
        if messages:
            raise NotImplementedError(
                "dense_psum transport cannot carry sparse messages; use "
                "fused_allgather/per_leaf_allgather or a dense-only "
                "dispatch policy")
        return []


@registry.register(registry.TRANSPORT, "fused_allgather")
def _fused(sync_axes: tuple[str, ...] = (), timer=None, mesh=None,
           **_: Any) -> FusedAllgather:
    return FusedAllgather(sync_axes, timer=timer, mesh=mesh)


@registry.register(registry.TRANSPORT, "bucketed_allgather")
def _bucketed(sync_axes: tuple[str, ...] = (),
              bucket_bytes: int = DEFAULT_BUCKET_BYTES, timer=None,
              mesh=None, **_: Any) -> BucketedAllgather:
    return BucketedAllgather(sync_axes, bucket_bytes=bucket_bytes,
                             timer=timer, mesh=mesh)


@registry.register(registry.TRANSPORT, "hierarchical")
def _hierarchical(sync_axes: tuple[str, ...] = (),
                  intra_axis: str | None = None, timer=None, mesh=None,
                  **_: Any) -> HierarchicalAllgather:
    return HierarchicalAllgather(sync_axes, intra_axis=intra_axis,
                                 timer=timer, mesh=mesh)


@registry.register(registry.TRANSPORT, "per_leaf_allgather")
def _per_leaf(sync_axes: tuple[str, ...] = (), timer=None, mesh=None,
              **_: Any) -> PerLeafAllgather:
    return PerLeafAllgather(sync_axes, timer=timer, mesh=mesh)


@registry.register(registry.TRANSPORT, "dense_psum")
def _dense_psum(sync_axes: tuple[str, ...] = (), timer=None, mesh=None,
                **_: Any) -> DensePsum:
    return DensePsum(sync_axes, timer=timer, mesh=mesh)
