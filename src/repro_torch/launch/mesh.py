"""Data-parallel meshes over ``torch.distributed``.

Port of the meshes of ``src/repro/launch/mesh.py`` that hold no
``"model"`` axis: ``("data",) = (p,)``, or ``("node", "local") = (n, l)``
as in the JAX harness. A ``Mesh`` names the axes over the ranks of the
default process group in first-axis-major order (rank = node * l +
local), the order in which ``jax.lax.all_gather`` stacks rows over a
joint axis tuple, and holds one process group per set of axes.

    dev = init_process_group("file:///tmp/pg", rank, world_size,
                             device="cpu")
    mesh = Mesh((2, 2), ("node", "local"))
    mesh.group(("local",)), mesh.size("node"), mesh.index(("node",))

Nothing here picks an address, a rank or a backend by itself: the caller
passes them (the launcher reads ``torchrun``'s environment).
"""
from __future__ import annotations

import datetime
import itertools
import math

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device


def init_process_group(init_method: str, rank: int, world_size: int,
                       backend: str | None = None,
                       device: str | torch.device | None = None,
                       timeout: datetime.timedelta | None = None
                       ) -> torch.device:
    """Join the default process group; returns the resolved device.

    ``backend`` defaults to ``nccl`` on a CUDA device (one rank per card)
    and ``gloo`` on the CPU. Several ranks sharing one card need
    ``gloo``, which the caller passes. A CUDA ``device`` with an index
    becomes the current device. ``timeout`` bounds the rendezvous and
    every collective of the group, so a rank whose peer hangs or died
    raises instead of waiting; ``None`` keeps torch's default (30 minutes
    for gloo)."""
    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, **kw)
    return dev


class Mesh:
    """Named data-parallel axes over every rank of the default group.

    Builds one process group per non-empty set of axes and per fixing of
    the other axes' coordinates; every rank creates every group, in the
    same order, as ``torch.distributed.new_group`` requires."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...]):
        shape, axis_names = tuple(shape), tuple(axis_names)
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(
                axis_names):
            raise ValueError(f"mesh shape {shape} and axes {axis_names} "
                             f"must match one to one")
        if "model" in axis_names:
            raise NotImplementedError(
                "a 'model' mesh axis is not ported yet (see ROADMAP.md)")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(axis_names, shape))} holds "
                             f"{math.prod(shape)} ranks, the process group "
                             f"{world}")
        self.shape = shape
        self.axis_names = axis_names
        self.rank = dist.get_rank()
        grid = np.arange(world).reshape(shape)
        self.coords = dict(zip(axis_names, (int(c) for c in np.unravel_index(
            self.rank, shape))))
        self._groups = {}
        for r in range(1, len(axis_names) + 1):
            for axes in itertools.combinations(range(len(axis_names)), r):
                rest = [d for d in range(len(shape)) if d not in axes]
                # the other axes leading: each row of `blocks` is one group
                blocks = grid.transpose(rest + list(axes)).reshape(
                    -1, math.prod(shape[d] for d in axes))
                for ranks in blocks.tolist():
                    group = dist.new_group(ranks)
                    if self.rank in ranks:
                        self._groups[tuple(axis_names[d] for d in axes)] = \
                            group

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)]

    def axes_size(self, axes: tuple[str, ...]) -> int:
        return math.prod(self.size(a) for a in axes)

    def mesh_order(self, axes: tuple[str, ...]) -> tuple[str, ...]:
        """``axes`` sorted into the mesh's own axis order (raises on an
        axis the mesh lacks)."""
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"axis {a!r} not in mesh {self.axis_names}")
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes: tuple[str, ...]):
        """The process group of the ranks that share this rank's
        coordinates off ``axes``. Its ranks ascend in mesh-order-major
        position along ``axes``."""
        return self._groups[self.mesh_order(axes)]

    def index(self, axes: tuple[str, ...]) -> int:
        """This rank's position along the joint ``axes``, major in the
        order given (``jax.lax.axis_index`` over an axis tuple)."""
        pos = 0
        for a in axes:
            pos = pos * self.size(a) + self.coords[a]
        return pos

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Mesh({dict(zip(self.axis_names, self.shape))})"
