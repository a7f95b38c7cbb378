"""RGC trainer: one device, or pure data parallelism over a mesh.

Port of ``src/repro/train/trainer.py``: its ``mesh=None`` path and its
pure data-parallel path (``flat_step``). The model comes from
``models.registry.get_model``: the paper's LSTM LM or a transformer of
the dense, moe or vlm family. Each step computes ``model.loss(params, batch)``
on this rank's rows of every batch key and its LOCAL gradients
(``torch.autograd.grad``) and hands them to ``GradientSync.update``
(residual + momentum correction -> selection -> pack -> allgather ->
decompress -> SGD apply).

With ``mesh`` (a ``launch.mesh.Mesh`` without a ``"model"`` axis) every
rank holds the whole parameter tree, made from the same seed, and takes
its contiguous rows of the global batch: its first-axis-major position
over the batch axes picks them, as ``shard_map`` with ``P(batch_axes)``
does. The sync runs over the batch axes, and the reported loss is the
mean over ranks (the reference's ``pmean``). ``tc.schedule`` picks the
§5.6 schedule (``core.overlap``); under ``stale1`` / ``staleK`` the
optimizer state is a ``ScheduleState`` around the LeafState tree.

``ckpt_every=N`` saves a fault-tolerance checkpoint every N steps into
``ckpt_dir`` (a ``checkpoint.CheckpointManager`` full + sparse-delta
chain, in the reference's format). It holds every worker's params,
residual, velocity and pending ring, one row per worker, so
``restore_checkpoint`` resumes bitwise at the same worker count and
redistributes by the remainder rule at another one.

``Trainer(...)`` runs on CUDA unless ``device="cpu"`` is passed, and
raises when no card is present and the CPU was not asked for.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import sync as sync_lib
from repro_torch.core import tree
from repro_torch.core.gradient_sync import GradientSync, build_gradient_sync
from repro_torch.core.schedule import DensitySchedule
from repro_torch.models.registry import Model, get_model


@dataclass
class TrainState:
    params: Any              # nested dict of tensors
    rgc: Any                 # LeafState tree, or a ScheduleState around it
    step: int = 0


def _residual_dtype(tc: TrainConfig):
    return torch.bfloat16 if tc.residual_dtype == "bf16" else torch.float32


def _batch_axes(mesh) -> tuple[str, ...]:
    return () if mesh is None else tuple(mesh.axis_names)


def make_gradient_sync(tc: TrainConfig, device, mesh=None,
                       timer: Any = None) -> GradientSync:
    """The composed sync transform a TrainConfig describes, over the
    batch axes of ``mesh`` (none: one worker). ``tc.optimizer`` is
    ``rgc`` / ``rgc_quant`` / ``dense`` or any registered compressor
    spec, optionally with corrections (``"factor_masking+warmup(rgc)"``);
    a spec-named ``warmup`` ramps over ``tc.warmup_steps_per_stage``.
    ``timer`` threads a ``StageTimer`` through the pipeline (``None``:
    ``NullTimer``)."""
    return build_gradient_sync(
        tc.optimizer,
        transport=tc.transport,
        sync_axes=_batch_axes(mesh),
        mesh=mesh,
        density=tc.density,
        momentum=tc.momentum,
        nesterov=tc.nesterov,
        weight_decay=tc.weight_decay,
        local_clip=tc.local_clip,
        residual_dtype=_residual_dtype(tc),
        warmup_steps_per_stage=tc.warmup_steps_per_stage,
        dense_warmup=tc.dense_warmup,
        bucket_bytes=tc.bucket_bytes,
        intra_axis=tc.intra_axis,
        fuse_leaves=tc.fuse_leaves,
        fuse_accumulate=tc.fuse_accumulate,
        schedule=tc.schedule,
        timer=timer,
        device=device,
    )


def make_train_step(model: Model, sync: GradientSync,
                    tc: TrainConfig, *, density: Optional[float] = None,
                    mesh=None) -> Callable:
    """(params, rgc_state, batch, lr) -> (loss, new_params, new_state);
    ``batch`` holds this rank's rows, the loss is the mean over ranks."""
    axes = _batch_axes(mesh)
    dens = tc.density if density is None else density
    if tc.optimizer == "dense":
        dens = 1.0

    def step(params, rgc_state, batch, lr):
        leaves, treedef = tree.flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss = model.loss(tree.unflatten(treedef, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
        del leaves
        new_params, new_state = sync.update(
            tree.unflatten(treedef, list(grads)), rgc_state, params, lr,
            density=dens)
        loss = sync_lib.dense_allreduce_mean(loss.detach(), axes, mesh)
        return loss, new_params, new_state
    return step


class Trainer:
    """End-to-end training loop for a registry model (``get_model``), on
    one device or data parallel over ``mesh``, with checkpoints into ``ckpt_dir`` every
    ``ckpt_every`` steps (0: only at the end of ``run``; no
    ``ckpt_dir``: none) and a full snapshot every ``ckpt_full_every``-th
    save."""

    def __init__(self, arch_cfg: ModelConfig, tc: TrainConfig,
                 device: str | torch.device | None = None, mesh=None,
                 ckpt_dir: Optional[str] = None, ckpt_every: int = 0,
                 ckpt_full_every: int = 4):
        self.model = get_model(arch_cfg)
        self.device = resolve_device(device)
        self.cfg = arch_cfg
        self.tc = tc
        self.mesh = mesh
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.ckpt_full_every = ckpt_full_every
        self._ckpt_mgr = None
        self.schedule = DensitySchedule(
            target=tc.density,
            warmup_steps_per_stage=tc.warmup_steps_per_stage,
            dense_warmup=tc.dense_warmup)
        self._sync = make_gradient_sync(tc, self.device, mesh)
        self._steps: dict[float, Callable] = {}

    def init_state(self, seed: Optional[int] = None,
                   params: Optional[dict] = None) -> TrainState:
        """Fresh state: the port's own random init from ``seed`` (default
        ``tc.seed``) or, for parity runs, the given ``params`` tree."""
        if params is None:
            params = self.model.init_params(
                self.tc.seed if seed is None else seed, self.device)
        return TrainState(params=params, rgc=self._sync.init(params), step=0)

    def density_at(self, step: int) -> float:
        d = self._sync.scheduled_density(step)
        return self.schedule.density_at(step) if d is None else d

    def _step_fn(self, density: float) -> Callable:
        if self.tc.optimizer == "dense":
            density = 1.0
        if density not in self._steps:
            self._steps[density] = make_train_step(
                self.model, self._sync, self.tc, density=density,
                mesh=self.mesh)
        return self._steps[density]

    def _local_rows(self, rows):
        """This rank's contiguous rows of one key of a global batch (all
        of it without a mesh)."""
        if self.mesh is None:
            return rows
        axes = _batch_axes(self.mesh)
        p = self.mesh.axes_size(axes)
        if rows.shape[0] % p:
            raise ValueError(f"global batch {rows.shape[0]} does not "
                             f"split over {p} workers")
        n = rows.shape[0] // p
        i = self.mesh.index(axes)
        return rows[i * n:(i + 1) * n]

    # -- fault-tolerance checkpointing --------------------------------------

    def _num_workers(self) -> int:
        if self.mesh is None:
            return 1
        return self.mesh.axes_size(_batch_axes(self.mesh))

    def _manager(self):
        from repro_torch.checkpoint import CheckpointManager
        if self.ckpt_dir is None:
            raise ValueError("Trainer has no ckpt_dir")
        if self._ckpt_mgr is None:
            self._ckpt_mgr = CheckpointManager(
                self.ckpt_dir, full_every=self.ckpt_full_every)
        return self._ckpt_mgr

    def save_checkpoint(self, state: TrainState) -> Optional[str]:
        """Persist the full training state (params, residual, velocity,
        thresholds, counters and any pending message ring) with one row
        per worker, so restore is bitwise. On a mesh every rank calls it:
        the rows are gathered to every rank, rank 0 writes, and all ranks
        then meet, so a failed write raises on every rank. Returns the
        written entry's path (``None`` on the other ranks)."""
        from repro_torch.checkpoint import stack_worker_copies
        stacked = stack_worker_copies({"params": state.params,
                                       "rgc": state.rgc}, self.mesh)
        writer = self.mesh is None or self.mesh.rank == 0
        path, err = None, None
        if writer:
            try:
                path = self._manager().save(
                    state.step, stacked,
                    metadata={"num_workers": self._num_workers(),
                              "schedule": self.tc.schedule,
                              "optimizer": self.tc.optimizer})
            except Exception as e:             # raised after the meeting
                err = e
        del stacked
        if self.mesh is not None:
            ok = torch.tensor([int(err is None)], device=self.device)
            dist.all_reduce(ok, op=dist.ReduceOp.MIN)
            if not writer:
                self._ckpt_mgr = None          # re-read rank 0's manifest
            if err is None and not int(ok.item()):
                raise RuntimeError(
                    f"rank 0 failed to write the checkpoint of step "
                    f"{state.step} into {self.ckpt_dir}")
        if err is not None:
            raise err
        return path

    def restore_checkpoint(self, step: Optional[int] = None) -> TrainState:
        """Resume from ``ckpt_dir`` at ``step`` (default latest), and
        build the model as ``init_state`` does.

        Same worker count: every worker's buffers go back to its device,
        a bitwise continuation, pending ring included. Different worker
        count: each old worker's pending ring is reabsorbed into its
        residual (``core.overlap.reabsorb_pending``), then residual and
        velocity redistribute by the remainder SUM rule and the scalar
        state by the copy rule (``checkpoint.elastic``); the pending
        ring restarts zeroed."""
        from repro_torch.checkpoint import (redistribute_leaf_states,
                                            redistribute_tree,
                                            unstack_to_devices)
        from repro_torch.checkpoint.ckpt import (flatten, map_with_keys,
                                                 np_dtype, to_numpy, to_torch)
        from repro_torch.core.overlap import ScheduleState, reabsorb_pending

        mgr = self._manager()
        if step is None:
            step = mgr.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.ckpt_dir}")
        p_ckpt = int(mgr.metadata.get("num_workers", 1))
        p_now = self._num_workers()

        fresh = self.init_state()
        template = map_with_keys(
            lambda _, t: np.zeros((p_ckpt,) + tuple(t.shape), np_dtype(t)),
            {"params": fresh.params, "rgc": fresh.rgc})
        del fresh
        stacked = mgr.restore(template, step=step)
        if p_now == p_ckpt:
            dev = unstack_to_devices(stacked, self.mesh, self.device)
            return TrainState(params=dev["params"], rgc=dev["rgc"],
                              step=step)

        # reabsorb each OLD worker's in-flight ring into its residual
        # (packed for a 1/p_ckpt-weighted apply: not replayable at
        # p_now), then redistribute
        def row(tree_, i):
            return map_with_keys(lambda _, s: to_torch(s[i], self.device),
                                 tree_)
        workers = [map_with_keys(lambda _, t: to_numpy(t), reabsorb_pending(
            self._sync, row(stacked["params"], i), row(stacked["rgc"], i)))
            for i in range(p_ckpt)]
        flats = [dict(flatten(w)) for w in workers]
        stacked_leaf = map_with_keys(
            lambda k, x: np.stack([f[k] for f in flats]).view(x.dtype),
            workers[0])
        new_leaf = redistribute_leaf_states(stacked_leaf, p_now)
        new_params = redistribute_tree(stacked["params"], p_now,
                                       lambda key, leaf: False)
        dev = unstack_to_devices({"params": new_params, "leaf": new_leaf},
                                 self.mesh, self.device)
        init = self._sync.init(dev["params"])
        rgc = (ScheduleState(leaf=dev["leaf"], pending=init.pending)
               if isinstance(init, ScheduleState) else dev["leaf"])
        return TrainState(params=dev["params"], rgc=rgc, step=step)

    def run(self, state: TrainState, batches, num_steps: int,
            log_every: int = 10, log_fn=print,
            on_metrics: Optional[Callable[[int, float, float], None]] = None
            ) -> TrainState:
        """``batches`` yields GLOBAL batches; each rank trains on its
        rows. ``on_metrics(step, density, loss)`` fires every step (and
        waits for the step's loss)."""
        lr = torch.tensor(self.tc.lr, dtype=torch.float32, device=self.device)
        it = iter(batches)
        for _ in range(num_steps):
            batch = {k: torch.as_tensor(self._local_rows(v),
                                        device=self.device)
                     for k, v in next(it).items()}
            density = self.density_at(state.step)
            loss, params, rgc_state = self._step_fn(density)(
                state.params, state.rgc, batch, lr)
            del batch
            state = TrainState(params, rgc_state, state.step + 1)
            if on_metrics is not None:
                on_metrics(state.step, density, float(loss))
            if log_every and state.step % log_every == 0:
                log_fn(f"step {state.step:5d}  density {density:.4%}  "
                       f"loss {float(loss):.4f}")
            if (self.ckpt_dir and self.ckpt_every
                    and state.step % self.ckpt_every == 0):
                self.save_checkpoint(state)
        if self.ckpt_dir and self._manager().latest_step() != state.step:
            self.save_checkpoint(state)
        return state
