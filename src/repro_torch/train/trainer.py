"""RGC trainer: one device, or pure data parallelism over a mesh.

Port of ``src/repro/train/trainer.py``: its ``mesh=None`` path and its
pure data-parallel path (``flat_step``). Each step computes the loss and
LOCAL gradients of the LSTM LM (``torch.autograd.grad``) and hands them
to ``GradientSync.update`` (residual + momentum correction -> selection
-> pack -> allgather -> decompress -> SGD apply).

With ``mesh`` (a ``launch.mesh.Mesh`` without a ``"model"`` axis) every
rank holds the whole parameter tree, made from the same seed, and takes
its contiguous rows of the global batch: its first-axis-major position
over the batch axes picks them, as ``shard_map`` with ``P(batch_axes)``
does. The sync runs over the batch axes, and the reported loss is the
mean over ranks (the reference's ``pmean``). ``tc.schedule`` picks the
§5.6 schedule (``core.overlap``); under ``stale1`` / ``staleK`` the
optimizer state is a ``ScheduleState`` around the LeafState tree.
Checkpoints wait (see ROADMAP.md).

``Trainer(...)`` runs on CUDA unless ``device="cpu"`` is passed, and
raises when no card is present and the CPU was not asked for.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core import sync as sync_lib
from repro_torch.core import tree
from repro_torch.core.gradient_sync import GradientSync, build_gradient_sync
from repro_torch.core.schedule import DensitySchedule
from repro_torch.models import lstm


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


def make_train_step(model: lstm.LSTMLM, sync: GradientSync,
                    tc: TrainConfig, *, density: Optional[float] = None,
                    mesh=None) -> Callable:
    """(params, rgc_state, tokens, lr) -> (loss, new_params, new_state);
    ``tokens`` are this rank's rows, the loss the mean over ranks."""
    axes = _batch_axes(mesh)
    dens = tc.density if density is None else density
    if tc.optimizer == "dense":
        dens = 1.0

    def step(params, rgc_state, tokens, lr):
        model.set_params(params)
        leaves, treedef = tree.flatten(model.params())
        loss = model(tokens)
        grads = torch.autograd.grad(loss, leaves)
        new_params, new_state = sync.update(
            tree.unflatten(treedef, list(grads)), rgc_state, params, lr,
            density=dens)
        loss = sync_lib.dense_allreduce_mean(loss.detach(), axes, mesh)
        return loss, new_params, new_state
    return step


class Trainer:
    """End-to-end training loop for the LSTM LM, on one device or data
    parallel over ``mesh``."""

    def __init__(self, arch_cfg: ModelConfig, tc: TrainConfig,
                 device: str | torch.device | None = None, mesh=None):
        if arch_cfg.family != "lstm":
            raise NotImplementedError(
                f"model family {arch_cfg.family!r} is not ported yet "
                f"(see ROADMAP.md)")
        self.device = resolve_device(device)
        self.cfg = arch_cfg
        self.tc = tc
        self.mesh = mesh
        self.schedule = DensitySchedule(
            target=tc.density,
            warmup_steps_per_stage=tc.warmup_steps_per_stage,
            dense_warmup=tc.dense_warmup)
        self._sync = make_gradient_sync(tc, self.device, mesh)
        self._steps: dict[float, Callable] = {}
        self.model: lstm.LSTMLM | None = None

    def init_state(self, seed: Optional[int] = None,
                   params: Optional[dict] = None) -> TrainState:
        """Fresh state: the port's own random init from ``seed`` (default
        ``tc.seed``) or, for parity runs, the given ``params`` tree."""
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.tc.seed if seed is None else seed)
            params = lstm.init_params(self.cfg, gen, self.device)
        self.model = lstm.LSTMLM(self.cfg, params)
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

    def _local_rows(self, tokens):
        """This rank's contiguous rows of a global batch (all of it
        without a mesh)."""
        if self.mesh is None:
            return tokens
        axes = _batch_axes(self.mesh)
        p = self.mesh.axes_size(axes)
        if tokens.shape[0] % p:
            raise ValueError(f"global batch {tokens.shape[0]} does not "
                             f"split over {p} workers")
        n = tokens.shape[0] // p
        i = self.mesh.index(axes)
        return tokens[i * n:(i + 1) * n]

    def run(self, state: TrainState, batches, num_steps: int,
            log_every: int = 10, log_fn=print,
            on_metrics: Optional[Callable[[int, float, float], None]] = None
            ) -> TrainState:
        """``batches`` yields GLOBAL batches; each rank trains on its
        rows. ``on_metrics(step, density, loss)`` fires every step (and
        waits for the step's loss)."""
        if self.model is None:
            raise RuntimeError("call init_state() before run()")
        lr = torch.tensor(self.tc.lr, dtype=torch.float32, device=self.device)
        it = iter(batches)
        for _ in range(num_steps):
            tokens = torch.as_tensor(self._local_rows(next(it)["tokens"]),
                                     device=self.device)
            density = self.density_at(state.step)
            loss, params, rgc_state = self._step_fn(density)(
                state.params, state.rgc, tokens, lr)
            state = TrainState(params, rgc_state, state.step + 1)
            if on_metrics is not None:
                on_metrics(state.step, density, float(loss))
            if log_every and state.step % log_every == 0:
                log_fn(f"step {state.step:5d}  density {density:.4%}  "
                       f"loss {float(loss):.4f}")
        self.model.set_params(state.params)
        return state
