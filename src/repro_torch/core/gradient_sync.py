"""``GradientSync``: the composed RedSync pipeline (Algorithms 4 + 5).

Port of ``src/repro/core/gradient_sync.py``:

    sync = build_gradient_sync(optimizer="rgc", device="cuda")
    state = sync.init(params)
    new_params, new_state = sync.update(grads, state, params, lr)

Trees are nested dicts of tensors (``core.tree`` flattens them in the
reference's sorted-key order). ``update`` runs residual/momentum
accumulation -> selection -> packing + allgather -> scatter-add
decompression -> SGD apply, with the per-leaf method choice owned by a
dispatch policy; ``density >= 1.0`` is the §5.7 dense sentinel.

With ``fuse_leaves`` (default) the sparse leaves coalesce into flat
residual arenas (``core.arena``) and ALL arenas of a step select
together in one ``kernels.segmented.multi_select``: one count launch
per search iteration for every segment. On a CUDA device that call runs
the hand-written kernels; on the CPU it runs their plain twins.

With ``fuse_accumulate`` each arena's residual update runs as ONE pass
(``kernels.segmented.seg_residual_update_stats``) that also yields the
arena's selection statistics, instead of per leaf followed by a gather
and a separate statistics pass. In eager PyTorch both compute the same
separately rounded products, so the two are bitwise equal.

``optimizer`` is ``"rgc"`` (§5.5 size-based dispatch), ``"rgc_quant"``
(the same, each non-dense compressor wrapped in §5.2.3 quantization but
on the ``no_quant_paths`` leaves), ``"dense"`` or any registered
compressor spec, optionally prefixed by ``+``-joined corrections. Spec
corrections are additive: the ``momentum`` / ``local_clip`` fields stay
the switches for their corrections whether or not the spec names them.

``update`` is functional: it reads its inputs and returns new tensors.
Ported here: the four §5.6 schedules (``core.overlap``: ``sequential``,
``chunked`` under ``chunk_bytes``, ``stale1``, ``staleK``), all five
transports (over the process groups of a ``launch.mesh.Mesh`` when
``sync_axes`` name workers), the four corrections, every compressor,
``fuse_accumulate`` and bf16 residuals.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, NamedTuple

import torch

from repro_torch import resolve_device

from . import arena
from . import registry
from . import tree
from .compressors import _Base as _CompressorBase  # noqa: F401 (registration)
from .correction import LocalClip, MomentumCorrection, split_corrections
from .dispatch import FixedPolicy, leaf_nbytes
from .instrument import NullTimer
from .overlap import SequentialSchedule, make_schedule, partition_chunks
from .residual import LeafState, accumulate, mask_communicated
from .sync import message_len
from .transport import DEFAULT_BUCKET_BYTES
from .transport import FusedAllgather  # noqa: F401 (registration)


class _StepPlan(NamedTuple):
    """Static per-step dispatch plan, cached per (treedef, leaf
    signature, density, all_dense)."""

    paths: tuple[str, ...]
    dense: tuple[int, ...]                              # dense-path leaves
    sparse: tuple[tuple[int, Any, int], ...]            # per-leaf (i, comp, k)
    groups: tuple[arena.ArenaGroup, ...]                # fused arenas
    group_comps: tuple[Any, ...]                        # compressor per group


def _by_leaf(group: arena.ArenaGroup, states: list,
             fld: str) -> dict[int, Any]:
    return {slot.leaf: getattr(st, fld)
            for slot, st in zip(group.slots, states)}


@dataclass
class GradientSync:
    """Composed residual-gradient-compression transform."""

    policy: Any
    transport: Any
    density: float = 0.001
    momentum: float = 0.9
    nesterov: bool = False
    weight_decay: float = 0.0
    local_clip: float | None = None
    quantize: bool = False
    no_quant_paths: tuple[str, ...] = ("lm_head", "embed")
    residual_dtype: Any = torch.float32
    fuse_leaves: bool = True
    # one fused residual-update+stats pass per arena instead of per leaf
    fuse_accumulate: bool = False
    corrections: tuple | None = None
    compressor_params: dict = field(default_factory=dict)
    schedule: Any = None
    # byte budget of one "chunked" chunk (raw gradient bytes; shares the
    # bucket_bytes knob and default with the bucketed transport)
    chunk_bytes: int = DEFAULT_BUCKET_BYTES
    timer: Any = None
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    _compressors: dict = field(default_factory=dict, repr=False)
    _plans: dict = field(default_factory=dict, repr=False)

    def __post_init__(self) -> None:
        if self.timer is None:
            self.timer = NullTimer()
        if self.schedule is None:
            self.schedule = SequentialSchedule()
        corr = list(self.corrections or ())
        names = {c.name for c in corr}
        if self.local_clip is not None and "local_clip" not in names:
            corr.insert(0, LocalClip(self.local_clip))
        if self.momentum and "momentum" not in names:
            corr.append(MomentumCorrection(self.momentum, self.nesterov))
        self.corrections = tuple(corr)
        self._arena_ok = all(
            getattr(c, "arena_safe", lambda: False)()
            for c in self.corrections)

    # -- construction helpers ----------------------------------------------

    def compressor(self, name: str):
        if name not in self._compressors:
            self._compressors[name] = registry.make(
                registry.COMPRESSOR, name, **self.compressor_params)
        return self._compressors[name]

    def _leaf_compressor(self, name: str, path: str):
        """The §5.2.3 quantization wrap where configured; the output and
        embedding layers (``no_quant_paths``) are never quantized."""
        if (self.quantize and name != "dense"
                and not name.startswith("quantized")
                and not any(t in path for t in self.no_quant_paths)):
            return self.compressor(f"quantized({name})")
        return self.compressor(name)

    @property
    def uses_momentum_buffer(self) -> bool:
        return bool(self.momentum) or any(
            getattr(c, "needs_momentum_buffer", False)
            for c in self.corrections)

    def scheduled_density(self, step: int) -> float | None:
        for c in self.corrections:
            d = c.density_at(step, self.density)
            if d is not None:
                return d
        return None

    def _check_device(self, leaves: list) -> None:
        for x in leaves:
            if x.device.type != self.device.type:
                raise ValueError(
                    f"GradientSync on {self.device} got a tensor on "
                    f"{x.device}")

    def _accumulate(self, grad, param, state: LeafState) -> LeafState:
        """Residual accumulation: first owning correction wins, else V += g."""
        for c in self.corrections:
            st = c.accumulate(grad, param, state,
                              weight_decay=self.weight_decay)
            if st is not None:
                return st
        return accumulate(grad, param, state, momentum=0.0, nesterov=False,
                          weight_decay=self.weight_decay)

    # -- the transform ------------------------------------------------------

    def init(self, params: Any) -> Any:
        """Params-congruent tree of ``LeafState``."""
        flat = tree.flatten_with_paths(params)
        self._check_device([p for _, p in flat])
        out = []
        for path, p in flat:
            comp = self._leaf_compressor(self.policy.compressor_for(path, p),
                                         path)
            out.append(comp.init_leaf(p, momentum=self.uses_momentum_buffer,
                                      residual_dtype=self.residual_dtype))
        leaf_state = tree.unflatten(tree.structure(params), out)
        return self.schedule.init_state(self, params, leaf_state)

    def _plan(self, treedef, paths, leaves_g: list, density: float,
              all_dense: bool) -> _StepPlan:
        """Resolve (and cache) the static dispatch plan for this step."""
        sig = tuple((tuple(g.shape), str(g.dtype)) for g in leaves_g)
        key = (treedef, sig, density, all_dense)
        if key not in self._plans:
            self._plans[key] = self._plan_leaves(
                range(len(leaves_g)), paths, leaves_g, density, all_dense)
        return self._plans[key]

    def _plan_leaves(self, indices, paths, leaves_g, density: float,
                     all_dense: bool, aid_base: int = 0) -> _StepPlan:
        """The plan of the leaves in ``indices``, in that order: the whole
        tree, or one chunk's leaves, whose arenas then hold only them."""
        dense: list[int] = []
        sparse: list[tuple[int, Any, int]] = []
        fusable: dict[tuple[str, str], list] = {}
        for i in indices:
            g = leaves_g[i]
            name = ("dense" if all_dense
                    else self.policy.compressor_for(paths[i], g))
            if name == "dense":
                dense.append(i)
                continue
            k = max(1, int(math.ceil(density * g.numel())))
            comp = self._leaf_compressor(name, paths[i])
            if (self.fuse_leaves and self._arena_ok
                    and getattr(comp, "supports_segmented", False)
                    and not comp.quantized):
                cap = comp.capacity(k)
                fusable.setdefault((comp.name, str(g.dtype)), []).append(
                    (i, paths[i], int(g.numel()), k, cap,
                     message_len(cap, False)))
            else:
                sparse.append((i, comp, k))

        groups, group_comps = [], []
        for aid, ((name, dtype), slots) in enumerate(fusable.items()):
            groups.append(arena.build_group(aid_base + aid, name, dtype,
                                            slots))
            group_comps.append(self.compressor(name))
        return _StepPlan(paths=tuple(paths[i] for i in indices),
                         dense=tuple(dense), sparse=tuple(sparse),
                         groups=tuple(groups),
                         group_comps=tuple(group_comps))

    def _chunk_plans(self, treedef, paths, leaves_g: list, density: float,
                     all_dense: bool) -> tuple[_StepPlan, ...]:
        """The ``chunked`` schedule's per-chunk plans (cached): the leaves
        split by ``overlap.partition_chunks`` under ``chunk_bytes`` (raw
        gradient bytes), each chunk planned alone with arena ids
        ``1000 * cid + i``."""
        sig = tuple((tuple(g.shape), str(g.dtype)) for g in leaves_g)
        key = (treedef, sig, density, all_dense, "chunked",
               self.chunk_bytes)
        if key not in self._plans:
            chunks = partition_chunks([leaf_nbytes(g) for g in leaves_g],
                                      self.chunk_bytes)
            self._plans[key] = tuple(
                self._plan_leaves(c.leaves, paths, leaves_g, density,
                                  all_dense, aid_base=1000 * c.cid)
                for c in chunks)
        return self._plans[key]

    def _target_plan(self, params: Any) -> tuple[_StepPlan, list]:
        """The target-density plan over ``params``' leaves (the unit
        layout of the buffered schedules' pending messages), and the
        leaves."""
        flat = tree.flatten_with_paths(params)
        leaves = [x for _, x in flat]
        return self._plan(tree.structure(params), tuple(p for p, _ in flat),
                          leaves, self.density, self.density >= 1.0), leaves

    def _pending_zeros(self, params: Any) -> tuple[torch.Tensor, ...]:
        """Zero-count f32 wire messages on the sync's device in the
        target-density plan's unit order (arena groups, then per-leaf
        units): the buffered schedules' initial pending buffer. An
        all-zero message decodes as count 0, so applying it is a no-op."""
        plan, _ = self._target_plan(params)
        sizes = [g.msg_total for g in plan.groups]
        sizes += [message_len(comp.capacity(k), comp.quantized)
                  for _, comp, k in plan.sparse]
        return tuple(torch.zeros(n, dtype=torch.float32, device=self.device)
                     for n in sizes)

    def _arena_coeffs(self) -> tuple[float, bool]:
        for c in self.corrections:
            coeffs = getattr(c, "arena_coeffs", lambda: None)()
            if coeffs is not None:
                return coeffs
        return 0.0, False

    def _need_u(self) -> tuple[bool, bool]:
        m, _ = self._arena_coeffs()
        mask_u = any(getattr(c, "arena_mask_momentum", False)
                     for c in self.corrections)
        return mask_u, self.uses_momentum_buffer and bool(m or mask_u)

    def _accumulate_group(self, group: arena.ArenaGroup, comp,
                          leaves_g: list, leaves_p: list, leaves_s: list
                          ) -> tuple:
        """Residual update, then the arena's 2-D view. Returns
        ``(v2d, u2d, stats, states)``. Per leaf (the correction hook
        chain) then a gather; or, with ``fuse_accumulate``, a gather of
        g, V, U (and p) and one fused update+statistics pass whose
        ``(mean, max)`` — over ``comp``'s per-slot sampling strides —
        feed ``multi_select``."""
        from repro_torch.kernels import segmented as kseg
        _, need_u = self._need_u()
        m, nesterov = self._arena_coeffs()
        geom = group.geometry

        def _fused():
            g2d = arena.gather(group, leaves_g)
            v2d = arena.gather(group, [s.residual for s in leaves_s])
            u2d = (arena.gather(group, [s.momentum for s in leaves_s])
                   if need_u else None)
            p2d = arena.gather(group, leaves_p) if self.weight_decay else None
            strides = comp.segment_strides(geom)
            v2, u2, sums, maxs = kseg.seg_residual_update_stats(
                g2d, v2d, u2d if m else None, p2d, geom, momentum=m,
                nesterov=nesterov, weight_decay=self.weight_decay,
                round_dtype=(None if self.residual_dtype == torch.float32
                             else self.residual_dtype),
                stride_seg=strides)
            stats = (kseg.seg_mean(sums, geom, strides), maxs)
            states = [leaves_s[slot.leaf] for slot in group.slots]
            return v2, (u2 if u2 is not None else u2d), stats, states

        def _per_leaf():
            states = []
            for slot in group.slots:
                self.timer.count("dispatch_accumulate")
                states.append(self._accumulate(
                    leaves_g[slot.leaf], leaves_p[slot.leaf],
                    leaves_s[slot.leaf]))
            v2d = arena.gather(group, _by_leaf(group, states, "residual"))
            u2d = (arena.gather(group, _by_leaf(group, states, "momentum"))
                   if need_u else None)
            return v2d, u2d, None, states

        if self.fuse_accumulate:
            self.timer.count("dispatch_accumulate")
            return self.timer.stage("accumulate", _fused)
        return self.timer.stage("accumulate", _per_leaf)

    def _select_groups(self, groups, comps, accs) -> list[tuple]:
        """Alg 2/3 across EVERY arena of the step in one ``multi_select``.
        Returns one ``(selected, slot_states)`` pair per group."""
        from repro_torch.kernels import segmented as kseg
        specs = [comp.segment_spec(group.geometry, acc[3])
                 for group, comp, acc in zip(groups, comps, accs)]
        parts = [(acc[0], group.geometry, spec, acc[2])
                 for group, spec, acc in zip(groups, specs, accs)]
        out = kseg.multi_select(parts)
        return [(sel, comp.finish_segments(acc[3], thr))
                for comp, acc, (sel, thr) in zip(comps, accs, out)]

    def _finish_group(self, group: arena.ArenaGroup, selected: list,
                      slot_states: list, v2d, u2d, leaves_p: list,
                      new_states: list) -> torch.Tensor:
        """mask -> scatter state back -> pack; returns the arena message."""
        timer = self.timer
        mask_u, need_u = self._need_u()

        def _mask():
            gidx = arena.communicated_indices(group, selected)
            v = arena.mask_arena(v2d, gidx)
            u = (arena.mask_arena(u2d, gidx)
                 if (mask_u and need_u) else u2d)
            return v, u

        timer.count("dispatch_mask")
        v2d_m, u2d_m = timer.stage("mask", _mask)

        v_views = arena.scatter(group, v2d_m)
        u_views = arena.scatter(group, u2d_m) if need_u else {}
        for slot, st in zip(group.slots, slot_states):
            shape = leaves_p[slot.leaf].shape
            st = st._replace(residual=v_views[slot.leaf].reshape(shape)
                             .to(self.residual_dtype))
            if need_u:
                st = st._replace(momentum=u_views[slot.leaf].reshape(shape))
            new_states[slot.leaf] = st

        timer.count("dispatch_pack")
        return timer.stage("pack",
                           lambda: arena.pack_group(group, selected))

    def _count_overflow(self, selections) -> None:
        """Count ``threshold_filter`` capacity overflows (first
        ``capacity`` survivors kept, count saturated) as
        ``select_overflow``. Only under an active timer: reading a flag
        is a host sync, and a ``NullTimer`` step must stay free of them."""
        if not self.timer.active:
            return
        for sel in selections:
            if sel.overflow is not None:
                self.timer.count("select_overflow", int(bool(sel.overflow)))

    def update(self, grads: Any, state: Any, params: Any, lr, *,
               density: float | None = None) -> tuple[Any, Any]:
        """One synchronized step. Returns (new_params, new_state)."""
        density = self.density if density is None else density
        return self.schedule.step(self, grads, state, params, lr, density)

    # -- schedule stage helpers ---------------------------------------------

    def _context(self, grads: Any, leaf_state: Any, params: Any):
        flat = tree.flatten_with_paths(grads)
        paths = tuple(p for p, _ in flat)
        leaves_raw = [g for _, g in flat]
        treedef = tree.structure(grads)
        leaves_p = tree.flatten(params)[0]
        leaves_s = tree.flatten(leaf_state)[0]
        self._check_device(leaves_raw + leaves_p)
        n_workers = self.transport.num_workers()
        leaves_g = list(leaves_raw)
        for c in self.corrections:
            leaves_g = c.on_grads(leaves_g, leaves_p, n_workers)
        return (treedef, paths, leaves_raw, leaves_g, leaves_p, leaves_s,
                n_workers)

    def _compress_plan(self, plan: _StepPlan, leaves_g: list,
                       leaves_p: list, leaves_s: list, new_states: list
                       ) -> tuple[list, list]:
        """Residual update + selection + packing for every sparse unit
        (arena groups first, then per-leaf fallbacks); fills
        ``new_states`` in place. Returns ``(messages, msg_meta)``."""
        timer = self.timer
        messages: list[torch.Tensor] = []
        msg_meta: list[tuple] = []

        if plan.groups:
            accs = [self._accumulate_group(group, comp, leaves_g, leaves_p,
                                           leaves_s)
                    for group, comp in zip(plan.groups, plan.group_comps)]
            timer.count("dispatch_select")
            results = timer.stage(
                "select", lambda: self._select_groups(
                    plan.groups, plan.group_comps, accs))
            self._count_overflow(s for sel, _ in results for s in sel)
            for group, comp, (sel, slot_states), acc in zip(
                    plan.groups, plan.group_comps, results, accs):
                messages.append(self._finish_group(
                    group, sel, slot_states, acc[0], acc[1], leaves_p,
                    new_states))
                msg_meta.append(("arena", group, comp))

        for i, comp, k in plan.sparse:
            timer.count("dispatch_accumulate")
            st = timer.stage("accumulate", lambda i=i: self._accumulate(
                leaves_g[i], leaves_p[i], leaves_s[i]))
            flat_v = st.residual.reshape(-1).to(torch.float32)
            timer.count("dispatch_select")
            selected, st = timer.stage(
                "select", lambda f=flat_v, st=st: comp.compress(f, k, st))
            self._count_overflow([selected])

            def _mask(st=st, sel=selected):
                st2 = mask_communicated(st, sel.indices, momentum=False)
                for c in self.corrections:
                    st2 = c.on_communicated(st2, sel.indices)
                return st2
            timer.count("dispatch_mask")
            new_states[i] = timer.stage("mask", _mask)
            timer.count("dispatch_pack")
            messages.append(timer.stage(
                "pack",
                lambda sel=selected: self.transport.pack(sel, comp.quantized)))
            msg_meta.append(("leaf", i, comp, k))

        return messages, msg_meta

    def _gather(self, messages: list) -> list:
        return self.timer.stage(
            "transfer", lambda: self.transport.allgather(messages))

    def _apply_gathered(self, gathered: list, msg_meta: list,
                        leaves_p: list, new_params: list, lr,
                        n_workers: int) -> None:
        """Decompress gathered messages and apply the SGD update."""
        def _apply(buf, i, comp, k):
            g_sum = comp.decompress(buf, leaves_p[i].numel(), k)
            upd = (g_sum / n_workers).reshape(leaves_p[i].shape)
            return (leaves_p[i].to(torch.float32)
                    - lr * upd).to(leaves_p[i].dtype)

        for buf, meta in zip(gathered, msg_meta):
            if meta[0] == "arena":
                _, group, comp = meta
                for slot, sbuf in zip(group.slots,
                                      arena.split_message(group, buf)):
                    new_params[slot.leaf] = self.timer.stage(
                        "unpack", lambda b=sbuf, s=slot: _apply(
                            b, s.leaf, comp, s.k))
            else:
                _, i, comp, k = meta
                new_params[i] = self.timer.stage(
                    "unpack", lambda b=buf, i=i, c=comp, k=k: _apply(
                        b, i, c, k))

    def _dense_reduce(self, i: int, leaves_g: list) -> torch.Tensor:
        return self.timer.stage(
            "transfer",
            lambda: self.transport.allreduce_mean(leaves_g[i]))

    def _dense_apply(self, i: int, g_mean, leaves_p: list, leaves_s: list,
                     new_states: list, new_params: list, lr) -> None:
        """Momentum-SGD apply of one dense leaf's reduced gradient."""
        st = leaves_s[i]
        if self.weight_decay:
            g_mean = g_mean + self.weight_decay * \
                leaves_p[i].to(torch.float32)
        if self.momentum:
            u = self.momentum * st.momentum + g_mean
            upd = (g_mean + self.momentum * u) if self.nesterov else u
            new_states[i] = st._replace(momentum=u)
        else:
            upd = g_mean
        new_params[i] = (leaves_p[i].to(torch.float32)
                         - lr * upd).to(leaves_p[i].dtype)


def build_gradient_sync(
    optimizer: str = "rgc",
    *,
    transport: str = "fused_allgather",
    sync_axes: tuple[str, ...] = (),
    mesh: Any = None,
    density: float = 0.001,
    momentum: float = 0.9,
    nesterov: bool = False,
    weight_decay: float = 0.0,
    local_clip: float | None = None,
    residual_dtype: Any = torch.float32,
    no_quant_paths: tuple[str, ...] = ("lm_head", "embed"),
    dense_threshold_bytes: int | None = None,
    trimmed_threshold_bytes: int | None = None,
    warmup_steps_per_stage: int = 0,
    dense_warmup: bool = False,
    bucket_bytes: int | None = None,
    intra_axis: str | None = None,
    fuse_leaves: bool = True,
    fuse_accumulate: bool = False,
    schedule: str = "sequential",
    timer: Any = None,
    device: str | torch.device | None = None,
    **compressor_params: Any,
) -> GradientSync:
    """Build a ``GradientSync`` from string-addressable component names
    (the reference's grammar: ``"rgc"``, ``"rgc_quant"``, ``"dense"``,
    any registered compressor spec, optionally prefixed by ``+``-joined
    corrections such as ``"factor_masking+warmup(rgc)"``; a
    corrections-only spec defaults the base to ``"rgc"``).
    ``warmup_steps_per_stage`` and ``dense_warmup`` parameterize a
    spec-named ``warmup``.

    ``sync_axes`` name the data-parallel axes of ``mesh`` (a
    ``launch.mesh.Mesh``) the step syncs over; no axes is one worker.
    ``schedule`` is a ``core.overlap`` spec (``"sequential"``,
    ``"chunked"``, ``"stale1"``, ``"staleK(k=N)"``).
    ``bucket_bytes`` (bucketed_allgather's byte budget, and the
    ``chunked`` schedule's ``chunk_bytes``) and
    ``intra_axis`` (hierarchical's intra-node axis; default the last
    sync axis) go to the transport, which ignores knobs it does not use.
    ``timer`` is the ``StageTimer`` shared by the sync loop and the
    transport (``None``: ``NullTimer``).

    ``device`` defaults to CUDA and raises when no card is present;
    ``device="cpu"`` runs the plain PyTorch path.
    """
    dev = resolve_device(device)
    corr_names, base = split_corrections(optimizer)
    optimizer = base or "rgc"
    corrections = None
    if corr_names:
        corrections = tuple(
            registry.make(registry.CORRECTION, name, momentum=momentum,
                          nesterov=nesterov, local_clip=local_clip,
                          density=density,
                          warmup_steps_per_stage=warmup_steps_per_stage,
                          dense_warmup=dense_warmup, **compressor_params)
            for name in corr_names)

    policy_kw = {}
    if dense_threshold_bytes is not None:
        policy_kw["dense_threshold_bytes"] = dense_threshold_bytes
    if trimmed_threshold_bytes is not None:
        policy_kw["trimmed_threshold_bytes"] = trimmed_threshold_bytes

    quantize = False
    if optimizer in ("rgc", "rgc_quant"):
        policy = registry.make(registry.DISPATCH_POLICY, "size_based",
                               **policy_kw)
        quantize = optimizer == "rgc_quant"
    elif optimizer == "dense":
        policy = FixedPolicy("dense")
    elif registry.contains(registry.COMPRESSOR, optimizer):
        registry.make(registry.COMPRESSOR, optimizer, **compressor_params)
        policy = FixedPolicy(optimizer)
    else:
        raise ValueError(
            f"unknown optimizer {optimizer!r}: expected rgc | rgc_quant | "
            f"dense | a registered compressor "
            f"{registry.names(registry.COMPRESSOR)}, optionally prefixed "
            f"by '+'-joined corrections "
            f"{registry.names(registry.CORRECTION)}")

    timer = timer if timer is not None else NullTimer()
    transport_kw: dict[str, Any] = {"sync_axes": tuple(sync_axes),
                                    "timer": timer, "mesh": mesh}
    if bucket_bytes is not None:
        transport_kw["bucket_bytes"] = bucket_bytes
    if intra_axis is not None:
        transport_kw["intra_axis"] = intra_axis
    return GradientSync(
        policy=policy,
        transport=registry.make(registry.TRANSPORT, transport,
                                **transport_kw),
        density=density,
        momentum=momentum,
        nesterov=nesterov,
        weight_decay=weight_decay,
        local_clip=local_clip,
        quantize=quantize,
        no_quant_paths=tuple(no_quant_paths),
        residual_dtype=residual_dtype,
        fuse_leaves=fuse_leaves,
        fuse_accumulate=fuse_accumulate,
        schedule=make_schedule(schedule),
        chunk_bytes=(DEFAULT_BUCKET_BYTES if bucket_bytes is None
                     else int(bucket_bytes)),
        corrections=corrections,
        compressor_params=dict(compressor_params),
        timer=timer,
        device=dev,
    )
