"""Overlapped backprop/communication schedules (RedSync §5.6).

Port of ``src/repro/core/overlap.py``. A schedule owns the dispatch
order of ``GradientSync.update`` (``TrainConfig.schedule``):

``sequential``
    Compress every unit, ONE transport barrier, then unpack/apply.

``chunked``
    ``partition_chunks`` splits the tree into chunks in REVERSE
    parameter order (last layer first, as backprop produces gradients)
    under the ``chunk_bytes`` budget, never splitting a leaf. Each
    chunk's accumulate/select/mask/pack runs and its collective is
    issued before the next chunk's compute; unpack/apply drains after.
    Each chunk's arenas hold only its own leaves (arena ids
    ``1000 * cid + i``). Per-unit arithmetic is the same as
    ``sequential``'s and updates to distinct leaves commute, so params
    and state are bitwise ``sequential``'s; only the number and order
    of collectives change.

``stale1``
    One-step-delayed double buffer: step *t* packs its own messages
    into ``ScheduleState.pending`` and communicates + applies those of
    step *t-1* (zero-count at step 0).

``staleK(k=K)``
    A ring of K generations, oldest first: step *t* applies the buffer
    packed at step *t-K*. ``k=1`` runs ``stale1``'s exact op sequence.

Both stale schedules keep dense leaves synchronous; a §5.7 dense step
(density >= 1.0) runs fully synchronous and carries the pending buffers
through untouched (packed values may only be applied, never dropped).
They need a fixed target density: an intermediate warm-up density
raises. ``reabsorb_pending`` folds the in-flight buffers back into the
residual (the elastic worker-count-change rule).

The reference's ``wrap_state_specs`` (shard_map partition specs of the
schedule state) has no counterpart: the port shards nothing.
"""
from __future__ import annotations

import re
from typing import Any, NamedTuple, Sequence

import torch

from . import arena
from . import registry
from . import tree
from .transport import assign_buckets


class Chunk(NamedTuple):
    """One pipeline chunk: a contiguous run of the REVERSED leaf order."""

    cid: int
    leaves: tuple[int, ...]    # leaf indices, reverse parameter order
    nbytes: int                # summed gradient bytes of the chunk


def partition_chunks(nbytes: Sequence[int],
                     chunk_bytes: int) -> tuple[Chunk, ...]:
    """Greedy reverse-order partition of per-leaf gradient byte sizes:
    ``transport.assign_buckets`` over the reversed leaf order, so a leaf
    over the budget forms a singleton chunk and nothing is split. The
    sizes are raw gradient bytes, not packed-message bytes."""
    order = list(reversed(range(len(nbytes))))
    buckets = assign_buckets([int(nbytes[i]) for i in order], chunk_bytes)
    return tuple(
        Chunk(cid, tuple(order[j] for j in bucket),
              sum(int(nbytes[order[j]]) for j in bucket))
        for cid, bucket in enumerate(buckets))


class ScheduleState(NamedTuple):
    """Optimizer state of a buffered schedule: ``leaf`` is the
    params-congruent LeafState tree; ``pending`` holds packed f32 wire
    messages in the target-density plan's unit order — ``stale1``'s
    flat tuple of the previous step's messages, or ``staleK``'s ring of
    K such tuples, oldest first. ``core.tree`` treats it as one leaf."""

    leaf: Any
    pending: tuple[Any, ...]


class SequentialSchedule:
    """Full-tree barrier order: compress all -> one transfer -> apply."""

    name = "sequential"

    def init_state(self, sync, params, leaf_state):
        return leaf_state

    def step(self, sync, grads, state, params, lr, density):
        all_dense = density >= 1.0
        (treedef, paths, leaves_raw, leaves_g, leaves_p, leaves_s,
         n_workers) = sync._context(grads, state, params)
        plan = sync._plan(treedef, paths, leaves_raw, density, all_dense)
        new_states = list(leaves_s)
        new_params = list(leaves_p)

        messages, meta = sync._compress_plan(
            plan, leaves_g, leaves_p, leaves_s, new_states)
        gathered = sync._gather(messages)
        sync._apply_gathered(gathered, meta, leaves_p, new_params, lr,
                             n_workers)
        for i in plan.dense:
            g_mean = sync._dense_reduce(i, leaves_g)
            sync._dense_apply(i, g_mean, leaves_p, leaves_s, new_states,
                              new_params, lr)
        return (tree.unflatten(treedef, new_params),
                tree.unflatten(treedef, new_states))


class ChunkedSchedule:
    """§5.6 chunk-pipelined order: per chunk (reverse parameter order),
    compress then issue its collective at once; unpack/apply drains
    after every chunk's collective was issued. Bitwise ``sequential``."""

    name = "chunked"

    def init_state(self, sync, params, leaf_state):
        return leaf_state

    def step(self, sync, grads, state, params, lr, density):
        all_dense = density >= 1.0
        (treedef, paths, leaves_raw, leaves_g, leaves_p, leaves_s,
         n_workers) = sync._context(grads, state, params)
        plans = sync._chunk_plans(treedef, paths, leaves_raw, density,
                                  all_dense)
        new_states = list(leaves_s)
        new_params = list(leaves_p)
        timer = sync.timer

        inflight = []
        for cid, plan in enumerate(plans):
            timer.set_lane(f"chunk{cid}")
            msgs, meta = sync._compress_plan(
                plan, leaves_g, leaves_p, leaves_s, new_states)
            gathered = sync._gather(msgs) if msgs else []
            dense_means = [(i, sync._dense_reduce(i, leaves_g))
                           for i in plan.dense]
            timer.set_lane(None)
            inflight.append((cid, meta, gathered, dense_means))

        for cid, meta, gathered, dense_means in inflight:
            timer.set_lane(f"chunk{cid}")
            sync._apply_gathered(gathered, meta, leaves_p, new_params, lr,
                                 n_workers)
            for i, g_mean in dense_means:
                sync._dense_apply(i, g_mean, leaves_p, leaves_s,
                                  new_states, new_params, lr)
            timer.set_lane(None)
        return (tree.unflatten(treedef, new_params),
                tree.unflatten(treedef, new_states))


class Stale1Schedule:
    """One-step-delayed double-buffered sync (§5.6 maximal overlap).

    Step *t* packs its own messages into the pending buffer and
    communicates + applies the messages packed at step *t-1*. Dense
    leaves and the §5.7 dense warm-up stay synchronous."""

    name = "stale1"

    def init_state(self, sync, params, leaf_state):
        return ScheduleState(leaf=leaf_state,
                             pending=sync._pending_zeros(params))

    def _check(self, sync, state, density) -> None:
        if not isinstance(state, ScheduleState):
            raise TypeError(
                f"{self.name} schedule state must come from "
                f"GradientSync.init (ScheduleState with a pending message "
                f"buffer)")
        if density < 1.0 and density != sync.density:
            raise ValueError(
                f"{self.name} requires a fixed target density (pending "
                f"message buffers have the target plan's shapes): got step "
                f"density {density} vs configured {sync.density}. The §5.7 "
                f"dense warm-up (density >= 1.0) is supported; the DGC "
                f"intermediate-density ramp is not.")

    def _oldest(self, pending) -> tuple:
        return pending

    def _push(self, pending, messages: list) -> tuple:
        return tuple(messages)

    def step(self, sync, grads, state, params, lr, density):
        self._check(sync, state, density)
        (treedef, paths, leaves_raw, leaves_g, leaves_p, leaves_s,
         n_workers) = sync._context(grads, state.leaf, params)
        new_states = list(leaves_s)
        new_params = list(leaves_p)

        if density >= 1.0:
            # §5.7 dense step: every leaf synchronous; the buffers ride
            # along until the next sparse step applies them
            for i in range(len(leaves_g)):
                g_mean = sync._dense_reduce(i, leaves_g)
                sync._dense_apply(i, g_mean, leaves_p, leaves_s,
                                  new_states, new_params, lr)
            new_pending = state.pending
        else:
            # the target plan: the same key as _pending_zeros', so the
            # buffers' layout always matches this step's meta
            plan = sync._plan(treedef, paths, leaves_raw, density, False)
            # pack step t's messages (residual masked now, at selection)...
            messages, meta = sync._compress_plan(
                plan, leaves_g, leaves_p, leaves_s, new_states)
            # ...but communicate and apply the oldest buffer
            gathered = sync._gather(list(self._oldest(state.pending)))
            sync._apply_gathered(gathered, meta, leaves_p, new_params, lr,
                                 n_workers)
            for i in plan.dense:
                g_mean = sync._dense_reduce(i, leaves_g)
                sync._dense_apply(i, g_mean, leaves_p, leaves_s,
                                  new_states, new_params, lr)
            new_pending = self._push(state.pending, messages)

        return (tree.unflatten(treedef, new_params),
                ScheduleState(leaf=tree.unflatten(treedef, new_states),
                              pending=new_pending))


class StaleKSchedule(Stale1Schedule):
    """K-step-delayed ring-buffered sync (the ``stale1`` generalization):
    a sparse step gathers + applies ``pending[0]`` (packed K sparse steps
    ago; zero-count for the first K), packs its own messages and rotates
    them in at the tail. ``k=1`` issues ``stale1``'s op sequence; only
    the ring nests one level deeper."""

    name = "staleK"

    def __init__(self, k: int = 2):
        if int(k) < 1:
            raise ValueError(f"staleK requires k >= 1, got {k}")
        self.k = int(k)

    def init_state(self, sync, params, leaf_state):
        zeros = sync._pending_zeros(params)
        return ScheduleState(leaf=leaf_state,
                             pending=tuple(zeros for _ in range(self.k)))

    def _check(self, sync, state, density) -> None:
        if not isinstance(state, ScheduleState):
            raise TypeError(
                "staleK schedule state must come from GradientSync.init "
                "(ScheduleState with a pending message ring)")
        if len(state.pending) != self.k:
            raise ValueError(
                f"staleK(k={self.k}) got a pending ring of length "
                f"{len(state.pending)} — state from a different k?")
        super()._check(sync, state, density)

    def _oldest(self, pending) -> tuple:
        return pending[0]

    def _push(self, pending, messages: list) -> tuple:
        return pending[1:] + (tuple(messages),)


# -- schedule spec grammar ---------------------------------------------------

_SCHEDULE_SPEC_RE = re.compile(
    r"^\s*(?P<name>[A-Za-z_]\w*)\s*(?:\(\s*(?P<args>[^()]*)\s*\))?\s*$")


def parse_schedule_spec(spec: str) -> tuple[str, dict[str, Any]]:
    """``"name"`` or ``"name(key=value, ...)"`` -> (name, kwargs); values
    parse as int, then float, then bare string."""
    m = _SCHEDULE_SPEC_RE.match(spec)
    if m is None:
        raise ValueError(
            f"malformed schedule spec {spec!r}: expected 'name' or "
            f"'name(key=value, ...)'")
    kwargs: dict[str, Any] = {}
    args = m.group("args")
    for item in (args.split(",") if args else ()):
        item = item.strip()
        if not item:
            continue
        if "=" not in item:
            raise ValueError(
                f"schedule spec {spec!r}: argument {item!r} is not "
                f"'key=value'")
        key, _, raw = item.partition("=")
        key, raw = key.strip(), raw.strip()
        value: Any
        try:
            value = int(raw)
        except ValueError:
            try:
                value = float(raw)
            except ValueError:
                value = raw
        kwargs[key] = value
    return m.group("name"), kwargs


def make_schedule(spec: str, **params: Any):
    """Build a registered schedule from its spec string: ``"sequential"``,
    ``"chunked"``, ``"stale1"``, ``"staleK"`` (k defaults to 2),
    ``"staleK(k=4)"``. Spec kwargs override ``params``; an unknown name
    raises ``KeyError`` listing the registered schedules."""
    name, kwargs = parse_schedule_spec(spec)
    return registry.make(registry.SCHEDULE, name, **{**params, **kwargs})


# -- elastic topology change -------------------------------------------------

def reabsorb_pending(sync, params: Any, state: Any) -> Any:
    """Fold a buffered schedule's in-flight packed messages back into the
    residual; returns the plain params-congruent LeafState tree (other
    states pass through unchanged).

    Every generation is decompressed locally and added into the residual:
    the masked coordinates are zero, so this restores the pre-mask f32
    values exactly (a bf16 residual rounds once). The caller re-inits the
    schedule state with a fresh zero ring. New tensors only: the pending
    buffers and the old residuals are read, never written."""
    if not isinstance(state, ScheduleState):
        return state
    generations = state.pending
    if generations and not isinstance(generations[0], (tuple, list)):
        generations = (generations,)      # stale1's flat double buffer

    plan, leaves_p = sync._target_plan(params)
    new_states = tree.flatten(state.leaf)[0]

    def add_to_residual(i, dense):
        st = new_states[i]
        v = st.residual.to(torch.float32) + dense.reshape(st.residual.shape)
        new_states[i] = st._replace(residual=v.to(st.residual.dtype))

    for gen in generations:
        units = list(gen)
        for group, comp in zip(plan.groups, plan.group_comps):
            buf = units.pop(0)
            for slot, sbuf in zip(group.slots,
                                  arena.split_message(group, buf[None])):
                add_to_residual(slot.leaf, comp.decompress(
                    sbuf, leaves_p[slot.leaf].numel(), slot.k))
        for i, comp, k in plan.sparse:
            buf = units.pop(0)
            add_to_residual(i, comp.decompress(buf[None],
                                               leaves_p[i].numel(), k))
        if units:
            raise ValueError(
                f"pending generation has {len(units)} unconsumed unit "
                f"buffers — checkpoint from a different plan/config?")
    return tree.unflatten(tree.structure(params), new_states)


@registry.register(registry.SCHEDULE, "sequential")
def _sequential(**_: Any) -> SequentialSchedule:
    return SequentialSchedule()


@registry.register(registry.SCHEDULE, "chunked")
def _chunked(**_: Any) -> ChunkedSchedule:
    return ChunkedSchedule()


@registry.register(registry.SCHEDULE, "stale1")
def _stale1(**_: Any) -> Stale1Schedule:
    return Stale1Schedule()


@registry.register(registry.SCHEDULE, "staleK")
def _stalek(k: int = 2, **_: Any) -> StaleKSchedule:
    return StaleKSchedule(k=k)
