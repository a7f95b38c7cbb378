"""Step schedules (RedSync §5.6).

Port of ``src/repro/core/overlap.py``, ``sequential`` only: compress
every unit, ONE transport barrier, then unpack/apply. ``chunked``,
``stale1`` and ``staleK`` wait (see ROADMAP.md).
"""
from __future__ import annotations

from typing import Any

from . import registry
from . import tree


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


def make_schedule(spec: str, **params: Any):
    """Build a registered schedule from its spec string."""
    return registry.make(registry.SCHEDULE, spec, **params)


@registry.register(registry.SCHEDULE, "sequential")
def _sequential(**_: Any) -> SequentialSchedule:
    return SequentialSchedule()
