"""Sparse checkpoint chains and elastic restore (reference:
``src/repro/checkpoint``); the same on-disk format as the reference."""
from .ckpt import latest_step, load_flat, restore, save, save_flat
from .delta import apply_delta, leaf_delta
from .elastic import (redistribute_leaf_states, redistribute_stacked,
                      redistribute_tree, stack_worker_copies,
                      unstack_to_devices)
from .manager import CheckpointManager, read_manifest

__all__ = ["latest_step", "load_flat", "restore", "save", "save_flat",
           "apply_delta", "leaf_delta", "redistribute_leaf_states",
           "redistribute_stacked", "redistribute_tree",
           "stack_worker_copies", "unstack_to_devices",
           "CheckpointManager", "read_manifest"]
