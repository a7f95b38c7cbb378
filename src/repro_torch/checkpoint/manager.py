"""Full-snapshot + sparse-delta checkpoint chains.

Port of ``src/repro/checkpoint/manager.py``; the same layout and the same
bytes. Under one directory::

    <dir>/manifest.json            # chain index + user metadata (atomic)
    <dir>/step_00000010/           # FULL snapshot (ckpt.save format)
    <dir>/delta_00000012/          # sparse delta vs step 10
        arrays.npz                 #   per-leaf packed delta / dense copy
        meta.json                  #   step, base step, per-leaf kind, sha256
    <dir>/delta_00000014/          # sparse delta vs step 12 ...

``CheckpointManager.save`` writes a FULL snapshot for the first save and
after every ``full_every - 1`` consecutive deltas (and whenever it has no
in-memory base to diff against, e.g. the first save after a resume);
otherwise it writes a packed sparse delta (``delta.leaf_delta``) against
the previously saved tree. ``restore`` resolves a step by walking the
base-pointer chain back to its full snapshot and replaying deltas
forward; every delta file is sha256-verified and structurally validated
first, so corruption and truncation raise ``ValueError`` instead of
silently mis-restoring. ``compact`` folds a resolved chain into a full
snapshot and drops its delta links.

All writes are atomic (tmp + rename, like ``ckpt.save``): an interrupted
save never corrupts the chain, and the manifest is rewritten last so it
only ever points at fully materialized entries.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np

from . import ckpt
from .delta import BF16, apply_delta, dtype_name, leaf_delta

__all__ = ["CheckpointManager", "read_manifest"]

_MANIFEST = "manifest.json"


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def read_manifest(directory: str) -> dict[str, Any] | None:
    path = os.path.join(directory, _MANIFEST)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


class CheckpointManager:
    """Chained full + sparse-delta checkpoints over one directory.

    ``full_every=N``: a full snapshot every N-th save (N-1 deltas in
    between). ``metadata`` (any JSON-serializable dict, e.g.
    ``{"num_workers": 8}``) is carried in the manifest and returned by
    ``read_manifest`` — the elastic restore path reads the checkpoint's
    worker count from it.
    """

    def __init__(self, directory: str, full_every: int = 4):
        if full_every < 1:
            raise ValueError(f"full_every must be >= 1, got {full_every}")
        self.directory = directory
        self.full_every = int(full_every)
        self._last_flat: dict[str, np.ndarray] | None = None
        self._last_step: int | None = None
        man = read_manifest(directory) or {"entries": [], "metadata": {}}
        self._entries: list[dict[str, Any]] = list(man.get("entries", []))
        self._metadata: dict[str, Any] = dict(man.get("metadata", {}))

    # -- chain index --------------------------------------------------------

    @property
    def metadata(self) -> dict[str, Any]:
        return dict(self._metadata)

    def steps(self) -> list[int]:
        return [e["step"] for e in self._entries]

    def latest_step(self) -> int | None:
        return self._entries[-1]["step"] if self._entries else None

    def _entry(self, step: int) -> dict[str, Any]:
        for e in self._entries:
            if e["step"] == step:
                return e
        raise FileNotFoundError(
            f"no checkpoint for step {step} in {self.directory} "
            f"(have {self.steps()})")

    def _deltas_since_full(self) -> int:
        n = 0
        for e in reversed(self._entries):
            if e["kind"] == "full":
                break
            n += 1
        return n

    def _write_manifest(self) -> None:
        os.makedirs(self.directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.directory, prefix=".tmp_man_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"entries": self._entries,
                           "metadata": self._metadata}, f, indent=1)
            os.replace(tmp, os.path.join(self.directory, _MANIFEST))
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any,
             metadata: dict[str, Any] | None = None) -> str:
        """Save ``tree`` at ``step`` (full or delta per the chain policy)."""
        if metadata:
            self._metadata.update(metadata)
        if self._last_step is not None and step <= self._last_step:
            raise ValueError(
                f"checkpoint steps must increase: {step} after "
                f"{self._last_step}")
        flat = ckpt._flatten_native(tree)
        force_full = (
            self._last_flat is None
            or self._deltas_since_full() >= self.full_every - 1
            or set(flat) != set(self._last_flat))
        if force_full:
            path = ckpt.save(self.directory, step, tree)
            entry = {"step": step, "kind": "full", "base": None,
                     "path": os.path.basename(path)}
        else:
            path, sha = self._save_delta(step, flat)
            entry = {"step": step, "kind": "delta", "base": self._last_step,
                     "path": os.path.basename(path), "sha256": sha}
        self._entries.append(entry)
        self._last_flat = flat
        self._last_step = step
        self._write_manifest()
        return path

    def _save_delta(self, step: int,
                    flat: dict[str, np.ndarray]) -> tuple[str, str]:
        assert self._last_flat is not None
        final = os.path.join(self.directory, f"delta_{step:08d}")
        tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_delta_")
        try:
            arrays: dict[str, np.ndarray] = {}
            kinds: dict[str, str] = {}
            for key, new in flat.items():
                packed = leaf_delta(self._last_flat[key], new)
                if packed is None:
                    arrays[key] = ckpt._to_disk(new)    # bf16 -> u16 view
                    kinds[key] = "dense"
                else:
                    arrays[key] = packed
                    kinds[key] = "sparse"
            npz = os.path.join(tmp, "arrays.npz")
            np.savez(npz, **arrays)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, "base": self._last_step,
                           "kinds": kinds, "sha256": _sha256(npz)}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        with open(os.path.join(final, "meta.json")) as f:
            sha = json.load(f)["sha256"]
        return final, sha

    # -- restore ------------------------------------------------------------

    def _chain_to(self, step: int) -> list[dict[str, Any]]:
        """Entries from the governing full snapshot to ``step``, inclusive."""
        chain = [self._entry(step)]
        while chain[0]["kind"] != "full":
            base = chain[0]["base"]
            if base is None:
                raise ValueError(
                    f"corrupt chain: delta at step {chain[0]['step']} has "
                    f"no base pointer")
            chain.insert(0, self._entry(base))
        return chain

    def _load_delta(self, entry: dict[str, Any]) -> tuple[dict, dict]:
        path = os.path.join(self.directory, entry["path"])
        meta_path = os.path.join(path, "meta.json")
        npz_path = os.path.join(path, "arrays.npz")
        if not (os.path.exists(meta_path) and os.path.exists(npz_path)):
            raise ValueError(f"corrupt checkpoint delta at {path}: "
                             f"missing arrays.npz or meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        if _sha256(npz_path) != meta["sha256"]:
            raise ValueError(
                f"corrupt checkpoint delta at {path}: sha256 mismatch "
                f"(truncated or bit-rotted write)")
        try:
            data = dict(np.load(npz_path).items())
        except Exception as e:
            raise ValueError(
                f"corrupt checkpoint delta at {path}: {e}") from e
        return data, meta

    def resolve_flat(self, step: int | None = None) -> dict[str, np.ndarray]:
        """Template-free chain resolution: the native-dtype flat leaf
        dict at ``step`` (default latest), full snapshot + replayed,
        verified deltas."""
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(
                    f"no checkpoints in {self.directory}")
        chain = self._chain_to(step)
        flat = ckpt.load_flat(self.directory, chain[0]["step"])
        for entry in chain[1:]:
            data, meta = self._load_delta(entry)
            if set(data) != set(flat):
                raise ValueError(
                    f"corrupt checkpoint delta at step {entry['step']}: "
                    f"leaf set mismatch vs its base")
            for key in flat:
                if meta["kinds"][key] == "dense":
                    arr = data[key]
                    if arr.dtype == np.uint16 \
                            and dtype_name(flat[key]) == "bfloat16":
                        arr = arr.view(BF16)
                    if arr.shape != flat[key].shape:
                        raise ValueError(
                            f"corrupt checkpoint delta at step "
                            f"{entry['step']}: dense leaf {key} shape "
                            f"{arr.shape} vs {flat[key].shape}")
                    flat[key] = arr
                else:
                    flat[key] = apply_delta(flat[key], data[key])
        return flat

    def restore(self, template: Any, step: int | None = None) -> Any:
        """Resolve ``step`` (default latest) against ``template``.

        Template validation (shape/dtype/missing leaves) matches
        ``ckpt.restore``; the chain's deltas are verified and replayed in
        order on top of the governing full snapshot.
        """
        return ckpt.unflatten_like(template, self.resolve_flat(step))

    # -- compaction ---------------------------------------------------------

    def compact(self) -> None:
        """Fold the latest chain into a full snapshot; drop delta dirs.

        After compaction the latest step is a full snapshot restoring
        bitwise-identically to the pre-compaction chain, and the manifest
        holds only full entries (older fulls are kept as history).
        """
        step = self.latest_step()
        if step is None:
            return
        tail = self._entry(step)
        if tail["kind"] != "full":
            ckpt.save_flat(self.directory, step, self.resolve_flat(step))
        survivors = []
        for e in self._entries:
            if e["kind"] == "delta" and e["step"] != step:
                shutil.rmtree(os.path.join(self.directory, e["path"]),
                              ignore_errors=True)
            elif e["kind"] == "full":
                survivors.append(e)
        if tail["kind"] != "full":
            shutil.rmtree(os.path.join(self.directory, tail["path"]),
                          ignore_errors=True)
            survivors.append({"step": step, "kind": "full", "base": None,
                              "path": f"step_{step:08d}"})
        survivors.sort(key=lambda e: e["step"])
        self._entries = survivors
        self._write_manifest()

