"""Port parity of the checkpoint package (``repro_torch.checkpoint``)
and the trainer's fault-tolerance hooks against ``repro.checkpoint``.

* The on-disk format both ways: the same state (f32, int32, bf16 and 0-d
  leaves, in dicts, named tuples and tuples) gives byte-identical files
  from both packages, full snapshots and delta chains alike, and each
  package restores the other's chain bitwise.
* The packed deltas, the chain manager and the remainder rule, case by
  case against the reference's results and errors.
* ``Trainer`` crash/resume on the CPU: a run that saves every 2 steps,
  dies after step 5 and is restored at step 4 ends bitwise where the
  uninterrupted run ends; its saved keys, shapes and dtypes are the
  reference Trainer's.
* Elastic 2 -> 1: the two-rank trainer group of ``test_torch_dist.py``
  saves one ``stale1`` chain; both packages' ``restore_checkpoint`` at
  one worker give the same bits.
* The launcher's ``--ckpt-dir`` / ``--ckpt-every`` / ``--resume`` /
  ``--data``.

Everything runs in this process but the two-rank group, which
``test_torch_dist.py`` spawns once per run.
"""
import os

import numpy as np
import pytest
import torch
from test_torch_dist import _trainer_ranks, trainer_run  # noqa: F401

import _torch_dist_prog as prog


@pytest.fixture(scope="module", autouse=True)
def _free_jax_executables():
    """Free the XLA executables, and the memory maps they hold, that
    earlier test modules on this worker left: on entry and on exit."""
    import gc
    try:
        from jax import clear_caches
    except ImportError:              # a card-only run, without JAX
        def clear_caches():
            pass
    clear_caches()
    gc.collect()
    yield
    clear_caches()
    gc.collect()


def _bf16():
    import ml_dtypes
    return np.dtype(ml_dtypes.bfloat16)


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        from repro_torch.checkpoint.ckpt import to_numpy
        a = to_numpy(a)
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _files(d) -> dict:
    """{relative path: bytes} of every file under ``d``."""
    out = {}
    for root, _, names in os.walk(d):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, d)] = f.read()
    return out


def _same_flat(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _bits(got[k]) == _bits(want[k]), k


# ---------------------------------------------------------------------------
# the on-disk format, both ways
# ---------------------------------------------------------------------------

def _states(steps: int = 6):
    """The same state per step as (reference tree of numpy arrays, port
    tree of torch tensors): a param vector with a few coordinates
    changed a step (one to -0.0), a bf16 residual changed sparsely on
    odd steps and densely on even ones, 0-d f32 / int32 counters, and a
    two-generation pending ring."""
    from repro.core.overlap import ScheduleState as JSS
    from repro.core.residual import LeafState as JLS

    from repro_torch.core.overlap import ScheduleState
    from repro_torch.core.residual import LeafState

    bf16 = _bf16()
    rng = np.random.default_rng(0)
    w = rng.standard_normal(512).astype(np.float32)
    res = rng.standard_normal(64).astype(np.float32).astype(bf16)
    n = np.arange(-3, 5, dtype=np.int32)
    out = []
    for s in range(1, steps + 1):
        w = w.copy()
        w[rng.integers(0, 512, 4)] += 1.0
        if s == 3:
            w[7] = -0.0 if w[7] == 0 else 0.0
        res = res.copy()
        idx = rng.integers(0, 64, 2 if s % 2 else 64)
        res[idx] = (res[idx].astype(np.float32) * 0.5).astype(bf16)
        n = n + 1
        ref = {"params": {"w": w.copy(), "n": n.copy()},
               "rgc": JSS(leaf={"w": JLS(
                   residual=res.copy(), momentum=np.float32(0.0),
                   threshold=np.float32(0.25 * s), phase=np.int32(s % 2),
                   interval=np.int32(s))},
                   pending=((w[:16] * s,), (w[16:32] - s,)))}

        def t(a):
            a = np.asarray(a)
            if a.dtype == bf16:
                return torch.from_numpy(a.view(np.int16).copy()).view(
                    torch.bfloat16)
            return torch.from_numpy(a.copy())
        rl = ref["rgc"].leaf["w"]
        port = {"params": {k: t(v) for k, v in ref["params"].items()},
                "rgc": ScheduleState(
                    leaf={"w": LeafState(*(t(x) for x in rl))},
                    pending=tuple((t(g[0]),) for g in ref["rgc"].pending))}
        out.append((ref, port))
    return out


def test_format_byte_identical_and_restored_both_ways(tmp_path,
                                                      monkeypatch):
    """Full snapshots (``ckpt.save``) and a full/delta chain
    (``full_every=3``: full, delta, delta, full, delta, delta) are
    byte-identical from both packages, file by file; each package
    restores the other's files bitwise at every step (the port's bf16
    as its bits, dtype names numpy's); an interrupted port save leaves
    no step behind."""
    import jax

    import repro.checkpoint as rck
    import repro_torch.checkpoint as pck
    from repro_torch.checkpoint import ckpt as pckpt
    from repro_torch.checkpoint.delta import dtype_name

    states = _states()
    ref0, port0 = states[0]
    rck.save(str(tmp_path / "ref_full"), 1, ref0)
    pck.save(str(tmp_path / "port_full"), 1, port0)
    assert _files(tmp_path / "ref_full") == _files(tmp_path / "port_full")
    flat = pck.load_flat(str(tmp_path / "ref_full"), 1)
    assert {k: dtype_name(v) for k, v in flat.items()} == {
        k: str(v.dtype) for k, v in
        rck.load_flat(str(tmp_path / "ref_full"), 1).items()}
    assert "['rgc'].leaf['w'].residual" in flat and \
        "['rgc'].pending[1][0]" in flat
    got = pck.restore(str(tmp_path / "ref_full"), port0)
    for (k, a), (_, b) in zip(pckpt.flatten(got), pckpt.flatten(port0)):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype, k
        assert _bits(a) == _bits(b), k
    jgot = rck.restore(str(tmp_path / "port_full"), ref0)
    assert [_bits(x) for x in jax.tree.leaves(jgot)] == \
        [_bits(x) for x in jax.tree.leaves(ref0)]

    rm = rck.CheckpointManager(str(tmp_path / "ref"), full_every=3)
    pm = pck.CheckpointManager(str(tmp_path / "port"), full_every=3)
    for s, (ref, port) in enumerate(states, 1):
        rm.save(s, ref, metadata={"num_workers": 2})
        pm.save(s, port, metadata={"num_workers": 2})
    kinds = [e["kind"] for e in pck.read_manifest(
        str(tmp_path / "port"))["entries"]]
    assert kinds == ["full", "delta", "delta"] * 2
    assert _files(tmp_path / "ref") == _files(tmp_path / "port")

    pr = pck.CheckpointManager(str(tmp_path / "ref"))
    rp = rck.CheckpointManager(str(tmp_path / "port"))
    for s, (ref, port) in enumerate(states, 1):
        want = {k: pckpt.to_numpy(v) for k, v in pckpt.flatten(port)}
        _same_flat(pr.resolve_flat(s), want)
        out = rp.restore(jax.tree.map(np.zeros_like, ref), step=s)
        assert [_bits(x) for x in jax.tree.leaves(out)] == \
            [_bits(x) for x in jax.tree.leaves(ref)], s
        out = pr.restore(port, step=s)
        assert [_bits(x) for _, x in pckpt.flatten(out)] == \
            [_bits(x) for _, x in pckpt.flatten(port)], s

    # an interrupted save (the file written, then the crash) leaves the
    # latest step as it was and no tmp dir
    d = str(tmp_path / "port_full")
    os.makedirs(os.path.join(d, ".tmp_ckpt_dead"))
    real = np.savez

    def boom(*a, **k):
        real(*a, **k)
        raise RuntimeError("simulated death mid-save")
    monkeypatch.setattr(pckpt.np, "savez", boom)
    with pytest.raises(RuntimeError):
        pck.save(d, 2, port0)
    monkeypatch.undo()
    assert pck.latest_step(d) == rck.latest_step(d) == 1
    assert [x for x in os.listdir(d) if x.startswith(".tmp_")] == \
        [".tmp_ckpt_dead"]
    assert pck.latest_step(str(tmp_path / "none")) is None


# ---------------------------------------------------------------------------
# packed deltas, the chain manager, the remainder rule
# ---------------------------------------------------------------------------

def _outcome(fn, *args):
    """(packed or rebuilt bytes, or None) or (error type, message)."""
    try:
        out = fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))
    return None if out is None else (out.dtype.itemsize, out.shape,
                                     _bits(out))


def test_delta_cases_match_reference():
    """Every case of the reference's delta tests, through both packages:
    the packed vectors and rebuilt leaves bitwise (f32, bf16, int32; a
    -0.0 and a NaN-payload change; empty), the dense fallbacks (None),
    and the same ``ValueError`` for truncated, empty, bad-index and
    shape-mismatched input."""
    from repro.checkpoint import delta as rd
    from repro_torch.checkpoint import delta as pd

    bf16 = _bf16()
    rng = np.random.default_rng(0)
    base = rng.standard_normal(256).astype(np.float32)
    cases = []
    for dt in ("float32", "bfloat16", "int32"):
        old = {"float32": base, "bfloat16": base.astype(bf16),
               "int32": (base * 1000).astype(np.int32)}[dt]
        new = old.copy()
        new[[0, 17, 99, 255]] = new[[0, 17, 99, 255]] + old.dtype.type(3)
        cases.append((old, new))
    old = np.asarray([0.0, 1, 2, 3, 4, 5, 6], np.float32)
    new = old.copy()
    new[0] = -0.0
    cases.append((old, new))
    new = old.copy()
    new.view(np.uint32)[3] = 0x7FC00001          # a NaN with a payload
    old2 = old.copy()
    old2.view(np.uint32)[3] = 0x7FC00002
    cases += [(old2, new), (np.arange(64, dtype=np.float32),) * 2,
              (np.arange(10, dtype=np.float32),
               np.arange(10, dtype=np.float32) + 1),
              (np.arange(10.0), np.arange(10.0) + 1)]   # no f32 carrier

    def port(a):
        return a.view(np.uint16).view(pd.BF16) if a.dtype == bf16 else a

    for i, (old, new) in enumerate(cases):
        want = _outcome(rd.leaf_delta, old, new)
        got = _outcome(pd.leaf_delta, port(old), port(new))
        assert got == want, i
        if want is not None:
            packed = rd.leaf_delta(old, new)
            assert _outcome(pd.apply_delta, port(old), packed) == \
                _outcome(rd.apply_delta, old, packed) == \
                _outcome(lambda x: x, new), i
            assert pd.delta_nbytes(packed, new) == packed.nbytes

    old = np.arange(64, dtype=np.float32)
    new = old.copy()
    new[[3, 9]] += 1
    packed = rd.leaf_delta(old, new)
    bad_idx = np.concatenate([
        np.asarray([2], np.int32).view(np.float32),
        np.asarray([70, 3], np.int32).view(np.float32),
        np.asarray([1.0, 2.0], np.float32)])
    for vec in (packed[:-1], np.asarray([], np.float32), bad_idx):
        want = _outcome(rd.apply_delta, old, vec)
        assert want[0] == "ValueError"
        assert _outcome(pd.apply_delta, old, vec) == want
    for fn in (rd.leaf_delta, pd.leaf_delta):
        with pytest.raises(ValueError, match="mismatch"):
            fn(np.ones(4, np.float32), np.ones(5, np.float32))
    assert pd.leaf_delta(np.ones(4, np.float32), np.ones(4, np.float32)) \
        .tobytes() == rd.leaf_delta(np.ones(4, np.float32),
                                    np.ones(4, np.float32)).tobytes()


def _chain(mgr, n=6, seed=0):
    """The reference tests' chain: ``w`` with 4 coordinates bumped a
    step and a counter ``n``; returns the per-step history."""
    rng = np.random.default_rng(seed)
    t = {"w": rng.standard_normal(512).astype(np.float32),
         "n": np.asarray([0], np.int32)}
    history = []
    for s in range(1, n + 1):
        w = t["w"].copy()
        w[rng.integers(0, 512, 4)] += 1.0
        t = {"w": w, "n": t["n"] + 1}
        mgr.save(s, t, metadata={"num_workers": 8})
        history.append((s, {k: v.copy() for k, v in t.items()}))
    return history


def test_manager_chain_policy_resume_compaction_and_errors(tmp_path):
    """The reference tests' chain through the port's manager: its policy
    and every step restored; a fresh instance resumes it (its first save
    is full); compaction keeps the bits and drops every delta; a
    truncated delta, a template mismatch and a step that does not
    increase raise what the reference raises; metadata persists."""
    import repro.checkpoint as rck
    from repro_torch.checkpoint import CheckpointManager, read_manifest

    d = str(tmp_path / "c")
    mgr = CheckpointManager(d, full_every=3)
    history = _chain(mgr)
    rdir = str(tmp_path / "r")
    _chain(rck.CheckpointManager(rdir, full_every=3))
    assert _files(d) == _files(rdir)
    assert [e["kind"] for e in read_manifest(d)["entries"]] == \
        ["full", "delta", "delta", "full", "delta", "delta"]

    def zeros(ref):
        return {k: np.zeros_like(v) for k, v in ref.items()}
    for s, ref in history:
        out = mgr.restore(zeros(ref), step=s)
        assert all(_bits(out[k]) == _bits(ref[k]) for k in ref), s
    with pytest.raises(ValueError, match="increase"):
        mgr.save(1, history[0][1])
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": np.zeros(99, np.float32),
                     "n": np.zeros(1, np.int32)})
    with pytest.raises(KeyError, match="missing"):
        mgr.restore({**zeros(history[0][1]),
                     "extra": np.zeros(2, np.float32)})
    with pytest.raises(FileNotFoundError):
        mgr.restore(zeros(history[0][1]), step=99)

    s, ref = history[-1]
    mgr2 = CheckpointManager(d)
    assert mgr2.metadata["num_workers"] == 8
    out = mgr2.restore(zeros(ref))
    assert all(_bits(out[k]) == _bits(ref[k]) for k in ref)
    mgr2.save(s + 1, ref)
    assert read_manifest(d)["entries"][-1]["kind"] == "full"

    mgr3 = CheckpointManager(rdir)
    mgr3.compact()
    assert all(e["kind"] == "full" for e in read_manifest(rdir)["entries"])
    assert not [x for x in os.listdir(rdir) if x.startswith("delta_")]
    out = rck.CheckpointManager(rdir).restore(zeros(ref))
    assert all(_bits(out[k]) == _bits(ref[k]) for k in ref)

    entry = [e for e in read_manifest(d)["entries"]
             if e["kind"] == "delta"][-1]
    npz = os.path.join(d, entry["path"], "arrays.npz")
    with open(npz, "r+b") as f:
        f.truncate(os.path.getsize(npz) - 32)
    for m in (CheckpointManager(d), rck.CheckpointManager(d)):
        with pytest.raises(ValueError, match="corrupt"):
            m.restore(zeros(ref), step=s)


def test_redistribution_matches_reference():
    """``redistribute_stacked`` (additive and copy, shrink and grow, f32
    and bf16), ``redistribute_leaf_states`` (param-shaped and placeholder
    momentum) and ``redistribute_tree`` give the reference's bits on the
    same rows; without a mesh, stacking and unstacking is ``p = 1``."""
    import jax

    import repro.checkpoint as rck
    from repro.core.residual import LeafState as JLS
    from repro_torch.checkpoint import (redistribute_leaf_states,
                                        redistribute_stacked,
                                        redistribute_tree,
                                        stack_worker_copies,
                                        unstack_to_devices)
    from repro_torch.checkpoint.delta import BF16
    from repro_torch.core.residual import LeafState

    bf16 = _bf16()
    rng = np.random.default_rng(1)
    f32 = rng.standard_normal((8, 33)).astype(np.float32)
    for rows, port_rows in ((f32, f32),
                            (f32.astype(bf16),
                             f32.astype(bf16).view(np.uint16).view(BF16))):
        for p in (1, 2, 3, 4, 8, 16):
            for additive in (True, False):
                want = rck.redistribute_stacked(rows, p, additive)
                got = redistribute_stacked(port_rows, p, additive)
                assert got.shape == want.shape
                assert _bits(got) == _bits(want), (rows.dtype, p, additive)

    p_old = 4
    ref = {"a": JLS(residual=f32[:p_old], momentum=f32[4:8] * 2,
                    threshold=np.arange(p_old, dtype=np.float32),
                    phase=np.arange(p_old, dtype=np.int32),
                    interval=np.arange(p_old, dtype=np.int32) + 3),
           "b": JLS(residual=f32[:p_old, :5], momentum=np.zeros(
               p_old, np.float32), threshold=np.ones(p_old, np.float32),
               phase=np.zeros(p_old, np.int32),
               interval=np.zeros(p_old, np.int32))}
    port = {k: LeafState(*v) for k, v in ref.items()}
    for p in (1, 3, 8):
        want = rck.redistribute_leaf_states(ref, p)
        got = redistribute_leaf_states(port, p)
        for k in ref:
            assert [_bits(x) for x in got[k]] == \
                [_bits(x) for x in want[k]], (k, p)
    tree = {"x": f32[:p_old], "y": {"z": f32[:p_old, :2]}}
    want = rck.redistribute_tree(tree, 2, lambda kp, leaf: leaf.shape[-1]
                                 == 2)
    got = redistribute_tree(tree, 2, lambda key, leaf: key.endswith(
        "['z']"))
    assert [_bits(x) for x in jax.tree.leaves(want)] == \
        [_bits(got["x"]), _bits(got["y"]["z"])]

    one = {"w": torch.arange(6.0).reshape(2, 3),
           "b": torch.ones(2, dtype=torch.bfloat16)}
    stacked = stack_worker_copies(one)
    assert stacked["w"].shape == (1, 2, 3) and stacked["b"].shape == (1, 2)
    back = unstack_to_devices(stacked, None, "cpu")
    assert back["b"].dtype == torch.bfloat16
    assert all(torch.equal(back[k], one[k]) for k in one)


# ---------------------------------------------------------------------------
# the trainer: crash / resume, elastic 2 -> 1
# ---------------------------------------------------------------------------

RESUME_KW = dict(lr=0.2, density=0.02)
RESUME_BATCH, RESUME_SEQ = 2, 8


class _Crash(Exception):
    pass


def _port_state(state) -> dict:
    from repro_torch.checkpoint.ckpt import flatten, to_numpy
    return {k: to_numpy(v) for k, v in flatten(
        {"params": state.params, "rgc": state.rgc})}


@pytest.mark.parametrize("schedule,residual", [
    ("sequential", "f32"), ("staleK(k=2)", "f32"), ("sequential", "bf16")])
def test_trainer_crash_resume_bitwise(tmp_path, schedule, residual):
    """An 8-step run, and one with ``ckpt_every=2`` that dies after step
    5 (no end save) and is restored at step 4 by a fresh ``Trainer``
    (which builds its own model) with the stream replayed: params, every
    ``LeafState`` field and the pending ring end bitwise equal. The chain
    is full, delta at steps 2, 4 (then full after the resume), and its
    keys, shapes and dtypes are what the reference Trainer saves for the
    same config."""
    import json

    from repro.configs import TrainConfig as JTC
    from repro.configs import get_config
    from repro.train.trainer import Trainer as JTrainer

    from repro_torch.checkpoint import read_manifest
    from repro_torch.configs import paper_lstm
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import bigram_batches
    from repro_torch.train.trainer import Trainer

    tc = TrainConfig(**RESUME_KW, schedule=schedule, residual_dtype=residual)
    cfg = paper_lstm.smoke()

    def data(skip=0):
        it = bigram_batches(cfg.vocab_size, RESUME_BATCH, RESUME_SEQ, seed=0)
        for _ in range(skip):
            next(it)
        return it

    want = Trainer(cfg, tc, device="cpu")
    want = _port_state(want.run(want.init_state(), data(), 8, log_every=0))

    d = str(tmp_path / "ck")
    crashed = Trainer(cfg, tc, device="cpu", ckpt_dir=d, ckpt_every=2)

    def crash(step, density, loss):
        if step == 5:
            raise _Crash
    with pytest.raises(_Crash):
        crashed.run(crashed.init_state(), data(), 8, log_every=0,
                    on_metrics=crash)
    assert [(e["step"], e["kind"]) for e in read_manifest(d)["entries"]] \
        == [(2, "full"), (4, "delta")]
    resumed = Trainer(cfg, tc, device="cpu", ckpt_dir=d, ckpt_every=2)
    state = resumed.restore_checkpoint(4)
    assert state.step == 4
    state = resumed.run(state, data(4), 4, log_every=0)
    got = _port_state(state)
    assert list(got) == list(want)
    for k in want:
        assert _bits(got[k]) == _bits(want[k]), k
    assert [(e["step"], e["kind"]) for e in read_manifest(d)["entries"]][2:] \
        == [(6, "full"), (8, "delta")]
    assert read_manifest(d)["metadata"] == {
        "num_workers": 1, "schedule": schedule, "optimizer": "rgc"}

    jd = str(tmp_path / "jax")
    jt = JTrainer(get_config("paper-lstm", smoke=True),
                  JTC(**RESUME_KW, schedule=schedule,
                      residual_dtype=residual), ckpt_dir=jd)
    jt.save_checkpoint(jt.init_state())
    with open(os.path.join(jd, "step_00000000", "tree.json")) as f:
        jleaves = json.load(f)["leaves"]
    with open(os.path.join(d, "step_00000002", "tree.json")) as f:
        leaves = json.load(f)["leaves"]
    assert list(leaves.items()) == list(jleaves.items())
    assert list(leaves) == list(want)


def test_elastic_two_to_one_matches_reference(
        trainer_run, tmp_path):  # noqa: F811
    """The two-rank group (``_torch_dist_prog._trainer_task``) saved a
    ``stale1`` chain after ``CKPT_STEPS`` steps, one row per rank.
    Restored at one worker by the port (twice) and by the reference's
    ``Trainer.restore_checkpoint`` (its ring reabsorbed into each old
    worker's residual, then the remainder rule): the same bits, params,
    LeafState fields and the zeroed ring; the params are rank 0's, the
    residual the two reabsorbed residuals' sum. A save whose write fails
    on rank 0 raised on both ranks."""
    import shutil

    import jax

    from repro.configs import TrainConfig as JTC
    from repro.configs import get_config
    from repro.train.trainer import Trainer as JTrainer

    from repro_torch.checkpoint import CheckpointManager, read_manifest
    from repro_torch.configs import paper_lstm
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.trainer import Trainer

    src = os.path.join(trainer_run, prog.CKPT_DIR)
    man = read_manifest(src)
    assert man["metadata"] == {"num_workers": 2, "schedule": "stale1",
                               "optimizer": "rgc"}
    assert [e["step"] for e in man["entries"]] == [prog.CKPT_STEPS]
    d = str(tmp_path / "ck")
    shutil.copytree(src, d)
    kw = dict(**prog.TRAINER_KW, schedule="stale1")
    got = [_port_state(Trainer(paper_lstm.smoke(), TrainConfig(**kw),
                               device="cpu", ckpt_dir=d)
                       .restore_checkpoint()) for _ in range(2)]
    assert list(got[0]) == list(got[1])
    assert all(_bits(got[0][k]) == _bits(got[1][k]) for k in got[0])

    js = JTrainer(get_config("paper-lstm", smoke=True), JTC(**kw),
                  ckpt_dir=d).restore_checkpoint()
    assert js.step == prog.CKPT_STEPS
    flat, _ = jax.tree_util.tree_flatten_with_path(
        {"params": js.params, "rgc": js.rgc})
    want = {jax.tree_util.keystr(kp): np.asarray(v) for kp, v in flat}
    assert list(got[0]) == list(want)
    for k in want:
        assert _bits(got[0][k]) == _bits(want[k]), k

    rows = CheckpointManager(d).resolve_flat()
    for k, v in got[0].items():
        if k.startswith("['params']"):
            assert _bits(v) == _bits(rows[k][0]), k
        elif k.startswith("['rgc'].pending"):
            assert not np.any(v), k
    assert any(_bits(got[0][k]) != _bits(rows[k][0]) for k in got[0]
               if k.endswith(".residual"))

    # a save that failed on rank 0 raised on both ranks
    fails = [r["failed_save"] for r in _trainer_ranks(trainer_run)]
    assert fails[0] and fails[0].startswith("FileExistsError"), fails
    assert fails[1] and "rank 0 failed to write the checkpoint" in fails[1]


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_ckpt_resume(tmp_path, capsys):
    """``--ckpt-dir D --ckpt-every 2 --steps 4``, then ``--resume --steps
    6``, ends with the state of an uninterrupted 6-step run (its end
    save), under ``--data bigram`` and ``--data zipf``; ``--resume``
    without ``--ckpt-dir`` exits with the reference's message."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import main

    base = ["--arch", "paper-lstm", "--smoke", "--device", "cpu",
            "--batch", "2", "--seq", "8", "--density", "0.02",
            "--log-every", "0"]
    for data in ("bigram", "zipf"):
        a, b = str(tmp_path / f"{data}_a"), str(tmp_path / f"{data}_b")
        main(base + ["--data", data, "--steps", "4", "--ckpt-dir", a,
                     "--ckpt-every", "2"])
        main(base + ["--data", data, "--steps", "6", "--ckpt-dir", a,
                     "--resume"])
        assert f"resumed from step 4 in {a}" in capsys.readouterr().out
        main(base + ["--data", data, "--steps", "6", "--ckpt-dir", b])
        got, want = (CheckpointManager(x).resolve_flat(6) for x in (a, b))
        _same_flat(got, want)
    bigram = CheckpointManager(str(tmp_path / "bigram_b")).resolve_flat(6)
    assert _bits(bigram["['params']['lm_head']"]) != _bits(
        want["['params']['lm_head']"])
    with pytest.raises(SystemExit, match="--resume requires --ckpt-dir"):
        main(base + ["--resume"])
