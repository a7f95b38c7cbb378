"""Port tests of the transport layer and the stage timer, mirroring
``tests/test_transport.py`` on ``repro_torch`` alone: bucket assignment,
registration, ``intra_axis`` resolution, the builder's and the trainer's
transport knobs, single-worker parity of every transport with the fused
one, the stage set, ``WallClockTimer`` / ``NullTimer`` and the
``select_overflow`` counter. Plus parity of the timer's summary with the
JAX ``WallClockTimer``'s on the same config (arena and per-leaf paths),
the API protocols, and the launcher's transport flags."""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")


# ---------------------------------------------------------------------------
# bucket-boundary assignment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbytes,budget,want", [
    ([100, 100, 100], 250, [[0, 1], [2]]),
    ([100, 200, 50, 50, 300, 10], 300, [[0, 1], [2, 3], [4], [5]]),
    ([150, 150], 300, [[0, 1]]),                 # an exact fit is kept
    ([150, 151], 300, [[0], [1]]),
    ([500], 300, [[0]]),                         # oversized: own bucket
    ([10, 500, 10], 300, [[0], [1], [2]]),
    ([], 300, []),
], ids=["pinned", "pinned2", "exact-fit", "one-over", "oversized",
        "oversized-middle", "empty"])
def test_assign_buckets_pinned(nbytes, budget, want):
    from repro.core.transport import assign_buckets as jassign
    from repro_torch.core.transport import assign_buckets
    assert assign_buckets(nbytes, budget) == want == jassign(nbytes, budget)


def test_assign_buckets_total_and_invalid():
    from repro_torch.core.transport import assign_buckets
    rng = np.random.default_rng(0)
    sizes = [int(s) for s in rng.integers(1, 5000, size=200)]
    buckets = assign_buckets(sizes, 8192)
    assert [i for b in buckets for i in b] == list(range(len(sizes)))
    assert all(buckets)
    with pytest.raises(ValueError):
        assign_buckets([10], 0)


# ---------------------------------------------------------------------------
# registration, construction, knobs
# ---------------------------------------------------------------------------

def test_five_transports_registered_as_reference():
    import repro.core  # noqa: F401 (registrations)
    from repro.core import registry as jreg
    from repro_torch.core import registry
    names = set(registry.names(registry.TRANSPORT))
    assert names == {"fused_allgather", "bucketed_allgather", "hierarchical",
                     "per_leaf_allgather", "dense_psum"}
    assert names == set(jreg.names(jreg.TRANSPORT))


def test_hierarchical_axis_resolution():
    from repro_torch.core.transport import HierarchicalAllgather
    t = HierarchicalAllgather(("node", "local"))
    assert t.intra_axis == "local" and t.inter_axes == ("node",)
    t = HierarchicalAllgather(("pod", "data"), intra_axis="pod")
    assert t.intra_axis == "pod" and t.inter_axes == ("data",)
    t = HierarchicalAllgather(("data",))
    assert t.intra_axis is None and t.inter_axes == ("data",)
    with pytest.raises(ValueError):
        HierarchicalAllgather(("node", "local"), intra_axis="bogus")


def test_builder_threads_transport_knobs():
    from repro_torch.core import build_gradient_sync
    sync = build_gradient_sync("rgc", transport="bucketed_allgather",
                               bucket_bytes=12345, device="cpu")
    assert sync.transport.bucket_bytes == 12345
    sync = build_gradient_sync("rgc", transport="hierarchical",
                               sync_axes=("node", "local"), device="cpu")
    assert sync.transport.intra_axis == "local"
    sync = build_gradient_sync("rgc", transport="hierarchical",
                               sync_axes=("node", "local"),
                               intra_axis="node", device="cpu")
    assert sync.transport.intra_axis == "node"
    # sync axes without a mesh: nothing to count the workers over
    with pytest.raises(ValueError, match="need a mesh"):
        sync.transport.num_workers()


def test_trainer_passes_transport_knobs():
    """``make_gradient_sync`` hands ``tc.bucket_bytes`` / ``tc.intra_axis``
    and the mesh's batch axes to the transport, as the reference does."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.trainer import make_gradient_sync
    sync = make_gradient_sync(
        TrainConfig(transport="bucketed_allgather", bucket_bytes=12345),
        "cpu")
    assert sync.transport.bucket_bytes == 12345
    assert sync.transport.sync_axes == ()
    mesh = types.SimpleNamespace(axis_names=("node", "local"))
    sync = make_gradient_sync(
        TrainConfig(transport="hierarchical", intra_axis="node"), "cpu",
        mesh)
    assert sync.transport.sync_axes == ("node", "local")
    assert sync.transport.intra_axis == "node"
    assert sync.transport.mesh is mesh


def test_launcher_transport_flags(monkeypatch):
    """``--transport`` / ``--bucket-bytes`` reach the TrainConfig; a model
    axis in ``--mesh`` raises before any process group is joined."""
    from repro_torch.launch import train as launch
    from repro_torch.train import trainer

    seen = []

    class Stop(Exception):
        pass

    def fake(cfg, tc, device=None, **kw):
        seen.append(tc)
        raise Stop
    monkeypatch.setattr(trainer, "Trainer", fake)
    with pytest.raises(Stop):
        launch.main(["--arch", "paper-lstm", "--smoke", "--device", "cpu",
                     "--transport", "bucketed_allgather", "--bucket-bytes",
                     "777"])
    assert seen[-1].transport == "bucketed_allgather"
    assert seen[-1].bucket_bytes == 777
    with pytest.raises(NotImplementedError, match="model axis"):
        launch.main(["--arch", "paper-lstm", "--smoke", "--device", "cpu",
                     "--mesh", "2x2"])


def test_protocols_hold_for_the_port():
    from repro_torch.core import (STAGES, Compressor, Correction,
                                  DispatchPolicy, NullTimer, Schedule,
                                  StageTimer, Transport, WallClockTimer,
                                  build_gradient_sync, registry)
    from repro_torch.core.correction import MomentumCorrection
    assert STAGES
    sync = build_gradient_sync("rgc", device="cpu")
    for name in registry.names(registry.TRANSPORT):
        assert isinstance(registry.make(registry.TRANSPORT, name), Transport)
    for name in ("dense", "trimmed_topk", "threshold_bsearch",
                 "sampled_bsearch"):
        assert isinstance(sync.compressor(name), Compressor)
    assert isinstance(sync.policy, DispatchPolicy)
    assert isinstance(sync.schedule, Schedule)
    assert isinstance(MomentumCorrection(0.9, False), Correction)
    assert isinstance(NullTimer(), StageTimer)
    assert isinstance(WallClockTimer(), StageTimer)


# ---------------------------------------------------------------------------
# single-worker bitwise parity: every transport agrees with fused at p = 1
# ---------------------------------------------------------------------------

def _tree():
    rng = np.random.default_rng(0)
    return {"a": rng.standard_normal(50_000).astype(np.float32),
            "b": rng.standard_normal(40_000).astype(np.float32),
            "c": rng.standard_normal(500).astype(np.float32)}


@pytest.mark.parametrize("transport,kw", [
    ("bucketed_allgather", {"bucket_bytes": 30_000}),
    ("hierarchical", {}),
    ("per_leaf_allgather", {}),
])
def test_single_worker_parity(transport, kw):
    from repro_torch.core import build_gradient_sync, tree

    params = {k: torch.from_numpy(v) for k, v in _tree().items()}
    grads = {k: v * 0.01 for k, v in params.items()}

    def run(name, **tkw):
        sync = build_gradient_sync("rgc", transport=name, density=0.01,
                                   dense_threshold_bytes=4096, device="cpu",
                                   **tkw)
        st = sync.init(params)
        return sync.update(grads, st, params, torch.tensor(0.1))

    ref_p, ref_s = run("fused_allgather")
    got_p, got_s = run(transport, **kw)
    for a, b in zip(tree.flatten(ref_p)[0], tree.flatten(got_p)[0]):
        assert torch.equal(a, b)
    for a, b in zip(tree.flatten(ref_s)[0], tree.flatten(got_s)[0]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_single_worker_parity_quantized():
    """The same with quantized leaves (``rgc_quant``: "a" binary search
    and "b" trimmed top-k per leaf, ``[count | indices | mean]``
    messages; "embed" unquantized in an arena), for the bucketed,
    hierarchical and per-leaf transports; the bucketed transport buckets
    the quantized messages by their own byte sizes."""
    from repro_torch.core import (WallClockTimer, assign_buckets,
                                  build_gradient_sync, tree)

    params = {k: torch.from_numpy(v) for k, v in _tree().items()}
    params["embed"] = params.pop("c")
    grads = {k: v * 0.01 for k, v in params.items()}

    def run(name, **tkw):
        timer = WallClockTimer()
        sync = build_gradient_sync("rgc_quant", transport=name,
                                   density=0.01, dense_threshold_bytes=1024,
                                   trimmed_threshold_bytes=180_000,
                                   device="cpu", timer=timer, **tkw)
        sent = []
        gather = sync.transport.allgather
        sync.transport.allgather = lambda ms: sent.extend(ms) or gather(ms)
        st = sync.init(params)
        out = sync.update(grads, st, params, torch.tensor(0.1))
        return out, sent, timer.summary()["counts"]

    (ref_p, ref_s), ref_msgs, _ = run("fused_allgather")
    for transport, kw in (("bucketed_allgather", {"bucket_bytes": 4_500}),
                          ("hierarchical", {}),
                          ("per_leaf_allgather", {})):
        (got_p, got_s), msgs, counts = run(transport, **kw)
        assert [m.numel() for m in msgs] == [m.numel() for m in ref_msgs]
        assert [m.numel() for m in msgs] == [1 + 5 + 5, 1 + 1000 + 1,
                                             1 + 400 + 1]
        if transport == "bucketed_allgather":
            want = assign_buckets([4 * m.numel() for m in msgs],
                                  kw["bucket_bytes"])
            assert counts["buckets"] == len(want) == 2
        for a, b in zip(tree.flatten(ref_p)[0], tree.flatten(got_p)[0]):
            assert torch.equal(a, b), transport
        for a, b in zip(tree.flatten(ref_s)[0], tree.flatten(got_s)[0]):
            for x, y in zip(a, b):
                assert torch.equal(x, y), transport
        assert [int(s.phase) for s in tree.flatten(got_s)[0]] == [1, 1, 0]


# ---------------------------------------------------------------------------
# the stage timer
# ---------------------------------------------------------------------------

def test_stage_set_pinned():
    from repro.core import STAGES as JSTAGES
    from repro_torch.core import STAGES
    assert STAGES == ("accumulate", "select", "mask", "pack", "transfer",
                      "unpack") == JSTAGES


def test_wallclock_timer_records_stages():
    from repro_torch.core import STAGES, WallClockTimer, build_gradient_sync

    rng = np.random.default_rng(1)
    params = {"w": torch.from_numpy(rng.standard_normal(60_000)
                                    .astype(np.float32)),
              "b": torch.from_numpy(rng.standard_normal(100)
                                    .astype(np.float32))}
    grads = {k: v * 0.01 for k, v in params.items()}
    timer = WallClockTimer()
    sync = build_gradient_sync("rgc", transport="bucketed_allgather",
                               density=0.01, dense_threshold_bytes=4096,
                               timer=timer, device="cpu")
    assert sync.transport.timer is timer     # one hook, shared
    sync.update(grads, sync.init(params), params, torch.tensor(0.1))
    summ = timer.summary()
    for stage in STAGES:
        assert summ["stages"][stage]["calls"] >= 1
        assert summ["stages"][stage]["total_s"] >= 0.0
    assert summ["counts"]["buckets"] >= 1
    assert abs(sum(s["share"] for s in summ["stages"].values()) - 1.0) < 1e-9
    timer.set_lane("chunk0")
    timer.stage("select", lambda: None)
    assert set(timer.summary()["lanes"]) == {"chunk0"}
    timer.reset()
    assert timer.summary() == {"stages": {}, "counts": {}, "total_s": 0}


def test_null_timer_is_passthrough():
    from repro_torch.core import NullTimer
    t = NullTimer()
    assert t.stage("select", lambda: 42) == 42
    t.count("buckets", 3)
    t.set_lane("chunk0")
    assert t.summary() == {}


def test_select_overflow_counted_only_under_an_active_timer():
    """A filter whose threshold lets more than ``capacity`` through flags
    an overflow; an active timer counts it, an inactive one never reads
    the flag (no host sync)."""
    from repro_torch.core import build_gradient_sync
    from repro_torch.core.selection import Selected

    class Recorder:
        def __init__(self, active):
            self.active, self.seen = active, []

        def stage(self, name, thunk):
            return thunk()

        def count(self, name, n=1):
            self.seen.append((name, n))

    flags = [Selected(None, None, None, torch.tensor(True)),
             Selected(None, None, None, torch.tensor(False)),
             Selected(None, None, None)]
    for active in (True, False):
        rec = Recorder(active)
        sync = build_gradient_sync("rgc", timer=rec, device="cpu")
        sync._count_overflow(flags)
        assert rec.seen == ([("select_overflow", 1), ("select_overflow", 0)]
                            if active else [])


@pytest.mark.parametrize("fuse_leaves", [True, False], ids=["arena",
                                                            "per-leaf"])
def test_timer_summary_keys_and_counts_match_reference(fuse_leaves):
    """Two eager updates (refresh, then threshold reuse) of a tree with a
    bisection leaf, a trimmed leaf and a dense leaf: the port's summary
    has the JAX timer's stage names and calls, and the same counters
    (``dispatch_*``, ``messages``, ``collectives``, ``buckets``,
    ``select_overflow``) with the same values."""
    import jax.numpy as jnp

    from repro.core import WallClockTimer as JTimer
    from repro.core import build_gradient_sync as jbuild
    from repro_torch.core import WallClockTimer, build_gradient_sync

    rng = np.random.default_rng(3)
    np_params = {"w": rng.standard_normal(60_000).astype(np.float32),
                 "m": rng.standard_normal(20_000).astype(np.float32),
                 "b": rng.standard_normal(100).astype(np.float32)}
    np_grads = [{k: (rng.standard_normal(v.shape) * 0.01).astype(np.float32)
                 for k, v in np_params.items()} for _ in range(2)]
    kw = dict(transport="bucketed_allgather", bucket_bytes=4096,
              density=0.01, dense_threshold_bytes=4096,
              trimmed_threshold_bytes=100_000, fuse_leaves=fuse_leaves)

    jt = JTimer()
    jsync = jbuild("rgc", timer=jt, **kw)
    jp = {k: jnp.asarray(v) for k, v in np_params.items()}
    js = jsync.init(jp)
    for g in np_grads:
        jp, js = jsync.update({k: jnp.asarray(v) for k, v in g.items()},
                              js, jp, jnp.float32(0.1))

    tt = WallClockTimer()
    tsync = build_gradient_sync("rgc", timer=tt, device="cpu", **kw)
    tp = {k: torch.from_numpy(v) for k, v in np_params.items()}
    ts = tsync.init(tp)
    for g in np_grads:
        tp, ts = tsync.update({k: torch.from_numpy(v) for k, v in g.items()},
                              ts, tp, torch.tensor(0.1))

    want, got = jt.summary(), tt.summary()
    assert sorted(got) == sorted(want)
    assert list(got["stages"]) == list(want["stages"])
    assert {n: s["calls"] for n, s in got["stages"].items()} == \
        {n: s["calls"] for n, s in want["stages"].items()}
    assert got["counts"] == want["counts"]
    assert "select_overflow" in got["counts"]
    assert want["counts"]["buckets"] > 1
