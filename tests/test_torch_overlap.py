"""Port parity of the §5.6 overlap schedules (``repro_torch.core.overlap``)
against ``repro.core.overlap``.

The tree, the chunk budget and the §5.5 thresholds are
``tests/test_overlap.py``'s (three chunks: (small, mid2), mid, big; every
leaf sparse). Each step of the reference runs under ``jax.jit``. The
learning rate is a power of two, so ``lr * upd`` is exact and XLA's
contraction of the reference's ``p - lr * upd`` into one fused
multiply-add rounds as the port's two operations do: params are held
bitwise, like the LeafState fields and the pending messages.
"""
import numpy as np
import pytest

SIZES = {"big": 300_000, "mid": 96 * 1024 + 3, "mid2": 33_001,
         "small": 1_000}
CHUNK_BYTES = 260_000
KW = dict(density=0.01, dense_threshold_bytes=2048, momentum=0.9)
LR = 0.125
STEPS = 4


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


def _inputs(seed=0, sizes=SIZES, steps=STEPS):
    rng = np.random.default_rng(seed)
    params = {k: rng.standard_normal(n).astype(np.float32)
              for k, n in sizes.items()}
    grads = [{k: (rng.standard_normal(n) * 0.01).astype(np.float32)
              for k, n in sizes.items()} for _ in range(steps)]
    return params, grads


def _ref(schedule, params, grads, **kw):
    """The reference's steps, each under jit: (params, state) as numpy
    after every step, and the sync."""
    import jax
    import jax.numpy as jnp

    from repro.core import build_gradient_sync
    sync = build_gradient_sync("rgc", sync_axes=(), schedule=schedule,
                               bucket_bytes=CHUNK_BYTES, **{**KW, **kw})
    p = {k: jnp.asarray(v) for k, v in params.items()}
    st = sync.init(p)
    step = jax.jit(lambda g, s, p: sync.update(g, s, p, jnp.float32(LR)))
    out = []
    for g in grads:
        p, st = step({k: jnp.asarray(v) for k, v in g.items()}, st, p)
        out.append(jax.tree.map(np.asarray, (p, st)))
    return out, sync


def _port(schedule, params, grads, timer=None, **kw):
    """The port's steps on the CPU: (params, state) as numpy after every
    step, and the sync."""
    import torch

    from repro_torch import convert
    from repro_torch.core import build_gradient_sync
    sync = build_gradient_sync("rgc", schedule=schedule, device="cpu",
                               bucket_bytes=CHUNK_BYTES, timer=timer,
                               **{**KW, **kw})
    p = convert.from_numpy(params)
    st = sync.init(p)
    out = []
    for g in grads:
        p, st = sync.update(convert.from_numpy(g), st, p,
                            torch.tensor(LR, dtype=torch.float32))
        out.append(convert.to_numpy((p, st)))
    return out, sync


def _assert_bitwise(got, want):
    import jax
    la, lb = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(la) == len(lb) and la
    for i, (x, y) in enumerate(zip(la, lb)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, i
        if x.dtype == np.float32:
            x, y = x.view(np.int32), y.view(np.int32)
        assert np.array_equal(x, y), (i, x.shape)


def _check_partition(chunks, sizes, budget):
    """``tests/test_overlap.py``'s invariants of a chunk layout."""
    flat = [i for c in chunks for i in c.leaves]
    assert flat == list(reversed(range(len(sizes))))
    assert [c.cid for c in chunks] == list(range(len(chunks)))
    for c in chunks:
        assert c.nbytes == sum(sizes[i] for i in c.leaves)
        assert c.nbytes <= budget or len(c.leaves) == 1
    for a, b in zip(chunks, chunks[1:]):
        assert a.nbytes + sizes[b.leaves[0]] > budget


def test_partition_chunks_matches_reference():
    """A deterministic grid of sizes and budgets (the reference's grid
    and a seeded one): the same chunks as the reference, with its
    invariants; a budget <= 0 raises ValueError in both."""
    from repro.core.overlap import partition_chunks as ref
    from repro_torch.core import Chunk, partition_chunks
    rng = np.random.default_rng(5)
    grid = [
        ([4], 4), ([4], 1), ([1, 2, 3, 4, 5], 5), ([5, 4, 3, 2, 1], 5),
        ([10, 10, 10], 10), ([10, 10, 10], 30), ([10, 10, 10], 29),
        ([100, 1, 1, 1, 100], 3), ([7] * 13, 20), ([1] * 64, 8),
        ([1 << 22, 128, 1 << 22], 1 << 20),
    ] + [(list(rng.integers(1, 5000, rng.integers(1, 40))),
          int(rng.integers(1, 20_000))) for _ in range(40)]
    for sizes, budget in grid:
        got = partition_chunks(sizes, budget)
        assert all(isinstance(c, Chunk) for c in got)
        assert [tuple(c) for c in got] == [tuple(c) for c in
                                           ref(sizes, budget)]
        _check_partition(got, sizes, budget)
    for budget in (0, -4):
        for fn in (ref, partition_chunks):
            with pytest.raises(ValueError):
                fn([1, 2], budget)


def test_schedule_spec_grammar_matches_reference():
    """``parse_schedule_spec`` and ``make_schedule``: the grammar, the
    kwargs (spec over params), the registry names and the exception
    types are the reference's."""
    from repro.core import overlap as jov
    from repro_torch.core import overlap as tov
    from repro_torch.core import registry
    good = ("sequential", "chunked", "stale1", "staleK", "staleK(k=3)",
            " staleK ( k = 2 ) ", "foo(a=1.5, b=bar)", "staleK(k=1,)")
    for spec in good:
        assert tov.parse_schedule_spec(spec) == jov.parse_schedule_spec(spec)
    for bad in ("staleK(3)", "staleK(k=3", "stale K", "(k=1)",
                "staleK(k=1))", ""):
        for mod in (jov, tov):
            with pytest.raises(ValueError):
                mod.parse_schedule_spec(bad)
    assert set(registry.names(registry.SCHEDULE)) == {
        "sequential", "chunked", "stale1", "staleK"}
    for spec, params in (("sequential", {}), ("chunked", {}),
                         ("stale1", {}), ("staleK", {}),
                         ("staleK(k=3)", {}), ("staleK", {"k": 5}),
                         ("staleK(k=3)", {"k": 5}), ("stale1", {"k": 5})):
        got = tov.make_schedule(spec, **params)
        want = jov.make_schedule(spec, **params)
        assert type(got).__name__ == type(want).__name__
        assert got.name == want.name
        assert getattr(got, "k", None) == getattr(want, "k", None)
    for spec, exc in (("nope", KeyError), ("staleK(k=0)", ValueError),
                      ("staleK(k=", ValueError)):
        for mod in (jov, tov):
            with pytest.raises(exc):
                mod.make_schedule(spec)


def test_chunked_matches_reference_and_sequential():
    """``chunked`` equals the reference's ``chunked`` and the port's own
    ``sequential`` bitwise after every step (params and LeafState), with
    the arenas on (per-chunk arena ids 1000 * cid) and off; it issues one
    collective per chunk, under the timer lanes ``chunk0..2``."""
    from repro_torch.core import WallClockTimer
    params, grads = _inputs()
    for fuse in (True, False):
        timer = WallClockTimer()
        got, sync = _port("chunked", params, grads, timer=timer,
                          fuse_leaves=fuse)
        want, _ = _ref("chunked", params, grads, fuse_leaves=fuse)
        seq, _ = _port("sequential", params, grads, fuse_leaves=fuse)
        for t in range(STEPS):
            _assert_bitwise(got[t], want[t])
            _assert_bitwise(got[t], seq[t])
        plans = next(v for k, v in sync._plans.items() if "chunked" in k)
        assert len(plans) == 3
        aids = [g.aid for plan in plans for g in plan.groups]
        assert aids == ([0, 1000, 2000] if fuse else [])
        counts = timer.summary()["counts"]
        assert counts["collectives"] == 3 * STEPS
        assert sorted(timer.summary()["lanes"]) == ["chunk0", "chunk1",
                                                    "chunk2"]


def _stale_runs():
    params, grads = _inputs(seed=1)
    return params, grads, {
        spec: (_port(spec, params, grads), _ref(spec, params, grads))
        for spec in ("stale1", "staleK(k=1)", "staleK(k=2)")}


@pytest.fixture(scope="module")
def stale_runs():
    pytest.importorskip("torch")
    return _stale_runs()


def test_stale_schedules_match_reference(stale_runs):
    """``stale1``, ``staleK(k=1)`` and ``staleK(k=2)`` equal the reference
    bitwise after every step on params, LeafState and the pending
    messages; the first K steps apply nothing (every leaf is sparse);
    ``staleK(k=1)`` is ``stale1`` with the ring one level deeper; a dense
    step (density 1.0) carries the ring through untouched; a plain
    state, a ring of the wrong length and an intermediate density raise
    the reference's exceptions."""
    import jax.numpy as jnp
    import torch

    from repro_torch import convert
    params, grads, runs = stale_runs
    for spec, ((got, tsync), (want, jsync)) in runs.items():
        for t in range(STEPS):
            _assert_bitwise(got[t], want[t])
        k = 1 if spec == "stale1" else tsync.schedule.k
        for t in range(k):
            _assert_bitwise(got[t][0], params)
        assert any(not np.array_equal(got[k][0][n], params[n])
                   for n in params)
    (s1, _), _ = runs["stale1"]
    (k1, _), _ = runs["staleK(k=1)"]
    for a, b in zip(s1, k1):
        _assert_bitwise((a[0], a[1].leaf, a[1].pending),
                        (b[0], b[1].leaf, b[1].pending[0]))

    (got, tsync), (_, jsync) = runs["staleK(k=2)"]
    p, st = (convert.from_numpy(x) for x in got[-1])
    lr = torch.tensor(LR, dtype=torch.float32)
    _, dense_st = tsync.update(convert.from_numpy(grads[0]), st, p, lr,
                               density=1.0)
    _assert_bitwise(convert.to_numpy(dense_st.pending), got[-1][1].pending)
    assert any(m.any() for gen in got[-1][1].pending for m in gen)

    jp = {n: jnp.asarray(v) for n, v in params.items()}
    jg = {n: jnp.asarray(v) for n, v in grads[0].items()}
    for sync, pp, gg, lr_ in ((tsync, p, convert.from_numpy(grads[0]), lr),
                              (jsync, jp, jg, jnp.float32(LR))):
        state = sync.init(pp)
        with pytest.raises(ValueError, match="fixed target density"):
            sync.update(gg, state, pp, lr_, density=0.25)
        with pytest.raises(TypeError):
            sync.update(gg, state.leaf, pp, lr_)
        with pytest.raises(ValueError, match="ring of length"):
            sync.update(gg, state._replace(pending=state.pending[:1]), pp,
                        lr_)


def test_reabsorb_pending_matches_reference(stale_runs):
    """``reabsorb_pending`` of the final ``stale1`` and ``staleK(k=2)``
    states equals the reference's bitwise, leaves its input untouched,
    passes a plain LeafState tree through, and after one ``stale1`` step
    from init restores the pre-mask residual (the step's gradient)."""
    import jax
    import jax.numpy as jnp
    import torch

    from repro.core.overlap import reabsorb_pending as jreabsorb
    from repro_torch import convert
    from repro_torch.core.overlap import reabsorb_pending
    params, grads, runs = stale_runs
    for spec in ("stale1", "staleK(k=2)"):
        (got, tsync), (want, jsync) = runs[spec]
        tp, tst = (convert.from_numpy(x) for x in got[-1])
        jp, jst = jax.tree.map(jnp.asarray, want[-1])
        out = convert.to_numpy(reabsorb_pending(tsync, tp, tst))
        _assert_bitwise(out, jax.tree.map(np.asarray,
                                          jreabsorb(jsync, jp, jst)))
        _assert_bitwise(convert.to_numpy(tst), got[-1][1])
        assert reabsorb_pending(tsync, tp, tst.leaf) is tst.leaf
        for n in params:        # something was in flight
            assert not np.array_equal(out[n].residual,
                                      got[-1][1].leaf[n].residual)

    (_, tsync), _ = runs["stale1"]
    p = convert.from_numpy(params)
    _, st = tsync.update(convert.from_numpy(grads[0]), tsync.init(p), p,
                         torch.tensor(LR, dtype=torch.float32))
    out = convert.to_numpy(reabsorb_pending(tsync, p, st))
    for n, g in grads[0].items():
        assert np.array_equal(out[n].residual.view(np.int32),
                              g.view(np.int32)), n


def test_trainer_schedules():
    """``Trainer`` with ``chunked`` (four chunks at smoke width) is
    bitwise ``sequential`` (params and state, four steps); with
    ``stale1`` its losses are the JAX trainer's within rtol 1e-4."""
    import jax

    from repro.configs import TrainConfig as JTC
    from repro.configs import get_config
    from repro.data import bigram_batches as jbigram
    from repro.train.trainer import Trainer as JTrainer
    from repro_torch import convert
    from repro_torch.configs import paper_lstm
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core import ScheduleState, tree
    from repro_torch.data import bigram_batches
    from repro_torch.train.trainer import Trainer

    base = dict(lr=0.2, optimizer="rgc", density=0.01)
    jtr = JTrainer(get_config("paper-lstm", smoke=True),
                   JTC(**base, schedule="stale1"))
    jstate = jtr.init_state()
    params = jax.tree.map(np.asarray, jstate.params)
    want = []
    jtr.run(jstate, jbigram(512, 2, 16, seed=0), STEPS, log_every=0,
            on_metrics=lambda s, d, loss: want.append(loss))

    def run(**kw):
        tr = Trainer(paper_lstm.smoke(), TrainConfig(**base, **kw),
                     device="cpu")
        state = tr.init_state(params=convert.from_numpy(params))
        losses = []
        state = tr.run(state, bigram_batches(512, 2, 16, seed=0), STEPS,
                       log_every=0,
                       on_metrics=lambda s, d, loss: losses.append(loss))
        return losses, state, tr

    got, st1, _ = run(schedule="stale1")
    assert len(got) == STEPS and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert isinstance(st1.rgc, ScheduleState)

    _, seq, _ = run(schedule="sequential")
    _, chk, tr = run(schedule="chunked", bucket_bytes=300_000)
    plans = next(v for k, v in tr._sync._plans.items() if "chunked" in k)
    assert len(plans) == 4
    assert isinstance(seq.rgc, dict) and isinstance(chk.rgc, dict)
    for a, b in ((chk.params, seq.params), (chk.rgc, seq.rgc)):
        _assert_bitwise(convert.to_numpy(a), convert.to_numpy(b))
    assert tree.structure(chk.rgc) == tree.structure(seq.rgc)


def test_launcher_schedule_flag(capsys):
    """``--schedule "staleK(k=2)"`` trains; a malformed or unknown spec
    fails before any work (nothing printed, no step)."""
    pytest.importorskip("torch")
    from repro_torch.launch import train
    common = ["--arch", "paper-lstm", "--smoke", "--steps", "3",
              "--batch", "2", "--seq", "16", "--density", "0.02",
              "--device", "cpu", "--log-every", "1"]
    train.main(common + ["--schedule", "staleK(k=2)"])
    out = capsys.readouterr().out
    assert "schedule=staleK(k=2)" in out
    losses = [float(line.split()[-1]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 3 and all(np.isfinite(losses))
    for spec, exc in (("staleK(k=2", ValueError), ("stale2", KeyError)):
        with pytest.raises(exc):
            train.main(common + ["--schedule", spec])
        assert capsys.readouterr().out == ""
