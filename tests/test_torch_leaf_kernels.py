"""Port parity: the per-leaf kernels' plain twins and the ``kernels.ops``
compositions of the per-leaf path (``fuse_leaves=False``).

The same seeded numpy leaf goes through ``repro.kernels`` (JAX, CPU: the
``ref`` twins, the Pallas kernels in interpret mode, at most 8 rows) and
through the port's wrappers on the CPU, which run the plain twins:

* ``count_gt`` and ``compact_gt`` bitwise against the Pallas kernels and
  ``repro.kernels.ref``; ``compact_gt_exact`` (the exact form, which the
  reference lacks) bitwise against ``repro.core.selection.threshold_filter``;
* ``abs_sum_max``: max bitwise against the Pallas kernel, the sum bitwise
  against ``repro.core.selection.pinned_sum`` and within rtol 1e-6 of the
  Pallas kernel, which adds its rows' sums in sequence (another order);
* ``residual_update`` bitwise against ``repro.core.residual.accumulate``
  and within 1 ulp of the Pallas kernel, whose ``m * U + g`` XLA may
  contract into one FMA (``residual.accumulate`` pins the product).

The compositions (``trimmed_topk``, ``threshold_binary_search``,
``threshold_filter``) are held bitwise to the reference's ``jnp``
selectors: indices, values, count, overflow flag and threshold, on cases
that take each branch (bucket overflow, short pick, both). The CUDA
kernels run only on the card: ``test_cuda_leaf_kernels_match_twins``
(marker ``cuda``); this module imports JAX only inside its CPU tests.
"""
import numpy as np
import pytest

LEAVES = [(1, False), (1000, True), (1024, False), (1025, True),
          (5000, False), (8192, True)]


def _leaf(n, seed, tied=False, scale=1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = (rng.integers(-4, 5, n) * 0.5 if tied else rng.standard_normal(n))
    return (v * scale).astype(np.float32)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("n,tied", LEAVES)
def test_count_and_compact_twins_match_reference(n, tied):
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.kernels import compact as jcompact
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels import threshold_count as jcount
    from repro_torch.kernels import compact, ops, threshold_count
    x = _leaf(n, n, tied)
    x2d, _ = jops._to2d(jnp.asarray(x), 1024)
    xt = torch.from_numpy(x)
    pallas_count = jax.jit(lambda a, t: jcount.count_gt(a, t, interpret=True))
    for thr in (0.0, 0.5, 1.0):
        t = np.float32(thr)
        got = threshold_count.count_gt(xt, torch.tensor(t))
        assert got.dtype == torch.int32
        assert int(got) == int(pallas_count(x2d, t)) == \
            int(jref.count_gt(jnp.asarray(x), t)) == \
            int(ops.nnz_gt(xt.reshape(1, n), torch.tensor(t)))
        for cap in (8, 16):
            w = jcompact.compact_gt(x2d, t, cap, n, interpret=True)
            r = jref.compact_gt(jnp.asarray(x), t, 1024, cap)
            g = compact.compact_gt(xt, torch.tensor(t), cap)
            for gi, wi, ri in zip(g, w, r):
                np.testing.assert_array_equal(_bits(gi.numpy()), _bits(wi))
                np.testing.assert_array_equal(_bits(gi.numpy()), _bits(ri))


@pytest.mark.parametrize("n,tied", LEAVES)
def test_compact_gt_exact_twin_matches_reference(n, tied):
    """The exact form is the reference's first-capacity filter: values,
    indices and padding bitwise."""
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    from repro.core import selection as jsel
    from repro_torch.kernels import compact
    x = _leaf(n, n + 5, tied)
    xt = torch.from_numpy(x)
    for thr in (0.0, 0.5, 1.0):
        t = torch.tensor(np.float32(thr))
        for capacity in sorted({1, min(n, 50), n}):
            gv, gi = compact.compact_gt_exact(xt, t, capacity)
            want = jsel.threshold_filter(jnp.asarray(x), np.float32(thr),
                                         capacity)
            assert gi.dtype == torch.int32 and gv.dtype == torch.float32
            np.testing.assert_array_equal(gi.numpy(),
                                          np.asarray(want.indices))
            np.testing.assert_array_equal(_bits(gv.numpy()),
                                          _bits(want.values))


@pytest.mark.parametrize("n,tied", LEAVES)
def test_abs_sum_max_twin_matches_reference(n, tied):
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    from repro.core.selection import pinned_sum
    from repro.kernels import block_stats as jstats
    from repro.kernels import ops as jops
    from repro_torch.kernels import block_stats
    x = _leaf(n, n + 1, tied)
    ws, wm = jstats.abs_sum_max(jops._to2d(jnp.asarray(x), 1024)[0],
                                interpret=True)
    gs, gm = block_stats.abs_sum_max(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(gm.numpy()), _bits(wm))
    np.testing.assert_array_equal(_bits(gs.numpy()),
                                  _bits(pinned_sum(jnp.abs(jnp.asarray(x)))))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)


@pytest.mark.parametrize("n,nesterov", [(1, False), (1025, True),
                                        (5000, False), (8192, True)])
def test_residual_update_twin_matches_reference(n, nesterov):
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    from repro.core.residual import LeafState, accumulate
    from repro.kernels import ops as jops
    from repro.kernels import residual_update as jru
    from repro_torch.kernels import residual_update as ru
    g, u, v = (_leaf(n, n + s, scale=sc)
               for s, sc in ((2, 1e-2), (3, 1e-1), (4, 1.0)))
    gu, gv = ru.residual_update(torch.from_numpy(g), torch.from_numpy(u),
                                torch.from_numpy(v), momentum=0.9,
                                nesterov=nesterov)
    st = accumulate(jnp.asarray(g), jnp.zeros(n),
                    LeafState(jnp.asarray(v), jnp.asarray(u), jnp.float32(0),
                              jnp.int32(0), jnp.int32(0)),
                    momentum=0.9, nesterov=nesterov, weight_decay=0.0)
    np.testing.assert_array_equal(_bits(gu.numpy()), _bits(st.momentum))
    np.testing.assert_array_equal(_bits(gv.numpy()), _bits(st.residual))

    # The Pallas kernel's U' may be one FMA: within 1 ulp of the largest
    # of m*U, g and U' (the gap one rounding leaves against two). Its V'
    # is then this twin's V' arithmetic on that U', bit for bit: the FMA
    # is the only difference.
    def rows(a):
        return jops._to2d(jnp.asarray(a), 1024)[0]
    pu, pv = (np.asarray(a).reshape(-1)[:n] for a in jru.residual_update(
        rows(g), rows(u), rows(v), momentum=0.9, nesterov=nesterov,
        interpret=True))
    scale = np.maximum.reduce([np.abs(np.float32(0.9) * u), np.abs(g),
                               np.abs(pu)])
    assert np.all(np.abs(gu.numpy() - pu) <= np.spacing(scale))
    want_v = v + pu
    if nesterov:
        want_v = want_v + g
    np.testing.assert_array_equal(_bits(want_v), _bits(pv))


def _check_selected(got, want, got_thr=None, want_thr=None):
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_array_equal(_bits(got.values.numpy()),
                                  _bits(want.values))
    assert int(got.count) == int(want.count)
    assert (got.overflow is None) == (want.overflow is None)
    if want.overflow is not None:
        assert bool(got.overflow) == bool(want.overflow)
    if want_thr is not None:
        np.testing.assert_array_equal(_bits(got_thr.numpy()),
                                      _bits(want_thr))


def _trimmed_case(case):
    """(leaf, k, eps, branches taken: exact compaction, short pick) for
    one trimmed top-k case."""
    if case == "normal":               # rounded: ties among survivors
        return np.round(_leaf(5000, 20), 1), 25, 0.2, (0, 0)
    if case == "eps0.1":
        return _leaf(6000, 21), 30, 0.1, (0, 0)
    if case == "nnz_below_k":          # 4 nonzeros, k = 10
        x = np.zeros(3000, np.float32)
        x[[5, 700, 1500, 2999]] = [1.0, -2.0, 0.5, 3.0]
        return x, 10, 0.2, (0, 1)
    if case == "overflow":   # 60 large values in the first row, cap 32
        x = _leaf(5000, 22, scale=0.01)
        x[100:160] = np.linspace(5.0, 6.0, 60, dtype=np.float32)
        return x, 20, 0.2, (1, 0)
    # both: 18 nonzeros (two tied) in the first row, cap 16, k = 20
    x = np.zeros(10 * 1024, np.float32)
    x[3:21] = np.linspace(-6.0, 6.0, 18, dtype=np.float32)
    x[20] = x[4]
    return x, 20, 0.2, (1, 1)


@pytest.mark.parametrize("case", ["normal", "eps0.1", "nnz_below_k",
                                  "overflow", "overflow_short"])
def test_ops_trimmed_topk_matches_jnp(case):
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.core import selection as jsel
    from repro_torch.kernels import common, ops
    x, k, eps, taken = _trimmed_case(case)
    want = jax.jit(lambda a: jsel.trimmed_topk(a, k, eps))(jnp.asarray(x))
    before = dict(common.branches)
    got = ops.trimmed_topk(torch.from_numpy(x), k, eps=eps)
    _check_selected(got, want)
    assert tuple(common.branches[b] - before[b] for b in
                 ("exact_compaction", "short_pick")) == taken


@pytest.mark.parametrize("warm", [False, True])
def test_ops_threshold_binary_search_matches_jnp(warm):
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.core import selection as jsel
    from repro_torch.kernels import ops
    x, k = _leaf(7000, 30), 14
    # a warm threshold just below the converged one: probe out of band
    w = np.float32(2.2) if warm else None

    def search(a):
        return jsel.threshold_binary_search(
            a, k, 1e-3, warm=None if w is None else jnp.float32(w))
    want, wthr = jax.jit(search)(jnp.asarray(x))
    got, gthr = ops.threshold_binary_search(
        torch.from_numpy(x), k, eps=1e-3,
        warm=None if w is None else torch.tensor(w))
    _check_selected(got, want, gthr, wthr)


@pytest.mark.parametrize("case", ["reuse", "overflow", "bucket_overflow"])
def test_ops_threshold_filter_matches_jnp(case):
    """Reuse: a cached threshold with room in every bucket. Overflow: a
    threshold whose survivors overflow both the buckets and the message
    capacity (the count saturates, the flag is set). Bucket overflow: 36
    survivors crowd one 32-wide bucket but fit the capacity of 40, so the
    exact list ends in padding."""
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.core import selection as jsel
    from repro_torch.kernels import common, ops
    x = _leaf(6000, 31)
    thr, capacity = {"reuse": (np.float32(2.7), 60),
                     "overflow": (np.float32(0.5), 40),
                     "bucket_overflow": (np.float32(1.0), 40)}[case]
    if case == "bucket_overflow":
        x = x * np.float32(0.01)
        x[1100:1136] = np.linspace(1.5, 3.0, 36, dtype=np.float32) * \
            np.float32(-1) ** np.arange(36)
    want = jax.jit(lambda a, t: jsel.threshold_filter(a, t, capacity))(
        jnp.asarray(x), thr)
    before = common.branches["exact_compaction"]
    got = ops.threshold_filter(torch.from_numpy(x), torch.tensor(thr),
                               capacity)
    _check_selected(got, want)
    assert bool(got.overflow) == (case == "overflow")
    assert common.branches["exact_compaction"] - before == \
        int(case != "reuse")


# The card test imports nothing of JAX (the card's host has none); run it
# there with: python -m pytest --noconftest -m cuda tests/test_torch_*.py

@pytest.mark.cuda
def test_cuda_leaf_kernels_match_twins():
    """On the card: each per-leaf CUDA kernel against its plain twin on
    the same CUDA tensors, on ragged and tied leaves, with threshold 0
    (bucket overflow), a misaligned start (also at a length that is not a
    multiple of 4) and rows crowded wholly above the threshold: counts,
    sum and max bits, buckets at caps 1 to 1024, the exact compaction at
    three capacities, and U'/V' with nesterov off and on, all bitwise."""
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import (block_stats, common, compact, ref,
                                     residual_update, threshold_count)
    before = dict(common.launches)
    for n, tied in LEAVES + [(4999, False), (70_000, False)]:
        leaf = _leaf(n + 1, n, tied)
        crowd = leaf.copy()               # rows 1 and 2 wholly above 4
        crowd[1024:3072] = np.where(crowd[1024:3072] < 0, -4.5, 4.5)
        base = torch.from_numpy(leaf).cuda()
        for x in (base[:n], base[1:],    # aligned, misaligned
                  torch.from_numpy(crowd).cuda()[:n]):
            for thr in (0.0, 1.0):
                t = torch.tensor(thr, device="cuda")
                assert torch.equal(threshold_count.count_gt(x, t),
                                   ref.count_gt(ref.rows(x), t))
                for cap in (1, 8, 16, 1024):
                    got = compact.compact_gt(x, t, cap)
                    for a, b in zip(got, ref.compact_gt(ref.rows(x), t, cap,
                                                        n)):
                        assert torch.equal(a, b)
                for capacity in sorted({1, min(n, 50), n}):
                    for a, b in zip(
                            compact.compact_gt_exact(x, t, capacity),
                            ref.compact_gt_exact(ref.rows(x), t, capacity,
                                                 n)):
                        assert torch.equal(a, b)
            for a, b in zip(block_stats.abs_sum_max(x),
                            ref.abs_sum_max(ref.rows(x), n)):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            for nesterov in (False, True):
                args = (x * 1e-2, x * 0.5, x)
                for a, b in zip(
                        residual_update.residual_update(
                            *args, momentum=0.9, nesterov=nesterov),
                        ref.residual_update(
                            *args, momentum=0.9, nesterov=nesterov)):
                    assert torch.equal(a.view(torch.int32),
                                       b.view(torch.int32))
    for name in ("count_gt", "abs_sum_max", "compact_gt", "compact_gt_exact",
                 "residual_update"):
        assert common.launches[name] > before[name]
