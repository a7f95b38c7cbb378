"""Port parity: selection numerics and selectors.

The same seeded numpy vectors go through ``repro.core.selection`` (JAX,
CPU) and ``repro_torch.core.selection``; pinned scalar arithmetic must be
bitwise equal, selected index/value sets exactly equal."""
import numpy as np
import pytest


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


class _Jitted:
    """The reference selectors under ``jax.jit`` (sizes static), as its
    trainer runs them; their arithmetic is pinned, so jit and eager agree
    bitwise."""

    STATIC = {"trimmed_topk": (1, 2), "threshold_binary_search": (1, 2),
              "exact_topk": (1,), "threshold_filter": (2,)}

    def __getattr__(self, name):
        import jax

        from repro.core import selection
        fn = getattr(selection, name)
        if name in self.STATIC:
            return jax.jit(fn, static_argnums=self.STATIC[name])
        return fn


def _mods():
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    from repro_torch.core import selection as tsel
    return torch, jnp, _Jitted(), tsel


def _bits(a) -> np.ndarray:
    a = np.asarray(a, np.float32)
    return a.view(np.int32)


def _vec(n: int, seed: int, tied: bool = False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if tied:        # few distinct magnitudes: every rank is a tie
        return (rng.integers(-4, 5, n) * 0.25).astype(np.float32)
    return rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("n", [7, 1024, 4097])
def test_pinned_sum_bitwise(n):
    torch, jnp, jsel, tsel = _mods()
    v = np.abs(_vec(n, n))
    want = jsel.pinned_sum(jnp.asarray(v))
    got = tsel.pinned_sum(torch.from_numpy(v))
    assert _bits(got.numpy()) == _bits(want)
    want_m = jsel.mean_of_sum(want, n)
    got_m = tsel.mean_of_sum(got, n)
    assert _bits(got_m.numpy()) == _bits(want_m)


@pytest.mark.parametrize("n", [33])
def test_scalar_pins_bitwise(n):
    """threshold_at, bisect_midpoint, ladder_ratio and warm_ratio,
    elementwise over seeded vectors (including degenerate spans)."""
    torch, jnp, jsel, tsel = _mods()
    rng = np.random.default_rng(n)
    mean = np.abs(rng.standard_normal(n)).astype(np.float32)
    mx = (mean + np.abs(rng.standard_normal(n))).astype(np.float32)
    mx[::5] = mean[::5]                       # span 0 -> warm ratio 0
    ratio = rng.random(n).astype(np.float32)
    thr = (mean + rng.standard_normal(n)).astype(np.float32)
    step = rng.integers(0, 12, n).astype(np.int32)
    eps = np.float32(0.2)
    t = torch.from_numpy

    pairs = [
        (jsel.threshold_at(jnp.asarray(mean), jnp.asarray(mx),
                           jnp.asarray(ratio)),
         tsel.threshold_at(t(mean), t(mx), t(ratio))),
        (jsel.bisect_midpoint(jnp.asarray(mean), jnp.asarray(mx)),
         tsel.bisect_midpoint(t(mean), t(mx))),
        (jsel.ladder_ratio(jnp.asarray(step), eps),
         tsel.ladder_ratio(t(step), eps)),
        (jsel.warm_ratio(jnp.asarray(thr), jnp.asarray(mean),
                         jnp.asarray(mx)),
         tsel.warm_ratio(t(thr), t(mean), t(mx))),
    ]
    for want, got in pairs:
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _assert_same_selection(want, got):
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(_bits(got.values.numpy()),
                                  _bits(want.values))
    assert int(got.count) == int(want.count)
    if want.overflow is not None:
        assert bool(got.overflow) == bool(want.overflow)


CASES = [(1000, False), (4096, True)]


@pytest.mark.parametrize("n,tied", CASES)
def test_threshold_filter_equal(n, tied):
    torch, jnp, jsel, tsel = _mods()
    x = _vec(n, 11, tied)
    for thr, cap in ((0.5, 16), (0.5, 4 * n), (0.0, 32)):
        want = jsel.threshold_filter(jnp.asarray(x), jnp.float32(thr), cap)
        got = tsel.threshold_filter(torch.from_numpy(x),
                                    torch.tensor(thr), cap)
        _assert_same_selection(want, got)


@pytest.mark.parametrize("n,tied", CASES)
def test_trimmed_topk_equal(n, tied):
    torch, jnp, jsel, tsel = _mods()
    x = _vec(n, 12, tied)
    for k in (10, n // 3):
        want = jsel.trimmed_topk(jnp.asarray(x), k, 0.2)
        got = tsel.trimmed_topk(torch.from_numpy(x), k, 0.2)
        _assert_same_selection(want, got)


@pytest.mark.parametrize("n,tied", CASES)
def test_threshold_binary_search_equal(n, tied):
    """Cold and warm-started bisection, and the reuse short-circuit."""
    torch, jnp, jsel, tsel = _mods()
    x = _vec(n, 13, tied)
    for k in (3, 40):
        for warm in (None, 1.5):
            jw = None if warm is None else jnp.float32(warm)
            tw = None if warm is None else torch.tensor(warm)
            want, wthr = jsel.threshold_binary_search(
                jnp.asarray(x), k, 1e-3, warm=jw)
            got, gthr = tsel.threshold_binary_search(
                torch.from_numpy(x), k, 1e-3, warm=tw)
            assert _bits(gthr.numpy()) == _bits(wthr)
            _assert_same_selection(want, got)
        want, _ = jsel.threshold_binary_search(jnp.asarray(x), k, 1e-3,
                                               jnp.float32(0.7))
        got, _ = tsel.threshold_binary_search(torch.from_numpy(x), k, 1e-3,
                                              torch.tensor(0.7))
        _assert_same_selection(want, got)


def test_exact_topk_ties_lowest_index_first():
    """``jax.lax.top_k`` breaks ties lowest index first; the port's
    stable sort must give the same picks on an all-tied vector."""
    torch, jnp, jsel, tsel = _mods()
    x = _vec(513, 14, tied=True)
    for k in (17, 200):
        _assert_same_selection(jsel.exact_topk(jnp.asarray(x), k),
                               tsel.exact_topk(torch.from_numpy(x), k))
