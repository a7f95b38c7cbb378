"""Port parity: one ``GradientSync.update`` step.

Identical numpy params, gradients and optimizer state (random residual
and velocity, cached thresholds, refresh and reuse intervals) go through
``repro.core.gradient_sync`` (JAX, under ``jax.jit`` as its trainer runs
it) and ``repro_torch.core.gradient_sync`` on the CPU. The tree is small
and the §5.5 byte thresholds are lowered so one step holds dense,
trimmed and bsearch leaves. Residual, sparse-leaf momentum, thresholds,
intervals and the packed wire messages must be bitwise equal.

The reference's ``p - lr * upd`` and dense ``m * u + g`` are not
contraction-pinned, so XLA may fuse either into an FMA, whose single
rounding differs from two roundings by up to 1 ulp of the larger
operand (near cancellation the result's own ulp is far smaller). So
dense-leaf momentum is held to 1 ulp of its larger operand, and params,
which on a dense leaf see both unpinned multiply-adds in a chain, to 2.
"""
import numpy as np
import pytest

LR = 0.1
THRESHOLDS = dict(dense_threshold_bytes=1024, trimmed_threshold_bytes=8192)


def _tree(seed, scale):
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    # sizes: 3072 + 4000 bsearch, 1200 trimmed, 50 + 17 dense (rgc)
    return {"a": r(64, 48), "b": r(40, 30), "c": r(50),
            "d": {"e": r(100, 40), "f": r(17)}}


def _random_state(sync, params, seed):
    """The reference's init state with random residual / velocity and a
    mix of refresh (interval 0) and reuse (interval 3) leaves."""
    import jax
    import jax.numpy as jnp

    from repro.core.residual import LeafState
    rng = np.random.default_rng(seed)
    state = jax.tree.map(np.asarray, sync.init(
        jax.tree.map(jnp.asarray, params)))

    def fill(st):
        shape = st.residual.shape
        mom = (st.momentum if st.momentum.ndim == 0 else
               (rng.standard_normal(shape) * 1e-3).astype(np.float32))
        return LeafState(
            (rng.standard_normal(shape) * 1e-3).astype(np.float32), mom,
            np.float32(abs(rng.standard_normal()) * 2e-3),
            np.int32(0), np.int32(rng.integers(0, 2) * 3))
    return jax.tree.map(fill, state,
                        is_leaf=lambda x: isinstance(x, LeafState))


def _assert_fma_close(got, want, *operands, ulps=1):
    """|got - want| <= ``ulps`` ulp of the largest of ``operands`` and
    ``want`` (elementwise): the gap fused vs unfused multiply-adds leave."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.maximum.reduce([np.abs(np.asarray(o, np.float32))
                               for o in (*operands, want)])
    assert np.all(np.abs(got - want) <= ulps * np.spacing(scale)), \
        float(np.max(np.abs(got - want) / np.spacing(scale)))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("optimizer,fuse,density", [
    ("rgc", True, 0.01),
    ("rgc", False, 0.01),
    ("threshold_bsearch", True, 0.01),
    ("threshold_bsearch", False, 0.01),
    ("rgc", True, 1.0),
])
def test_gradient_sync_update_matches_reference(optimizer, fuse, density):
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.core.gradient_sync import build_gradient_sync as jbuild
    from repro_torch import convert
    from repro_torch.core.gradient_sync import build_gradient_sync as tbuild

    params, grads = _tree(0, 0.5), _tree(1, 1e-2)
    kw = dict(density=density, fuse_leaves=fuse, **THRESHOLDS)
    jsync = jbuild(optimizer, **kw)
    tsync = tbuild(optimizer, device="cpu", **kw)
    state = _random_state(jsync, params, 2)

    jsent, tsent = [], []
    jsync.transport.allgather = (
        lambda ms, f=jsync.transport.allgather: jsent.extend(ms) or f(ms))
    tsync.transport.allgather = (
        lambda ms, f=tsync.transport.allgather: tsent.extend(ms) or f(ms))

    def jstep(g, s, p, lr):
        jsent.clear()
        return jsync.update(g, s, p, lr), list(jsent)
    (jp, js), jmsgs = jax.jit(jstep)(
        *(jax.tree.map(jnp.asarray, t) for t in (grads, state, params)),
        jnp.float32(LR))
    tp, ts = tsync.update(convert.from_numpy(grads),
                          convert.from_numpy(state),
                          convert.from_numpy(params),
                          torch.tensor(LR, dtype=torch.float32))

    is_ls = {"is_leaf": lambda x: hasattr(x, "_fields")}
    jp, js = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    tp, ts = convert.to_numpy(tp), convert.to_numpy(ts)
    for a, b, p0 in zip(jax.tree.leaves(tp), jax.tree.leaves(jp),
                        jax.tree.leaves(params)):
        _assert_fma_close(a, b, p0, p0 - b, ulps=2)
    jls = jax.tree.leaves(js, **is_ls)
    tls = jax.tree.leaves(ts, **is_ls)
    assert len(jls) == len(tls) == len(jax.tree.leaves(params))
    dense = [density >= 1.0 or (optimizer == "rgc" and p.size * 4 < 1024)
             for p in jax.tree.leaves(params)]
    s0 = jax.tree.leaves(state, **is_ls)
    for w, g, is_dense, st, g0 in zip(jls, tls, dense, s0,
                                      jax.tree.leaves(grads)):
        for name, fw, fg in zip(w._fields, w, g):
            assert np.asarray(fg).dtype == np.asarray(fw).dtype
            if is_dense and name == "momentum":
                _assert_fma_close(fg, fw, 0.9 * st.momentum, g0)
            else:
                np.testing.assert_array_equal(_bits(fg), _bits(fw))
    assert len(jmsgs) == len(tsent)
    assert bool(tsent) == (density < 1.0)
    for w, g in zip(jmsgs, tsent):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


@pytest.mark.parametrize("momentum,nesterov,wd", [
    (0.9, False, 0.0), (0.9, True, 1e-4), (0.0, False, 1e-4)])
def test_residual_accumulate_and_masks_match_reference(momentum, nesterov,
                                                       wd):
    """``accumulate``, ``accumulate_arena`` and the communicated-coordinate
    masks, eagerly on both sides (bitwise)."""
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    from repro.core import residual as jres
    from repro_torch.core import residual as tres
    rng = np.random.default_rng(9)
    g, p, v, u = (rng.standard_normal((37, 29)).astype(np.float32)
                  for _ in range(4))
    idx = np.asarray([0, 5, 37 * 29 - 1, 37 * 29, 400], np.int32)
    kw = dict(momentum=momentum, nesterov=nesterov, weight_decay=wd)
    js = jres.LeafState(jnp.asarray(v), jnp.asarray(u), jnp.float32(0),
                        jnp.int32(0), jnp.int32(0))
    ts = tres.LeafState(*(torch.from_numpy(np.array(a)) for a in js))
    want = jres.accumulate(jnp.asarray(g), jnp.asarray(p), js, **kw)
    got = tres.accumulate(torch.from_numpy(g), torch.from_numpy(p), ts, **kw)
    for w, t in zip(want, got):
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(w))
    want = jres.mask_communicated(want, jnp.asarray(idx), momentum=True)
    got = tres.mask_communicated(got, torch.from_numpy(idx), momentum=True)
    for w, t in zip(want, got):
        np.testing.assert_array_equal(_bits(t.numpy()), _bits(w))
    wv, wu = jres.accumulate_arena(jnp.asarray(g), jnp.asarray(v),
                                   jnp.asarray(u), jnp.asarray(p), **kw)
    tv, tu = tres.accumulate_arena(*(torch.from_numpy(a)
                                     for a in (g, v, u, p)), **kw)
    np.testing.assert_array_equal(_bits(tv.numpy()), _bits(wv))
    assert (tu is None) == (wu is None)
    if wu is not None:
        np.testing.assert_array_equal(_bits(tu.numpy()), _bits(wu))
