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
    ("trimmed_topk", False, 0.01),
    ("trimmed_topk", True, 0.01),
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


def _jit_pinned_stages(monkeypatch):
    """Run the reference's ``multi_select`` and sparse decompression under
    ``jax.jit`` inside an otherwise eager update: their arithmetic is
    pinned or exact (jit and eager agree bitwise), and op by op they
    compile hundreds of tiny programs."""
    import jax

    from repro.core import sync as jsync_lib
    from repro.kernels import segmented as jseg
    orig = jseg.multi_select
    monkeypatch.setattr(jsync_lib, "unpack_decompress", jax.jit(
        jsync_lib.unpack_decompress, static_argnums=(1, 2, 3)))

    def jitted(parts, *, use_pallas, interpret=None):
        static = [(g, sp._replace(refresh=None, cached=None))
                  for _, g, sp, _ in parts]

        def run(dyn):
            return orig([(x, g, sp._replace(refresh=r, cached=c), st)
                         for (x, st, r, c), (g, sp) in zip(dyn, static)],
                        use_pallas=use_pallas, interpret=interpret)
        return jax.jit(run)([(x, st, sp.refresh, sp.cached)
                             for x, _, sp, st in parts])
    monkeypatch.setattr(jseg, "multi_select", jitted)


@pytest.mark.parametrize("fuse_acc,momentum,bf16", [
    (False, 0.0, False), (True, 0.0, False), (False, 0.9, False),
    (True, 0.9, False), (False, 0.9, True)])
def test_sampled_sync_update_matches_reference(fuse_acc, momentum, bf16,
                                               monkeypatch):
    """``sampled_bsearch`` on every leaf (strides 8, 2, 1, 8, 1 at density
    0.05), per-leaf or fused residual accumulation, bf16 residuals in one
    case. The reference runs under ``jax.jit`` and all but params (the
    unpinned ``p - lr * upd``) are bitwise; with momentum AND its fused
    path it runs eagerly (but for its pinned selection), since under jit
    that path may contract ``m * U + g`` (it allows 1 ulp), and then
    params are bitwise too.
    The port's fused and per-leaf accumulation are bitwise equal to each
    other."""
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.core.gradient_sync import build_gradient_sync as jbuild
    from repro_torch import convert
    from repro_torch.core.gradient_sync import build_gradient_sync as tbuild

    params, grads = _tree(3, 0.5), _tree(4, 1e-2)
    kw = dict(density=0.05, momentum=momentum, fuse_accumulate=fuse_acc)
    jsync = jbuild("sampled_bsearch", residual_dtype=(
        jnp.bfloat16 if bf16 else jnp.float32), **kw)
    rd = torch.bfloat16 if bf16 else torch.float32
    state = _random_state(jsync, params, 5)
    if bf16:
        state = jax.tree.map(
            lambda st: st._replace(residual=np.asarray(
                jnp.asarray(st.residual, jnp.bfloat16))), state,
            is_leaf=lambda x: hasattr(x, "_fields"))

    jsent = []
    jsync.transport.allgather = (
        lambda ms, f=jsync.transport.allgather: jsent.extend(ms) or f(ms))

    def jstep(g, s, p, lr):
        jsent.clear()
        return jsync.update(g, s, p, lr), list(jsent)
    eager = bool(momentum) and fuse_acc
    if eager:
        _jit_pinned_stages(monkeypatch)
    else:
        jstep = jax.jit(jstep)
    (jp, js), jmsgs = jstep(
        *(jax.tree.map(jnp.asarray, t) for t in (grads, state, params)),
        jnp.float32(LR))
    jp, js = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
    is_ls = {"is_leaf": lambda x: hasattr(x, "_fields")}

    outs = []
    for fuse in (fuse_acc, not fuse_acc):
        tsync = tbuild("sampled_bsearch", device="cpu", residual_dtype=rd,
                       **dict(kw, fuse_accumulate=fuse))
        tsent = []
        tsync.transport.allgather = (
            lambda ms, f=tsync.transport.allgather, o=tsent:
            o.extend(ms) or f(ms))
        tp, ts = tsync.update(convert.from_numpy(grads),
                              convert.from_numpy(state),
                              convert.from_numpy(params),
                              torch.tensor(LR, dtype=torch.float32))
        assert all(s.residual.dtype == rd for s in ts.values()
                   if hasattr(s, "residual"))
        outs.append((convert.to_numpy(tp), convert.to_numpy(ts), tsent))
    (tp, ts, tsent), (tp2, ts2, tsent2) = outs

    for a, b, p0 in zip(jax.tree.leaves(tp), jax.tree.leaves(jp),
                        jax.tree.leaves(params)):
        if eager:
            np.testing.assert_array_equal(_bits(a), _bits(b))
        else:
            _assert_fma_close(a, b, p0, p0 - b, ulps=2)
    for w, g in zip(jax.tree.leaves(js, **is_ls),
                    jax.tree.leaves(ts, **is_ls)):
        for fw, fg in zip(w, g):
            fw = np.asarray(fw)
            if fw.dtype.name == "bfloat16":     # the port hands back f32
                fw = fw.astype(np.float32)
            assert np.asarray(fg).dtype == fw.dtype
            np.testing.assert_array_equal(_bits(fg), _bits(fw))
    assert len(jmsgs) == len(tsent) > 0
    for w, g in zip(jmsgs, tsent):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    for a, b in zip(jax.tree.leaves((tp, ts, [m.numpy() for m in tsent])),
                    jax.tree.leaves((tp2, ts2, [m.numpy() for m in tsent2]))):
        np.testing.assert_array_equal(_bits(np.asarray(a, np.float32)),
                                      _bits(np.asarray(b, np.float32)))
