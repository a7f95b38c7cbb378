"""Port parity for the legacy ``rgc`` entry points and the composed sync
they build, on the four ``PARITY_CFGS`` of ``test_api.py``.

Each configuration goes through both packages'
``gradient_sync_from_rgc_config`` on the smoke ``paper-lstm`` tree with
the same lowered §5.5 byte thresholds (so the sparse leaves take both
trimmed top-k and the binary search), for 3 steps. Every step starts
both packages from the reference's params and state of the step before
(the reference's update runs under ``jax.jit``, once compiled per
configuration), so each step is compared on its own:

* packed messages: count and indices bitwise, values bitwise, the
  quantized wire mean within ``WIRE_RTOL`` relative (the reference's
  sum order is XLA's);
* state: residual, momentum, threshold, phase and interval bitwise, but
  a dense leaf's momentum (the reference's unpinned ``m * u + g``: 1 ulp
  of its larger operand);
* params: 2 ulp (the unpinned ``p - lr * upd``, as in
  ``test_torch_sync.py``), plus ``lr * |upd| * WIRE_RTOL`` on quantized
  leaves, and on dense leaves ``lr`` times the dense momentum's 1-ulp
  gap (``upd`` is that momentum).

This holds ``clip_wd_nesterov_unfused`` (``local_clip``, weight decay,
Nesterov, per-leaf messages) against the composed reference sync; the
reference's own legacy-monolith test of it stays as it is.
"""
import dataclasses

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


WIRE_RTOL = 2e-6
LR = 0.1
_TH = dict(dense_threshold_bytes=1024, trimmed_threshold_bytes=64 * 1024)


def _cfgs(RGCConfig, **extra):
    return {
        "rgc_mix": RGCConfig(density=0.02, momentum=0.9, sync_axes=(),
                             bsearch_interval=2, **_TH, **extra),
        "rgc_quant": RGCConfig(density=0.02, momentum=0.0, quantize=True,
                               sync_axes=(), **_TH, **extra),
        "dense_warmup": RGCConfig(density=1.0, momentum=0.9, sync_axes=(),
                                  **_TH, **extra),
        "clip_wd_nesterov_unfused": RGCConfig(
            density=0.02, momentum=0.9, nesterov=True, weight_decay=1e-4,
            local_clip=1.0, fuse_messages=False, sync_axes=(), **_TH,
            **extra),
    }


def _params():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.models.registry import get_model
    cfg = get_config("paper-lstm", smoke=True)
    model = get_model(dataclasses.replace(cfg, dtype=jnp.float32))
    return jax.tree.map(np.asarray, model.init_params(0))


def _grads(params, step):
    import jax
    leaves, treedef = jax.tree.flatten(params)
    out = [(np.random.default_rng(1000 * step + j).standard_normal(p.shape)
            * 0.1).astype(np.float32) for j, p in enumerate(leaves)]
    return jax.tree.unflatten(treedef, out)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _spy(sync):
    sent = []
    gather = sync.transport.allgather
    sync.transport.allgather = lambda ms: sent.extend(ms) or gather(ms)
    return sent


def _ulp_close(got, want, scale, ulps, extra=0.0):
    gap = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert np.all(gap <= ulps * np.spacing(scale) + extra), float(np.max(gap))


@pytest.mark.parametrize("cfg_name", ["rgc_mix", "rgc_quant", "dense_warmup",
                                      "clip_wd_nesterov_unfused"])
def test_rgc_config_sync_matches_reference(cfg_name):
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.core.rgc import RGCConfig as JCfg
    from repro.core.rgc import gradient_sync_from_rgc_config as jfrom
    from repro_torch import convert
    from repro_torch.core.rgc import RGCConfig as TCfg
    from repro_torch.core.rgc import gradient_sync_from_rgc_config as tfrom

    jcfg, tcfg = _cfgs(JCfg)[cfg_name], _cfgs(TCfg)[cfg_name]
    jsync, tsync = jfrom(jcfg), tfrom(tcfg, device="cpu")
    params = _params()
    jsent, tsent = _spy(jsync), _spy(tsync)

    def jstep(g, s, p, lr):
        jsent.clear()
        return jsync.update(g, s, p, lr), list(jsent)
    jstep = jax.jit(jstep)

    is_ls = {"is_leaf": lambda x: hasattr(x, "_fields")}
    state = jax.tree.map(np.asarray, jsync.init(params))
    tinit = convert.to_numpy(tsync.init(convert.from_numpy(params)))
    for w, g in zip(jax.tree.leaves(state, **is_ls),
                    jax.tree.leaves(tinit, **is_ls)):
        for fw, fg in zip(w, g):
            np.testing.assert_array_equal(_bits(fg), _bits(fw))

    paths = [jax.tree_util.keystr(kp) for kp, _ in
             jax.tree_util.tree_flatten_with_path(params)[0]]
    comps = {p: jsync._leaf_compressor(
        jsync.policy.compressor_for(p, leaf), p).name
        for p, leaf in zip(paths, jax.tree.leaves(params))}
    if cfg_name != "dense_warmup":
        names = {n.replace("quantized(", "").rstrip(")")
                 for n in comps.values()}
        assert {"trimmed_topk", "threshold_bsearch"} <= names
    quant = [n.startswith("quantized") for n in comps.values()]
    assert any(quant) == (cfg_name == "rgc_quant")
    for (p, name), leaf in zip(comps.items(), jax.tree.leaves(params)):
        assert tsync._leaf_compressor(tsync.policy.compressor_for(
            p, torch.from_numpy(leaf)), p).name == name

    lr = np.float32(LR)
    for step in range(3):
        grads = _grads(params, step)
        (jp, js), jmsgs = jstep(grads, state, params, lr)
        jp, js = jax.tree.map(np.asarray, jp), jax.tree.map(np.asarray, js)
        tsent.clear()
        tp, ts = tsync.update(convert.from_numpy(grads),
                              convert.from_numpy(state),
                              convert.from_numpy(params),
                              torch.tensor(LR, dtype=torch.float32))
        tp, ts = convert.to_numpy(tp), convert.to_numpy(ts)

        plan = next(iter(tsync._plans.values()))
        mq = [False] * len(plan.groups) + [c.quantized
                                           for _, c, _ in plan.sparse]
        assert len(jmsgs) == len(tsent) == len(mq)
        assert (len(mq) > 0) == (cfg_name != "dense_warmup")
        for w, g, q in zip(jmsgs, tsent, mq):
            w, g = np.asarray(w), g.numpy()
            assert w.shape == g.shape
            cut = -1 if q else None
            np.testing.assert_array_equal(_bits(g[:cut]), _bits(w[:cut]),
                                          err_msg=f"step {step} message")
            if q:
                np.testing.assert_allclose(g[-1], w[-1], rtol=WIRE_RTOL,
                                           atol=0)

        for path, q, w, g, s0, g0 in zip(
                paths, quant, jax.tree.leaves(js, **is_ls),
                jax.tree.leaves(ts, **is_ls),
                jax.tree.leaves(state, **is_ls), jax.tree.leaves(grads)):
            dense = comps[path] == "dense" or tcfg.density >= 1.0
            for fname, fw, fg in zip(w._fields, w, g):
                assert np.asarray(fg).dtype == np.asarray(fw).dtype
                if dense and fname == "momentum" and tcfg.momentum:
                    _ulp_close(fg, fw, np.maximum.reduce([
                        np.abs(tcfg.momentum * s0.momentum), np.abs(g0),
                        np.abs(fw)]), 1)
                else:
                    np.testing.assert_array_equal(
                        _bits(fg), _bits(fw),
                        err_msg=f"step {step} {path} {fname}")
        for q, a, b, p0, s0, s1, g0 in zip(
                quant, jax.tree.leaves(tp), jax.tree.leaves(jp),
                jax.tree.leaves(params), jax.tree.leaves(state, **is_ls),
                jax.tree.leaves(js, **is_ls), jax.tree.leaves(grads)):
            upd = np.abs(p0 - b)
            extra = upd * WIRE_RTOL if q else 0.0
            if tcfg.density >= 1.0 and tcfg.momentum:
                # the dense momentum's 1-ulp gap, carried by lr * u
                extra = LR * np.spacing(np.maximum.reduce([
                    np.abs(tcfg.momentum * s0.momentum), np.abs(g0),
                    np.abs(s1.momentum)]))
            _ulp_close(a, b, np.maximum.reduce([np.abs(p0), upd, np.abs(b)]),
                       2, extra=extra)
        params, state = jp, js


def test_rgc_init_apply_and_leaf_method_match_reference():
    """The shims: ``rgc_init`` == the reference's bitwise; one
    ``rgc_apply`` == the port's own ``GradientSync.update`` bitwise and
    the reference's within its FMA allowance; ``leaf_method`` and
    ``leaf_bytes`` agree per leaf."""
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.core import rgc as jrgc
    from repro_torch import convert
    from repro_torch.core import rgc as trgc
    params = _params()
    jcfg = jrgc.RGCConfig(density=0.02, sync_axes=(), **_TH)
    tcfg = trgc.RGCConfig(density=0.02, sync_axes=(), **_TH)
    assert tcfg.residual_dtype == torch.float32 and tcfg.backend == "jnp"
    for leaf in jax.tree.leaves(params):
        t = torch.from_numpy(leaf)
        assert trgc.leaf_method(t, tcfg) == jrgc.leaf_method(
            jnp.asarray(leaf), jcfg)
        assert trgc.leaf_bytes(t) == jrgc.leaf_bytes(jnp.asarray(leaf))
    tp0 = convert.from_numpy(params)
    ts0 = trgc.rgc_init(tp0, tcfg, device="cpu")
    js0 = jax.tree.map(np.asarray, jrgc.rgc_init(params, jcfg))
    is_ls = {"is_leaf": lambda x: hasattr(x, "_fields")}
    for w, g in zip(jax.tree.leaves(js0, **is_ls),
                    jax.tree.leaves(convert.to_numpy(ts0), **is_ls)):
        for fw, fg in zip(w, g):
            np.testing.assert_array_equal(_bits(fg), _bits(fw))
    grads = _grads(params, 0)
    lr = torch.tensor(LR, dtype=torch.float32)
    tp, ts = trgc.rgc_apply(convert.from_numpy(grads), tp0, ts0, lr=lr,
                            cfg=tcfg, device="cpu")
    sync = trgc.gradient_sync_from_rgc_config(tcfg, device="cpu")
    assert not sync.compressor("threshold_bsearch").warm_start
    sp, ss = sync.update(convert.from_numpy(grads), ts0, tp0, lr)
    for a, b in zip(jax.tree.leaves([convert.to_numpy(t) for t in (tp, ts)]),
                    jax.tree.leaves([convert.to_numpy(t) for t in (sp, ss)])):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    jp, _ = jax.jit(lambda g, p, s: jrgc.rgc_apply(
        g, p, s, lr=jnp.float32(LR), cfg=jcfg))(grads, params, js0)
    for a, b, p0 in zip(jax.tree.leaves(convert.to_numpy(tp)),
                        jax.tree.leaves(jp), jax.tree.leaves(params)):
        b = np.asarray(b)
        _ulp_close(a, b, np.maximum.reduce([np.abs(p0), np.abs(p0 - b)]), 2)


def test_no_quant_paths_keep_embed_and_lm_head_unquantized():
    """The port's ``keystr`` paths match the reference's substring rule:
    under ``rgc_quant`` the embedding table and the output layer stay
    unquantized (and fused into the arena); every other sparse leaf is
    quantized and per leaf."""
    pytest.importorskip("torch")
    from repro_torch import convert
    from repro_torch.core import tree
    from repro_torch.core.gradient_sync import build_gradient_sync
    params = convert.from_numpy(_params())
    sync = build_gradient_sync("rgc_quant", device="cpu", **_TH)
    paths = [p for p, _ in tree.flatten_with_paths(params)]
    leaves = tree.flatten(params)[0]
    plan = sync._plan(tree.structure(params), tuple(paths), leaves, 0.01,
                      False)
    arena_paths = {s.path for g in plan.groups for s in g.slots}
    assert arena_paths == {"['embed']['table']", "['lm_head']"}
    per_leaf = {paths[i]: c for i, c, _ in plan.sparse}
    assert set(per_leaf) == set(paths) - arena_paths
    assert all(c.quantized for c in per_leaf.values())
