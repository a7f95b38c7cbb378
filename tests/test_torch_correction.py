"""Port parity for the DGC corrections (``repro_torch.core.correction``).

Mirrors ``test_correction.py``: the registry, aliases and spec grammar;
``local_clip_scale`` and ``LocalClip`` (bitwise against the reference
under ``jax.jit``); ``factor_masking``, on a scalar velocity as well;
``warmup`` and its default ramp; spec corrections adding to the config
fields; and ``scheduled_density`` driving the port's ``Trainer``. Then
one ``GradientSync.update`` of ``"factor_masking+warmup(rgc)"`` with
``local_clip`` against the reference's.
"""
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


CORRECTIONS = ["momentum", "factor_masking", "local_clip", "warmup"]


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _np_grads(shapes, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def test_registry_aliases_and_params():
    pytest.importorskip("torch")
    from repro_torch.core import registry
    from repro_torch.core.api import Correction
    from repro_torch.core.correction import (FactorMasking, LocalClip,
                                             MomentumCorrection, Warmup)
    names = registry.names(registry.CORRECTION)
    assert set(CORRECTIONS) | {"clip", "masking"} == set(names)
    for name in names:
        assert isinstance(registry.make(registry.CORRECTION, name),
                          Correction)
    assert isinstance(registry.make(registry.CORRECTION, "clip"), LocalClip)
    assert isinstance(registry.make(registry.CORRECTION, "masking"),
                      FactorMasking)
    assert isinstance(registry.make(registry.CORRECTION, "warmup"), Warmup)
    m = registry.make(registry.CORRECTION, "momentum", momentum=0.7,
                      nesterov=True, unrelated=1)
    assert isinstance(m, MomentumCorrection) and m.momentum == 0.7
    assert registry.make(registry.CORRECTION, "clip",
                         local_clip=2.5).clip_norm == 2.5
    assert registry.make(registry.CORRECTION, "clip").clip_norm == 1.0
    # per-leaf hooks decide the arena path, as in the reference
    assert LocalClip().arena_safe() and FactorMasking().arena_safe()
    assert FactorMasking.arena_mask_momentum


SPECS = [
    "rgc", "quantized(trimmed_topk)", "momentum",
    "momentum+clip(threshold_bsearch)", "momentum+clip+threshold_bsearch",
    "momentum(clip(threshold_bsearch))", "warmup(rgc)",
    "warmup+momentum+clip(dense)", "momentum(quantized(trimmed_topk))",
    "factor_masking+warmup(rgc)", "nope+momentum",
    "clip(threshold_bsearch)+warmup", "momentum+nope+rgc"]


def test_spec_grammar_matches_reference():
    pytest.importorskip("torch")
    import repro.core  # noqa: F401 (registrations)
    from repro.core.correction import split_corrections as jsplit
    from repro_torch.core.correction import split_corrections as tsplit
    for spec in SPECS:
        try:
            want = jsplit(spec)
        except ValueError:
            with pytest.raises(ValueError):
                tsplit(spec)
            continue
        assert tsplit(spec) == want, spec


def test_build_rejects_unknown():
    pytest.importorskip("torch")
    from repro_torch.core.gradient_sync import build_gradient_sync
    for bad in ("momentum+nope", "nope", "quantized(dense)",
                "quantized(sampled_bsearch)"):
        with pytest.raises(ValueError):
            build_gradient_sync(bad, device="cpu")


def test_local_clip_scale_matches_reference_bitwise():
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.core.residual import local_clip_scale as jscale
    from repro_torch.core.residual import local_clip_scale as tscale
    for sq, clip, workers in ((4.0, 1.0, 4), (0.01, 1.0, 2),
                              (1e-30, 1.0, 1), (0.0, 2.5, 3),
                              (123.456, 0.3, 64), (7.0, 1.0, 1)):
        want = jax.jit(jscale, static_argnums=(1, 2))(jnp.float32(sq), clip,
                                                      workers)
        got = tscale(torch.tensor(sq, dtype=torch.float32), clip, workers)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want),
                                      err_msg=f"{sq} {clip} {workers}")


def test_local_clip_on_grads_matches_reference_bitwise():
    """Clipping (scale < 1) and pass-through (scale == 1) cases; the
    squared norm's pinned sums in tree order from int 0, then the
    separately rounded product; bf16 leaves come back f32, as JAX
    promotes them."""
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.core.correction import LocalClip as JClip
    from repro_torch.core.correction import LocalClip as TClip
    for workers, scale, bf16 in ((4, 1.0, False), (1, 1e-3, False),
                                 (2, 0.1, False), (2, 1.0, True)):
        grads = _np_grads([(32, 5), (7,), (300,)], seed=workers,
                          scale=scale)
        jg = [jnp.asarray(g, jnp.bfloat16 if bf16 else jnp.float32)
              for g in grads]
        want = jax.jit(lambda gs: JClip(1.0).on_grads(gs, gs, workers))(jg)
        tg = [torch.from_numpy(g).to(torch.bfloat16 if bf16
                                     else torch.float32) for g in grads]
        got = TClip(1.0).on_grads(tg, tg, workers)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            assert np.asarray(w).dtype == np.float32
            np.testing.assert_array_equal(
                _bits(g.numpy()), _bits(w),
                err_msg=f"workers {workers} scale {scale} bf16 {bf16}")


def test_factor_masking_matches_reference():
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    from repro.core.correction import FactorMasking as JMask
    from repro.core.residual import init_leaf as jinit
    from repro_torch.core.correction import FactorMasking as TMask
    from repro_torch.core.residual import init_leaf as tinit
    u = np.random.default_rng(3).standard_normal((6, 5)).astype(np.float32)
    idx = np.asarray([0, 7, 29, 30, 3], np.int32)    # 30 == size: padding
    js = jinit(jnp.zeros((6, 5)), momentum=True)._replace(
        momentum=jnp.asarray(u))
    ts = tinit(torch.zeros((6, 5)), momentum=True)._replace(
        momentum=torch.from_numpy(u))
    want = JMask().on_communicated(js, jnp.asarray(idx))
    got = TMask().on_communicated(ts, torch.from_numpy(idx))
    np.testing.assert_array_equal(_bits(got.momentum.numpy()),
                                  _bits(want.momentum))
    assert float(got.momentum[0, 0]) == 0 and float(got.momentum[0, 1]) != 0
    # a scalar velocity placeholder is left as it is
    st = tinit(torch.zeros(4), momentum=False)
    out = TMask().on_communicated(st, torch.tensor([0, 1]))
    assert out.momentum.shape == () and out is st


def test_warmup_ramp_matches_reference():
    pytest.importorskip("torch")
    from repro.core import registry as jreg
    from repro_torch.core import registry
    from repro_torch.core.correction import Warmup
    for kw in (dict(density=0.001), dict(density=0.01,
                                         warmup_steps_per_stage=5),
               dict(density=0.01, warmup_steps_per_stage=5,
                    dense_warmup=True),
               dict(density=0.02, warmup_steps_per_stage=2,
                    warmup_stages=(0.5, 0.1))):
        want = jreg.make(jreg.CORRECTION, "warmup", **kw)
        got = registry.make(registry.CORRECTION, "warmup", **kw)
        for step in range(0, 130, 3):
            assert got.density_at(step, kw["density"]) == \
                want.density_at(step, kw["density"])
    w = registry.make(registry.CORRECTION, "warmup", density=0.001)
    assert w.density_at(0, 0.001) == 0.25
    assert w.schedule.warmup_steps_per_stage == \
        Warmup.DEFAULT_STEPS_PER_STAGE == 25
    assert w.density_at(100, 0.001) == 0.001


def test_spec_corrections_add_to_config_fields():
    """The ``momentum`` / ``local_clip`` fields stay the switches for
    their corrections; the pipeline order and the policy equal the
    reference's."""
    pytest.importorskip("torch")
    from repro.core.gradient_sync import build_gradient_sync as jbuild
    from repro_torch.core.gradient_sync import build_gradient_sync as tbuild
    for spec, kw in (
            ("clip(threshold_bsearch)", dict(momentum=0.9, local_clip=1.0)),
            ("clip(threshold_bsearch)", dict(momentum=0.0, local_clip=1.0)),
            ("momentum+clip", dict(local_clip=1.0)),
            ("warmup(rgc)", dict(momentum=0.9, local_clip=1.0)),
            ("factor_masking+warmup(rgc)", dict(local_clip=1.0)),
            ("rgc_quant", dict(local_clip=0.5)),
            ("masking+momentum(rgc)", dict(momentum=0.5))):
        want, got = jbuild(spec, **kw), tbuild(spec, device="cpu", **kw)
        what = f"{spec} {kw}"
        assert [c.name for c in got.corrections] == \
            [c.name for c in want.corrections], what
        assert type(got.policy).__name__ == type(want.policy).__name__, what
        assert got.quantize == want.quantize, what
        assert got._arena_ok == want._arena_ok, what


def test_scheduled_density_drives_port_trainer():
    pytest.importorskip("torch")
    from repro_torch.configs import paper_lstm
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.gradient_sync import build_gradient_sync
    from repro_torch.train.trainer import Trainer
    sync = build_gradient_sync("warmup+momentum(rgc)", device="cpu",
                               density=0.01, warmup_steps_per_stage=2,
                               dense_warmup=True)
    assert sync.scheduled_density(0) == 1.0
    assert sync.scheduled_density(8) == 0.01
    assert build_gradient_sync("rgc", device="cpu").scheduled_density(0) \
        is None
    tc = TrainConfig(optimizer="warmup+momentum+clip(threshold_bsearch)",
                     density=0.01, local_clip=1.0,
                     warmup_steps_per_stage=2, dense_warmup=True)
    tr = Trainer(paper_lstm.smoke(), tc, device="cpu")
    assert [tr.density_at(s) for s in (0, 7, 8)] == [1.0, 1.0, 0.01]
    tr = Trainer(paper_lstm.smoke(), TrainConfig(
        optimizer="warmup(rgc)", density=0.001, warmup_steps_per_stage=3),
        device="cpu")
    assert [tr.density_at(s) for s in (0, 3, 6, 9, 12)] == \
        [0.25, 0.0625, 0.015625, 0.004, 0.001]


def test_explicit_spec_matches_implicit_fields_bitwise():
    """``"momentum+clip(threshold_bsearch)"`` == ``"threshold_bsearch"``
    with the ``momentum`` / ``local_clip`` fields, over 3 updates."""
    torch = pytest.importorskip("torch")
    from repro_torch.core.gradient_sync import build_gradient_sync
    kw = dict(density=0.02, momentum=0.9, nesterov=True, local_clip=1.0,
              weight_decay=1e-4, dense_threshold_bytes=32, device="cpu")
    syncs = [build_gradient_sync(s, **kw) for s in
             ("momentum+clip(threshold_bsearch)", "threshold_bsearch")]

    def tree(seed):
        w, b = _np_grads([(400, 50), (16,)], seed)
        return {"w": torch.from_numpy(w), "b": torch.from_numpy(b)}
    outs = []
    for sync in syncs:
        p = tree(1)
        st = sync.init(p)
        for step in range(3):
            p, st = sync.update(tree(10 + step), st, p, torch.tensor(0.1))
        outs.append([p["b"], p["w"], *st["b"], *st["w"]])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_masking_warmup_clip_update_matches_reference():
    """One update of ``"factor_masking+warmup(rgc)"`` with ``local_clip``
    (momentum 0.9, lowered byte thresholds: arena, trimmed and dense
    leaves) against the reference's under ``jax.jit``: residual, momentum
    of the sparse leaves, thresholds and messages bitwise."""
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.core.gradient_sync import build_gradient_sync as jbuild
    from repro_torch import convert
    from repro_torch.core.gradient_sync import build_gradient_sync as tbuild
    kw = dict(density=0.01, local_clip=1.0, warmup_steps_per_stage=2,
              dense_threshold_bytes=1024, trimmed_threshold_bytes=8192)
    spec = "factor_masking+warmup(rgc)"
    jsync, tsync = jbuild(spec, **kw), tbuild(spec, device="cpu", **kw)
    shapes = {"a": (64, 48), "b": (40, 30), "c": (50,), "e": (100, 40)}
    p_np = dict(zip(shapes, _np_grads(shapes.values(), 0, 0.5)))
    g_np = dict(zip(shapes, _np_grads(shapes.values(), 1, 1.0)))
    density = jsync.scheduled_density(0)
    assert density == tsync.scheduled_density(0) == 0.25
    jsent, tsent = [], []
    jsync.transport.allgather = (
        lambda ms, f=jsync.transport.allgather: jsent.extend(ms) or f(ms))
    tsync.transport.allgather = (
        lambda ms, f=tsync.transport.allgather: tsent.extend(ms) or f(ms))

    def jstep(g, s, p):
        jsent.clear()
        return jsync.update(g, s, p, jnp.float32(0.1), density=density)[1], \
            list(jsent)
    state = jax.tree.map(np.asarray, jsync.init(p_np))
    js, jmsgs = jax.jit(jstep)(g_np, state, p_np)
    _, ts = tsync.update(convert.from_numpy(g_np), convert.from_numpy(state),
                         convert.from_numpy(p_np), torch.tensor(0.1),
                         density=density)
    assert len(jmsgs) == len(tsent) > 0
    for w, g in zip(jmsgs, tsent):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    is_ls = {"is_leaf": lambda x: hasattr(x, "_fields")}
    ts = convert.to_numpy(ts)
    for key in ("a", "b", "e"):          # the sparse leaves
        for fw, fg in zip(jax.tree.leaves(js[key], **is_ls)[0],
                          jax.tree.leaves(ts[key], **is_ls)[0]):
            np.testing.assert_array_equal(_bits(fg), _bits(fw))
