"""Port parity: segmented kernels' plain twins and ``multi_select``.

The same seeded numpy arena goes through ``repro.kernels`` (JAX, CPU:
the ``ref`` twins and the Pallas kernels in interpret mode) and
``repro_torch.kernels``. The twins must match ``repro.kernels.ref``
bitwise; against the Pallas bodies counts and compaction are exact and
sums within rtol 1e-6 (the Pallas stats body accumulates row sums in
sequence, not the pinned tree). The CUDA kernels themselves run only on
the card: ``test_cuda_kernels_match_twins`` (marker ``cuda``).

The strided (sampled) forms and the fused residual-update+stats pass
are held the same way: their twins bitwise to ``repro.kernels.ref`` and
``repro.core.residual.accumulate_arena``, sampled ``multi_select``
bitwise to the reference's jnp backend."""
import numpy as np
import pytest

SIZES = (1500, 1024, 3000)      # ragged 3-slot arena: odd, exact, 3 rows
SEG_KS = (7, 3, 40)
STRIDES = (16, 1, 128)          # sampled strides; 1500 and 3000 not multiples
ALL_STRIDES = tuple(1 << j for j in range(11))
# every stride 1 to 1024 (in both orders) over one-element slots and sizes
# that end mid-row
SMALL_STRIDED_SIZES = (1, 1000, 1025, 5000, 3, 2047, 4097, 1, 20_000,
                       33_333, 1500)


def _groups(sizes=SIZES, ks=SEG_KS, alg="threshold_bsearch"):
    from repro.core import arena as jarena
    from repro_torch.core import arena as tarena
    slots = [(i, f"s{i}", n, k, 2 * k, 1 + 4 * k)
             for i, (n, k) in enumerate(zip(sizes, ks))]
    return (jarena.build_group(0, alg, "float32", slots),
            tarena.build_group(0, alg, "float32", slots))


def _arena(group, seed, tied=False) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = np.zeros(group.total, np.float32)
    for s in group.slots:
        v = (rng.integers(-4, 5, s.size) * 0.5 if tied
             else rng.standard_normal(s.size))
        x[s.offset:s.offset + s.size] = v
    return x.reshape(group.nblocks, 1024)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def test_arena_layout_equal():
    pytest.importorskip("torch")
    jg, tg = _groups()
    assert jg.slots == tg.slots or [vars(s) for s in jg.slots] == \
        [vars(s) for s in tg.slots]
    jgeo, tgeo = jg.geometry, tg.geometry
    for f in ("block_seg", "block_base", "block_size"):
        np.testing.assert_array_equal(getattr(jgeo, f), getattr(tgeo, f))
    assert (jgeo.seg_sizes, jgeo.seg_ks, jgeo.seg_rows) == \
        (tgeo.seg_sizes, tgeo.seg_ks, tgeo.seg_rows)


@pytest.mark.parametrize("tied", [False, True])
def test_twins_match_reference_bitwise(tied):
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro_torch.kernels import segmented as kseg
    jg, tg = _groups()
    g = tg.geometry
    x = _arena(jg, 1, tied)
    xt = torch.from_numpy(x)
    thr = np.asarray([0.9, 1.0, 0.0], np.float32)

    ws, wm = jax.jit(lambda a: jref.seg_abs_sum_max(
        a, g.block_seg, g.block_size, g.n_seg))(jnp.asarray(x))
    gs, gm = kseg.seg_abs_sum_max(xt, g)
    np.testing.assert_array_equal(_bits(gs.numpy()), _bits(ws))
    np.testing.assert_array_equal(_bits(gm.numpy()), _bits(wm))

    wc = jref.seg_count_gt(jnp.asarray(x), g.block_seg, jnp.asarray(thr),
                           g.n_seg)
    gc = kseg.seg_count_gt(xt, g, torch.from_numpy(thr))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))

    for cap in (8, 64):
        w = jax.jit(lambda a, t, cap=cap: jref.seg_compact_gt(
            a, g.block_seg, g.block_base, g.block_size, t, cap))(
                jnp.asarray(x), jnp.asarray(thr))
        got = kseg.seg_compact_gt(xt, g, torch.from_numpy(thr), cap)
        np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(w[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(w[1]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(w[2]))


def test_twins_match_pallas_interpret():
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    from repro.kernels import segmented as jseg
    from repro_torch.kernels import segmented as kseg
    jg, tg = _groups()
    g = tg.geometry
    x = _arena(jg, 2)
    xt = torch.from_numpy(x)
    thr = np.asarray([1.2, 0.4, 2.0], np.float32)

    ws, wm = jseg.seg_abs_sum_max(jnp.asarray(x), g.block_seg, g.n_seg,
                                  interpret=True)
    gs, gm = kseg.seg_abs_sum_max(xt, g)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6)
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))

    wc = jseg.seg_count_gt(jnp.asarray(x), g.block_seg, jnp.asarray(thr),
                           interpret=True)
    np.testing.assert_array_equal(
        kseg.seg_count_gt(xt, g, torch.from_numpy(thr)).numpy(),
        np.asarray(wc))

    w = jseg.seg_compact_gt(jnp.asarray(x), g.block_seg, g.block_base,
                            g.block_size, jnp.asarray(thr), 16,
                            interpret=True)
    got = kseg.seg_compact_gt(xt, g, torch.from_numpy(thr), 16)
    for a, b in zip(got, w):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _spec_pair(kind: str, n_seg: int, seed: int, ks=SEG_KS,
               strides=STRIDES):
    """Matching (reference, port) SegmentSpecs for one arena."""
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    from repro.kernels import segmented as jseg
    from repro_torch.kernels import segmented as kseg
    if kind == "trimmed":
        return (jseg.SegmentSpec(alg="trimmed", eps=0.2),
                kseg.SegmentSpec(alg="trimmed", eps=0.2))
    rng = np.random.default_rng(seed)
    refresh = np.ones(n_seg, bool)
    cached = None
    sampled = kind.startswith("sampled_")
    kind = kind.removeprefix("sampled_")
    warm = kind in ("warm", "reuse")
    if warm:
        cached = np.abs(rng.standard_normal(n_seg)).astype(np.float32) + 0.5
    if kind == "reuse":
        refresh[::2] = False
    # sampled: strided statistics and counts, 3k message capacity
    kw = (dict(strides=strides, capacities=tuple(3 * k for k in ks))
          if sampled else {})
    j = jseg.SegmentSpec(
        alg="bsearch", eps=1e-3, refresh=jnp.asarray(refresh),
        cached=None if cached is None else jnp.asarray(cached), warm=warm,
        **kw)
    t = kseg.SegmentSpec(
        alg="bsearch", eps=1e-3, refresh=torch.from_numpy(refresh),
        cached=None if cached is None else torch.from_numpy(cached),
        warm=warm, **kw)
    return j, t


def _check_multi(parts_np, kinds, **spec_kw):
    """The reference runs under ``jax.jit`` (its selection arithmetic is
    pinned, so jit and eager agree bitwise)."""
    torch = pytest.importorskip("torch")
    import jax
    import jax.numpy as jnp

    from repro.kernels import segmented as jseg
    from repro_torch.kernels import segmented as kseg
    jparts, tparts = [], []
    for (x, jg, tg), kind, seed in zip(parts_np, kinds, range(10)):
        js, ts = _spec_pair(kind, tg.geometry.n_seg, seed, **spec_kw)
        jparts.append((jnp.asarray(x), jg.geometry, js, None))
        tparts.append((torch.from_numpy(x), tg.geometry, ts, None))
    want = jax.jit(lambda: jseg.multi_select(jparts, use_pallas=False))()
    got = kseg.multi_select(tparts)
    assert len(want) == len(got)
    for (wsel, wthr), (gsel, gthr) in zip(want, got):
        np.testing.assert_array_equal(_bits(gthr.numpy()), _bits(wthr))
        for w, g in zip(wsel, gsel):
            np.testing.assert_array_equal(g.indices.numpy(),
                                          np.asarray(w.indices))
            np.testing.assert_array_equal(_bits(g.values.numpy()),
                                          _bits(w.values))
            assert int(g.count) == int(w.count)
            if w.overflow is not None:
                assert bool(g.overflow) == bool(w.overflow)


# Slots whose survivors crowd one row: with k 20 and 16 over 10 and 8 rows
# the buckets hold 16 (24 for the sampled capacity 3k), so 40-60 survivors
# in a row overflow them; the 1500-element slot keeps its buckets.
CROWD_SIZES = (10240, 1500, 8000)
CROWD_KS = (20, 7, 16)
CROWD_STRIDES = (16, 1, 8)


def _crowded_arena(group, seed, short=False) -> np.ndarray:
    """Slots 0 and 2: noise x 0.01 with 60 and 40 large distinct
    magnitudes of alternating sign in their second row; slot 1 plain
    normal. ``short``: slot 0 holds only 18 nonzeros, in its second row,
    and slot 1 only four, so a trimmed ladder ends with fewer than k
    survivors (slot 0 overflowing its bucket too)."""
    rng = np.random.default_rng(seed)
    x = np.zeros(group.total, np.float32)
    for s, crowd in zip(group.slots, (60, 0, 40)):
        v = rng.standard_normal(s.size).astype(np.float32)
        if crowd:
            v *= np.float32(0.01)
            v[1100:1100 + crowd] = (np.linspace(5.0, 6.0, crowd) *
                                    (-1.0) ** np.arange(crowd))
        x[s.offset:s.offset + s.size] = v
    if short:
        s0, s1 = group.slots[0], group.slots[1]
        x[s0.offset:s0.offset + s0.size] = 0.0
        x[s0.offset + 1030:s0.offset + 1048] = np.linspace(-6.0, 6.0, 18)
        x[s1.offset:s1.offset + s1.size] = 0.0
        x[s1.offset + np.array([5, 700, 1100, 1499])] = [1.0, -2.0, 0.5, 3.0]
    return x.reshape(group.nblocks, 1024)


# (kind, tied): the spec kind; "crowded_*" and "short_*" run the crowded
# arena (CROWD_*), the others the ragged one (SIZES). The branches each
# takes in the port: (exact compactions, short picks); the tied ragged
# arenas overflow their buckets too. Cases not listed take neither.
MULTI_BRANCHES = {"cold": (3, 0), "reuse": (3, 0), "sampled_cold": (3, 0),
                  "sampled_reuse": (2, 0), "crowded_cold": (2, 0),
                  "crowded_sampled_cold": (2, 0), "crowded_trimmed": (2, 0),
                  "short_trimmed": (2, 2)}


@pytest.mark.parametrize("kind,tied", [
    ("trimmed", False), ("cold", True), ("warm", False), ("reuse", True),
    ("sampled_cold", True), ("sampled_warm", False),
    ("sampled_reuse", False), ("crowded_cold", False),
    ("crowded_sampled_cold", False), ("crowded_trimmed", False),
    ("short_trimmed", False)])
def test_multi_select_matches_reference(kind, tied):
    """Bitwise the reference's jnp ``multi_select``; a slot whose survivors
    overflow their buckets, or a trimmed slot with fewer than k survivors,
    takes the exact compaction or the short pick (``common.branches``)."""
    from repro_torch.kernels import common
    crowded = kind.startswith(("crowded_", "short_"))
    base = kind.split("_", 1)[1] if crowded else kind
    alg = "trimmed_topk" if base == "trimmed" else "threshold_bsearch"
    before = dict(common.branches)
    if crowded:
        jg, tg = _groups(CROWD_SIZES, CROWD_KS, alg=alg)
        x = _crowded_arena(jg, 3, short=kind.startswith("short"))
        _check_multi([(x, jg, tg)], [base], ks=CROWD_KS,
                     strides=CROWD_STRIDES)
    else:
        jg, tg = _groups(alg=alg)
        _check_multi([(_arena(jg, 3, tied), jg, tg)], [kind])
    taken = tuple(common.branches[b] - before[b]
                  for b in ("exact_compaction", "short_pick"))
    assert taken == MULTI_BRANCHES.get(kind, (0, 0))


def test_multi_select_two_arenas_one_call():
    """A trimmed and a warm bsearch arena searched together (the fused
    select GradientSync issues), including a trimmed slot whose k exceeds
    its survivors (the jnp fallback to the exact top-k)."""
    jt, tt = _groups((2048, 1100), (600, 5), alg="trimmed_topk")
    jb, tb = _groups()
    _check_multi([(_arena(jt, 4, tied=True), jt, tt),
                  (_arena(jb, 5), jb, tb)], ["trimmed", "warm"])


def test_gather_topk_from_buckets_ties():
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    from repro.kernels import ops as jops
    from repro_torch.kernels import ops as tops
    rng = np.random.default_rng(6)
    vals = (rng.integers(-2, 3, (10, 8)) * 0.5).astype(np.float32)
    idx = rng.integers(0, 120, (10, 8)).astype(np.int32)
    for k in (5, 40, 79):
        for mag in (True, False):
            w = jops._gather_topk_from_buckets(jnp.asarray(vals),
                                               jnp.asarray(idx), k, 100, mag)
            g = tops._gather_topk_from_buckets(torch.from_numpy(vals),
                                               torch.from_numpy(idx), k, 100,
                                               mag)
            np.testing.assert_array_equal(g[0].numpy(), np.asarray(w[0]))
            np.testing.assert_array_equal(_bits(g[1].numpy()), _bits(w[1]))
    for cap, nb in ((30000, 14649), (18000, 8790), (10, 3), (5000, 2)):
        assert tops._cap_for(cap, nb, 1024) == jops._cap_for(cap, nb, 1024)


@pytest.mark.parametrize("tied", [False, True])
def test_strided_twins_match_reference_bitwise(tied):
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    from repro.kernels import segmented as jseg
    from repro_torch.kernels import segmented as kseg
    jg, tg = _groups()
    g = tg.geometry
    x = _arena(jg, 11, tied)
    xt = torch.from_numpy(x)
    stride_b = np.asarray(STRIDES, np.int32)[g.block_seg]
    ws, wm = jref.seg_abs_sum_max(jnp.asarray(x), g.block_seg, g.block_size,
                                  g.n_seg, STRIDES)
    gs, gm = kseg.seg_abs_sum_max(xt, g, STRIDES)
    np.testing.assert_array_equal(_bits(gs.numpy()), _bits(ws))
    np.testing.assert_array_equal(_bits(gm.numpy()), _bits(wm))
    for thr in ([0.9, 1.0, 0.0], [0.0, 0.0, 0.0]):
        thr = np.asarray(thr, np.float32)
        wc = jref.seg_count_gt(jnp.asarray(x), g.block_seg, jnp.asarray(thr),
                               g.n_seg, stride_b)
        gc = kseg.seg_count_gt(xt, g, torch.from_numpy(thr), STRIDES)
        np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(
        _bits(kseg.seg_mean(gs, g, STRIDES).numpy()),
        _bits(jseg.seg_mean(ws, jg.geometry, STRIDES)))
    # every stride 1 to 1024, one-element slots, thresholds 0, 1, negative
    # (the stride grid's zero padding counts) and mixed
    jg, tg = _groups(SMALL_STRIDED_SIZES,
                     tuple(max(1, n // 100) for n in SMALL_STRIDED_SIZES))
    g = tg.geometry
    x = _arena(jg, 13, tied)
    xt = torch.from_numpy(x)
    n = g.n_seg
    thrs = [np.full(n, v, np.float32) for v in (0.0, 1.0, -1.0)]
    thrs.append(np.asarray([(-1.0, 0.0, 1.0)[i % 3] for i in range(n)],
                           np.float32))
    for strides in (ALL_STRIDES, ALL_STRIDES[::-1]):
        ws, wm = jref.seg_abs_sum_max(jnp.asarray(x), g.block_seg,
                                      g.block_size, n, strides)
        gs, gm = kseg.seg_abs_sum_max(xt, g, strides)
        np.testing.assert_array_equal(_bits(gs.numpy()), _bits(ws))
        np.testing.assert_array_equal(_bits(gm.numpy()), _bits(wm))
        stride_b = np.asarray(strides, np.int32)[g.block_seg]
        for thr in thrs:
            wc = jref.seg_count_gt(jnp.asarray(x), g.block_seg,
                                   jnp.asarray(thr), n, stride_b)
            gc = kseg.seg_count_gt(xt, g, torch.from_numpy(thr), strides)
            np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("momentum,nesterov,wd,bf16", [
    (0.9, False, 0.0, False), (0.9, True, 1e-4, False),
    (0.0, False, 0.0, False), (0.9, False, 0.0, True)])
def test_residual_update_stats_twin_matches_reference(momentum, nesterov, wd,
                                                      bf16):
    """V'/U' bitwise ``accumulate_arena`` (eager), sums bitwise the
    reference twin's pinned (strided) stats of V'; against the Pallas
    body in interpret mode within 1 ulp of the largest operand per
    multiply-add XLA may contract into an FMA (``wd * p + g`` and
    ``m * U + g``: one rounding where the twin has two), carried through
    each further rounded add (one bf16 ulp when V' is rounded to bf16);
    sums rtol 1e-6 (the body sums rows in sequence), max exact."""
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    from repro.core import residual as jres
    from repro.kernels import ref as jref
    from repro.kernels import segmented as jseg
    from repro_torch.kernels import segmented as kseg
    jg, tg = _groups()
    geo = tg.geometry
    g, v, u, p = (_arena(jg, 20 + i) * sc for i, sc in
                  enumerate((1e-2, 1e-3, 1e-3, 0.5)))
    kw = dict(momentum=momentum, nesterov=nesterov, weight_decay=wd)
    t = [torch.from_numpy(a) for a in (g, v, u, p)]
    for strides in (STRIDES, None):
        tv, tu, ts, tm = kseg.seg_residual_update_stats(
            *t, geo, round_dtype=torch.bfloat16 if bf16 else None,
            stride_seg=strides, **kw)
        wv, wu = jres.accumulate_arena(
            *(jnp.asarray(a) for a in (g, v, u, p)),
            residual_dtype=jnp.bfloat16 if bf16 else jnp.float32, **kw)
        np.testing.assert_array_equal(_bits(tv.numpy()), _bits(wv))
        assert (tu is None) == (wu is None) == (not momentum)
        if momentum:
            np.testing.assert_array_equal(_bits(tu.numpy()), _bits(wu))
        ws, wm = jref.seg_abs_sum_max(wv, geo.block_seg, geo.block_size,
                                      geo.n_seg, strides)
        np.testing.assert_array_equal(_bits(ts.numpy()), _bits(ws))
        np.testing.assert_array_equal(_bits(tm.numpy()), _bits(wm))
    pv, pu, ps, pm = jseg.seg_residual_update_stats(
        jnp.asarray(g), jnp.asarray(v),
        jnp.asarray(u) if momentum else None, jnp.asarray(p) if wd else None,
        geo.block_seg, geo.n_seg, round_dtype=jnp.bfloat16 if bf16 else None,
        interpret=True, **kw)
    scale = np.maximum.reduce([np.abs(np.asarray(a)) for a in (
        g + wd * p, momentum * u, v, pv, pu if momentum else v)])
    u_ulps = 1 + bool(wd)
    v_ulps = u_ulps + 1 + nesterov
    assert np.all(np.abs(tv.numpy() - np.asarray(pv))
                  <= (2 ** 16 if bf16 else v_ulps) * np.spacing(scale))
    if momentum:
        assert np.all(np.abs(tu.numpy() - np.asarray(pu))
                      <= u_ulps * np.spacing(scale))
    np.testing.assert_allclose(ts.numpy(), np.asarray(ps), rtol=1e-6)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(pm))


@pytest.mark.parametrize("interval,warm", [(0, False), (0, True), (3, True)])
def test_sampled_per_leaf_one_slot_arena_matches_search(interval, warm):
    """A lone sampled leaf through a one-slot arena and ``multi_select``
    (the CUDA route) equals ``selection.sampled_threshold_search`` of
    both packages bitwise, and so does the CPU ``compress``; interval 3
    is a reuse step."""
    torch = pytest.importorskip("torch")
    import jax.numpy as jnp

    from repro.core import arena as jarena
    from repro.core import selection as jsel
    from repro_torch.core import arena as tarena
    from repro_torch.core import compressors
    from repro_torch.core.residual import init_leaf
    n, k = 5000, 100
    x = _arena(jarena.build_group(0, "x", "float32",
                                  [(0, "x", n, k, 3 * k, 1)]), 14)
    flat = x.reshape(-1)[:n]
    thr0 = np.float32(0.7)
    comp = compressors.SampledBSearch(warm_start=warm)
    stride = 4
    assert comp.segment_strides(tarena.single_slot_geometry(n, k)) == \
        (stride,)
    st = init_leaf(torch.zeros(n))._replace(
        threshold=torch.tensor(thr0), interval=torch.tensor(interval,
                                                           dtype=torch.int32))
    if interval % comp.interval == 0:
        w, wthr = jsel.sampled_threshold_search(
            jnp.asarray(flat), k, stride=stride, capacity=3 * k,
            warm=jnp.float32(thr0) if warm else None)
    else:
        w, wthr = jsel.threshold_filter(jnp.asarray(flat), thr0, 3 * k), thr0
    for sel, new in (comp.compress_arena(torch.from_numpy(flat), k, st),
                     comp.compress(torch.from_numpy(flat), k, st)):
        np.testing.assert_array_equal(sel.indices.numpy(),
                                      np.asarray(w.indices))
        np.testing.assert_array_equal(_bits(sel.values.numpy()),
                                      _bits(w.values))
        assert int(sel.count) == int(w.count)
        assert bool(sel.overflow) == bool(w.overflow)
        assert _bits(new.threshold.numpy()) == _bits(wthr)
        assert int(new.interval) == interval + 1


def _port_group(sizes=SIZES, ks=SEG_KS):
    from repro_torch.core import arena
    return arena.build_group(0, "threshold_bsearch", "float32", [
        (i, f"s{i}", n, k, 2 * k, 1 + 4 * k)
        for i, (n, k) in enumerate(zip(sizes, ks))])


def _need_cuda():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch


# The card tests import nothing of JAX (the card's host has none); run them
# there with: python -m pytest --noconftest -m cuda tests/test_torch_*.py

@pytest.mark.cuda
@pytest.mark.parametrize("tied", [False, True])
def test_cuda_kernels_match_twins(tied):
    """On the card: each CUDA kernel against its plain twin on the same
    CUDA tensors (bitwise sums, exact counts and compaction, bitwise
    fused residual update), with ties or not, threshold 0, bucket
    overflow and strides off the slot sizes; the strided forms also at
    every stride 1 to 1024 (``_check_strided_on_card``)."""
    torch = _need_cuda()
    from repro_torch.kernels import ref
    from repro_torch.kernels import segmented as kseg
    group = _port_group()
    g = group.geometry
    x = torch.from_numpy(_arena(group, 7, tied)).cuda()
    thr = torch.tensor([0.9, 1.0, 0.0], device="cuda")
    ks, km = kseg.seg_abs_sum_max(x, g)
    ps, pm = ref.seg_abs_sum_max(x, g.block_seg, g.block_size, g.n_seg)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
    assert torch.equal(km, pm)
    assert torch.equal(kseg.seg_count_gt(x, g, thr),
                       ref.seg_count_gt(x, g.block_seg, thr, g.n_seg))
    got = kseg.seg_compact_gt(x, g, thr, 8)
    want = ref.seg_compact_gt(x, g.block_seg, g.block_base,
                              g.block_size, thr, 8)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _check_compaction_on_card(torch, ref, kseg, tied)
    # the strided (sampled) forms and the fused residual update
    ks, km = kseg.seg_abs_sum_max(x, g, STRIDES)
    ps, pm = ref.seg_abs_sum_max(x, g.block_seg, g.block_size, g.n_seg,
                                 STRIDES)
    assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
    assert torch.equal(km, pm)
    assert torch.equal(
        kseg.seg_count_gt(x, g, thr, STRIDES),
        ref.seg_count_gt(x, g.block_seg, thr, g.n_seg,
                         np.asarray(STRIDES, np.int32)[g.block_seg]))
    u, p = x * 0.5, x * 0.25
    for m, nest, wd, rd in ((0.9, False, 0.0, None),
                            (0.9, True, 1e-4, None),
                            (0.0, False, 0.0, None),
                            (0.9, False, 0.0, torch.bfloat16)):
        kw = dict(momentum=m, nesterov=nest, weight_decay=wd,
                  round_dtype=rd, stride_seg=STRIDES)
        got = kseg.seg_residual_update_stats(x * 1e-2, x, u, p, g, **kw)
        want = ref.seg_residual_update_stats(x * 1e-2, x, u, p, g, **kw)
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a.view(torch.int32),
                                   b.view(torch.int32))
    _check_strided_on_card(torch, ref, kseg, tied)


# Strides 1 to 1024 over slots of one element, a large stride-1 slot
# (333,333 elements) and sizes that end mid-row; each stride order is also
# taken reversed, so every stride meets two sizes.
STRIDED_SIZES = (333_333, 1, 1000, 1025, 5000, 70_000, 3, 2047, 4097, 1,
                 100_000)


def _check_strided_on_card(torch, ref, kseg, tied):
    """The strided seg_abs_sum_max and seg_count_gt against their twins,
    bitwise, at every stride 1 to 1024, with thresholds 0, 1, negative
    (the stride grid's zero padding counts) and mixed."""
    group = _port_group(STRIDED_SIZES, tuple(max(1, n // 100)
                                             for n in STRIDED_SIZES))
    g = group.geometry
    assert any(b + 1024 > n for b, n in zip(g.block_base, g.block_size))
    x = torch.from_numpy(_arena(group, 13, tied)).cuda()
    n = g.n_seg
    thrs = [torch.full((n,), v, device="cuda") for v in (0.0, 1.0, -1.0)]
    thrs.append(torch.tensor([(-1.0, 0.0, 1.0)[i % 3] for i in range(n)],
                             device="cuda"))
    for strides in (ALL_STRIDES, ALL_STRIDES[::-1]):
        ks, km = kseg.seg_abs_sum_max(x, g, strides)
        ps, pm = ref.seg_abs_sum_max(x, g.block_seg, g.block_size, n,
                                     strides)
        assert torch.equal(ks.view(torch.int32), ps.view(torch.int32))
        assert torch.equal(km.view(torch.int32), pm.view(torch.int32))
        stride_b = np.asarray(strides, np.int32)[g.block_seg]
        for thr in thrs:
            assert torch.equal(kseg.seg_count_gt(x, g, thr, strides),
                               ref.seg_count_gt(x, g.block_seg, thr, n,
                                                stride_b))


def _check_compaction_on_card(torch, ref, kseg, tied):
    """seg_compact_gt against its twin at caps 1 to 1024, on arenas whose
    slots end mid-row (block_size < block_base + 1024; a negative
    threshold counts the zero padding unless the kernel masks it) and
    with two rows crowded wholly above every threshold."""
    for sizes, ks in ((SIZES, SEG_KS), ((1, 1025, 2047), (1, 3, 20))):
        group = _port_group(sizes, ks)
        g = group.geometry
        assert any(b + 1024 > n for b, n in zip(g.block_base, g.block_size))
        a = _arena(group, 11, tied)
        crowd = np.where(a[1:3] < 0, -4.5, np.where(a[1:3] > 0, 4.5, 0.0))
        a[1:3] = crowd
        x = torch.from_numpy(a).cuda()
        for thr in ([1.0, 0.5, 2.0], [-1.0, -1.0, 0.0]):
            t = torch.tensor(thr, device="cuda")
            for cap in (1, 8, 16, 1024):
                got = kseg.seg_compact_gt(x, g, t, cap)
                want = ref.seg_compact_gt(x, g.block_seg, g.block_base,
                                          g.block_size, t, cap)
                for p, q in zip(got, want):
                    assert torch.equal(p, q)


@pytest.mark.cuda
def test_cuda_gradient_sync_matches_cpu_bitwise():
    """On the card: two port updates (refresh, then reuse) on CUDA — the
    kernel path — equal the same updates on the CPU — the plain path the
    other tests tie to the JAX reference — bitwise, with dense, trimmed
    and bsearch leaves in one step."""
    torch = _need_cuda()
    from repro_torch.core import tree
    from repro_torch.core.gradient_sync import build_gradient_sync
    from repro_torch.kernels import segmented as kseg
    rng = np.random.default_rng(8)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))
    params = {"a": t(64, 48), "b": t(40, 30), "c": t(50),
              "d": {"e": t(100, 40), "f": t(17)}}
    grads = [tree.tree_map(lambda p: t(*p.shape, scale=1e-2), params)
             for _ in range(2)]

    def run(device):
        sync = build_gradient_sync("rgc", density=0.01, device=device,
                                   dense_threshold_bytes=1024,
                                   trimmed_threshold_bytes=8192)
        mv = lambda tr: tree.tree_map(lambda x: x.to(device), tr)  # noqa: E731
        p = mv(params)
        st = sync.init(p)
        lr = torch.tensor(0.1, device=device)
        for g in grads:
            p, st = sync.update(mv(g), st, p, lr)
        return [x.cpu() for x in tree.flatten(p)[0]] + [
            f.cpu() for s in tree.flatten(st)[0] for f in s]

    before = kseg.launches["seg_count_gt"]
    on_card = run("cuda")
    assert kseg.launches["seg_count_gt"] > before
    for a, b in zip(on_card, run("cpu")):
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
